"""Command line of the port — counterpart of `run.py test`, `run.py eval` and
`run.py train`:

    python -m pfnl_tpu_torch test {pfnl,vespcn,mcresnet,ltdvsr,drvsr,duf} --data DIR
        [--save-dir D] [--weights params.npz] [--compute-dtype bfloat16]
        [--device cuda] [--start 0] [--name NAME]
    python -m pfnl_tpu_torch eval pfnl [--save-dir D] [--eval-list F]
        [--compute-dtype float32|bfloat16] [--device cuda]
    python -m pfnl_tpu_torch train pfnl --train-list F [--eval-list F]
        [--steps N] [--in-size 32] [--batch-size 16] [--save-dir D]
        [--save-every 500] [--compute-dtype float32|bfloat16] [--no-eval]
        [--device cuda]

`test` super-resolves every sequence of a dataset directory into
`DIR/<seq>/<NAME>/*.png`: PFNL degrades `DIR/<seq>/truth/*.png` on the
device, the Y-channel families (vespcn, mcresnet, ltdvsr, drvsr) and DUF
(52 layers) read the pre-rendered `DIR/<seq>/blur4/*.png`, as the JAX
package does.  Its weights, as JAX's `_restored_state`: the newest
`ckpt_*.pt` that `train` wrote under `--save-dir` (the preset's
`./checkpoint/<model>` by default); without one they stay random, drawn
from `--seed`.  `--weights` takes precedence: a flat `.npz` of '/'-joined
flax paths (for DUF with its BatchNorm state: `params/...` and
`batch_stats/...`).

`eval` restores the same way and runs the Evaluator at the checkpoint's
step, appending to `<save-dir>/<model>.txt` as `train`'s evaluations do.
Only PFNL trains in the port, so only PFNL evaluates.

`train` trains from the sequences of a filelist (the paper config by
default: batch 16, LR crop 32, 7 frames, float32), saving checkpoints and
the eval log (`pfnl.txt`) under `--save-dir`, and resuming from its newest
checkpoint.

The device is `cuda` unless `--device` names another: a machine whose CUDA
fails runs nothing rather than falling back to the CPU.
"""

import argparse
import os
import sys

import torch

from pfnl_tpu_torch.models import MODEL_REGISTRY


def _parser():
    p = argparse.ArgumentParser(prog="python -m pfnl_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("test", help="super-resolve every sequence of a dataset dir")
    t.add_argument("model", choices=sorted(MODEL_REGISTRY))
    t.add_argument("--data", required=True,
                   help="dataset dir: <seq>/truth/*.png (pfnl) or <seq>/blur4/*.png")
    t.add_argument("--save-dir", default=None,
                   help="restore its newest ckpt_*.pt (default: the preset's save_dir)")
    t.add_argument("--weights", default=None, help="flat .npz of flax params (before --save-dir)")
    t.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    t.add_argument("--device", default="cuda")
    t.add_argument("--start", type=int, default=0, help="first sequence index")
    t.add_argument("--name", default=None, help="output subdirectory (default: model)")
    t.add_argument("--seed", type=int, default=0, help="seed of the random weights")

    e = sub.add_parser("eval", help="evaluate the newest checkpoint of --save-dir")
    e.add_argument("model", choices=sorted(MODEL_REGISTRY))
    e.add_argument("--save-dir", default=None)
    e.add_argument("--eval-list", default=None)
    e.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    e.add_argument("--device", default="cuda")

    r = sub.add_parser("train", help="train from a filelist of sequence dirs")
    r.add_argument("model", choices=["pfnl"])
    r.add_argument("--train-list", default=None)
    r.add_argument("--eval-list", default=None)
    r.add_argument("--steps", type=int, default=None, help="last global step (default: preset)")
    r.add_argument("--in-size", type=int, default=None, help="LR crop (GT crop x4)")
    r.add_argument("--batch-size", type=int, default=None)
    r.add_argument("--save-dir", default=None)
    r.add_argument("--save-every", type=int, default=500)
    r.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"])
    r.add_argument("--no-eval", action="store_true")
    r.add_argument("--device", default="cuda")
    return p


# what the families other than PFNL wait for before they train, and so evaluate
_NOT_TRAINED = {"duf": "the DUF training slice",
                **{m: "the flow-family training slice" for m in ("vespcn", "mcresnet", "ltdvsr",
                                                                 "drvsr")}}


def _restored_model(args, cfg, seed=0, weights=None):
    """The family's model, weights random from `seed`, then the npz
    `weights` if given, else the newest ckpt_*.pt under cfg.save_dir if
    there is one (run.py `_restored_state`, :140-146, which starts from the
    init); returns (model on --device in eval mode, the checkpoint's step
    or 0)."""
    from pfnl_tpu_torch.train.trainer import load_newest_checkpoint
    from pfnl_tpu_torch.utils.weights import load_npz

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model = MODEL_REGISTRY[args.model](num_frames=cfg.num_frames, scale=cfg.scale, dtype=dtype,
                                       generator=torch.Generator().manual_seed(seed))
    step = 0
    if weights:
        model.load_state_dict(load_npz(weights))
    else:
        state = load_newest_checkpoint(cfg.save_dir, model, "cpu")
        if state is not None:
            step = int(state["step"])
    return model.to(args.device).eval(), step


def _config(args, **over):
    from pfnl_tpu_torch.config import preset

    if args.save_dir is not None:
        over["save_dir"] = args.save_dir
    return preset(args.model, **over)


def cmd_test(args):
    """run.py cmd_test (:149-166) without the mesh."""
    from pfnl_tpu_torch.infer.predictor import Predictor

    cfg = _config(args)
    model, _ = _restored_model(args, cfg, args.seed, args.weights)
    Predictor(model).testvideos(args.data, start=args.start, name=args.name or cfg.model)


def cmd_eval(args):
    """run.py cmd_eval (:123-137): the restored model through the Evaluator
    at the checkpoint's step."""
    from pfnl_tpu_torch.eval.evaluator import Evaluator

    if args.model in _NOT_TRAINED:
        raise SystemExit(f"eval {args.model}: the port does not train {args.model} yet, so it "
                         f"has no checkpoint to evaluate; that comes with "
                         f"{_NOT_TRAINED[args.model]}")
    cfg = _config(args, **({"eval_list": args.eval_list} if args.eval_list else {}))
    cfg.log_path = os.path.join(cfg.save_dir, f"{cfg.model}.txt")
    model, step = _restored_model(args, cfg)
    Evaluator(cfg, model).run(step, log_path=cfg.log_path)


def cmd_train(args):
    """run.py cmd_train (:60-120) without the multi-host flags."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.data.manifest import load_manifest
    from pfnl_tpu_torch.data.pipeline import TrainPipeline
    from pfnl_tpu_torch.eval.evaluator import Evaluator
    from pfnl_tpu_torch.train.trainer import Trainer

    over = {k: v for k, v in (("train_list", args.train_list), ("eval_list", args.eval_list),
                              ("in_size", args.in_size), ("batch_size", args.batch_size),
                              ("save_dir", args.save_dir),
                              ("compute_dtype", args.compute_dtype)) if v is not None}
    cfg = preset(args.model, **over)
    cfg.log_path = os.path.join(cfg.save_dir, f"{cfg.model}.txt")
    tr = Trainer(cfg, device=args.device)
    seqs = load_manifest(cfg.train_list, cfg.scale, need_blur=cfg.producer != "single")
    pipe = TrainPipeline(seqs, cfg.producer, cfg.num_frames, cfg.in_size, cfg.scale,
                         cfg.batch_size, seed=cfg.seed, num_threads=cfg.host_threads,
                         prefetch=cfg.prefetch)
    eval_fn = None
    if not args.no_eval:
        ev = Evaluator(cfg, tr.model)

        def eval_fn(trainer, step):
            ev.run(step, log_path=cfg.log_path)

    try:
        tr.fit(pipe, max_steps=args.steps, eval_fn=eval_fn, save_every=args.save_every)
    finally:
        pipe.close()


def main(argv=None):
    args = _parser().parse_args(argv)
    {"test": cmd_test, "eval": cmd_eval, "train": cmd_train}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
