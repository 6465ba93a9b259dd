"""Command line of the port — counterpart of `run.py test`, `eval`, `train`,
`import-tf1`, `prepare` and `parity`:

    python -m pfnl_tpu_torch test {pfnl,vespcn,mcresnet,ltdvsr,drvsr,frvsr,duf} --data DIR
        [--save-dir D] [--weights params.npz] [--compute-dtype bfloat16]
        [--device cuda] [--start 0] [--name NAME] [--seed 0]
    python -m pfnl_tpu_torch eval {pfnl,vespcn,mcresnet,ltdvsr,drvsr,frvsr,duf} [--save-dir D]
        [--eval-list F] [--eval-in-size 128x240] [--compute-dtype float32|bfloat16]
        [--device cuda]
    python -m pfnl_tpu_torch train {pfnl,vespcn,mcresnet,ltdvsr,drvsr,frvsr,duf} --train-list F
        [--eval-list F] [--eval-in-size 128x240] [--steps N] [--in-size 32] [--batch-size 16] [--save-dir D]
        [--save-every 500] [--compute-dtype float32|bfloat16] [--no-eval]
        [--device cuda] [--dp N] [--sp N] [--coordinator HOST:PORT --num-processes N --process-id I]
    python -m pfnl_tpu_torch export {pfnl,vespcn,mcresnet,ltdvsr,drvsr,frvsr,duf} [--save-dir D]
        [--weights params.npz] [--compute-dtype float32|bfloat16] [--hw 180x320] [--batch 8]
        [--dtype float32|bfloat16] [--out F.pt2] [--device cuda] [--seed 0]
    python -m pfnl_tpu_torch import-tf1 MODEL --ckpt PREFIX|FILE.h5 [--save-dir D]
    python -m pfnl_tpu_torch prepare --root R [--scale 4] [--val-count 19]
        [--overwrite] [--no-filelists] [--device cuda]
    python -m pfnl_tpu_torch parity MODEL --data DIR [--name N] [--tables-only]
        [and the options of `test`]

`test --dp N` serves the window batches data-parallel over N devices
(cuda:0..N-1, or N replicas on the CPU with `--device cpu`): run.py's
`--dp` mesh.

`test` super-resolves every sequence of a dataset directory into
`DIR/<seq>/<NAME>/*.png`: PFNL degrades `DIR/<seq>/truth/*.png` on the
device, the Y-channel families (vespcn, mcresnet, ltdvsr, drvsr), FRVSR
(frame by frame, its state carried on the device) and DUF (52 layers)
read the pre-rendered `DIR/<seq>/blur4/*.png`, as the JAX package does.
Its weights, as JAX's `_restored_state`: the newest `ckpt_*.pt` under
`--save-dir` (the preset's `./checkpoint/<model>` by default), which
`train` or `import-tf1` wrote; without one they stay random, drawn from
`--seed`.  `--weights` takes precedence: a flat `.npz` of '/'-joined flax
paths (for DUF with its BatchNorm state: `params/...` and
`batch_stats/...`).

`eval` restores the same way and runs the family's Evaluator at the
checkpoint's step, appending to `<save-dir>/<model>.txt` as `train`'s
evaluations do (PFNL and DUF: RGB PSNR; the Y families: Y PSNR and SSIM per
output frame; FRVSR: RGB PSNR per frame of its 10-frame windows).

`train` trains from the sequences of a filelist (the family's paper config
by default, e.g. PFNL batch 16, LR crop 32, 7 frames; float32; the flow
families staged at their `stage_switch_step`; DUF-52L batch 11, LR crop 32,
its BatchNorms in training mode), saving checkpoints and the eval log
(`<model>.txt`) under `--save-dir`, and resuming from its newest
checkpoint.

`train --dp N --sp M` trains data-parallel on N x M ranks, one process a
device (the batch split over the N data ranks; the M space ranks of a data
index replicate its step, as JAX's `--sp` does): without `--coordinator` it
starts the N x M local ranks itself (cuda:0.. or the CPU), with it this
process is rank `--process-id` of `--num-processes`, meeting the others at
the coordinator's address (run.py's multi-host flags).

`export` restores the model as `test` does and writes the AOT artifact of
its serving program at batch x LR `--hw` (input `--dtype`) to `--out`
(infer/export.py), printing what run.py's `export` prints.

`import-tf1` reads the authors' TF1 checkpoint (a `PREFIX` with its
`.index` and `.data-*` files, no TensorFlow needed; for DUF also the
original VSR-DUF `.h5` weights, which need h5py), loads it into the
family's model (`load_state_dict(strict=True)`: a name or shape that does
not fit fails, naming it) and writes `ckpt_000000000.pt` (step 0, the
model alone) under `--save-dir`.

`prepare` renders `blur{scale}/` beside every `truth/` under `--root` on
the device and writes the train/val filelists there.  `parity` runs `test`
into `DIR/<seq>/<NAME>/` (`<model>_parity` by default), then prints the
MATLAB-equivalent Y-channel PSNR/SSIM table of those frames against
`truth/` (`--tables-only`: the table alone).

The device is `cuda` unless `--device` names another: a machine whose CUDA
fails runs nothing rather than falling back to the CPU.
"""

import argparse
import os
import sys

import torch

from pfnl_tpu_torch.models import MODEL_REGISTRY


def _hw(text: str) -> tuple:
    """"128x240" -> (128, 240), as run.py's --eval-in-size."""
    h, w = text.split("x")
    return int(h), int(w)


def _parser():
    p = argparse.ArgumentParser(prog="python -m pfnl_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def serving(q):
        """The options of `test` that `parity` shares."""
        q.add_argument("model", choices=sorted(MODEL_REGISTRY))
        q.add_argument("--data", required=True,
                       help="dataset dir: <seq>/truth/*.png (pfnl) or <seq>/blur4/*.png")
        q.add_argument("--save-dir", default=None,
                       help="restore its newest ckpt_*.pt (default: the preset's save_dir)")
        q.add_argument("--weights", default=None,
                       help="flat .npz of flax params (before --save-dir)")
        q.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
        q.add_argument("--device", default="cuda")
        q.add_argument("--name", default=None, help="output subdirectory")
        q.add_argument("--seed", type=int, default=0, help="seed of the random weights")

    t = sub.add_parser("test", help="super-resolve every sequence of a dataset dir")
    serving(t)
    t.add_argument("--start", type=int, default=0, help="first sequence index")
    t.add_argument("--dp", type=int, default=1,
                   help="serve the window batches data-parallel over N devices")

    e = sub.add_parser("eval", help="evaluate the newest checkpoint of --save-dir")
    e.add_argument("model", choices=sorted(MODEL_REGISTRY))
    e.add_argument("--save-dir", default=None)
    e.add_argument("--eval-list", default=None)
    e.add_argument("--eval-in-size", type=_hw, default=None, help="HxW of the LR eval crops")
    e.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    e.add_argument("--device", default="cuda")

    r = sub.add_parser("train", help="train from a filelist of sequence dirs")
    r.add_argument("model", choices=sorted(MODEL_REGISTRY))
    r.add_argument("--train-list", default=None)
    r.add_argument("--eval-list", default=None)
    r.add_argument("--eval-in-size", type=_hw, default=None, help="HxW of the LR eval crops")
    r.add_argument("--steps", type=int, default=None, help="last global step (default: preset)")
    r.add_argument("--in-size", type=int, default=None, help="LR crop (GT crop x4)")
    r.add_argument("--batch-size", type=int, default=None)
    r.add_argument("--save-dir", default=None)
    r.add_argument("--save-every", type=int, default=500)
    r.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"])
    r.add_argument("--no-eval", action="store_true")
    r.add_argument("--device", default="cuda")
    r.add_argument("--dp", type=int, default=1, help="data-parallel ranks (the batch axis)")
    r.add_argument("--sp", type=int, default=1,
                   help="space ranks (the non-local attention's axis; replicate the step)")
    r.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous for a multi-process run")
    r.add_argument("--num-processes", type=int, default=None)
    r.add_argument("--process-id", type=int, default=None)

    x = sub.add_parser("export", help="AOT-export the serving program (torch.export)")
    x.add_argument("model", choices=sorted(MODEL_REGISTRY))
    x.add_argument("--save-dir", default=None,
                   help="restore its newest ckpt_*.pt (default: the preset's save_dir)")
    x.add_argument("--weights", default=None,
                   help="flat .npz of flax params (before --save-dir)")
    x.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    x.add_argument("--hw", type=_hw, default=(180, 320), help="LR input HxW")
    x.add_argument("--batch", type=int, default=8)
    x.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the input's dtype")
    x.add_argument("--out", default=None)
    x.add_argument("--device", default="cuda")
    x.add_argument("--seed", type=int, default=0, help="seed of the random weights")

    m = sub.add_parser("import-tf1", help="convert a reference TF1 checkpoint to ckpt_*.pt")
    m.add_argument("model", choices=sorted(MODEL_REGISTRY))
    m.add_argument("--ckpt", required=True,
                   help="TF1 checkpoint prefix (with .index/.data-* files), or DUF's .h5")
    m.add_argument("--save-dir", default=None, help="default: the preset's save_dir")

    q = sub.add_parser("prepare", help="render blur{scale}/ and write the filelists")
    q.add_argument("--root", required=True)
    q.add_argument("--scale", type=int, default=4)
    q.add_argument("--val-count", type=int, default=19)
    q.add_argument("--overwrite", action="store_true")
    q.add_argument("--no-filelists", action="store_true")
    q.add_argument("--device", default="cuda")

    y = sub.add_parser("parity", help="test, then the Y-PSNR/SSIM table")
    serving(y)
    y.add_argument("--tables-only", action="store_true",
                   help="skip inference, just recompute the table")
    return p


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
    """run.py cmd_test (:149-166); --dp N serves on N devices (run.py's mesh)."""
    from pfnl_tpu_torch.infer.predictor import Predictor

    cfg = _config(args)
    devices = None
    dp = getattr(args, "dp", 1)
    if dp > 1:
        if torch.device(args.device).type == "cuda":
            if dp > torch.cuda.device_count():
                raise SystemExit(f"--dp {dp}: only {torch.cuda.device_count()} GPUs are visible")
            devices = [torch.device("cuda", i) for i in range(dp)]
        else:
            devices = [torch.device(args.device)] * dp
    model, _ = _restored_model(args, cfg, args.seed, args.weights)
    Predictor(model, devices=devices).testvideos(args.data, start=args.start,
                                                 name=args.name or cfg.model)


def cmd_export(args):
    """run.py cmd_export (:169-191)."""
    from pfnl_tpu_torch.infer.export import export_model

    cfg = _config(args)
    model, _ = _restored_model(args, cfg, args.seed, args.weights)
    h, w = args.hw
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    blob = export_model(model, args.batch, cfg.num_frames, (h, w), dtype=dtype,
                        model_name=cfg.model)
    out = args.out or f"{cfg.model}_{h}x{w}_b{args.batch}.pt2"
    with open(out, "wb") as f:
        f.write(blob)
    print(f"exported {cfg.model} [{args.batch},{cfg.num_frames},{h},{w},3] "
          f"-> {out} ({len(blob)/1e6:.1f} MB)")


def cmd_import_tf1(args):
    """run.py cmd_import_tf1 (:231-272): the family's model (float32, the
    seed-0 init), its parameters replaced by the checkpoint's, saved at
    step 0 with no optimizer state (training starts Adam fresh)."""
    from pfnl_tpu_torch.train.trainer import save_checkpoint
    from pfnl_tpu_torch.utils.tf1_imports import IMPORTERS, import_duf_hdf5
    from pfnl_tpu_torch.utils.weights import from_flax, to_flax

    cfg = _config(args)
    importer, cfg_keys, has_stats = IMPORTERS[cfg.model]
    model = MODEL_REGISTRY[cfg.model](num_frames=cfg.num_frames, scale=cfg.scale,
                                      generator=torch.Generator().manual_seed(0))
    if args.ckpt.endswith((".h5", ".hdf5")):
        # the original VSR-DUF weights (reference utils.py:290-318)
        if cfg.model != "duf":
            raise SystemExit("hdf5 import is only defined for duf")
        params, stats = import_duf_hdf5(*to_flax(model), args.ckpt)
    else:
        out = importer(args.ckpt, **{k: getattr(cfg, k) for k in cfg_keys})
        params, stats = out if has_stats else (out, None)
    try:
        model.load_state_dict(from_flax(params, stats), strict=True)
    except RuntimeError as e:
        raise SystemExit(f"import-tf1 {cfg.model}: {args.ckpt} does not fit the model: {e}")
    path = save_checkpoint(cfg.save_dir, {"step": 0, "model": model.state_dict()})
    print(f"imported {args.ckpt} -> {path} (step 0)")


def cmd_prepare(args):
    """run.py cmd_prepare (:201-208)."""
    from pfnl_tpu_torch.data.prepare import make_filelists, prepare_dataset

    n = prepare_dataset(args.root, scale=args.scale, overwrite=args.overwrite, device=args.device)
    print(f"rendered {n} LR frames")
    if not args.no_filelists:
        make_filelists(args.root, val_count=args.val_count)


def cmd_parity(args):
    """run.py cmd_parity (:211-220): `test` over a dataset dir into
    <seq>/<name>/, then the MATLAB-equivalent Y-channel PSNR/SSIM table."""
    from pfnl_tpu_torch.eval.tables import dataset_table

    args.name = args.name or f"{args.model}_parity"
    if not args.tables_only:
        args.start = 0
        cmd_test(args)
    dataset_table(args.data, args.name)


def cmd_eval(args):
    """run.py cmd_eval (:123-137): the restored model through the Evaluator
    at the checkpoint's step."""
    from pfnl_tpu_torch.eval.evaluator import Evaluator

    cfg = _config(args, **{k: v for k, v in (("eval_list", args.eval_list),
                                             ("eval_in_size", args.eval_in_size)) if v})
    cfg.log_path = os.path.join(cfg.save_dir, f"{cfg.model}.txt")
    model, step = _restored_model(args, cfg)
    Evaluator(cfg, model).run(step, log_path=cfg.log_path)


def _train_config(args):
    from pfnl_tpu_torch.config import preset

    over = {k: v for k, v in (("train_list", args.train_list), ("eval_list", args.eval_list),
                              ("in_size", args.in_size), ("batch_size", args.batch_size),
                              ("eval_in_size", args.eval_in_size), ("save_dir", args.save_dir),
                              ("compute_dtype", args.compute_dtype)) if v is not None}
    cfg = preset(args.model, **over)
    cfg.log_path = os.path.join(cfg.save_dir, f"{cfg.model}.txt")
    return cfg


def cmd_train(args):
    """run.py cmd_train (:60-120).  --dp/--sp without --coordinator start
    the local ranks here (a TCP rendezvous on a free local port), each
    training in its own process on its own device."""
    cfg = _train_config(args)
    ranks = args.dp * args.sp
    if cfg.batch_size % args.dp:
        raise SystemExit(f"batch {cfg.batch_size} not divisible by dp={args.dp}")
    if ranks > 1 and args.coordinator is None:
        if torch.device(args.device).type == "cuda" and ranks > torch.cuda.device_count():
            raise SystemExit(f"--dp {args.dp} --sp {args.sp}: {ranks} ranks, "
                             f"only {torch.cuda.device_count()} GPUs are visible")
        import socket

        import torch.multiprocessing as mp

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(_train_rank, args=(args, f"localhost:{port}", ranks, True), nprocs=ranks,
                 join=True)
        return
    _train_rank(args.process_id or 0, args, args.coordinator, args.num_processes)


def _train_rank(rank, args, coordinator, num_processes, spawned=False):
    """One rank of `train` (the whole run on one process).  Local CPU ranks
    share the process's threads between them."""
    if spawned and torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // num_processes))
    from pfnl_tpu_torch.data.manifest import load_manifest
    from pfnl_tpu_torch.data.pipeline import TrainPipeline
    from pfnl_tpu_torch.eval.evaluator import Evaluator
    from pfnl_tpu_torch.parallel import multihost
    from pfnl_tpu_torch.parallel.mesh import data_group, make_mesh
    from pfnl_tpu_torch.train.trainer import Trainer

    multihost.initialize(coordinator, num_processes, rank if coordinator else None,
                         device=args.device)
    cfg = _train_config(args)
    mesh, data_rank, n_data = None, 0, 1
    if multihost.world_size() > 1 or args.dp > 1 or args.sp > 1:
        mesh = make_mesh(n_data=args.dp if args.dp > 1 else None, n_space=args.sp)
        n_data = mesh.shape[0]
        data_rank = torch.distributed.get_rank(data_group(mesh))
        if cfg.batch_size % n_data:
            raise SystemExit(f"batch {cfg.batch_size} not divisible by dp={n_data}")
    device = multihost.local_device(args.device)
    tr = Trainer(cfg, device=device)
    seqs = load_manifest(cfg.train_list, cfg.scale, need_blur=cfg.producer != "single")
    # a rank renders its own rows from its own stream; the space ranks of a
    # data index render the same rows (run.py:96-104)
    pipe = TrainPipeline(seqs, cfg.producer, cfg.num_frames, cfg.in_size, cfg.scale,
                         multihost.local_batch_size(cfg.batch_size, n_data),
                         seed=cfg.seed + 7919 * data_rank, num_threads=cfg.host_threads,
                         prefetch=cfg.prefetch)
    eval_fn = None
    if not args.no_eval:
        ev = Evaluator(cfg, tr.model)

        def eval_fn(trainer, step):
            ev.run(step, log_path=cfg.log_path)

    try:
        tr.fit(pipe, max_steps=args.steps, eval_fn=eval_fn, save_every=args.save_every,
               mesh=mesh)
    finally:
        pipe.close()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def main(argv=None):
    args = _parser().parse_args(argv)
    {"test": cmd_test, "eval": cmd_eval, "train": cmd_train, "import-tf1": cmd_import_tf1,
     "prepare": cmd_prepare, "parity": cmd_parity, "export": cmd_export}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
