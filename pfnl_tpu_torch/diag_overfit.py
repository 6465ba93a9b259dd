"""The overfit diagnostic on the port (counterpart: scripts/diag_overfit.py):
train a flow family (VESPCN by default) two ways and evaluate each every
`--eval-every` steps on the validation list and on the first three
training sequences, to tell overfitting (train-seq up, val down) from warp
damage (only the joint-flow run declines) and from a training fault (both
decline, or the loss stalls).

  baseline   the preset's joint training: the flow net frozen in stage 0,
             trained with the SR net from steps/2 on;
  zeroflow   EasyFlow's last convs `c5` and `s5` (kernel and bias) zeroed
             before the first step, so tanh(0) = 0 gives a zero flow and an
             identity splat; the run never leaves stage 0, so the flow stays
             exactly zero throughout (checked at the end).

Run:  python -m pfnl_tpu_torch.diag_overfit --steps 2000
      [--eval-every 250] [--model vespcn] [--variants baseline zeroflow]
      [--root DIR] [--workroot DIR] [--out FILE] [--device cuda]

The scenes are convergence.make_rich_dataset's, rendered into `--root`
unless its filelists are there.  `--root`, `--workroot` (checkpoints and
the training-subset filelist) and `--out` (the JSON of every variant,
written after each) default under the temporary directory
(`tempfile.gettempdir()`, so $TMPDIR).  Training and evaluation run in
full float32 (TF32 off), as convergence.run_family's do.  There is no CPU
fallback: `--device cuda` raises on a machine without a GPU.
"""

import argparse
import contextlib
import json
import os
import re
import tempfile
import time

import numpy as np
import torch

from pfnl_tpu_torch.utils.device import tf32_off

LOSS_RE = re.compile(r"Step:(\d+), loss:([0-9.eE+-]+)")
FLOW_LAYERS = ("easyflow.c5", "easyflow.s5")


def run_variant(name, model, train_list, val_list, train_eval_list, steps, eval_every,
                workroot, zero_flow=False, velocity_note="", device="cuda"):
    """Train `model` for `steps` steps on `device`, both evaluation lists
    every `eval_every`; returns dict(curves={"val": [(step, dB)], "train":
    [...]}, loss=[(step, loss)] from fit's log lines, wall=seconds,
    zero_flow, note=velocity_note)."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.data.manifest import load_manifest
    from pfnl_tpu_torch.data.pipeline import TrainPipeline
    from pfnl_tpu_torch.eval.evaluator import Evaluator
    from pfnl_tpu_torch.train.trainer import Trainer

    over = dict(train_list=train_list, eval_list=val_list, reload=False,
                eval_in_size=(32, 56), eval_batch_size=2,
                save_dir=os.path.join(workroot, name))
    over["decay_step"] = float(steps)
    over["max_step"] = steps + 1
    over["stage_switch_step"] = 10 ** 9 if zero_flow else steps // 2
    cfg = preset(model, **over)
    cfg_tr = preset(model, **{**over, "eval_list": train_eval_list})

    tr = Trainer(cfg, device=device)
    if zero_flow:
        names = dict(tr.model.named_parameters())
        flow = [f"{lay}.{leaf}" for lay in FLOW_LAYERS for leaf in ("kernel", "bias")]
        if not all(n in names for n in flow):
            raise ValueError(f"zero-flow ablation needs an easyflow family, not {model!r}")
        with torch.no_grad():
            for n in flow:
                names[n].zero_()
        # the JAX script re-initialises its Adam state here; the port's holds none yet
        assert not any(o.state for o in tr.optimizers), "Adam state before the first step"

    seqs = load_manifest(cfg.train_list, cfg.scale, need_blur=cfg.producer != "single")
    pipe = TrainPipeline(seqs, cfg.producer, cfg.num_frames, cfg.in_size, cfg.scale,
                         cfg.batch_size, seed=cfg.seed, num_threads=2, prefetch=4)
    curves = {"val": [], "train": []}
    loss_hist = []
    with contextlib.closing(pipe), tf32_off():
        ev_val = Evaluator(cfg, tr.model)
        ev_tr = Evaluator(cfg_tr, tr.model)

        def eval_fn(trainer, step):
            pv = float(np.mean(ev_val.run(step, print_fn=lambda *a: None)[0]))
            pt = float(np.mean(ev_tr.run(step, print_fn=lambda *a: None)[0]))
            curves["val"].append((step, pv))
            curves["train"].append((step, pt))
            w = [v for s, v in loss_hist if step - eval_every <= s < step]
            print(f"[{name}] step {step}: val {pv:.2f} dB, train-seq {pt:.2f} dB, "
                  f"train-loss {np.mean(w) if w else float('nan'):.4f}", flush=True)

        def print_fn(msg):
            m = LOSS_RE.search(str(msg))
            if m:
                loss_hist.append((int(m.group(1)), float(m.group(2))))

        t0 = time.time()
        tr.fit(pipe, max_steps=steps, eval_fn=eval_fn, save_every=eval_every,
               print_fn=print_fn)
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
        wall = time.time() - t0
    if zero_flow and tr.model.get_parameter("easyflow.c5.kernel").any():
        raise RuntimeError(f"{name}: the zero-flow run moved easyflow.c5.kernel")
    return dict(curves=curves, loss=loss_hist, wall=wall, zero_flow=zero_flow,
                note=velocity_note)


def main(argv=None):
    from pfnl_tpu_torch.convergence import make_rich_dataset

    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(prog="python -m pfnl_tpu_torch.diag_overfit")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--model", default="vespcn")
    ap.add_argument("--root", default=os.path.join(tmp, "conv_ds_torch"))
    ap.add_argument("--workroot", default=os.path.join(tmp, "diag_runs_torch"))
    ap.add_argument("--out", default=os.path.join(tmp, "diag_overfit_torch.json"))
    ap.add_argument("--variants", nargs="*", default=["baseline", "zeroflow"])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    train_list = os.path.join(a.root, "filelist_train.txt")
    val_list = os.path.join(a.root, "filelist_val.txt")
    if not os.path.exists(train_list):
        os.makedirs(a.root, exist_ok=True)
        print("generating synthetic dataset ...", flush=True)
        make_rich_dataset(a.root)
    # the training-subset list: the first three training sequences
    os.makedirs(a.workroot, exist_ok=True)
    train_eval_list = os.path.join(a.workroot, "filelist_train_eval.txt")
    with open(train_list) as f:
        head = [ln.strip() for ln in f if ln.strip()][:3]
    with open(train_eval_list, "wt") as f:
        f.write("\n".join(head) + "\n")

    results = {}
    for v in a.variants:
        print(f"=== variant {v} ===", flush=True)
        results[v] = run_variant(f"{a.model}_{v}", a.model, train_list, val_list,
                                 train_eval_list, a.steps, a.eval_every, a.workroot,
                                 zero_flow=v == "zeroflow", device=a.device)
        with open(a.out, "wt") as f:
            json.dump(results, f, indent=1)
    print(f"wrote {a.out}", flush=True)
    return results


if __name__ == "__main__":
    main()
