"""Command line of the port — counterpart of `run.py test`:

    python -m pfnl_tpu_torch test pfnl --data DIR [--weights params.npz]
        [--compute-dtype bfloat16] [--device cuda] [--start 0] [--name NAME]

Super-resolves every sequence of a dataset directory (`DIR/<seq>/truth/*.png`
degraded on the device) into `DIR/<seq>/<NAME>/*.png`.  `--weights` is a
flat `.npz` of '/'-joined flax parameter paths; without it the weights are
random, drawn from `--seed`.
"""

import argparse
import sys

import torch


def _parser():
    p = argparse.ArgumentParser(prog="python -m pfnl_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("test", help="super-resolve every sequence of a dataset dir")
    t.add_argument("model", choices=["pfnl"])
    t.add_argument("--data", required=True, help="dataset dir: <seq>/truth/*.png")
    t.add_argument("--weights", default=None, help="flat .npz of flax params")
    t.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    t.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    t.add_argument("--start", type=int, default=0, help="first sequence index")
    t.add_argument("--name", default=None, help="output subdirectory (default: model)")
    t.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    from pfnl_tpu.config import preset
    from pfnl_tpu_torch.infer.predictor import Predictor
    from pfnl_tpu_torch.models.pfnl import PFNL
    from pfnl_tpu_torch.utils.weights import load_npz

    cfg = preset(args.model)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model = PFNL(num_frames=cfg.num_frames, scale=cfg.scale, dtype=dtype,
                 generator=torch.Generator().manual_seed(args.seed))
    if args.weights:
        model.load_state_dict(load_npz(args.weights))
    model.to(args.device).eval()
    Predictor(model).testvideos(args.data, start=args.start, name=args.name or cfg.model)


if __name__ == "__main__":
    sys.exit(main())
