"""Readings the limits of `correct` are set from, on the chip, in one process.

    python benchmark/calibrate.py --workload <name> --seeds <n ...>
        [--control-seeds <n ...>] [--seconds <s>] [--out <file.jsonl>]

For each of --seeds, one run of the cell as `run.py` makes it (a window of
--seconds, then the check), the numbers it compares; for each of
--control-seeds, the control's numbers: the reference at the precision
below the configuration's (fp8 for bf16 serving, TF32 for float32
training) put in the program's place, on the same inputs a run of that
seed checks, or (--control half_batch) a training fault planted in the
reference.  The benchmark's own runs never run the control.  One JSON
line a reading, on stdout and appended to --out.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from benchmark import core  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", default=None,
                    help="the control's kind: fp8 (serving, the default there), tf32 (training, "
                         "the default there), or half_batch (a fault planted in the reference)")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA device")
    spec = core.cell(args.workload)
    drv = core.driver(spec["traffic"])
    dev = torch.device("cuda")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in args.seeds:
        t = time.perf_counter()
        rec = drv.run(core.Context(spec, seed, args.seconds, False, dev, time.perf_counter()))
        correct, checks = core.judge(rec, spec["limits"])
        emit(dict(cell=args.workload, side="program", seed=seed, checks=rec["checks"],
                  diag=rec.get("diag"),
                  correct=correct, attempted=rec["attempted"], failed=rec["failed"],
                  errors=rec.get("errors"), seconds=time.perf_counter() - t))
    for seed in args.control_seeds:
        t = time.perf_counter()
        ctx = core.Context(spec, seed, args.seconds, False, dev, time.perf_counter())
        checks = drv.control(ctx, args.control) if args.control else drv.control(ctx)
        emit(dict(cell=args.workload, side=args.control or "control", seed=seed, checks=checks,
                  seconds=time.perf_counter() - t))


if __name__ == "__main__":
    main()
