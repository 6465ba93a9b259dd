"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json's `workloads`)
names a configuration and a traffic mix; the mix names the driver that
sets the program up from the seed, warms up every shape, measures for
`--seconds`, then checks what the window produced against the plain
reference.  With `--trace 0` the line holds the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics, read from a torch.profiler trace
of a span of the window.  The numbers `correct` compares, each beside its
limit, are the last lines on standard error and the last key of the line.

Exits with a code other than 0 and prints no result without a CUDA device
(or fewer than the cell asks for), or where jax, jaxlib, flax, optax or
pfnl_tpu (the JAX package) is loaded once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache inside the checkout, at fixed paths
CACHE = os.path.join(HERE, ".cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import core  # noqa: E402

T_IMPORTED = time.perf_counter()


def fail(msg, code):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def result_line(spec, rec, trace: bool, card: str):
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = core.reader(m["name"], spec["root"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checks = core.judge(rec, spec["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": spec["work"]["chips"], "memory_peak_bytes": rec["memory_peak_bytes"],
              "card": card}
    line = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"], device["window_s"] = core.device_busy(rec) or (0.0, 0.0)
        bd = core.breakdown(rec)
        if bd:
            line["breakdown"] = bd
    line["checks"] = checks
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = core.cell(args.workload)
    chips = spec["work"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} CUDA device(s); "
             f"torch.cuda.is_available() is {torch.cuda.is_available()}", 2)
    torch.cuda.init()
    import pfnl_tpu_torch  # noqa: F401  (the program; absent in a bare checkout of the benchmark)

    torch.set_num_threads(4)
    ctx = core.Context(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                       T_PROCESS)
    ctx.marks += [("imports", T_IMPORTED), ("cuda and the program", time.perf_counter())]
    rec = core.driver(spec["traffic"], spec["root"]).run(ctx)
    bad = core.forbidden_modules()
    if bad:
        fail(f"loaded in this process once the window closed: {', '.join(bad)}", 3)
    from benchmark.device import card_label

    line = result_line(spec, rec, bool(args.trace), card_label())
    print("set-up: " + ", ".join(f"{n} {s:.3f} s" for n, s in ctx.phases()), file=sys.stderr)
    if rec.get("diag"):
        print(f"diagnostics: {rec['diag']}", file=sys.stderr)
    if rec.get("errors"):
        print(f"failed: {rec['errors']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    print("".join(f"check {name}: {c['value']!r} (limit {c['limit']!r})\n"
                  for name, c in line["checks"].items()), file=sys.stderr, end="", flush=True)


if __name__ == "__main__":
    main()
