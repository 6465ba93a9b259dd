"""Share of the traced kernel time outside the program's own kernels:
convolutions, elementwise, layout (kernel names sorted by the frozen rule
of benchmark/counts/categories.py)."""

from benchmark.counts.categories import category


def read(rec):
    tr = rec.get("trace_device")
    if rec["kind"] != "serve" or not tr or not tr["kernels"]:
        return None
    total = sum(e - s for s, e, _ in tr["kernels"])
    other = sum(e - s for s, e, n in tr["kernels"] if category(n) != "port kernel")
    return 100.0 * other / total if total > 0 else None
