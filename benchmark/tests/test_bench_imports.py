"""Nothing the benchmark's run imports has the top-level name jax, jaxlib,
flax, optax or pfnl_tpu (compared whole: pfnl_tpu_torch is the program);
without a card, or without the program beside it, run.py prints no result
and exits with a code other than 0."""

import os
import shutil
import subprocess
import sys

import bench_tiny
from benchmark import core

SCRIPT = """
import sys
sys.path[:0] = [{root!r}, {tests!r}]
import benchmark.run, benchmark.calibrate
import bench_tiny
from benchmark import core
for cell in {cells!r}:
    spec, rec = bench_tiny.run(cell, seconds=1.0)
    for m in spec["end_to_end"] + spec["per_layer"]:
        core.reader(m["name"])(rec)
    print("RAN", cell)
print("FORBIDDEN", core.forbidden_modules())
"""


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    """One cell of each configuration and driver, from the manifest."""
    tests = os.path.dirname(os.path.abspath(__file__))
    cells = bench_tiny.one_per_pair()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    script = SCRIPT.format(root=core.ROOT, tests=tests, cells=cells)
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=600, env=env, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert [line[4:] for line in out.stdout.splitlines() if line.startswith("RAN ")] == cells
    assert "FORBIDDEN []" in out.stdout


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in core.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pfnl_tpu_torch.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pfnl_tpu.models", sys)
    assert core.forbidden_modules() == ["pfnl_tpu"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pfnl.udm10",
                           "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def test_without_a_card_no_result(cuda_absent):
    out = _run(core.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_bare_checkout_of_the_benchmark_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(core.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
