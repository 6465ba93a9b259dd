"""pfnl_tpu_torch/bench.py, the port's counterpart of the root bench.py, on
the CPU at a toy size: its constants are bench.py's; `main` times each
family's serving forward (DRVSR's `last_only` frame, FRVSR's streamed
frames, DUF in eval mode) and prints bench.py's record, the same line as
bench.py's `main` under the same patched timer; `train_bench` (float32 and
bf16) and `fit_bench` print bench.py's records with finite values;
`bench_all` records a family that raises and goes on; both command lines
(`python -m pfnl_tpu_torch.bench`, `python -m pfnl_tpu_torch bench`) parse
their flags."""

import json
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import bench as jax_bench

from pfnl_tpu_torch import __main__ as port_cli
from pfnl_tpu_torch import bench
from pfnl_tpu_torch.infer.profile_serving import seeded_model
from tests.test_torch_imports import SOURCES, _imported

TOY_HW = "8x8"
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _records(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_constants_are_bench_pys():
    assert bench._REFERENCE_FPS == jax_bench._REFERENCE_FPS
    assert list(bench._MODEL_FRAMES.items()) == list(jax_bench._MODEL_FRAMES.items())
    assert list(bench._MODEL_BATCH.items()) == list(jax_bench._MODEL_BATCH.items())


def test_no_port_module_imports_the_root_bench():
    assert not [p for p in SOURCES if "bench" in _imported(p)]


def _serving_sr(model, frames):
    """The family's serving SR of main's input at TOY_HW, batch 1, float32,
    computed here from its own seeded model: DRVSR the full form's last
    frame, FRVSR the unrolled forward, DUF in eval mode."""
    m = seeded_model(model, torch.float32, 0, device="cpu", num_frames=frames)
    h, w = (int(v) for v in TOY_HW.split("x"))
    x = torch.from_numpy(np.random.default_rng(0).random((1, frames, h, w, 3), np.float32))
    with torch.no_grad():
        out = m.eval()(x)
    sr = out["sr"] if isinstance(out, dict) else out
    return sr[:, -1:] if model == "drvsr" else sr


@pytest.mark.parametrize("model", list(bench._MODEL_FRAMES))
def test_main_times_the_serving_forward(model, capsys, monkeypatch):
    frames = bench._MODEL_FRAMES[model]
    served = []
    real = bench._time_steps

    def spy(fn, steps, device, repeats=3):
        served.append(fn())
        return real(fn, steps, device, repeats)

    monkeypatch.setattr(bench, "_time_steps", spy)
    fps = bench.main(model, TOY_HW, frames, 1, 1, "float32", "cpu")
    (rec,) = _records(capsys)
    got = torch.stack(served[0], 1).float() if model == "frvsr" else served[0]
    want = _serving_sr(model, frames)
    print(f"{model}: {rec}; served SR {tuple(got.shape)}")
    assert got.shape == want.shape and torch.equal(got, want)
    assert set(rec) == RECORD_KEYS and rec["unit"] == "frames/sec"
    assert rec["metric"] == (f"HR frames/sec/chip ({model} {frames}f x4, 8x8->32x32, float32, "
                             f"batch 1)")
    assert fps > 0 and rec["value"] == round(fps, 3)
    assert rec["vs_baseline"] == round(fps / 4.2, 3)


@pytest.mark.parametrize("model,frames", [("pfnl", 7), ("frvsr", 3)])
def test_main_prints_bench_pys_line(model, frames, capsys, monkeypatch):
    """The same arguments, each side's timer patched to the same seconds: the
    same JSON line (FRVSR counts `frames` HR frames a window, PFNL one)."""
    monkeypatch.setattr(jax_bench, "_time_chained", lambda fn, *a, **k: 0.5)
    monkeypatch.setattr(bench, "_time_steps", lambda fn, steps, device, repeats=3: 0.5)
    jax_bench.main(model, TOY_HW, frames, 2, 1)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    bench.main(model, TOY_HW, frames, 2, 1, device="cpu")
    got = capsys.readouterr().out.strip().splitlines()[-1]
    print(got)
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_bench(dtype, capsys):
    rate, loss = bench.train_bench("pfnl", 2, 2, 8, 3, dtype, "cpu")
    (rec,) = _records(capsys)
    print(rec, loss)
    assert rec == {"metric": f"train steps/sec (pfnl b2 crop 8 {dtype})",
                   "value": round(rate, 3), "unit": "steps/sec", "vs_baseline": None}
    assert math.isfinite(rate) and rate > 0 and math.isfinite(loss)


def test_fit_bench(capsys):
    rate, tr = bench.fit_bench("pfnl", 2, 2, 8, 3, "cpu")
    (rec,) = _records(capsys)
    assert rec == {"metric": "fit() steps/sec (pfnl b2 crop 8)", "value": round(rate, 3),
                   "unit": "steps/sec", "vs_baseline": None}
    assert math.isfinite(rate) and rate > 0
    assert tr.global_step == 1 + 2


def test_bench_all_records_a_failure_and_goes_on(capsys, monkeypatch):
    real = bench.main
    calls = []

    def main(model, hw, frames, steps, batch, dtype, device):
        calls.append((model, frames, batch))
        if model == "ltdvsr":
            raise RuntimeError("CUDA out of memory")
        return real(model, hw, frames, steps, batch, dtype, device)

    monkeypatch.setattr(bench, "main", main)
    results = bench.bench_all(TOY_HW, 1, 1, "float32", "cpu")
    recs = _records(capsys)
    families = list(bench._MODEL_FRAMES)
    assert calls == [(f, bench._MODEL_FRAMES[f], 1) for f in families]
    assert list(results) == [f for f in families if f != "ltdvsr"]
    assert len(recs) == len(families)
    failed = recs[families.index("ltdvsr")]
    assert failed == {"metric": "HR frames/sec/chip (ltdvsr)", "value": None,
                      "unit": "frames/sec", "error": "CUDA out of memory"}
    assert all(r["value"] > 0 for r in recs if r is not failed)


# argv of `python -m pfnl_tpu_torch.bench` -> the call it makes (bench.py's __main__)
BENCH_CLI = [
    ([], ("main", ("pfnl", "180x320", 7, 10, 16, "bfloat16", "cuda"), {})),
    (["--model", "duf", "--device", "cpu"], ("main", ("duf", "180x320", 7, 10, 1, "bfloat16",
                                                      "cpu"), {})),
    (["--model", "frvsr", "--frames", "4", "--batch", "2", "--dtype", "float32", "--hw",
      "90x160"], ("main", ("frvsr", "90x160", 4, 10, 2, "float32", "cuda"), {})),
    (["--train"], ("train_bench", ("pfnl", 10),
                   {"batch": 16, "frames": 7, "dtype": "float32", "device": "cuda"})),
    (["--train", "--dtype", "bfloat16", "--steps", "3"],
     ("train_bench", ("pfnl", 3), {"batch": 16, "frames": 7, "dtype": "bfloat16",
                                   "device": "cuda"})),
    (["--train-fit", "--steps", "5"], ("fit_bench", ("pfnl", 50),
                                       {"batch": 16, "frames": 7, "device": "cuda"})),
    (["--all", "--steps", "2"], ("bench_all", ("180x320", 2, None, "bfloat16", "cuda"), {})),
]


@pytest.mark.parametrize("argv,call", BENCH_CLI, ids=[" ".join(a) or "defaults"
                                                       for a, _ in BENCH_CLI])
def test_bench_cli_flags(argv, call, monkeypatch):
    made = []
    for name in ("main", "train_bench", "fit_bench", "bench_all"):
        monkeypatch.setattr(bench, name, lambda *a, _n=name, **k: made.append((_n, a, k)))
    bench.cli(argv)
    assert made == [call]


def test_bench_cli_runs_and_profiles(tmp_path, capsys):
    argv = ["--model", "vespcn", "--hw", TOY_HW, "--batch", "1", "--steps", "1",
            "--device", "cpu"]
    bench.cli(argv)
    bench.cli(argv + ["--profile", str(tmp_path)])
    recs = _records(capsys)
    assert [r["metric"] for r in recs] == [
        "HR frames/sec/chip (vespcn 3f x4, 8x8->32x32, bfloat16, batch 1)"] * 2
    assert all(r["value"] > 0 for r in recs)
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_port_cli_bench(capsys, monkeypatch):
    """`python -m pfnl_tpu_torch bench`: run.py bench's flags and defaults,
    calling bench.main (batch 16, bf16), plus --device."""
    port_cli.main(["bench", "--model", "vespcn", "--hw", TOY_HW, "--frames", "3", "--steps", "1",
                   "--device", "cpu"])
    (rec,) = _records(capsys)
    assert rec["metric"] == "HR frames/sec/chip (vespcn 3f x4, 8x8->32x32, bfloat16, batch 16)"
    assert rec["value"] > 0
    made = []
    monkeypatch.setattr(bench, "main", lambda *a, **k: made.append((a, k)))
    port_cli.main(["bench"])
    assert made == [((), {"model": "pfnl", "hw": "180x320", "frames": 7, "steps": 20,
                          "device": "cuda"})]
