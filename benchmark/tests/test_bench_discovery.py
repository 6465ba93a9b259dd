"""A configuration, a traffic mix, a cell, a per-layer metric and a model's
plain reference are added as new files (and entries in the manifest),
without editing any file the benchmark has: shown in a copy of the
checkout.  No harness code branches on a model's name."""

import ast
import glob
import json
import math
import os
import shutil
from pathlib import Path

import pytest

import bench_tiny
from benchmark import core


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(core.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def _snapshot(root):
    return {str(f): f.read_bytes() for f in (root / "benchmark").rglob("*") if f.is_file()}


def _add_cell(root, cfg, traffic, limits):
    """A configuration file, its limits and one cell of it on `traffic`, in
    the copy's files and manifest; the cell's name."""
    name = f"{cfg['name']}.{traffic}"
    (root / f"benchmark/configs/{cfg['name']}.json").write_text(json.dumps(cfg))
    (root / f"benchmark/limits/{name}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name=cfg["name"], source=cfg["source"],
                                 file=f"benchmark/configs/{cfg['name']}.json", reduced=[],
                                 why="a new family"))
    bench["workloads"].append(dict(name=name, config=cfg["name"], traffic=traffic, chips=1,
                                   why="a new family's cell"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


STAND_IN = "_stand_in"  # appended to a family's name: a family no model of the program is


def _write_new(path, text):
    """text into path unless the file is there: a file the checkout has stays."""
    if not path.exists():
        path.write_text(text)


MCRESNET = {"name": "mcresnet_x4", "model": "mcresnet" + STAND_IN,
            "source": "https://github.com/psychopa4/PFNL/blob/master/model/mcresnet.py",
            "num_frames": 5, "scale": 4, "port_kwargs": {"num_frames": 5, "scale": 4},
            "serve_dtype": "float32", "init": [[".", "range:-0.05:0.05"]], "reduced": []}

STUB = '''"""A stub reference: records the shape of each window batch it serves."""
import json
import os

import torch

LR_MULTIPLE = 4
CALLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mcresnet.calls")


def serve(p, x, cfg, prec):
    with open(CALLS, "a") as f:
        f.write(json.dumps(list(x.shape)) + "\\n")
    n, _, h, w, _ = x.shape
    return torch.zeros(n, cfg["scale"] * h, cfg["scale"] * w, 3, device=x.device)
'''

SERVING_STUB = '''"""A stub reference: what the clips driver calls of one, computing nothing."""
import torch

LR_MULTIPLE = 4


def serve(p, x, cfg, prec):
    n, _, h, w, _ = x.shape
    return torch.zeros(n, cfg["scale"] * h, cfg["scale"] * w, 3, device=x.device)
'''

FULL_STUB = SERVING_STUB + '''

def train_loss(p, gt, lr, cfg):
    return torch.zeros((), device=gt.device)
'''


def test_a_new_family_comes_in_as_new_files(tmp_path, monkeypatch):
    """A Y family (LR padded to 4) with its own reference module: the clips
    driver pads the windows it checks to the module's LR_MULTIPLE.  MCResNet
    serves under a family name of its own, so the test holds once the
    checkout has MCResNet's reference."""
    from pfnl_tpu_torch.models import MODEL_REGISTRY

    monkeypatch.setitem(MODEL_REGISTRY, MCRESNET["model"], MODEL_REGISTRY["mcresnet"])
    root = _copy(tmp_path)
    before = _snapshot(root)
    name = _add_cell(root, MCRESNET, "udm10", {"worst_frame_rms": 2.0})
    (root / f"benchmark/reference/{MCRESNET['model']}.py").write_text(STUB)
    spec = bench_tiny.cut(core.cell(name, root=str(root)))
    spec["traffic"]["lr_hw"] = [18, 26]                 # not a multiple of 4
    rec = core.driver(spec["traffic"], str(root)).run(bench_tiny.context(spec))
    calls = [json.loads(line) for line in
             (root / "benchmark/reference/mcresnet.calls").read_text().splitlines()]
    assert calls and all(c == [1, 5, 20, 28, 3] for c in calls), calls
    assert rec["attempted"] > 0 and rec["failed"] == 0, rec["errors"]
    assert 0 < rec["checks"]["worst_frame_rms"] < float("inf")   # cropped back to 72 x 104
    for p, data in before.items():
        assert Path(p).read_bytes() == data


@pytest.mark.parametrize("traffic,named_after,missing", [("udm10", "vespcn", "is missing"),
                                                        ("train_b64", "duf", "lacks train_loss")])
def test_a_model_without_its_reference_fails_before_set_up(tmp_path, traffic, named_after,
                                                           missing):
    """A configuration whose "model" is a family no model of the program is
    (`named_after` and STAND_IN), with no reference file or with one that
    serves but has no train_loss.  Every family of the program gets a whole
    stub reference in the copy first: the two cases hold whatever references
    the checkout gains."""
    from pfnl_tpu_torch.models import MODEL_REGISTRY

    root = _copy(tmp_path)
    for family in MODEL_REGISTRY:
        _write_new(root / f"benchmark/reference/{family}.py", FULL_STUB)
    model = named_after + STAND_IN
    assert model not in MODEL_REGISTRY
    if missing != "is missing":
        (root / f"benchmark/reference/{model}.py").write_text(SERVING_STUB)
    cfg = json.loads((root / "benchmark/configs/pfnl.json").read_text())
    cfg.update(name=f"{model}_x4", model=model)
    name = _add_cell(root, cfg, traffic, {"worst_frame_rms": 2.0})
    spec = bench_tiny.cut(core.cell(name, root=str(root)))
    ctx = bench_tiny.context(spec)
    with pytest.raises(LookupError, match=f"benchmark/reference/{model}.py.*{missing}"):
        core.driver(spec["traffic"], str(root)).run(ctx)
    assert [n for n, _ in ctx.marks] == ["start"]       # no scenes, weights or warm-up


VESPCN = {"name": "vespcn", "model": "vespcn",
          "source": "https://github.com/psychopa4/PFNL/blob/master/model/vespcn.py",
          "paper": "Caballero et al., Real-Time Video Super-Resolution with Spatio-Temporal "
                   "Networks and Motion Compensation, CVPR 2017",
          "num_frames": 3, "scale": 4, "port_kwargs": {"num_frames": 3, "scale": 4},
          "serve_dtype": "bfloat16",
          "init": [["rnn_out\\.kernel$", "glorot*0.1"],
                   ["kernel$", "glorot"],
                   ["bias$", "range:-0.0866:0.0866"],
                   ["alpha$", "range:0:0.25"]],
          "reduced": []}
# serving metrics whose readers read no model's kernels or counts
MODEL_AGNOSTIC = ("device_idle_pct.serve", "read_ms.serve", "dispatch_ms.serve",
                  "write_ms.serve", "padded_window_pct.serve")


def test_the_next_family_comes_in_as_new_files(tmp_path):
    """VESPCN's serving cell, added to a copy as new files and manifest
    entries (its configuration, its limits, a stub reference) where the
    checkout lacks them: the helpers that the fault, control and
    import tests take their cells from list it where a serving cell belongs,
    and the tiny cell runs on the CPU through the real model, the
    Predictor's Y path and K7's plain path."""
    root = _copy(tmp_path)
    before = _snapshot(root)
    name = f"{VESPCN['name']}.udm10"
    if all(w["name"] != name for w in core.manifest(root)["workloads"]):
        _add_cell(root, VESPCN, "udm10", {"worst_frame_rms": 2.0})
        bench = json.loads((root / "BENCHMARK.json").read_text())
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in ("hr_fps",) + MODEL_AGNOSTIC:
                m["workloads"].append(name)
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _write_new(root / f"benchmark/reference/{VESPCN['model']}.py", SERVING_STUB)

    assert name in bench_tiny.serving_cells(root) and name in bench_tiny.one_per_pair(root)
    assert name in bench_tiny.every_cell(root) and name not in bench_tiny.training_cells(root)
    spec = bench_tiny.cut(core.cell(name, root=str(root)))
    assert "hr_fps" in {m["name"] for m in spec["end_to_end"]}
    rec = core.driver(spec["traffic"], str(root)).run(bench_tiny.context(spec))
    assert rec["attempted"] > 0 and rec["failed"] == 0, rec["errors"]
    assert math.isfinite(rec["checks"]["worst_frame_rms"])
    for p, data in before.items():
        assert Path(p).read_bytes() == data


HARNESS = sorted(glob.glob(os.path.join(core.ROOT, "benchmark", "drivers", "*.py"))
                 + [os.path.join(core.ROOT, "benchmark", "tests", "bench_tiny.py")])


@pytest.mark.parametrize("path", HARNESS, ids=os.path.basename)
def test_no_harness_code_branches_on_a_model_name(path):
    """No model's name in a comparison, and no model's reference imported by
    name: a configuration's "model" finds its files."""
    from pfnl_tpu_torch.models import MODEL_REGISTRY

    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Compare):
            for v in [node.left] + node.comparators:
                assert not (isinstance(v, ast.Constant) and v.value in MODEL_REGISTRY), (
                    path, node.lineno, v.value)
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for m in mods:
            parts = m.split(".")
            assert not (parts[:2] == ["benchmark", "reference"] and len(parts) > 2
                        and parts[2] in MODEL_REGISTRY), (path, node.lineno, m)


def test_every_cell_resolves_by_name():
    for w in core.manifest()["workloads"]:
        spec = core.cell(w["name"])
        assert spec["config"]["name"] == w["config"]
        assert core.driver(spec["traffic"]).run
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(core.reader(m["name"]))


def test_new_files_add_a_cell_and_a_metric(tmp_path):
    root = _copy(tmp_path)
    before = {p: open(p, "rb").read() for p in
              (str(f) for f in (root / "benchmark").rglob("*") if f.is_file())}
    cfg = json.loads((root / "benchmark/configs/pfnl.json").read_text())
    cfg["name"] = "pfnl_copy"
    (root / "benchmark/configs/pfnl_copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/udm10.json").read_text())
    traffic["clip_frames"] = [30, 34]
    (root / "benchmark/traffic/vid4_like.json").write_text(json.dumps(traffic))
    (root / "benchmark/limits/pfnl_copy.vid4_like.json").write_text('{"worst_frame_rms": 3.0}')
    (root / "benchmark/metrics/frames_checked.serve.py").write_text(
        'def read(rec):\n    return rec.get("checked_frames")\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="pfnl_copy", source=cfg["source"],
                                 file="benchmark/configs/pfnl_copy.json", reduced=[],
                                 why="a copy"))
    bench["workloads"].append(dict(name="pfnl_copy.vid4_like", config="pfnl_copy",
                                   traffic="vid4_like", chips=1, why="a new cell"))
    for m in bench["end_to_end"]:
        if m["name"] == "hr_fps":
            m["workloads"].append("pfnl_copy.vid4_like")
    bench["per_layer"].append(dict(name="frames_checked.serve", unit="frames", better="higher",
                                   source="program_counter", layer="serving entry",
                                   moves="hr_fps", workloads=["pfnl_copy.vid4_like"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = core.cell("pfnl_copy.vid4_like", root=str(root))
    assert spec["traffic"]["clip_frames"] == [30, 34]
    assert [m["name"] for m in spec["per_layer"]] == ["frames_checked.serve"]
    assert {m["name"] for m in spec["end_to_end"]} == {"hr_fps", "setup_s"}
    # cut to a CPU size, as bench_tiny cuts the others, and run through the copy's files
    bench_tiny.cut(spec)
    rec = core.driver(spec["traffic"], str(root)).run(bench_tiny.context(spec))
    assert core.reader("frames_checked.serve", str(root))(rec) == 6
    assert core.judge(rec, spec["limits"])[0]
    for p, data in before.items():  # nothing the benchmark had was edited
        assert open(p, "rb").read() == data
