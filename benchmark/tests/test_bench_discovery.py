"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files (and entries in the manifest), without editing any file the
benchmark has: shown in a copy of the checkout."""

import json
import os
import shutil

import bench_tiny
from benchmark import core


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(core.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


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
    spec["config"]["num_blocks"] = spec["config"]["port_kwargs"]["num_blocks"] = 2
    spec["traffic"].update(lr_hw=[16, 24], clip_frames=[8, 9], scenes=2, check_clips=2)
    rec = core.driver(spec["traffic"], str(root)).run(bench_tiny.context(spec))
    assert core.reader("frames_checked.serve", str(root))(rec) == 6
    assert core.judge(rec, spec["limits"])[0]
    for p, data in before.items():  # nothing the benchmark had was edited
        assert open(p, "rb").read() == data
