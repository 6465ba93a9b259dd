"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the time a full check takes, and every name resolving to a file."""

import os
import re

import pytest

from benchmark import core

BENCH = core.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(open(os.path.join(core.ROOT, "BENCHMARK.json"), "rb").read()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(core.ROOT, p))
        assert not p.endswith("_torch")
    for word in cmd[1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word == p or word.startswith(p + "/") for p in paths)


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and line(entry["source"]) and line(entry["why"])
    assert entry["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    cfg = core.load_json(os.path.join(core.ROOT, entry["file"]))
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_config_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entry(work):
    assert set(work) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert NAME.match(work[k])
    assert work["chips"] in (1, 4) and line(work["why"])
    spec = core.cell(work["name"])
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]
    assert spec["limits"], "every cell compares at least one number"
    assert os.path.exists(os.path.join(core.ROOT, "benchmark", "drivers",
                                       spec["traffic"]["driver"] + ".py"))


def test_cells_and_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(CELLS) == len(BENCH["workloads"])
    assert 1 <= len(CELLS) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert all(w in CELLS for w in m.get("workloads", []))
    assert os.path.exists(os.path.join(core.ROOT, "benchmark", "metrics", m["name"] + ".py"))


def test_setup_s_is_an_end_to_end_metric_of_every_cell():
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    assert E2E["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES and line(m["layer"]) and m["moves"] in E2E
    assert os.path.exists(os.path.join(core.ROOT, "benchmark", "metrics", m["name"] + ".py"))
    moved = E2E[m["moves"]]
    for w in m.get("workloads", CELLS):
        assert w in CELLS
        assert w in moved.get("workloads", CELLS), f"{w} does not report {m['moves']}"
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_names_are_unique():
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    configs = [c["name"] for c in BENCH["configs"]]
    assert len(set(configs)) == len(configs)


def test_a_layer_is_named_alike_by_all_its_metrics():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH["paths"]:
        for dirpath, dirnames, files in os.walk(os.path.join(core.ROOT, p)):
            dirnames[:] = [d for d in dirnames if not d.startswith((".", "__"))]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), core.ROOT)
                if "__pycache__" not in rel:
                    assert PATH.match(rel), rel
