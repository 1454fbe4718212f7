"""The benchmark's data files: every cell, configuration, traffic mix and
metric that BENCHMARK.json names has its file, and each file loads."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import compare, harness  # noqa: E402

BM = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["command"] == ["python3", "bench/run.py"]
    assert BM["paths"] == ["bench"]
    assert 1 <= BM["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BM["workloads"]])
def test_cell_loads(cell):
    c = harness.load_cell(cell)
    assert c.chips == 1
    assert set(c.checks) <= set(compare.NUMBERS) and c.checks
    assert c.traffic["loop"] == "closed" and c.traffic["in_flight"] == 1
    assert int(c.config["rows"]) >= int(c.traffic["k"])
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_configs_are_used_and_name_their_files():
    used = {w["config"] for w in BM["workloads"]}
    files = [c["file"] for c in BM["configs"]]
    assert len(set(files)) == len(files)
    for c in BM["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(cfg["reduced"]) == set(c["reduced"])
        for key in c["reduced"]:
            assert cfg[key] != cfg["published"][key]


@pytest.mark.parametrize(
    "metric", [m["name"] for m in BM["end_to_end"] + BM["per_layer"]])
def test_every_metric_has_its_reader(metric):
    read = harness.reader(metric)
    empty = {"config": {"rows": 1, "dim": 1}, "traffic": {
        "queries_per_request": 1, "k": 1}, "setup_s": 1.0,
        "window": {"seconds": 0.0, "latencies_s": [], "queries": 0},
        "numbers": {"queries": 0}, "trace": None,
        "counters": {"dist_calcs": 0, "queries": 0}}
    assert read(empty) is None or metric == "setup_s"


def test_names_units_and_bounds():
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert NAME.match(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BM["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BM["per_layer"]:
        assert m["moves"] in {e["name"] for e in BM["end_to_end"]}
    for w in BM["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
