"""The graph cell's readers and its pricing: `graph_bound_s` against the
hand count at the cell's shapes, and each reader of `hnsw-u8-q10k`'s
per-layer metrics on a run record, and on one with nothing to read (the
record of a program without the counters or the trace)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness, roofline, roofline_graph  # noqa: E402

CFG = json.loads((ROOT / "bench/configs/bigann-u8-hnsw-p4.json").read_text())
TR = json.loads((ROOT / "bench/traffic/closed-q10000-ef40.json").read_text())


def _run(**kw):
    run = {"config": CFG, "traffic": TR,
           "counters": {"dist_calcs": 45_000_000, "queries": 20_000},
           "trace": {"requests": 2, "queries": 20_000, "busy_s": 0.16,
                     "window_s": 0.2,
                     "device_s": {"void traversal_async_kernel<uchar>": 0.1,
                                  "void traversal_kernel<uchar>": 0.02,
                                  "Memcpy HtoD": 0.01}}}
    run.update(kw)
    return run


def test_graph_bound_is_the_hand_count():
    assert (CFG["dim"], CFG["dtype"]) == (128, "uint8")
    assert TR["queries_per_request"] == 10_000 and TR["ef"] == 40
    # 10,000 queries x 2,250 evaluations x (128 + 4 + 4) bytes =
    # 3.06 GB at 3.35 TB/s: 0.9134 ms
    b = roofline_graph.graph_bound_s(10_000, 2_250, 128, "uint8")
    assert abs(b - 10_000 * 2_250 * 136 / 3.35e12) < 1e-15
    assert abs(b * 1e3 - 0.91343) < 1e-5
    assert roofline_graph.graph_bound_s(1, 1, 128, "float32") \
        == (512 + 8) / roofline.HBM_BW


def test_dist_calcs_per_query_reads_the_counters():
    read = harness.reader("dist_calcs_per_query")
    assert read(_run()) == 2_250.0
    assert read(_run(counters={"dist_calcs": 0, "queries": 0})) is None


def test_traversal_kernel_ms_per_kq_reads_the_traversal_records():
    read = harness.reader("traversal_kernel_ms_per_kq")
    # (0.1 + 0.02) s over 20,000 queries: 6 ms a thousand
    assert read(_run()) == pytest.approx(6.0, rel=1e-12)
    assert read(_run(trace=None)) is None
    no_kernel = _run()
    no_kernel["trace"]["device_s"] = {"Memcpy HtoD": 0.01}
    assert read(no_kernel) is None


def test_graph_roofline_reads_the_trace_and_the_counters():
    read = harness.reader("graph_roofline")
    bound = roofline_graph.graph_bound_s(20_000, 2_250, 128, "uint8")
    assert read(_run()) == pytest.approx(100.0 * bound / 0.16, rel=1e-12)
    run = _run()
    run["trace"]["window_s"] = 30.0      # the host's time does not enter
    assert read(run) == pytest.approx(100.0 * bound / 0.16, rel=1e-12)
    assert read(_run(trace=None)) is None
    assert read(_run(counters={"dist_calcs": 0, "queries": 0})) is None


def test_the_cell_reports_the_graph_metrics_and_idle_share():
    c = harness.load_cell("hnsw-u8-q10k")
    names = {m["name"] for m in c.per_layer}
    assert names == {"device_idle_share", "dist_calcs_per_query",
                     "traversal_kernel_ms_per_kq", "graph_roofline"}
    assert {m["name"] for m in c.end_to_end} == {
        "qps", "latency_p90_ms", "recall_at_10", "setup_s"}
    assert c.config["spec"]["backend"] == "partitioned-batched"
    assert c.checks["invalid"] == 0 and c.checks["dist_err"] == 0
    assert 0 < c.checks["miss_share"] <= 0.05
