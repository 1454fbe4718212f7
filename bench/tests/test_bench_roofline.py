"""The exact scan's roofline bound at the flat cell's shapes equals the
hand count."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from bench import roofline  # noqa: E402


def test_flat_cell_bound_is_the_hand_count():
    cfg = json.loads((ROOT / "bench/configs/bigann-u8-flat-1m.json")
                     .read_text())
    tr = json.loads((ROOT / "bench/traffic/closed-q10000.json").read_text())
    b = roofline.scan_bound_s(cfg["rows"], cfg["dim"],
                              tr["queries_per_request"], tr["k"])
    # 2 * 10,000 * 1,000,000 * 128 = 2.56e12 int8 operations at
    # 1,979 TOP/s: 1.2936 ms; the bytes (128 MB of rows, 1.28 MB of
    # queries, 0.8 MB out) need only 0.0387 ms at 3.35 TB/s
    assert tr["queries_per_request"] == 10_000
    assert abs(b - 2.56e12 / 1979e12) < 1e-12
    assert abs(b * 1e3 - 1.2936) < 0.0001
    nbytes = 128e6 + 10_000 * 128 + 10_000 * 10 * 8
    assert nbytes / 3.35e12 < b / 10


def test_scan_roofline_reads_the_trace():
    sys.path[:0] = [str(ROOT / "src")]
    from bench import harness

    read = harness.reader("scan_roofline")
    cfg = {"rows": 1_000_000, "dim": 128}
    tr = {"queries_per_request": 10_000, "k": 10}
    bound = roofline.scan_bound_s(1_000_000, 128, 10_000, 10)
    run = {"config": cfg, "traffic": tr,
           "trace": {"requests": 2, "busy_s": 1.8, "window_s": 3.0}}
    assert abs(read(run) - 100.0 * 2 * bound / 1.8) < 1e-12
    # the host's time around the device's does not enter it
    run["trace"]["window_s"] = 30.0
    assert abs(read(run) - 100.0 * 2 * bound / 1.8) < 1e-12
    assert read({**run, "trace": None}) is None
