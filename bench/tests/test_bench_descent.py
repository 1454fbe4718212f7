"""The reader of `descent_kernel_ms_per_kq` (the upper-layer descent
kernel's device time per 1,000 queries) on a run record with the kernel's
device record, on one without it (a program without the kernel), and
beside the traversal kernel's records, which it does not count. No cell
reports it yet: BENCHMARK.json has no entry for it."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402

DESCENT = "void (anonymous namespace)::greedy_descent_kernel<unsigned char, 1>"


def _run(device_s, queries=20_000):
    return {"trace": {"requests": 2, "queries": queries, "busy_s": 0.03,
                      "window_s": 0.2, "device_s": device_s}}


def test_reads_the_descent_records_alone():
    read = harness.reader("descent_kernel_ms_per_kq")
    run = _run({DESCENT: 0.0008,
                "void traversal_async_kernel<uchar, false>": 0.012,
                "Memcpy HtoD": 0.001})
    # 0.8 ms over 20,000 queries: 0.04 ms a thousand; traversal not counted
    assert read(run) == pytest.approx(0.04, rel=1e-12)
    assert harness.reader("traversal_kernel_ms_per_kq")(run) == \
        pytest.approx(0.6, rel=1e-12)


def test_reads_none_without_the_kernel_or_the_trace():
    read = harness.reader("descent_kernel_ms_per_kq")
    assert read(_run({"void traversal_async_kernel<uchar, false>": 0.012,
                      "Memcpy HtoD": 0.001})) is None
    assert read({"trace": None}) is None
    assert read(_run({DESCENT: 0.0008}, queries=0)) is None

