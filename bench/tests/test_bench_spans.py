"""The program's spans and the benchmark's profiled stretches: the harness
leaves the program's tracer off, so its spans open no profiler range
there and the device metrics read what they read without them; with the
tracer on the same stretch holds them, and `devtrace.py` names a gap
inside one by its name (synthetic events)."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import devtrace, generator, harness  # noqa: E402
from repro_torch.api import SearchRequest  # noqa: E402
from repro_torch.obs.trace import TRACER  # noqa: E402

SEED = 2**31 + 91
SPANS = {"search", "encode", "upload", "scan"}


@pytest.fixture(scope="module")
def window():
    torch.set_num_threads(1)
    cell = harness.load_cell("flat-u8-q10k")
    base = generator.base_rows(1_200, SEED)
    pool = generator.query_pool(1_200, 3, 8, SEED)
    svc = harness.build_service(base, cell.config, "cpu")
    requests = [SearchRequest(np.ascontiguousarray(q), k=10) for q in pool]
    return harness._Window(svc, requests, "cpu")


def _names(prof):
    return {e.name for e in prof.events()}


def test_the_profiled_stretch_holds_no_program_range(window):
    assert not TRACER.enabled
    prof, _ = harness._profiled(window, 2, 0, host_ops=True)
    names = _names(prof)
    assert devtrace.RANGE in names and "aten::mm" in names
    assert not SPANS & names
    assert TRACER.spans() == []


def test_with_the_tracer_on_the_stretch_holds_the_spans(window):
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    try:
        prof, _ = harness._profiled(window, 1, 0, host_ops=True)
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()
    assert SPANS <= _names(prof)


def _ev(name, start, end, cuda=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_a_gap_inside_a_program_span_is_named_by_it():
    """One request (0-100 us): the program's `scan` range 10-90 holding an
    `aten::mm` 10-20, kernels at 15-40 and 60-95."""
    evs = [_ev(devtrace.RANGE, 0, 100), _ev("scan", 10, 90),
           _ev("aten::mm", 10, 20), _ev("kernel_a", 15, 40, cuda=True),
           _ev("kernel_b", 60, 95, cuda=True),
           _ev(devtrace.RANGE, 0, 100, cuda=True)]
    assert devtrace.device_busy(evs)["busy_s"] == pytest.approx(60e-6)
    gaps = dict(devtrace.idle_gaps(evs))
    assert gaps["scan"] == pytest.approx(20e-6)               # 40-60
    assert gaps["host, between ops"] == pytest.approx(20e-6)  # 0-15, 95-100
