"""The exact path's spans and the tracer's two extra clocks.

`SearchService.search` over the `exact` backend records `search` with the
children `encode` (the query preparation, where there is any), `upload`
(the queries becoming a device tensor) and `scan` (the route that ran,
with its work counts). A span given a CUDA `device_clock` is bracketed by
two CUDA events, resolved only when the spans are read (`dev_ms`); here a
stand-in for `torch.cuda` checks that bookkeeping without a card. Under
torch.profiler every sampled span is also a `record_function` range. A
span without device events exports exactly as the reference's tracer
exports it.
"""

import json
import time

import numpy as np
import pytest
import torch

from repro.obs.trace import Tracer as RefTracer
from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.obs.trace import TRACER, Tracer

torch.set_num_threads(1)

K = 5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 256, (1000, 16)).astype(np.float32)
    return rows, rng.integers(0, 256, (6, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def services(data):
    """dtype -> an exact service on the CPU."""
    return {dt: SearchService.build(data[0], IndexSpec(backend="exact",
                                                       dtype=dt),
                                    device="cpu")
            for dt in ("uint8", "float32")}


@pytest.fixture
def tracing():
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    try:
        yield TRACER
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()


def _tree(spans):
    by_id = {ev["id"]: ev for ev in spans}
    return {ev["name"]: by_id.get(ev["parent"], {}).get("name")
            for ev in spans}


def test_exact_search_records_encode_upload_scan(services, data, tracing):
    svc = services["uint8"]
    svc.search(SearchRequest(data[1], k=K))
    spans = TRACER.spans()
    assert _tree(spans) == {"search": None, "encode": "search",
                            "upload": "search", "scan": "search"}
    by = {ev["name"]: ev for ev in spans}
    be = svc.backend
    rows = be.vectors.shape[0]
    assert rows == 1024 and rows % be.CHUNK == 0
    # the CPU runs the chunk loop (the card's kernel route:
    # tests/test_torch_exact_route.py)
    assert by["scan"]["attrs"] == {"route": "chunks", "rows": rows,
                                   "chunks": rows // be.CHUNK,
                                   "queries": len(data[1]), "k": K}
    assert by["encode"]["attrs"] == {"queries": len(data[1])}
    assert by["upload"]["attrs"] == {"bytes": data[1].size * 4}
    for name in ("encode", "upload", "scan"):
        assert by["search"]["t0"] <= by[name]["t0"] <= by[name]["t1"] \
            <= by["search"]["t1"]
        assert "dev_ms" not in by[name]      # the CPU: no device events


def test_float32_l2_has_no_encode_span(services, data, tracing):
    services["float32"].search(SearchRequest(data[1], k=K))
    assert _tree(TRACER.spans()) == {"search": None, "upload": "search",
                                     "scan": "search"}


def test_tracing_off_keeps_no_span_and_makes_no_event(services, data,
                                                      monkeypatch):
    def no_event(*a, **kw):
        raise AssertionError("a CUDA event was made with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert not TRACER.enabled
    resp = services["uint8"].search(SearchRequest(data[1], k=K))
    assert resp.ids.shape == (len(data[1]), K)
    assert TRACER.spans() == []
    off = Tracer(enabled=False)
    with off.span("search"):
        with off.child_span("scan", device_clock="cuda:0", rows=1):
            pass
    assert off.spans() == []


class _FakeEvent:
    """A CUDA event on the host clock: `record` stamps perf_counter."""

    made, waited = 0, 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        _FakeEvent.waited += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_cuda(monkeypatch):
    """Just enough of torch.cuda for the tracer's device clock."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda i=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda i=None: syncs.append(i))
    _FakeEvent.made = _FakeEvent.waited = 0
    return syncs


def test_device_clock_is_resolved_lazily_and_exported(fake_cuda):
    tr = Tracer().configure(enabled=True)
    tr.clear()
    assert fake_cuda == [] and _FakeEvent.made == 0   # nothing at set-up
    with tr.span("search"):
        with tr.child_span("scan", device_clock=torch.device("cuda", 0),
                           rows=8):
            time.sleep(0.002)
        with tr.child_span("upload", device_clock="cpu"):
            pass
    assert _FakeEvent.made == 2 and _FakeEvent.waited == 0
    assert fake_cuda == []              # nothing waited in the request
    doc = tr.export()                   # the export waits for nothing
    assert _FakeEvent.waited == 0
    spans = {ev["name"]: ev for ev in tr.spans()}
    assert _FakeEvent.waited == 1 and fake_cuda == []
    scan = spans["scan"]
    assert "dev_ms" in scan and "_cuda" not in scan
    assert "dev_ms" not in spans["upload"] and "dev_ms" not in spans["search"]
    assert 2.0 <= scan["dev_ms"] <= (scan["t1"] - scan["t0"]) * 1e3
    tr.spans()                          # resolved once
    assert _FakeEvent.waited == 1
    # the export holds the host spans alone, as for spans without events
    json.loads(json.dumps(doc))
    assert [ev["args"]["name"] for ev in doc["traceEvents"]
            if ev["ph"] == "M" and ev["name"] == "thread_name"] \
        == ["MainThread"]
    host = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    assert sorted(ev["name"] for ev in host) == ["scan", "search", "upload"]
    assert all("dev_ms" not in ev["args"] for ev in host)


def test_spans_are_profiler_ranges(services, data, tracing):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        services["uint8"].search(SearchRequest(data[1], k=K))
    names = {e.name for e in prof.events()}
    assert {"search", "encode", "upload", "scan"} <= names
    scan = [e for e in prof.events() if e.name == "scan"]
    assert len(scan) == 1
    mm = [e for e in prof.events() if e.name == "aten::mm"
          and scan[0].time_range.start <= e.time_range.start
          <= scan[0].time_range.end]
    assert mm                  # the scan's matmuls run inside its range


def test_no_profiler_range_without_tracing(services, data):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        services["uint8"].search(SearchRequest(data[1], k=K))
    names = {e.name for e in prof.events()}
    assert not {"search", "encode", "upload", "scan"} & names


def _record_both(tr):
    tr.configure(enabled=True, sample_rate=1.0)
    tr.clear()
    tr._epoch = 100.0
    root = tr.record_span("search", 100.5, 101.25, tid="main", backend="exact")
    tr.record_span("scan", 100.75, 101.0, parent=root, tid="main", rows=1024)
    tr.record_span("upload", 100.6, 100.7, parent=root, tid="io", bytes=64)
    return json.dumps(tr.export())


def test_spans_without_device_events_export_as_the_reference():
    assert _record_both(Tracer()) == _record_both(RefTracer())


def test_live_spans_without_device_events_keep_the_export_schema(
        services, data, tracing):
    services["uint8"].search(SearchRequest(data[1], k=K))
    doc = TRACER.export()
    assert [ev["args"]["name"] for ev in doc["traceEvents"]
            if ev["name"] == "thread_name"] == ["MainThread"]
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            assert set(ev) == {"name", "ph", "pid", "tid", "ts", "dur",
                               "cat", "args"}
            assert ev["cat"] == "repro"
            assert "dev_ms" not in ev["args"]
