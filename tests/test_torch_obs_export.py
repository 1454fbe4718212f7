"""The rest of the port's `repro_torch.obs` (exporters, SLOs, flight
recorder) against the reference's, and the names the async serving and
ingest layers publish.

The same recorded counters, gauges and histograms go through both
packages' `write_snapshot` (JSON and Prometheus text) and
`PeriodicExporter`; the same samples through `SLOTracker` on a fake clock;
the same captures through `FlightRecorder`. Outputs are equal byte for
byte, timestamps fixed. Then one async search in each package, traced:
the same span names (`request` / `queue` / `exec` / `batch` / `dispatch`
/ `search`, and on csd `traversal` / `store-read` / ...), the same
`serve_*` and `serve_replica_*` series, and the port's Perfetto export
nests request > exec and batch > dispatch > search. The ingest layer's
spans and `ingest_*` series match too.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.api import IndexSpec as RefSpec
from repro.api import MutableSearchService as RefMutable
from repro.api import SearchRequest as RefRequest
from repro.api import SearchService as RefService
from repro.core.hnsw_graph import HNSWConfig as RefHNSW
from repro.obs import export as ref_export
from repro.serve import SearchServer as RefServer
from repro.store import CSDBackend as RefCSD
from repro_torch import obs
from repro_torch.api import (IndexSpec, MutableSearchService, SearchRequest,
                             SearchService)
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.data import VectorDataset
from repro_torch.obs import export
from repro_torch.serve import SearchServer
from repro_torch.store import CSDBackend

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

K, EF = 10, 40
HNSW = dict(M=8, ef_construction=40)
PKGS = {"port": obs, "ref": ref_obs}


def _record(o, registry):
    """One recording, the same in either package: labelled counters, a
    gauge, a default-bucket and a custom-bucket histogram, a collector."""
    registry.counter("serve_requests_total").inc(7)
    registry.counter("api_searches_total", backend="partitioned").inc(3)
    registry.counter("api_searches_total", backend="csd").inc()
    registry.gauge("store_cache_peak_bytes", cache="c1").set(12288)
    h = registry.histogram("serve_e2e_ms")
    for x in (0.3, 1.5, 2.0, 7.25, 40.0, 1e9):
        h.observe(x)
    b = registry.histogram("serve_batch_size", buckets=(1, 2, 4, 8))
    for x in (1, 3, 4, 8, 9):
        b.observe(x)

    class Owner:
        pass

    owner = Owner()
    registry.register_collector(owner, lambda _o: [
        ("counter", "serve_replica_batches_total",
         {"pool": "p", "replica": "0"}, 5),
        ("gauge", "serve_replica_inflight", {"pool": "p", "replica": "0"},
         0)])
    return owner


@pytest.fixture
def fixed_time(monkeypatch):
    for mod in (export, ref_export):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)


@pytest.mark.parametrize("fmt", ["json", "prom"])
def test_write_snapshot_matches_reference(tmp_path, fixed_time, fmt):
    out = {}
    keep = []
    for name, o in PKGS.items():
        reg = o.MetricsRegistry()
        keep.append(_record(o, reg))
        path = str(tmp_path / f"{name}.{fmt}")
        assert o.write_snapshot(path, reg) == path
        out[name] = open(path).read()
        assert (o.to_json(reg.snapshot()) if fmt == "json"
                else o.to_prometheus(reg.snapshot())) == out[name]
    assert out["port"] == out["ref"]
    if fmt == "json":
        snap = json.loads(out["port"])
        assert snap["ts_unix"] == 1_700_000_000.25
    else:
        assert "serve_e2e_ms_bucket{le=\"+Inf\"} 6" in out["port"]


def test_periodic_exporter_matches_reference(tmp_path, fixed_time):
    """One emit at start, exactly one final emit at stop (however often
    stop is called), the trace file beside it."""
    out = {}
    keep = []
    for name, o in PKGS.items():
        reg = o.MetricsRegistry()
        keep.append(_record(o, reg))
        tracer = o.Tracer(enabled=True)
        path = str(tmp_path / f"{name}.prom")
        ex = o.PeriodicExporter(path, 3600.0, registry=reg, tracer=tracer,
                                trace_path=str(tmp_path / f"{name}.t.json"))
        ex.start()
        reg.counter("serve_requests_total").inc()
        ex.stop()
        ex.stop()
        out[name] = (ex.emits, open(path).read(),
                     json.load(open(tmp_path / f"{name}.t.json")))
    assert out["port"] == out["ref"]
    assert out["port"][0] == 2
    with pytest.raises(ValueError):
        obs.PeriodicExporter(str(tmp_path / "x"), 0)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_slo_tracker_matches_reference():
    """The stock SLOs plus a recall SLO, fed the same samples on a fake
    clock: the same evaluations, breach events, summary and series."""
    outs = {}
    for name, o in PKGS.items():
        reg, clock = o.MetricsRegistry(), _Clock()
        slos = list(o.default_slos(p99_ms=5.0, error_rate=0.05,
                                   window_s=60.0)) + [
            o.SLO("recall", "recall", target=0.9, objective=0.9,
                  window_s=60.0, min_samples=5)]
        tr = o.SLOTracker(slos, clock=clock, registry=reg,
                          labels={"server": "s"})
        evals = []
        rng = np.random.default_rng(0)
        for step in range(120):
            clock.t += 0.5
            tr.record_latency(float(rng.exponential(3.0 if step < 60
                                                    else 9.0)))
            if step % 17 == 0:
                tr.record_error(2)
            tr.record_recall(0.95 if step % 3 else 0.7)
            if step % 20 == 19:
                evals.append(tr.evaluate())
        outs[name] = (evals, tr.breaches(), tr.summary(),
                      json.dumps(reg.snapshot(), sort_keys=True))
    assert outs["port"] == outs["ref"]
    assert outs["port"][1], "the fixture should breach at least once"


def test_flight_recorder_matches_reference(tmp_path):
    """The same captures (slowest kept, faster refused, errors ringed,
    per-query stats as JSON) give the same snapshot, export and series."""
    from repro.api import QueryStats as RefStats
    from repro_torch.api import QueryStats

    outs = {}
    for name, o, stats_cls in (("port", obs, QueryStats),
                               ("ref", ref_obs, RefStats)):
        reg = o.MetricsRegistry()
        fr = o.FlightRecorder(capacity=3, registry=reg)
        kept = [fr.record(seq=i, e2e_ms=e, queue_ms=e / 4, exec_ms=3 * e / 4,
                          k=10, ef=40,
                          stats=stats_cls(hops=np.int32(i),
                                          dist_calcs=np.arange(2) + i))
                for i, e in enumerate((5.0, 1.0, 9.5, 3.25, 0.5, 12.0))]
        for i in range(5):
            fr.record_error(seq=100 + i, error=f"RuntimeError: {i}", k=10)
        path = fr.write(str(tmp_path / f"{name}.json"))
        outs[name] = (kept, fr.snapshot(), fr.export(), open(path).read(),
                      json.dumps(reg.snapshot(), sort_keys=True))
    assert outs["port"] == outs["ref"]
    assert [r["seq"] for r in outs["port"][1]["slowest"]] == [5, 2, 0]


# ---------------------------------------------------------------------------
# the names one async search publishes, in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    ds = VectorDataset(600, 16, 8, seed=2)
    v = np.minimum(np.rint(ds.vectors()), 255.0).astype(np.float32)
    return v, np.rint(np.clip(ds.queries(6), 0, 255)).astype(np.float32)


@pytest.fixture(scope="module")
def services(data, tmp_path_factory):
    """backend -> (port service, reference service) over the same rows:
    partitioned built by each package, csd written from each one's
    partitioned DB."""
    v, _ = data
    kw = dict(backend="partitioned", num_partitions=2, keep_vectors=True,
              fused_hops=4)
    port = SearchService.build(v, IndexSpec(hnsw=HNSWConfig(**HNSW), **kw),
                               device="cpu")
    ref = RefService.build(v, RefSpec(hnsw=RefHNSW(**HNSW), **kw))
    out = {"partitioned": (port, ref)}
    csd = dict(backend="csd", keep_vectors=False, block_size=1024,
               cache_bytes=16384, prefetch=False)
    ps = dataclasses.replace(port.spec, storage_path=str(
        tmp_path_factory.mktemp("p") / "store"), **csd)
    rs = dataclasses.replace(ref.spec, storage_path=str(
        tmp_path_factory.mktemp("r") / "store"), **csd)
    out["csd"] = (
        SearchService(ps, CSDBackend.from_partitioned(port.backend.pdb, ps,
                                                      device="cpu")),
        RefService(rs, RefCSD.from_partitioned(ref.backend.pdb, rs)))
    return out


def _serve_traced(o, server_cls, service, q, rerank):
    """Spans, the Perfetto export and the serve series (taken while the
    server is alive) of one traced async run of `q`."""
    o.TRACER.configure(enabled=True, sample_rate=1.0)
    o.TRACER.clear()
    try:
        with server_cls(service, replicas=2, max_batch=4,
                        max_wait_ms=1.0) as srv:
            for f in srv.submit_many(q, k=K, ef=EF, rerank=rerank):
                f.result(timeout=300)
            snap = json.loads(srv.metrics("json"))
            uid = srv.pool.uid
        spans, doc = o.TRACER.spans(), o.TRACER.export()
    finally:
        o.TRACER.configure(enabled=False)
        o.TRACER.clear()
    series = {s["name"] for kind in ("counters", "gauges", "histograms")
              for s in snap[kind]
              if s["name"].startswith("serve_")
              and s["labels"].get("pool", uid) == uid}
    return spans, doc, series


@pytest.mark.parametrize("backend", ["partitioned", "csd"])
def test_async_span_and_metric_names_match_reference(services, data,
                                                     backend):
    port, ref = services[backend]
    q = data[1]
    got = _serve_traced(obs, SearchServer, port, q, True)
    want = _serve_traced(ref_obs, RefServer, ref, q, True)
    names = {ev["name"] for ev in got[0]}
    # the port's graph search adds spans of its own (core/search.py); the
    # rerank path merges in `batched_rerank`, so no `merge` span
    port_only = {"descend", "layer0"} if backend == "partitioned" else set()
    assert names == {ev["name"] for ev in want[0]} | port_only
    assert {"request", "queue", "exec", "batch", "dispatch",
            "search"} <= names
    if backend == "csd":
        assert {"traversal", "store-read", "hop_superstep", "hop-kernel",
                "rerank"} <= names
    assert got[2] == want[2]
    assert {"serve_requests_total", "serve_batches_total",
            "serve_replica_batches_total", "serve_replica_queries_total",
            "serve_replica_busy_seconds_total", "serve_replica_inflight",
            "serve_e2e_ms", "serve_queue_ms", "serve_exec_ms",
            "serve_batch_size"} <= got[2]


def test_port_trace_nests_request_exec_and_batch_dispatch_search(services,
                                                                 data):
    """In the port's Perfetto export: every exec span's parent is a
    request span, every dispatch's a batch, every search's a dispatch."""
    _, doc, _ = _serve_traced(obs, SearchServer, services["partitioned"][0],
                              data[1], False)
    json.loads(json.dumps(doc))
    evs = [ev for ev in doc["traceEvents"] if ev.get("ph") == "X"]
    by_id = {ev["args"]["span_id"]: ev["name"] for ev in evs}
    parent = {}
    for ev in evs:
        parent.setdefault(ev["name"], set()).add(
            by_id.get(ev["args"]["parent_id"]))
    assert parent["exec"] == {"request"} and parent["queue"] == {"request"}
    assert parent["dispatch"] == {"batch"}
    assert parent["search"] == {"dispatch"}


def test_ingest_span_and_metric_names_match_reference(data):
    v, q = data
    out = {}
    for name, o, cls, spec_cls, cfg, req in (
            ("port", obs, MutableSearchService, IndexSpec, HNSWConfig,
             SearchRequest),
            ("ref", ref_obs, RefMutable, RefSpec, RefHNSW, RefRequest)):
        kw = {"device": "cpu"} if name == "port" else {}
        svc = cls(spec_cls(backend="partitioned", hnsw=cfg(**HNSW)),
                  seal_threshold=200, **kw)
        g = svc.insert(v[:300])
        svc.delete(g[:10])
        o.TRACER.configure(enabled=True, sample_rate=1.0)
        o.TRACER.clear()
        try:
            with o.TRACER.span("request"):
                svc.search(req(q, k=K, ef=EF))
            spans = {ev["name"] for ev in o.TRACER.spans()}
        finally:
            o.TRACER.configure(enabled=False)
            o.TRACER.clear()
        svc.compact()
        snap = o.REGISTRY.snapshot()
        series = {(s["name"], s["value"]) for kind in ("counters", "gauges")
                  for s in snap[kind]
                  if s["labels"].get("index") == svc.uid
                  and s["name"] not in ("ingest_resident_bytes",
                                        "ingest_peak_resident_bytes")}
        names = {s["name"] for kind in ("counters", "gauges")
                 for s in snap[kind] if s["labels"].get("index") == svc.uid}
        out[name] = spans, series, names
    # a sealed segment's graph search adds the port's own spans
    # (core/search.py, core/partitioned.py)
    assert out["port"][0] == out["ref"][0] | {"descend", "layer0", "merge"}
    assert out["port"][1:] == out["ref"][1:]
    assert {"search", "segment", "memtable"} <= out["port"][0]
    assert {"ingest_rows_inserted_total", "ingest_rows_deleted_total",
            "ingest_compactions_total", "ingest_segments",
            "ingest_live_rows", "ingest_resident_bytes",
            "ingest_peak_resident_bytes"} == out["port"][2]
