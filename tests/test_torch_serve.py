"""The port's async serving layer (`repro_torch.serve`) against itself and
the reference.

The reference's batcher mechanics, held within the port: flush on
max_batch and on max_wait_ms, result-to-request ordering under
interleaved arrival, variable-k packing, drain, submit after shutdown,
separate batch keys, dispatch failure landing on the futures,
`bucket_size`, the latency split, the replica round-robin and csd
replicas with independent caches.

Then the acceptance bar of the reference's tests/test_serve.py: async ==
direct for exact, hnsw, partitioned and csd, on l2 and cosine, and on
float32, uint8 and pq partitioned. On integer-valued rows every sum is
exact, so ids and dists are bitwise equal on l2; on cosine the ids are
bitwise equal and the dists held within the reference's own rtol=1e-3,
atol=2.0 (tests/test_serve.py), since the batch shape changes the float
rounding of the normalized rows. The port's async results equal the
reference's async results on the same index; a CPU clone by
`_place_on_device` answers bitwise; the launch counters stay exact under
threads; the CLI's async flags write their files.
"""

import dataclasses
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import IndexSpec as RefSpec
from repro.api import SearchRequest as RefRequest
from repro.api import SearchService as RefService
from repro.core.hnsw_graph import HNSWConfig as RefHNSW
from repro.serve import SearchServer as RefServer
from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.data import VectorDataset
from repro_torch.kernels import (_build, attention, l2dist, l2topk, qdist,
                                 topk, traversal)
from repro_torch.launch import serve as serve_cli
from repro_torch.obs import TRACER
from repro_torch.serve import (DynamicBatcher, ReplicaPool, RequestQueue,
                               SearchServer, ServeClosed, bucket_size,
                               slice_stats)
from repro_torch.serve.dispatch import _clone_service, _place_on_device
from repro_torch.store import CSDBackend

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

K, EF = 10, 40
HNSW = dict(M=8, ef_construction=40)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data():
    """Integer-valued rows (0..255) and 13 queries: 13 is no power of
    two, so a batcher of max_batch 4 pads its last batch."""
    ds = VectorDataset(800, 32, 12, seed=1)
    v = np.minimum(np.rint(ds.vectors()), 255.0).astype(np.float32)
    return v, np.rint(np.clip(ds.queries(13), 0, 255)).astype(np.float32)


def _spec(backend, metric="l2", **kw):
    return IndexSpec(backend=backend, metric=metric,
                     num_partitions=1 if backend == "hnsw" else 2,
                     hnsw=HNSWConfig(**HNSW),
                     keep_vectors=backend != "exact", fused_hops=4, **kw)


@pytest.fixture(scope="module")
def zoo(data, tmp_path_factory):
    """(backend, metric, dtype) -> the port's service on the CPU, built
    lazily; csd re-serves the partitioned service's own graph from a
    block store."""
    v, _ = data
    svcs = {}

    def get(backend, metric="l2", dtype="float32"):
        key = (backend, metric, dtype)
        if key not in svcs:
            if backend == "csd":
                part = get("partitioned", metric)
                path = str(tmp_path_factory.mktemp("csd") / "store")
                spec = dataclasses.replace(
                    part.spec, backend="csd", keep_vectors=False,
                    storage_path=path, block_size=1024, cache_bytes=16384,
                    prefetch=False)
                svcs[key] = SearchService(spec, CSDBackend.from_partitioned(
                    part.backend.pdb, spec, device="cpu"))
            else:
                extra = {"dtype": dtype}
                if dtype == "pq":
                    extra["pq_m"] = 4
                svcs[key] = SearchService.build(
                    v, _spec(backend, metric, **extra), device="cpu")
        return svcs[key]

    return get


@pytest.fixture(scope="module")
def svc(zoo):
    return zoo("partitioned")


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _direct(service, queries, k=K, ef=EF, rerank=False):
    r = service.search(SearchRequest(queries=np.atleast_2d(queries), k=k,
                                     ef=ef, rerank=rerank))
    return _host(r.ids), _host(r.dists)


# ---------------------------------------------------------------------------
# batcher mechanics
# ---------------------------------------------------------------------------


def test_flush_on_max_batch(svc, data):
    """max_batch queued requests flush at once, long before the
    (deliberately huge) max_wait deadline."""
    q = data[1]
    with SearchServer(svc, replicas=1, max_batch=4,
                      max_wait_ms=60_000.0) as srv:
        res = [f.result(timeout=60)
               for f in [srv.submit(x, k=K, ef=EF) for x in q[:4]]]
        st = srv.stats()
    assert st.batch_sizes == {4: 1}
    np.testing.assert_array_equal(np.stack([r.ids for r in res]),
                                  _direct(svc, q[:4])[0])


def test_flush_on_max_wait(svc, data):
    """A partial batch flushes once the head of line has waited max_wait."""
    q = data[1]
    with SearchServer(svc, replicas=1, max_batch=64, max_wait_ms=30.0) as srv:
        t0 = time.perf_counter()
        res = [f.result(timeout=60)
               for f in [srv.submit(x, k=K, ef=EF) for x in q[:3]]]
        st = srv.stats()
    assert st.batch_sizes == {3: 1}
    assert all(r.queue_ms >= 25.0 for r in res)
    assert time.perf_counter() - t0 < 30
    np.testing.assert_array_equal(np.stack([r.ids for r in res]),
                                  _direct(svc, q[:3])[0])


def test_result_to_request_ordering_under_interleaved_arrival(svc, data):
    """Concurrent submitters with jittered arrival: every future gets ITS
    OWN query's results (scatter routes by future, not position)."""
    q = data[1]
    direct = _direct(svc, q)[0]
    out, lock = {}, threading.Lock()
    with SearchServer(svc, replicas=2, max_batch=5, max_wait_ms=5.0) as srv:
        def client(worker: int):
            for i in range(worker, len(q), 4):
                time.sleep(0.001 * (i % 3))
                res = srv.submit(q[i], k=K, ef=EF).result(timeout=120)
                with lock:
                    out[i] = res.ids
        threads = [threading.Thread(target=client, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(out) == list(range(len(q)))
    for i, ids in out.items():
        np.testing.assert_array_equal(ids, direct[i])


def test_variable_k_requests_pack_into_one_batch(svc, data):
    """k is not part of the batch key: mixed-k requests ride one batch
    (packed at k_max) and each gets its own bit-identical k-prefix."""
    q = data[1]
    ks = [3, 10, 7, 1]
    with SearchServer(svc, replicas=1, max_batch=4,
                      max_wait_ms=60_000.0) as srv:
        res = [f.result(timeout=60) for f in
               [srv.submit(q[i], k=k, ef=EF) for i, k in enumerate(ks)]]
        st = srv.stats()
    assert st.batch_sizes == {4: 1}
    for i, (r, k) in enumerate(zip(res, ks)):
        assert r.ids.shape == (k,)
        ids, dists = _direct(svc, q[i], k=k)
        np.testing.assert_array_equal(r.ids, ids[0])
        np.testing.assert_array_equal(r.dists, dists[0])


def test_drain_returns_all_futures(svc, data):
    q = data[1]
    srv = SearchServer(svc, replicas=2, max_batch=4, max_wait_ms=1.0)
    try:
        futs = srv.submit_many(np.repeat(q, 3, axis=0), k=K, ef=EF)
        assert srv.drain(timeout=120)
        assert all(f.done() for f in futs)
        assert srv.stats().completed == len(futs)
    finally:
        srv.shutdown()


def test_submit_after_shutdown_raises(svc, data):
    srv = SearchServer(svc, replicas=1)
    srv.shutdown()
    with pytest.raises(ServeClosed):
        srv.submit(data[1][0])
    queue = RequestQueue()
    queue.close()
    with pytest.raises(ServeClosed):
        queue.put(data[1][0])


def test_batch_key_separates_incompatible_requests(svc, data):
    """Different ef -> different traversal -> must not share a batch."""
    q = data[1]
    with SearchServer(svc, replicas=1, max_batch=8, max_wait_ms=5.0) as srv:
        futs = ([srv.submit(q[i], k=K, ef=40) for i in range(3)]
                + [srv.submit(q[i], k=K, ef=24) for i in range(3, 6)])
        res = [f.result(timeout=60) for f in futs]
    np.testing.assert_array_equal(np.stack([r.ids for r in res[:3]]),
                                  _direct(svc, q[:3], ef=40)[0])
    np.testing.assert_array_equal(np.stack([r.ids for r in res[3:]]),
                                  _direct(svc, q[3:6], ef=24)[0])


def test_dispatch_failure_lands_on_futures(data):
    """A failing backend call rejects the batch's futures; nothing hangs."""
    queue = RequestQueue()

    def boom(_req, n_queries=0):
        raise RuntimeError("replica on fire")

    b = DynamicBatcher(queue, boom, max_batch=2, max_wait_ms=5.0)
    b.start()
    p = queue.put(data[1][0], k=K, ef=EF)
    with pytest.raises(RuntimeError, match="replica on fire"):
        p.future.result(timeout=30)
    queue.close()
    b.join(timeout=10)
    assert not b.alive


def test_bucket_size_shapes():
    assert [bucket_size(n, 64) for n in (1, 2, 3, 5, 9, 64)] == \
        [1, 2, 4, 8, 16, 64]
    assert bucket_size(33, 48) == 48
    assert bucket_size(50, 48) == 50


def test_slice_stats_takes_tensors_and_keeps_request_scalars():
    from repro_torch.api import QueryStats

    st = QueryStats(hops=torch.tensor([3, 4], dtype=torch.int32),
                    dist_calcs=np.array([7, 8]), block_reads=5,
                    segments=[{"segment": "s", "n": 1}])
    row = slice_stats(st, 1)
    assert int(row.hops) == 4 and int(row.dist_calcs) == 8
    assert row.block_reads == 5 and row.segments == st.segments


# ---------------------------------------------------------------------------
# latency semantics, stats rollup, replicas
# ---------------------------------------------------------------------------


def test_latency_split_and_stats_rollup(svc, data):
    q = data[1]
    with SearchServer(svc, replicas=2, max_batch=8, max_wait_ms=2.0) as srv:
        res = [f.result(timeout=120)
               for f in srv.submit_many(q, k=K, ef=EF, with_stats=True)]
        st = srv.stats()
    want = svc.search(SearchRequest(q, k=K, ef=EF, with_stats=True)).stats
    for i, r in enumerate(res):
        assert r.queue_ms >= 0 and r.exec_ms > 0
        assert r.e2e_ms == pytest.approx(r.queue_ms + r.exec_ms, rel=1e-6)
        assert np.asarray(r.stats.dist_calcs).shape == ()
        assert int(r.stats.dist_calcs) == int(want.dist_calcs[i])
        assert int(r.stats.hops) == int(want.hops[i])
    assert st.completed == len(q) and st.qps > 0
    assert sum(s * c for s, c in st.batch_sizes.items()) == len(q)
    assert len(st.replicas) == 2
    # per-replica counters count REAL requests, never bucket-padding rows
    assert sum(r["queries"] for r in st.replicas) == len(q)
    assert "QPS" in st.summary()


def test_replica_pool_balances_and_round_robins(svc):
    """Ties round-robin; depth imbalance routes to the idler replica."""
    pool = ReplicaPool.replicate(svc, 2)
    try:
        picked = []

        def slow(rid, orig):
            def wrapped(req, n_queries):
                picked.append(rid)
                time.sleep(0.05)
                return orig(req, n_queries)
            return wrapped

        for rid in (0, 1):
            pool.replicas[rid]._search = slow(rid,
                                              pool.replicas[rid]._search)
        q = np.zeros((2, 32), np.float32)
        futs = [pool.submit(SearchRequest(queries=q, k=K, ef=EF))
                for _ in range(4)]
        for f in futs:
            f.result(timeout=60)
        assert sorted(picked) == [0, 0, 1, 1]
        # on the CPU the replicas share the one service, on no stream
        assert all(r.service is svc and r.stream is None
                   for r in pool.replicas)
    finally:
        pool.close()


def test_csd_replicas_have_independent_caches(zoo, data):
    """csd replication = one block store, N PageCaches (the paper's four
    SmartSSD DRAM tiers): each replica reports its own block traffic."""
    svc_csd = zoo("csd")
    q = data[1]
    direct = _direct(svc_csd, q)
    with SearchServer(svc_csd, replicas=2, max_batch=4,
                      max_wait_ms=1.0) as srv:
        res = [f.result(timeout=300)
               for f in srv.submit_many(np.repeat(q, 2, axis=0), k=K,
                                        ef=EF)]
        st = srv.stats()
    readers = {id(r.service.backend.reader) for r in srv.pool.replicas}
    assert len(readers) == 2
    assert srv.pool.replicas[1].owns_backend
    for r in st.replicas:
        assert r["backend"] == "csd" and r["queries"] > 0
        assert r["block_reads"] > 0
        assert 0.0 <= r["cache_hit_rate"] <= 1.0
    ids = np.stack([r.ids for r in res])
    np.testing.assert_array_equal(ids, np.repeat(direct[0], 2, axis=0))


# ---------------------------------------------------------------------------
# the acceptance bar: async == direct, for every backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,metric,dtype,rerank", [
    ("exact", "l2", "float32", False),
    ("hnsw", "l2", "float32", False),
    ("partitioned", "l2", "float32", False),
    ("partitioned", "l2", "float32", True),
    ("csd", "l2", "float32", False),
    ("csd", "l2", "float32", True),
    ("exact", "cosine", "float32", False),
    ("hnsw", "cosine", "float32", False),
    ("partitioned", "cosine", "float32", True),
    ("csd", "cosine", "float32", False),
    ("partitioned", "l2", "uint8", False),
    ("partitioned", "l2", "uint8", True),
    ("partitioned", "l2", "pq", False),
    ("partitioned", "l2", "pq", True),
])
def test_async_serve_is_bit_identical_to_direct(zoo, data, backend, metric,
                                                dtype, rerank):
    """Bucket padding (13 queries, max_batch 4: a last batch of 1 padded to
    1, batches of 3 padded to 4), two replicas and variable batch shapes
    change no id; on l2 no dist either."""
    service = zoo(backend, metric, dtype)
    q = data[1]
    ids, dists = _direct(service, q, rerank=rerank)
    with SearchServer(service, replicas=2, max_batch=4,
                      max_wait_ms=1.0) as srv:
        res = [f.result(timeout=300)
               for f in srv.submit_many(q, k=K, ef=EF, rerank=rerank)]
    np.testing.assert_array_equal(np.stack([r.ids for r in res]), ids)
    got = np.stack([r.dists for r in res])
    if metric == "l2":
        np.testing.assert_array_equal(got, dists)
    else:
        np.testing.assert_allclose(got, dists, rtol=1e-3, atol=2.0)


@pytest.mark.parametrize("metric,dtype", [("cosine", "float32"),
                                          ("l2", "uint8")])
def test_zero_pad_rows_change_no_real_lane(zoo, data, metric, dtype):
    """The batcher's zero pad rows, through cosine's normalization and the
    uint8 encoder, leave every real lane as it was: ids bitwise, uint8
    dists bitwise (integer sums), cosine dists (in [0, 2]) within 1e-5
    (the batch shape may round the normalized rows' products
    differently)."""
    service = zoo("partitioned", metric, dtype)
    q = data[1][:3]
    ids, dists = _direct(service, q, rerank=True)
    padded = np.concatenate([q, np.zeros((5, q.shape[1]), np.float32)])
    pi, pd = _direct(service, padded, rerank=True)
    np.testing.assert_array_equal(pi[:3], ids)
    if dtype == "uint8":
        np.testing.assert_array_equal(pd[:3], dists)
    else:
        np.testing.assert_allclose(pd[:3], dists, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["exact", "hnsw", "partitioned"])
def test_port_async_equals_reference_async(data, backend):
    """The same rows and spec through both packages' builds and async
    servers: bitwise in ids and dists (integer l2 data)."""
    v, q = data
    kw = dict(backend=backend, num_partitions=1 if backend == "hnsw" else 2,
              keep_vectors=backend != "exact")
    ref = RefService.build(v, RefSpec(hnsw=RefHNSW(**HNSW), **kw))
    port = SearchService.build(v, IndexSpec(hnsw=HNSWConfig(**HNSW), **kw),
                               device="cpu")
    out = []
    for server, service in ((RefServer, ref), (SearchServer, port)):
        with server(service, replicas=2, max_batch=4,
                    max_wait_ms=1.0) as srv:
            res = [f.result(timeout=300)
                   for f in srv.submit_many(q, k=K, ef=EF)]
        out.append((np.stack([np.asarray(r.ids) for r in res]),
                    np.stack([np.asarray(r.dists) for r in res])))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[0][1])
    direct = ref.search(RefRequest(q, k=K, ef=EF))
    np.testing.assert_array_equal(out[1][0], np.asarray(direct.ids))


@pytest.mark.parametrize("backend,dtype", [
    ("partitioned", "float32"), ("exact", "float32"),
    ("partitioned", "pq")])
def test_place_on_device_cpu_clone_is_bitwise(zoo, data, backend, dtype):
    service = zoo(backend, "l2", dtype)
    clone = _place_on_device(service, torch.device("cpu"))
    assert clone is not service and clone.backend is not service.backend
    assert clone.device == torch.device("cpu")
    q = data[1]
    for rerank in ((False, True) if backend != "exact" else (False,)):
        a = service.search(SearchRequest(q, k=K, ef=EF, rerank=rerank,
                                         with_stats=True))
        b = clone.search(SearchRequest(q, k=K, ef=EF, rerank=rerank,
                                       with_stats=True))
        for x, y in ((a.ids, b.ids), (a.dists, b.dists),
                     (a.stats.dist_calcs, b.stats.dist_calcs)):
            assert torch.equal(x, y)


def test_clone_service_shares_on_one_device_and_opens_csd_readers(zoo):
    part, csd = zoo("partitioned"), zoo("csd")
    assert _clone_service(part, 1) == (part, False)
    clone, owns = _clone_service(csd, 1)
    try:
        assert owns and clone.backend.reader is not csd.backend.reader
        assert clone.backend.reader.cache.capacity_bytes == \
            csd.spec.cache_bytes
    finally:
        clone.backend.reader.close()


def test_search_honours_request_trace(svc, data):
    """On a thread with no open span, `search` parents on request.trace;
    inside an open span it nests there instead."""
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    try:
        root = TRACER.sample_request()
        svc.search(SearchRequest(data[1][:2], k=K, ef=EF, trace=root))
        with TRACER.span("outer") as outer:
            svc.search(SearchRequest(data[1][:2], k=K, ef=EF, trace=root))
        spans = [ev for ev in TRACER.spans() if ev["name"] == "search"]
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()
    assert spans[0]["trace"] == root.trace_id
    assert spans[0]["parent"] == root.span_id
    assert spans[1]["parent"] == outer.ctx.span_id


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------


def test_launch_counters_are_exact_under_threads(monkeypatch):
    """Replica threads launching at once lose no count: N threads each
    bump a counter M times through the wrappers' one helper."""
    monkeypatch.setattr(traversal, "ASYNC_LAUNCHES", 0)
    monkeypatch.setattr(qdist, "TOPK_SMEM_LAUNCHES", 0)
    n_threads, m = 16, 3000          # more threads than cores
    barrier = threading.Barrier(n_threads)

    def worker(i):
        barrier.wait()
        for _ in range(m):
            _build.count_launch(traversal.__name__, "ASYNC_LAUNCHES")
            _build.count_launch(qdist.__name__, "TOPK_SMEM_LAUNCHES")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)                   # switch threads often
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert traversal.ASYNC_LAUNCHES == n_threads * m
    assert qdist.TOPK_SMEM_LAUNCHES == n_threads * m


def test_every_wrapper_counts_through_the_locked_helper():
    """No kernels module bumps a launch counter by a bare `+= 1`."""
    for mod in (attention, l2dist, l2topk, qdist, topk, traversal):
        src = Path(mod.__file__).read_text()
        assert "LAUNCHES += 1" not in src, mod.__name__
        assert "_build.count_launch(__name__," in src, mod.__name__


# ---------------------------------------------------------------------------
# the CLI and the example
# ---------------------------------------------------------------------------


def test_serve_cli_async_flags_on_cpu(tmp_path, capsys):
    """--serve-async with tracing, a metrics snapshot, the stock SLOs and
    the flight recorder: every file is written and parses."""
    out = {n: str(tmp_path / n) for n in ("trace.json", "metrics.json",
                                          "flight.json")}
    try:
        stats = serve_cli.main([
            "--n", "300", "--dim", "16", "--partitions", "2", "--batch", "8",
            "--num-batches", "2", "--M", "4", "--device", "cpu",
            "--serve-async", "--replicas", "2", "--max-batch", "4",
            "--trace-out", out["trace.json"],
            "--metrics-out", out["metrics.json"], "--slo",
            "--flight-out", out["flight.json"]])
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()
    assert stats["batches"] >= 4 and stats["qps"] > 0
    assert sum(r["queries"] for r in stats["replicas"]) == 16
    text = capsys.readouterr().out
    assert "[serve-async] 16 queries" in text and "slo latency_p99" in text
    trace = json.load(open(out["trace.json"]))
    names = {ev["name"] for ev in trace["traceEvents"]}
    assert {"request", "queue", "exec", "batch", "dispatch",
            "search"} <= names
    metrics = json.load(open(out["metrics.json"]))
    assert {"serve_requests_total", "serve_batches_total"} <= {
        s["name"] for s in metrics["counters"]}
    assert "serve_e2e_ms" in {s["name"] for s in metrics["histograms"]}
    assert json.load(open(out["flight.json"]))["otherData"]["flight"][
        "captured_total"] > 0


def test_image_search_example_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_image_search_serving",
        ROOT / "examples" / "torch_image_search_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hit = mod.main(["--n", "1200", "--queries", "64", "--serve-async",
                    "--device", "cpu"])
    assert hit > 0.5
    assert "OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_replicas_on_their_own_streams_match_direct(data):
    """Four replicas of one card service, each on its own stream: the
    same ids and dists as the direct search."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    v, q = data
    service = SearchService.build(v, _spec("partitioned"), device="cuda")
    ids, dists = _direct(service, q, rerank=True)
    with SearchServer(service, replicas=4, max_batch=4,
                      max_wait_ms=1.0) as srv:
        res = [f.result(timeout=300)
               for f in srv.submit_many(q, k=K, ef=EF, rerank=True)]
        streams = {r.stream for r in srv.pool.replicas}
    assert len(streams) == 4 and None not in streams
    np.testing.assert_array_equal(np.stack([r.ids for r in res]), ids)
    np.testing.assert_array_equal(np.stack([r.dists for r in res]), dists)
