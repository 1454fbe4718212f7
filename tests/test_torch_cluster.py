"""The port's sharded cluster (`repro_torch.cluster`) against the
reference's `repro.cluster`.

On integer-valued rows (every sum exact), for the exact, partitioned and
csd backends and PQ partitioned with codebooks fit once over the union,
rerank off and on: the port's 3-shard x 2-replica cluster, the
reference's and the port's single index over the union answer with
bitwise-equal ids and dists. The wire codec's bytes are equal in both
packages, a reference router drives port workers and a port router
reference workers, and `cluster.json` is byte-equal for the same
topology. Within the port: failover loses and duplicates nothing, a
transient fault fails over, all replicas down raises, the health monitor
detects a kill and a revival, a shard joins under three threads of live
traffic, replicas come and go with a new published version, the
manifest survives a torn write and refuses to regress, the dtype gate,
`shard_bounds` / `shard_spec`, and a SearchServer fronting the router
through `_clone_service`'s router branch.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro import cluster as rcl
from repro.api import IndexSpec as RefSpec
from repro.api import SearchRequest as RefRequest
from repro.core.hnsw_graph import HNSWConfig as RefHNSW
from repro.optim.compression import PQQuantizer as RefPQ
from repro_torch import cluster as tcl
from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.cluster import (ClusterRouter, ClusterTopology,
                                 HealthMonitor, ShardFault, ShardInfo,
                                 ShardWorker, build_cluster, from_wire,
                                 make_shard, read_topology, shard_bounds,
                                 shard_spec, to_wire, write_topology)
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.data import VectorDataset
from repro_torch.optim.compression import PQQuantizer
from repro_torch.serve import SearchServer
from repro_torch.serve.dispatch import _clone_service

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

N, DIM, NSHARDS, K, EF = 900, 32, 3, 10, 40
HNSW = dict(M=8, ef_construction=50, seed=0)


def _data():
    """900 integer-valued 32-d rows (0..255) and 10 queries."""
    ds = VectorDataset(N, DIM, 16, seed=7)
    v = np.minimum(np.rint(ds.vectors()), 255.0).astype(np.float32)
    return v, np.rint(np.clip(ds.queries(10), 0, 255)).astype(np.float32)


def _kw(backend, storage=None, **extra):
    return dict(metric="l2", backend=backend, num_partitions=1,
                keep_vectors=backend != "csd", storage_path=storage,
                cache_bytes=1 << 20, **extra)


def _spec(backend, storage=None, **extra):
    return IndexSpec(hnsw=HNSWConfig(**HNSW), **_kw(backend, storage,
                                                    **extra))


def _ref_spec(backend, storage=None, **extra):
    return RefSpec(hnsw=RefHNSW(**HNSW), **_kw(backend, storage, **extra))


def _codebooks(v):
    """PQ codebooks fit once over the union (both packages' fits agree:
    `test_pq_fit_is_byte_identical`)."""
    return PQQuantizer.fit(v, 8, seed=0).to_json()["codebooks"]


def _int_codebooks(v):
    """The fit rounded to integers: every LUT entry and ADC sum is then an
    exact integer, so the packages' distances agree bitwise."""
    return np.rint(PQQuantizer.fit(v, 8, seed=0).codebooks).tolist()


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module", params=["exact", "partitioned", "csd", "pq"])
def zoo(request, data, tmp_path_factory):
    """(backend, port single index over the union, port cluster,
    reference cluster) — 3 shards x 2 replicas each; "pq" is partitioned
    PQ with the codebooks fit once and riding both clusters' specs."""
    backend = request.param
    v, _ = data
    td = tmp_path_factory.mktemp(f"cluster-{backend}")
    extra = {}
    if backend == "pq":
        extra = dict(dtype="pq", pq_m=8, pq_codebooks=_int_codebooks(v))
    real = "partitioned" if backend == "pq" else backend
    csd = backend == "csd"
    spec = _spec(real, str(td / "port") if csd else None, **extra)
    rspec = _ref_spec(real, str(td / "ref") if csd else None, **extra)
    single_spec = spec if backend == "exact" else dataclasses.replace(
        spec, num_partitions=NSHARDS,
        storage_path=str(td / "single") if csd else None)
    single = SearchService.build(v, single_spec, device="cpu")
    port = build_cluster(v, spec, NSHARDS, replicas=2,
                         path=str(td / "port"), device="cpu")
    ref = rcl.build_cluster(v, rspec, NSHARDS, replicas=2,
                            path=str(td / "ref"))
    yield backend, single, port, ref
    port.close()
    ref.close()


def _np(resp):
    return np.asarray(resp.ids), np.asarray(resp.dists)


def _answers(zoo, q, rerank, k=K):
    backend, single, port, ref = zoo
    rerank = rerank and backend != "exact"
    got = port.search(SearchRequest(q, k=k, ef=EF, rerank=rerank))
    assert got.ids.dtype == torch.int64 and got.ids.device.type == "cpu"
    return (_np(got),
            _np(ref.search(RefRequest(queries=q, k=k, ef=EF, rerank=rerank))),
            _np(single.search(SearchRequest(q, k=k, ef=EF, rerank=rerank))))


def _assert_same(*answers):
    (i0, d0), *rest = answers
    for i, d in rest:
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_array_equal(d, d0)


# ---------------------------------------------------------------------------
# parity: port cluster == reference cluster == port single index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rerank", [False, True])
def test_cluster_matches_reference_and_single_index(zoo, data, rerank):
    _assert_same(*_answers(zoo, data[1], rerank))


def test_pq_fit_is_byte_identical(data):
    """The codebooks a pq cluster shares: the port's fit over the union is
    the reference's, byte for byte."""
    v, _ = data
    got = PQQuantizer.fit(v, 8, seed=0).codebooks
    want = RefPQ.fit(v, 8, seed=0).codebooks
    assert got.dtype == want.dtype
    assert got.tobytes() == np.asarray(want).tobytes()


def test_pq_cluster_fits_codebooks_once(data):
    """build_cluster fits over the union when the spec has none: every
    shard shares the single index's code space."""
    v, q = data
    spec = _spec("partitioned", dtype="pq", pq_m=8)
    router = build_cluster(v, spec, NSHARDS, device="cpu")
    try:
        cbs = router.spec.pq_codebooks
        assert cbs == _codebooks(v)
        for c in router.shards:
            assert c.replicas[0].service.spec.pq_codebooks == cbs
        single = SearchService.build(v, dataclasses.replace(
            spec, num_partitions=NSHARDS), device="cpu")
        _assert_same(_np(router.search(SearchRequest(q, k=K, ef=EF))),
                     _np(single.search(SearchRequest(q, k=K, ef=EF))))
    finally:
        router.close()


def test_cosine_rerank_matches_single_index(data):
    """The shards search and the router reranks with the metric-prepared
    (unit-norm) queries, as a single index does."""
    v, q = data
    spec = dataclasses.replace(_spec("partitioned"), metric="cosine")
    router = build_cluster(v, spec, NSHARDS, device="cpu")
    try:
        single = SearchService.build(v, dataclasses.replace(
            spec, num_partitions=NSHARDS), device="cpu")
        for rerank in (False, True):
            req = SearchRequest(q, k=K, ef=EF, rerank=rerank)
            _assert_same(_np(router.search(req)), _np(single.search(req)))
    finally:
        router.close()


def test_cluster_stats_rollup(zoo, data):
    backend, single, port, ref = zoo
    resp = port.search(SearchRequest(data[1], k=5, ef=EF, with_stats=True))
    s = port.stats()
    assert s.n_shards == NSHARDS and s.queries > 0
    assert set(s.qps) == {c.name for c in port.shards}
    assert s.row_skew >= 1.0 and s.query_skew >= 1.0
    if backend == "exact":
        return
    want = ref.search(RefRequest(queries=data[1], k=5, ef=EF,
                                 with_stats=True))
    for f in ("hops", "dist_calcs"):
        np.testing.assert_array_equal(getattr(resp.stats, f).numpy(),
                                      np.asarray(getattr(want.stats, f)))
    if backend == "csd":
        assert s.block_reads > 0 and s.bytes_read > 0
        assert s.cache_hit_rate is not None
        assert resp.stats.block_reads + resp.stats.cache_hits > 0


# ---------------------------------------------------------------------------
# the wire: byte-equal codecs, routers and workers across packages
# ---------------------------------------------------------------------------


def _messages():
    return [
        {"op": "search", "k": 10, "frac": 0.5, "flag": True,
         "name": "shard-000", "nothing": None,
         "queries": np.arange(12, dtype=np.float32).reshape(3, 4),
         "ids": np.array([[1, -1], [5, 9]], dtype=np.int64),
         "empty": np.zeros((0, 4), dtype=np.int32)},
        {"op": "ping"},
        {"ok": False, "error": "ShardFault: shard 'a' replica 0 is down"},
    ]


@pytest.mark.parametrize("i", range(3))
def test_wire_bytes_equal_both_ways(i):
    msg = _messages()[i]
    b = to_wire(msg)
    assert b == rcl.to_wire(msg)
    for got in (from_wire(b), rcl.from_wire(b)):
        assert set(got) == set(msg)
        for k, want in msg.items():
            if isinstance(want, np.ndarray):
                assert got[k].dtype == want.dtype
                np.testing.assert_array_equal(got[k], want)
            else:
                assert got[k] == want


def test_wire_rejects_bad_magic():
    with pytest.raises(ValueError, match="magic"):
        from_wire(b"XXXX" + b"\x00" * 16)


def _request(op, q, gids):
    return {"search": {"op": "search", "queries": q, "k": K, "ef": EF,
                       "rerank": False, "with_stats": True},
            "candidates": {"op": "candidates", "queries": q, "k": K,
                           "ef": EF},
            "fetch_rows": {"op": "fetch_rows", "ids": gids},
            "ping": {"op": "ping"}}[op]


@pytest.mark.parametrize("op", ["search", "candidates", "fetch_rows",
                                "ping"])
def test_reference_request_answered_by_port_worker(zoo, data, op):
    """A reference-encoded request to a port worker: the reply bytes are
    the reference worker's, and decode in the reference (exact shards
    refuse `candidates` in both, with the same error)."""
    backend, _, port, ref = zoo
    pw, rw = port.shards[1].replicas[0], ref.shards[1].replicas[0]
    payload = rcl.to_wire(_request(op, data[1], rw.gid_map[::7]))
    got = pw.submit(payload).result(timeout=120)
    want = rw.submit(payload).result(timeout=120)
    refused = op == "candidates" and backend == "exact"
    assert rcl.from_wire(got)["ok"] is not refused
    assert got == want


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("router", ["reference", "port"])
def test_routers_drive_the_other_packages_workers(zoo, data, router,
                                                  rerank):
    """A reference router over the port's workers, and a port router over
    the reference's, answer as the clusters they came from."""
    backend, _, port, ref = zoo
    rerank = rerank and backend != "exact"
    if router == "reference":
        mixed = rcl.ClusterRouter(
            ref.spec, [rcl.ShardClient(c.name, c.replicas)
                       for c in port.shards], publish=False)
    else:
        mixed = ClusterRouter(
            port.spec, [tcl.ShardClient(c.name, c.replicas)
                        for c in ref.shards], publish=False, device="cpu")
    try:
        got = mixed.search(SearchRequest(data[1], k=K, ef=EF, rerank=rerank))
    finally:
        mixed._pool.shutdown(wait=True)
    want = ref.search(RefRequest(queries=data[1], k=K, ef=EF, rerank=rerank))
    _assert_same(_np(got), _np(want))


def test_cluster_json_byte_equal(zoo, tmp_path):
    """The zoo clusters' manifests, and one topology written by each
    package, are byte-equal; each package reads the other's."""
    backend, _, port, ref = zoo
    paths = {"port": port.path, "ref": ref.path}
    texts = {k: open(os.path.join(p, "cluster.json"), "rb").read()
             for k, p in paths.items()}
    assert texts["port"] == texts["ref"]
    assert read_topology(ref.path) == port.topology()
    topo = ClusterTopology(shards=(ShardInfo("s0", replicas=2, rows=100),
                                   ShardInfo("s1", rows=7)), version=3)
    rtopo = rcl.ClusterTopology(shards=(rcl.ShardInfo("s0", 2, 100),
                                        rcl.ShardInfo("s1", rows=7)),
                                version=3)
    write_topology(str(tmp_path / "p"), topo)
    rcl.write_topology(str(tmp_path / "r"), rtopo)
    assert ((tmp_path / "p" / "cluster.json").read_bytes()
            == (tmp_path / "r" / "cluster.json").read_bytes())
    assert read_topology(str(tmp_path / "r")) == topo
    assert rcl.read_topology(str(tmp_path / "p")) == rtopo


# ---------------------------------------------------------------------------
# failover and health
# ---------------------------------------------------------------------------


def test_failover_correctness_no_lost_or_duplicated(zoo, data):
    backend, single, port, _ = zoo
    q = data[1]
    want = _np(single.search(SearchRequest(q, k=K, ef=EF)))
    shard = port.shards[0]
    before = [rep.queries for rep in shard.replicas]
    shard.replicas[0].kill()
    rounds = 6
    try:
        for _ in range(rounds):
            _assert_same(_np(port.search(SearchRequest(q, k=K, ef=EF))), want)
        # exactly one replica served each request: nothing lost or doubled
        served = sum(rep.queries for rep in shard.replicas) - sum(before)
        assert served == rounds * q.shape[0]
        assert shard.failovers >= 1
    finally:
        shard.replicas[0].revive()
        shard.mark(0, True)


def test_transient_fault_fails_over(zoo, data):
    backend, single, port, _ = zoo
    q = data[1]
    want = _np(single.search(SearchRequest(q, k=K, ef=EF)))
    shard = port.shards[1]
    failovers = shard.failovers
    shard.replicas[0].inject_faults(1)
    for _ in range(4):              # round-robin guarantees a hit
        _assert_same(_np(port.search(SearchRequest(q, k=K, ef=EF))), want)
    assert shard.failovers > failovers
    for i in range(len(shard.replicas)):
        shard.mark(i, True)


def test_all_replicas_down_raises(data):
    v, q = data
    router = build_cluster(v[:300], _spec("exact"), 2, device="cpu")
    try:
        for rep in router.shards[0].replicas:
            rep.kill()
        with pytest.raises(ShardFault, match="no live replicas"):
            router.search(SearchRequest(q, k=5, ef=EF))
    finally:
        router.close()


def test_health_monitor_detects_and_revives(zoo):
    _, _, port, _ = zoo
    mon = HealthMonitor(port, interval_s=30.0, timeout_s=60.0)
    shard = port.shards[2]
    shard.replicas[1].kill()
    try:
        assert mon.probe_now()[shard.name] == [True, False]
        assert shard.live() == 1
    finally:
        shard.replicas[1].revive()
    assert mon.probe_now()[shard.name] == [True, True]
    assert shard.live() == 2
    port._monitor = None


# ---------------------------------------------------------------------------
# elasticity under live traffic
# ---------------------------------------------------------------------------


def test_elastic_add_shard_under_live_traffic(data, tmp_path):
    v, q = data
    spec = _spec("exact")
    router = build_cluster(v[:600], spec, 2, path=str(tmp_path),
                           device="cpu")
    errors, stop = [], threading.Event()

    def hammer():
        req = SearchRequest(q, k=5, ef=EF)
        while not stop.is_set():
            try:
                r = router.search(req)
                if tuple(r.ids.shape) != (q.shape[0], 5):
                    errors.append("bad shape")
            except Exception as exc:   # traffic must never see the swap
                errors.append(repr(exc))

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        newbie = make_shard(v[600:], spec, name="shard-new",
                            gid_map=np.arange(600, N), shard_index=2,
                            device="cpu")
        router.add_shard(newbie)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert router.topology().n_shards == 3
    assert read_topology(str(tmp_path)).version == router.version
    # the new shard's rows are served now, and the cluster is the
    # equivalent single index again
    r = router.search(SearchRequest(v[700:701], k=1, ef=EF))
    assert int(r.ids[0, 0]) == 700 and float(r.dists[0, 0]) == 0.0
    single = SearchService.build(v, spec, device="cpu")
    _assert_same(_np(router.search(SearchRequest(q, k=K, ef=EF))),
                 _np(single.search(SearchRequest(q, k=K, ef=EF))))
    router.close()


def test_add_remove_replica_publishes(data, tmp_path):
    v, _ = data
    router = build_cluster(v[:300], _spec("exact"), 2, path=str(tmp_path),
                           device="cpu")
    v0 = router.version
    name = router.shards[0].name
    primary = router.shards[0].replicas[0]
    router.add_replica(name, ShardWorker(name, primary.service,
                                         primary.gid_map, rid=1))
    assert len(router._client(name).replicas) == 2
    assert read_topology(str(tmp_path)).version == v0 + 1
    router.remove_replica(name, 1).close()
    assert len(router._client(name).replicas) == 1
    with pytest.raises(ValueError, match="last replica"):
        router.remove_replica(name, 0)
    with pytest.raises(KeyError):
        router.remove_shard("no-such-shard")
    router.close()


# ---------------------------------------------------------------------------
# cluster.json durability, topology math, the dtype gate
# ---------------------------------------------------------------------------


def test_manifest_crash_safety(tmp_path):
    td = str(tmp_path)
    topo = ClusterTopology(shards=(ShardInfo("s0", replicas=2, rows=100),),
                           version=1)
    write_topology(td, topo)
    # a crash mid-write leaves a torn tmp file; the committed manifest wins
    with open(os.path.join(td, "cluster.json.tmp"), "w") as f:
        f.write('{"torn": tru')
    assert read_topology(td) == topo
    with pytest.raises(ValueError, match="stale topology"):
        write_topology(td, ClusterTopology(shards=(ShardInfo("s0"),),
                                           version=1))
    write_topology(td, ClusterTopology(shards=(ShardInfo("s0"),),
                                       version=2))
    assert read_topology(td).version == 2


def test_manifest_format_check_and_empty_dir(tmp_path):
    assert read_topology(str(tmp_path)) == ClusterTopology()
    with open(tmp_path / "cluster.json", "w") as f:
        json.dump({"format": "something-else", "version": 1}, f)
    with pytest.raises(ValueError, match="format"):
        read_topology(str(tmp_path))


@pytest.mark.parametrize("n,p", [(900, 3), (1000, 7), (5, 5), (64, 1)])
def test_shard_bounds_match_both_packages(n, p):
    want = np.linspace(0, n, p + 1).astype(np.int64)
    np.testing.assert_array_equal(shard_bounds(n, p), want)
    np.testing.assert_array_equal(rcl.shard_bounds(n, p), want)


def test_shard_bounds_rejects_zero_shards():
    with pytest.raises(ValueError):
        shard_bounds(100, 0)


@pytest.mark.parametrize("q_per_shard,index", [(1, 0), (1, 1), (2, 0),
                                               (2, 3)])
def test_shard_spec_seed_schedule(q_per_shard, index):
    """shard i with q partitions gets seeds [i*q, i*q + q), as global
    partitions of the single index, and the reference's spec too."""
    spec = dataclasses.replace(_spec("partitioned"),
                               num_partitions=q_per_shard)
    got = shard_spec(spec, index, storage_path="/x/y")
    want = rcl.shard_spec(dataclasses.replace(
        _ref_spec("partitioned"), num_partitions=q_per_shard), index,
        storage_path="/x/y")
    assert got.hnsw.seed == HNSW["seed"] + index * q_per_shard
    assert got.num_partitions == q_per_shard
    assert got.storage_path == "/x/y"
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("dtype", ["uint8", "int8"])
def test_cluster_refuses_scalar_quantized(dtype):
    spec = dataclasses.replace(_spec("partitioned"), dtype=dtype)
    with pytest.raises(ValueError, match="float32 or pq only"):
        ClusterRouter(spec, [])


def test_pq_cluster_needs_fitted_codebooks():
    spec = dataclasses.replace(_spec("partitioned"), dtype="pq")
    with pytest.raises(ValueError, match="pre-fitted codebooks"):
        ClusterRouter(spec, [])


def test_cluster_entry_points_need_cuda_unless_cpu_is_asked(data,
                                                            monkeypatch):
    v, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_cluster(v[:100], _spec("exact"), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_shard(v[:100], _spec("exact"), name="s", gid_map=np.arange(100))


# ---------------------------------------------------------------------------
# serving integration: a cluster is just another dispatch target
# ---------------------------------------------------------------------------


def test_search_server_over_cluster(zoo, data):
    backend, single, port, _ = zoo
    q = data[1]
    assert _clone_service(port, 1) == (port, False)
    want = single.search(SearchRequest(q, k=5, ef=EF)).ids.numpy()
    with SearchServer(port, replicas=2, max_batch=4,
                      max_wait_ms=1.0) as srv:
        assert all(r.service is port for r in srv.pool.replicas)
        futs = srv.submit_many(q, k=5, ef=EF)
        got = np.stack([f.result(timeout=120).ids for f in futs])
        srv.drain()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags,single", [
    (["--shards", "3", "--shard-replicas", "2", "--partitions", "1"],
     ["--partitions", "3"]),
    (["--backend", "distributed", "--partitions", "2"],
     ["--partitions", "2"])], ids=["shards", "distributed"])
def test_serve_cli_matches_single_index(monkeypatch, capsys, flags, single):
    """`launch.serve --shards 3 --shard-replicas 2` and `--backend
    distributed` serve the single index's ids, rerank on."""
    from repro_torch.launch import serve

    served = []

    def loop(*args, **kw):
        ids, stats = serve_loop(*args, **kw)
        served.append(np.asarray(ids))
        return ids, stats

    serve_loop = serve.serve_loop
    monkeypatch.setattr(serve, "serve_loop", loop)
    base = ["--n", "300", "--dim", "16", "--batch", "8", "--num-batches",
            "2", "--M", "4", "--rerank", "--device", "cpu"]
    for extra in (flags, single):
        stats = serve.main(base + extra)
        assert stats["batches"] == 2
    out = capsys.readouterr().out
    assert ("3-shard partitioned cluster (x2 replicas" in out
            if "--shards" in flags else "building distributed index" in out)
    np.testing.assert_array_equal(served[0], served[1])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_cluster_matches_single_index(data):
    """2 shards x 2 replicas on the card (each worker on its own stream):
    bitwise the single index's answers, rerank off and on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    v, q = data
    spec = dataclasses.replace(_spec("partitioned"), fused_hops=4)
    router = build_cluster(v, spec, 2, replicas=2, device="cuda")
    try:
        single = SearchService.build(v, dataclasses.replace(
            spec, num_partitions=2), device="cuda")
        for rerank in (False, True):
            req = SearchRequest(q, k=K, ef=EF, rerank=rerank)
            want = single.search(req)
            got = router.search(req)
            np.testing.assert_array_equal(got.ids.numpy(),
                                          want.ids.cpu().numpy())
            np.testing.assert_array_equal(got.dists.numpy(),
                                          want.dists.cpu().numpy())
    finally:
        router.close()
