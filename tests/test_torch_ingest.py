"""The port's mutable segmented index (`repro_torch.ingest`) against the
reference's `repro.ingest`.

One pinned insert / delete / flush / search / compact script runs through
both packages' `MutableSearchService` on the same integer-valued rows
(every sum exact) for the exact, partitioned and csd backends, rerank off
and on: ids and dists bitwise equal at every search, and the same segment
count. Also, within the port: deleted gids never surface (before and
after compaction, rerank off and on), compaction equals a from-scratch
`SearchService.build` over the survivors, csd compaction equals the
in-memory partitioned build, the bounded csd memory assertion, serving
writes interleaved with batched reads, and the spec checks. Manifest v2
round-trips in both directions (port save -> reference load, reference
save -> port load, half compacted), and the immutable loader refuses it
with the reference's pointer. The numpy pieces (tombstones, the rank
merge, the memtable scan) are held to the reference's.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.api import IndexSpec as RefSpec
from repro.api import MutableSearchService as RefMutable
from repro.api import SearchRequest as RefRequest
from repro.core import merge as ref_merge
from repro.core.hnsw_graph import HNSWConfig as RefHNSW
from repro.ingest import Memtable as RefMemtable
from repro.ingest import TombstoneSet as RefTombstones
from repro_torch.api import (IndexSpec, MutableSearchService, SearchRequest,
                             SearchService)
from repro_torch.core import merge
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.data import VectorDataset
from repro_torch.ingest import Memtable, TombstoneSet
from repro_torch.serve import SearchServer

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

K, EF = 10, 40
HNSW = dict(M=8, ef_construction=40)
SEAL = 150


@pytest.fixture(scope="module")
def data():
    """600 integer-valued 16-d rows (0..255) and 8 queries."""
    ds = VectorDataset(600, 16, 8, seed=0)
    v = np.minimum(np.rint(ds.vectors()), 255.0).astype(np.float32)
    return v, np.rint(np.clip(ds.queries(8), 0, 255)).astype(np.float32)


def _spec_kw(backend, tmp_path, **kw):
    out = dict(backend=backend, num_partitions=2,
               keep_vectors=backend != "csd")
    if backend == "csd":
        out.update(storage_path=str(tmp_path / "store"), block_size=512,
                   cache_bytes=16384, prefetch=False)
    out.update(kw)
    return out


def _port(backend, tmp_path, seal=SEAL, **kw):
    return MutableSearchService(
        IndexSpec(hnsw=HNSWConfig(**HNSW), **_spec_kw(backend, tmp_path,
                                                      **kw)),
        seal_threshold=seal, device="cpu")


def _ref(backend, tmp_path, seal=SEAL, **kw):
    return RefMutable(RefSpec(hnsw=RefHNSW(**HNSW),
                              **_spec_kw(backend, tmp_path, **kw)),
                      seal_threshold=seal)


def _np(resp):
    return np.asarray(resp.ids), np.asarray(resp.dists)


def _script(svc, request, v, q, rerank):
    """The pinned write / read script: inserts that seal mid-stream,
    deletes of sealed and memtable rows, a flush and a compaction, a
    search after each step. Returns every search's (ids, dists), the
    segment counts and the gids deleted before each search."""
    out, segs, dead, gone = [], [], [], []

    def look():
        out.append(_np(svc.search(request(q, k=K, ef=EF, rerank=rerank))))
        segs.append(svc.num_segments)
        gone.append(np.concatenate(dead) if dead else np.zeros(0))

    def delete(gids):
        svc.delete(gids)
        dead.append(gids)

    g1 = svc.insert(v[:200])              # one seal, 50 rows in the memtable
    look()
    delete(g1[::7])                       # sealed and memtable rows
    look()
    g2 = svc.insert(v[200:450])
    delete(g2[1::5])
    look()
    svc.flush()
    look()
    svc.compact()
    look()
    g3 = svc.insert(v[450:520])           # a memtable beside the merged one
    delete(g3[:3])
    look()
    return out, segs, gone


@pytest.mark.parametrize("backend", ["exact", "partitioned", "csd"])
@pytest.mark.parametrize("rerank", [False, True])
def test_script_matches_reference(data, tmp_path, backend, rerank):
    v, q = data
    port = _port(backend, tmp_path / "port")
    ref = _ref(backend, tmp_path / "ref")
    got, got_segs, dead = _script(port, SearchRequest, v, q, rerank)
    want, want_segs, _ = _script(ref, RefRequest, v, q, rerank)
    assert got_segs == want_segs
    for step, ((gi, gd), (wi, wd)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gi, wi, err_msg=f"ids, step {step}")
        np.testing.assert_array_equal(gd, wd, err_msg=f"dists, step {step}")
        assert gi.dtype == np.int64
    for (gi, _), gone in zip(got, dead):
        assert not np.isin(gi, gone).any()
    assert port.size == ref.size
    port.close()
    ref.close()


def _gt_of(vectors, gids, queries, k=K):
    d2 = (np.einsum("nd,nd->n", vectors, vectors)[None]
          - 2 * queries @ vectors.T
          + np.einsum("qd,qd->q", queries, queries)[:, None])
    return gids[np.argsort(d2, axis=1, kind="stable")[:, :k]]


@pytest.mark.parametrize("backend", ["partitioned", "csd"])
def test_deletes_never_surface_including_rerank(data, tmp_path, backend):
    """Delete the true nearest neighbours, so filtering is load-bearing."""
    v, q = data
    svc = _port(backend, tmp_path)
    svc.insert(v)
    dele = np.unique(_gt_of(v, np.arange(len(v)), q, k=5).ravel())
    assert svc.delete(dele) == len(dele)
    for rerank in (False, True):
        ids = np.asarray(svc.search(SearchRequest(q, k=K, ef=EF,
                                                  rerank=rerank)).ids)
        assert not np.isin(ids, dele).any(), f"rerank={rerank}"
        assert (ids[:, 0] >= 0).all()
    svc.compact()
    for rerank in (False, True):
        ids = np.asarray(svc.search(SearchRequest(q, k=K, ef=EF,
                                                  rerank=rerank)).ids)
        assert not np.isin(ids, dele).any()
    assert svc.size == len(v) - len(dele)
    svc.close()


@pytest.mark.parametrize("backend", ["exact", "partitioned", "csd"])
def test_compaction_equals_fresh_build(data, tmp_path, backend):
    """compact() == SearchService.build over the survivors (csd against
    the in-memory partitioned build): bitwise ids (remapped to global)
    and dists, rerank off and on."""
    v, q = data
    svc = _port(backend, tmp_path)
    g = svc.insert(v[:500])
    dead = np.concatenate([g[::6], g[5::11]])
    svc.delete(dead)
    svc.compact()
    assert svc.num_segments == 1
    alive = np.setdiff1d(g, dead)
    spec = dataclasses.replace(
        svc.spec, backend="partitioned" if backend == "csd" else backend,
        storage_path=None, keep_vectors=True)
    fresh = SearchService.build(v[alive], spec, device="cpu")
    for rerank in ((False, True) if backend != "exact" else (False,)):
        got = svc.search(SearchRequest(q, k=K, ef=EF, rerank=rerank))
        want = fresh.search(SearchRequest(q, k=K, ef=EF, rerank=rerank))
        wi = want.ids.numpy()
        np.testing.assert_array_equal(
            got.ids.numpy(), np.where(wi >= 0, alive[np.maximum(wi, 0)], -1))
        np.testing.assert_array_equal(got.dists.numpy(), want.dists.numpy())
    svc.close()


def test_memtable_seal_parity_exact_backend(data, tmp_path):
    """Exact backend: sealing is a pure representation change — the
    sealed segment answers bitwise as the pre-seal memtable scan."""
    v, q = data
    svc = _port("exact", tmp_path, seal=1000)
    svc.insert(v[:200])
    req = SearchRequest(q, k=K, ef=EF)
    pre = svc.search(req)
    assert svc.num_segments == 0
    svc.flush()
    assert svc.num_segments == 1
    post = svc.search(req)
    assert torch.equal(pre.ids, post.ids)
    assert torch.equal(pre.dists, post.dists)


@pytest.mark.parametrize("backend", ["partitioned", "csd"])
@pytest.mark.parametrize("direction", ["port -> reference",
                                       "reference -> port"])
def test_manifest_v2_roundtrips(data, tmp_path, backend, direction):
    """A half-compacted index (segments, tombstones and an unsealed
    memtable) saved by one package loads in the other and answers bitwise;
    the manifests are byte-identical."""
    v, q = data
    port = _port(backend, tmp_path / "port")
    ref = _ref(backend, tmp_path / "ref")
    for svc in (port, ref):
        g = svc.insert(v[:330])
        svc.delete(g[::9])
        svc.insert(v[330:420])
        assert svc.num_segments > 1 and svc.size
    path = str(tmp_path / "saved")
    if direction == "port -> reference":
        port.save(path)
        loaded, src, req = RefMutable.load(path), port, SearchRequest
        ref.save(str(tmp_path / "other"))
        other = str(tmp_path / "other")
    else:
        ref.save(path)
        loaded = MutableSearchService.load(path, device="cpu")
        src, req = ref, RefRequest
        port.save(str(tmp_path / "other"))
        other = str(tmp_path / "other")
    assert loaded.num_segments == src.num_segments
    assert loaded.size == src.size
    if backend != "csd":      # csd manifests name their own store paths
        with open(os.path.join(path, "index_manifest.json")) as a, \
                open(os.path.join(other, "index_manifest.json")) as b:
            assert a.read() == b.read()
    lr = RefRequest if isinstance(loaded, RefMutable) else SearchRequest
    for rerank in (False, True):
        a = _np(src.search(req(q, k=K, ef=EF, rerank=rerank)))
        b = _np(loaded.search(lr(q, k=K, ef=EF, rerank=rerank)))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    new = loaded.insert(v[420:423])
    assert new.min() >= 420
    for svc in (port, ref, loaded):
        svc.close()


def test_search_service_load_refuses_v2_with_a_pointer(data, tmp_path):
    v, _ = data
    svc = _port("partitioned", tmp_path)
    svc.insert(v[:160])
    svc.save(str(tmp_path / "saved"))
    with open(tmp_path / "saved" / "index_manifest.json") as f:
        assert json.load(f)["format_version"] == 2
    with pytest.raises(ValueError, match=r"format_version=2.*a mutable "
                       r"segmented index — open it with "
                       r"repro_torch\.api\.MutableSearchService\.load"):
        SearchService.load(str(tmp_path / "saved"), device="cpu")


def test_csd_streaming_ingest_bounded_memory(data, tmp_path):
    """Peak resident store memory during csd streaming ingest stays inside
    the (re-split) cache_bytes budget + the memtable buffer, however many
    segments accumulate."""
    v, q = data
    spec = IndexSpec(backend="csd", num_partitions=1,
                     hnsw=HNSWConfig(**HNSW),
                     storage_path=str(tmp_path / "store"), block_size=512,
                     cache_bytes=8192, prefetch=False)
    svc = MutableSearchService(spec, seal_threshold=60, device="cpu")
    mem_peak = 0
    for lo in range(0, len(v), 50):
        svc.insert(v[lo: lo + 50])
        svc.search(SearchRequest(q[:4], k=K, ef=EF, with_stats=True))
        mem_peak = max(mem_peak, svc.resident_bytes()
                       - svc.storage_resident_bytes())
    assert svc.num_segments >= 8
    cache_bound = max(spec.cache_bytes, svc.num_segments * spec.block_size)
    assert 0 < svc.peak_storage_resident_bytes <= cache_bound
    assert svc.peak_resident_bytes <= cache_bound + mem_peak
    svc.close()


def test_per_segment_stats_reported(data, tmp_path):
    v, q = data
    svc = _port("csd", tmp_path, seal=200)
    svc.insert(v[:500])
    st = svc.search(SearchRequest(q, k=K, ef=EF, with_stats=True)).stats
    names = [row["segment"] for row in st.segments]
    assert len(names) == svc.num_segments + 1 and names[-1] == "memtable"
    assert st.block_reads and st.block_reads == sum(
        row.get("block_reads", 0) for row in st.segments)
    assert (st.dist_calcs.numpy() > 0).all()
    svc.close()


def test_serve_interleaves_writes_with_batched_reads(data, tmp_path):
    """Mutations through the port's SearchServer are visible to every batch
    dispatched after they return, and deleted ids never appear in
    post-delete batches."""
    v, q = data
    svc = _port("partitioned", tmp_path, seal=120)
    with SearchServer(svc, replicas=2, max_batch=4, max_wait_ms=1.0) as srv:
        assert all(r.service is svc for r in srv.pool.replicas)
        srv.insert(v[:400])
        res = [f.result(timeout=120)
               for f in srv.submit_many(q, k=K, ef=EF)]
        assert all((r.ids >= 0).all() for r in res)
        dele = np.unique(_gt_of(v[:400], np.arange(400), q, k=3).ravel())
        assert srv.delete(dele) == len(dele)
        srv.insert(v[400:])
        for f in srv.submit_many(q, k=K, ef=EF, rerank=True):
            assert not np.isin(f.result(timeout=120).ids, dele).any()
        srv.flush_index()
        srv.compact_index()
        assert svc.num_segments == 1
        direct = svc.search(SearchRequest(q, k=K, ef=EF)).ids.numpy()
        res = [f.result(timeout=120)
               for f in srv.submit_many(q, k=K, ef=EF)]
        for r in res:
            assert (r.ids >= 0).all() and not np.isin(r.ids, dele).any()
        np.testing.assert_array_equal(np.stack([r.ids for r in res]),
                                      direct)
    svc.close()


def test_immutable_service_rejects_mutations(data):
    svc = SearchService.build(data[0][:256], IndexSpec(backend="exact"),
                              device="cpu")
    with SearchServer(svc, replicas=1) as srv:
        with pytest.raises(TypeError, match="immutable"):
            srv.insert(data[0][:1])


def test_mutable_spec_validation():
    with pytest.raises(ValueError, match="distributed"):
        MutableSearchService(IndexSpec(backend="distributed"), device="cpu")
    with pytest.raises(ValueError, match="float32-only"):
        MutableSearchService(IndexSpec(backend="partitioned", dtype="uint8",
                                       qscale=1.0, qzero=0), device="cpu")
    with pytest.raises(ValueError, match="graph-safe"):
        MutableSearchService(IndexSpec(backend="partitioned", metric="ip"),
                             device="cpu")
    with pytest.raises(ValueError, match="storage_path"):
        MutableSearchService(IndexSpec(backend="csd"), device="cpu")
    svc = MutableSearchService(IndexSpec(backend="exact", metric="ip"),
                               device="cpu")
    svc.insert(np.eye(4, dtype=np.float32))
    ids = svc.search(SearchRequest(np.eye(4, dtype=np.float32)[:1], k=1)).ids
    assert int(ids[0, 0]) == 0


def test_mutable_needs_cuda_unless_cpu_is_asked(data, tmp_path,
                                                monkeypatch):
    svc = _port("exact", tmp_path)
    svc.insert(data[0][:20])
    svc.save(str(tmp_path / "saved"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MutableSearchService(IndexSpec(backend="exact"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MutableSearchService.load(str(tmp_path / "saved"))
    loaded = MutableSearchService.load(str(tmp_path / "saved"), device="cpu")
    assert loaded.device == torch.device("cpu") and loaded.size == 20


# ---------------------------------------------------------------------------
# the numpy pieces against the reference's
# ---------------------------------------------------------------------------


def test_tombstones_match_reference():
    rng = np.random.default_rng(0)
    port, ref = TombstoneSet(), RefTombstones()
    for step in range(6):
        ids = rng.integers(0, 200 * (step + 1), 40)
        assert port.add(ids) == ref.add(ids)
        drop = ids[::3]
        port.discard(drop)
        ref.discard(drop)
        probe = np.arange(-2, 210 * (step + 1))
        np.testing.assert_array_equal(port.contains(probe),
                                      ref.contains(probe))
        np.testing.assert_array_equal(port.words(), ref.words())
        assert len(port) == len(ref)


def test_rank_merge_matches_reference():
    """Ties across sources (the stable argsort's order), dead lanes, and
    fewer candidates than k."""
    rng = np.random.default_rng(1)
    ids = [rng.integers(0, 50, (5, 4)), rng.integers(50, 99, (5, 3))]
    dists = [np.sort(rng.integers(0, 6, (5, 4)).astype(np.float32), 1),
             np.sort(rng.integers(0, 6, (5, 3)).astype(np.float32), 1)]
    dead = [d > 4 for d in dists]
    for k in (4, 10):
        masked = [merge.mask_dead_lanes(i, d, m)
                  for i, d, m in zip(ids, dists, dead)]
        ref_masked = [ref_merge.mask_dead_lanes(i, d, m)
                      for i, d, m in zip(ids, dists, dead)]
        for a, b in zip(masked, ref_masked):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        got = merge.rank_merge([m[0] for m in masked],
                               [m[1] for m in masked], k)
        want = ref_merge.rank_merge([m[0] for m in ref_masked],
                                    [m[1] for m in ref_masked], k)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_memtable_scan_matches_reference(data, metric):
    """The memtable's exact scan on the device (here the CPU) against the
    reference's, on global ids, with fewer rows than k and past one
    CHUNK."""
    v, q = data
    gids = np.arange(len(v), dtype=np.int64) * 3 + 7
    for n, k in ((6, K), (len(v), K), (len(v), 1)):
        got = Memtable.scan(v[:n], gids[:n], q, k, metric,
                            torch.device("cpu"))
        want = RefMemtable.scan(v[:n], gids[:n], q, k, metric)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
