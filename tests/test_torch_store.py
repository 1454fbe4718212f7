"""The port's block store and out-of-core `csd` backend against the reference.

One partitioned DB a row type (P=2, HNSW M=8, PQ at pq_m=4 with integer
codebooks) is built once with the port's numpy builder, which is
byte-identical to the reference's, and each package writes its own csd
block store from it. On integer-valued rows every sum is exact, so:

* the two packages' block stores are byte-identical, each opens the
  other's, and a csd index saved by either loads in the other;
* the port's csd answers bitwise as the reference's csd — ids, dists,
  hops, dist_calcs, supersteps and the page cache's counters — for l2, ip
  and cosine, float32 / uint8 / int8 / pq rows, fused_hops 1 and 4, rerank
  off and on (each test opens fresh readers of the stores in both
  packages, so the caches see one access sequence);
* inside the port, csd answers bitwise as `partitioned`, its resident
  cache stays within `cache_bytes`, and the prefetcher changes no result.

Also: the PageCache's LRU and counters against the reference's on one
access sequence, the store's crash-safety cases, and one search's span
and metric names in both packages.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.api import IndexSpec as RefSpec
from repro.api import SearchRequest as RefRequest
from repro.api import SearchService as RefService
from repro.core import hnsw_graph as rhg
from repro.core.partitioned import PartitionedDB as RefPDB
from repro.store import BlockFile as RefBlockFile
from repro.store import CSDBackend as RefCSD
from repro.store import PageCache as RefPageCache
from repro.store import open_store as ref_open_store
from repro_torch import obs
from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.api.backends import PartitionedBackend
from repro_torch.core import hnsw_graph as thg
from repro_torch.core.partitioned import (build_partitioned_db,
                                          quantize_db_vectors)
from repro_torch.data import VectorDataset
from repro_torch.optim.compression import PQQuantizer, VectorQuantizer
from repro_torch.store import (BlockFile, BlockFileWriter, CSDBackend,
                               PageCache, StoreFormatError, open_store)
from repro_torch.store.layout import to_host

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

K, EF, PQ_M, BLOCK = 10, 40, 4, 4096
CACHE = 8 * BLOCK                  # a few blocks: every hop evicts
HNSW = thg.HNSWConfig(M=8, ef_construction=40)
DTYPES = ("float32", "uint8", "int8", "pq")


@pytest.fixture(scope="module")
def data():
    """Integer-valued rows in 0..255 (max 255: uint8 quantizes them to
    themselves) and queries."""
    ds = VectorDataset(1500, 32, 12, seed=3)
    v = np.minimum(np.rint(ds.vectors()), 255.0)
    v[0, 0] = 255.0
    return v, np.rint(np.clip(ds.queries(16), 0, 255))


@pytest.fixture(scope="module")
def indexes(data):
    """dtype -> the port's partitioned service on the CPU (keep_vectors)
    and its numpy PartitionedDB. Two graph builds: float32 (shared by
    uint8, whose quantizer is the identity here, and pq, whose graph is
    built at full precision) and int8 (over its codes; max 254 gives the
    exact scale 2, so decoded rows are integers too)."""
    v, _ = data
    base = IndexSpec(num_partitions=2, hnsw=HNSW, keep_vectors=True)
    pdb = build_partitioned_db(v, 2, HNSW)
    out = {}

    def add(dtype, spec, pdb_d, raw):
        be = PartitionedBackend(spec, pdb_d, raw, "cpu")
        out[dtype] = {"svc": SearchService(spec, be), "pdb": pdb_d}

    add("float32", base, pdb, v)
    u8 = VectorQuantizer.fit(v, "uint8")
    assert (u8.scale, u8.zero_point) == (1.0, 0)
    add("uint8", dataclasses.replace(base, dtype="uint8", qscale=1.0,
                                     qzero=0),
        quantize_db_vectors(pdb, "uint8"), u8.encode(v))
    v8 = np.minimum(v, 254.0)
    v8[0, 0] = 254.0
    i8 = VectorQuantizer.fit(v8, "int8")
    codes8 = i8.encode(v8)
    add("int8", dataclasses.replace(base, dtype="int8", qscale=i8.scale,
                                    qzero=i8.zero_point),
        quantize_db_vectors(build_partitioned_db(codes8, 2, HNSW), "int8"),
        codes8)
    cb = np.rint(PQQuantizer.fit(v, PQ_M, seed=0).codebooks).tolist()
    spec = dataclasses.replace(base, dtype="pq", pq_m=PQ_M, pq_codebooks=cb)
    add("pq", spec, quantize_db_vectors(pdb, "pq", spec.quantizer()), v)
    return out


def _csd_spec(spec, path, **kw):
    kw = {"prefetch": False, **kw}
    return dataclasses.replace(spec, backend="csd", keep_vectors=False,
                               storage_path=path, block_size=BLOCK,
                               cache_bytes=CACHE, **kw)


def _ref_spec(spec):
    return RefSpec.from_json(json.loads(json.dumps(spec.to_json())))


@pytest.fixture(scope="module")
def stores(indexes, tmp_path_factory):
    """dtype -> (port store path, reference store path), each package's
    CSDBackend.from_partitioned over the same DB (pq: the code DB and the
    float32 rows for the `rerank_vectors` table)."""
    out = {}
    for dtype in DTYPES:
        svc, pdb = indexes[dtype]["svc"], indexes[dtype]["pdb"]
        raw = svc.backend.raw if dtype == "pq" else None
        port = str(tmp_path_factory.mktemp(f"port-{dtype}") / "store")
        ref = str(tmp_path_factory.mktemp(f"ref-{dtype}") / "store")
        CSDBackend.from_partitioned(pdb, _csd_spec(svc.spec, port), raw=raw,
                                    device="cpu")
        RefCSD.from_partitioned(
            RefPDB(db=rhg.DeviceDB(*to_host(pdb.db)),
                   num_partitions=pdb.num_partitions, dim=pdb.dim),
            _ref_spec(_csd_spec(svc.spec, ref)), raw=raw)
        out[dtype] = port, ref
    return out


def _backends(indexes, stores, dtype, path=None, **kw):
    """Fresh (port, reference) csd backends over the two stores (or both
    over `path`), cold caches; `kw` changes the spec (metric, fused_hops,
    prefetch)."""
    spec = indexes[dtype]["svc"].spec
    port_path, ref_path = stores[dtype]
    ps = _csd_spec(spec, path or port_path, **kw)
    rs = _ref_spec(_csd_spec(spec, path or ref_path, **kw))
    return CSDBackend.from_state(ps, {}, "cpu"), RefCSD.from_state(rs, {})


def _queries(indexes, data, dtype):
    """The queries a backend sees: codes as float32 for uint8 / int8."""
    q = data[1]
    quant = indexes[dtype]["svc"].quantizer
    return quant.encode_f32(q) if dtype in ("uint8", "int8") else q


_STORAGE = ("block_reads", "cache_hits", "cache_misses", "cache_hit_rate",
            "bytes_read", "supersteps")


def _answer(be, q, rerank):
    """ids, dists, hops, dist_calcs as numpy, and the storage counters."""
    ids, dists, st = be.search(q, K, EF, rerank, True)
    arrays = [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
              for a in (ids, dists, st.hops, st.dist_calcs)]
    return arrays, {f: getattr(st, f) for f in _STORAGE}


def _assert_same(got, want):
    for name, a, b in zip(("ids", "dists", "hops", "dist_calcs"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# the block store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_store_bytes_match_reference(stores, dtype):
    """write_store (through CSDBackend.from_partitioned) writes the
    reference's data file, manifest and commit marker byte for byte; the
    pq store carries the `rerank_vectors` table."""
    port, ref = stores[dtype]
    for name in ("blocks.bin", "store_manifest.json", "_COMMITTED"):
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    tables = BlockFile(port).tables
    assert ("rerank_vectors" in tables) == (dtype == "pq")


@pytest.mark.parametrize("dtype", ["float32", "pq"])
def test_each_package_opens_the_others_store(stores, dtype):
    port_path, ref_path = stores[dtype]
    mine, theirs = open_store(port_path, CACHE, False), ref_open_store(
        ref_path, CACHE, prefetch=False)
    cross = (open_store(ref_path, CACHE, False),
             ref_open_store(port_path, CACHE, prefetch=False))
    for name, t in mine.blockfile.tables.items():
        rows = np.arange(t["rows"])
        want = theirs.read_rows(name, rows)
        for reader in (mine, *cross):
            np.testing.assert_array_equal(reader.read_rows(name, rows), want)
    assert mine.meta == theirs.meta
    for a, b in zip(mine.load_db(), theirs.load_db()):
        np.testing.assert_array_equal(a, b)


def _tiny_store(path, blocks=8, block_size=BLOCK):
    """One int32 table, exactly one row per block."""
    rows = np.arange(blocks * block_size // 4,
                     dtype=np.int32).reshape(blocks, -1)
    w = BlockFileWriter(str(path), block_size)
    w.add_table("t", rows)
    w.finalize({"note": "tiny"})
    return rows


@pytest.mark.parametrize("case", ["no commit marker", "truncated data",
                                  "rewrite clears the stale commit"])
def test_crash_safety(tmp_path, case):
    """A store without its commit marker, with a data file shorter than its
    manifest, or half rewritten, is refused."""
    s = tmp_path / "s"
    _tiny_store(s)
    if case == "no commit marker":
        os.remove(s / "_COMMITTED")
        match = "commit marker"
    elif case == "truncated data":
        with open(s / "blocks.bin", "r+b") as f:
            f.truncate(BLOCK)
        match = "data file"
    else:
        BlockFileWriter(str(s), BLOCK)   # a writer that dies mid-rewrite
        match = "commit marker"
    with pytest.raises(StoreFormatError, match=match):
        BlockFile(str(s))


def test_page_cache_matches_reference(tmp_path):
    """The same access sequence (demand reads, prefetches, worker-side
    reads, a resize) through both packages' PageCache over one store:
    equal bytes and equal counters after every step."""
    rows = _tiny_store(tmp_path / "s", blocks=16)
    port = PageCache(BlockFile(str(tmp_path / "s")), 3 * BLOCK)
    ref = RefPageCache(RefBlockFile(str(tmp_path / "s")), 3 * BLOCK)
    rng = np.random.default_rng(0)
    ops = [("get", int(b)) for b in rng.integers(0, 16, 40)]
    ops[5:5] = [("prefetch", 7), ("prefetch", 7), ("prefetch_get", 9)]
    ops[20:20] = [("get_many", [3, 4, 3, 5]), ("resize", 2 * BLOCK)]
    for op, arg in ops:
        got = [getattr(c, op)(arg) for c in (port, ref)]
        if op in ("get", "prefetch_get"):
            assert got[0] == got[1] == rows[arg].tobytes()
        assert port.snapshot() == ref.snapshot(), (op, arg)
    assert port.hit_rate == ref.hit_rate
    assert port.evictions > 0 and port.peak_bytes <= 3 * BLOCK


# ---------------------------------------------------------------------------
# csd against the reference's csd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,metric,hops,rerank", [
    ("float32", "l2", 1, False), ("float32", "l2", 1, True),
    ("float32", "l2", 4, False), ("float32", "l2", 4, True),
    ("float32", "ip", 1, True), ("float32", "ip", 4, False),
    ("float32", "cosine", 1, False), ("float32", "cosine", 4, True),
    *[(dt, "l2", h, r) for dt in ("uint8", "int8", "pq") for h in (1, 4)
      for r in (False, True)],
])
def test_csd_matches_reference(indexes, stores, data, dtype, metric, hops,
                               rerank):
    """Bitwise in ids, dists, hops, dist_calcs, supersteps and the cache
    counters (block reads, hits, misses, hit rate, bytes), each package
    over its own store with a cold cache of 8 blocks."""
    port, ref = _backends(indexes, stores, dtype, metric=metric,
                          fused_hops=hops)
    q = _queries(indexes, data, dtype)
    got, got_io = _answer(port, q, rerank)
    want, want_io = _answer(ref, q, rerank)
    _assert_same(got, want)
    assert got_io == want_io
    assert got_io["block_reads"] > 0
    assert port.reader.cache.snapshot() == ref.reader.cache.snapshot()


# ---------------------------------------------------------------------------
# csd inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_csd_equals_partitioned(indexes, stores, data, dtype):
    """csd = partitioned bitwise through the service, fused_hops 1 and 4,
    rerank off and on; the resident cache never passes `cache_bytes`, and
    4-hop supersteps take fewer host syncs than single hops."""
    part = indexes[dtype]["svc"]
    steps = {}
    for hops in (1, 4):
        be, _ = _backends(indexes, stores, dtype, fused_hops=hops)
        csd = SearchService(be.spec, be)
        part.backend.spec = dataclasses.replace(part.spec, fused_hops=hops)
        try:
            for rerank in (False, True):
                outs = []
                for svc in (csd, part):
                    r = svc.search(SearchRequest(data[1], k=K, ef=EF,
                                                 rerank=rerank,
                                                 with_stats=True))
                    outs.append([t.numpy() for t in (
                        r.ids, r.dists, r.stats.hops, r.stats.dist_calcs)])
                    if svc is csd:
                        steps[hops, rerank] = r.stats.supersteps
                        assert r.stats.block_reads > 0
                _assert_same(*outs)
        finally:
            part.backend.spec = part.spec
        cache = be.reader.cache
        assert 0 < cache.peak_bytes <= cache.capacity_bytes == CACHE
    assert steps[4, False] < steps[1, False]


def test_prefetcher_changes_no_result(indexes, stores, data):
    """The next-hop prefetcher (hop-stepped path) reads ahead into the
    cache; the answers stay bitwise those without it."""
    q = data[1]
    outs = []
    for prefetch in (False, True):
        be, _ = _backends(indexes, stores, "float32", fused_hops=1,
                          prefetch=prefetch)
        try:
            outs.append(_answer(be, q, False)[0])
            if prefetch:
                be.reader.prefetcher.drain()
                assert be.reader.cache.prefetch_reads > 0
                assert be.reader.cache.peak_bytes <= CACHE
        finally:
            be.reader.close()
    _assert_same(outs[1], outs[0])


@pytest.mark.parametrize("direction", ["port -> reference",
                                       "reference -> port"])
def test_csd_index_saved_by_either_loads_in_the_other(indexes, stores, data,
                                                      tmp_path, direction):
    """The index manifest points at the block store (`storage_path`); the
    checkpoint holds only its format tag."""
    port, ref = _backends(indexes, stores, "uint8", fused_hops=4)
    q = data[1]
    if direction == "port -> reference":
        SearchService(port.spec, port).save(str(tmp_path))
        loaded = RefService.load(str(tmp_path))
        want = SearchService(port.spec, port)
        got = loaded.search(RefRequest(q, k=K, ef=EF, with_stats=True))
        r = want.search(SearchRequest(q, k=K, ef=EF, with_stats=True))
    else:
        RefService(ref.spec, ref).save(str(tmp_path))
        loaded = SearchService.load(str(tmp_path), device="cpu")
        assert loaded.device == torch.device("cpu")
        got = loaded.search(SearchRequest(q, k=K, ef=EF, with_stats=True))
        r = RefService(ref.spec, ref).search(RefRequest(q, k=K, ef=EF,
                                                        with_stats=True))
    assert loaded.spec.backend == "csd" and loaded.spec.fused_hops == 4
    for a, b in ((got.ids, r.ids), (got.dists, r.dists),
                 (got.stats.hops, r.stats.hops)):
        np.testing.assert_array_equal(
            np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a),
            np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b))


def test_csd_needs_cuda_unless_cpu_is_asked(indexes, stores, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _csd_spec(indexes["float32"]["svc"].spec, stores["float32"][0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CSDBackend.from_state(spec, {})


# ---------------------------------------------------------------------------
# obs: the same spans and metrics in both packages
# ---------------------------------------------------------------------------


def _names(snap, be):
    """Metric names of one backend's series: its csd collector, its page
    cache's, the API counters of backend "csd" and the fused-hops gauge."""
    ours = {be.uid, be.reader.cache.uid, "csd"}
    return {s["name"] for kind in ("counters", "gauges")
            for s in snap[kind]
            if ours & set(s["labels"].values())
            or s["name"] == "traversal_fused_hops"}


@pytest.mark.parametrize("hops", [1, 4])
def test_search_emits_the_reference_span_and_metric_names(indexes, stores,
                                                          data, hops):
    port, ref = _backends(indexes, stores, "float32", fused_hops=hops)
    q = data[1]
    spans = {}
    for name, tracer, run in (
            ("port", obs.TRACER, lambda: SearchService(port.spec, port).search(
                SearchRequest(q, k=K, ef=EF, rerank=True))),
            ("ref", ref_obs.TRACER, lambda: RefService(ref.spec, ref).search(
                RefRequest(q, k=K, ef=EF, rerank=True)))):
        tracer.configure(enabled=True, sample_rate=1.0)
        tracer.clear()
        try:
            run()
            spans[name] = {ev["name"] for ev in tracer.spans()}
        finally:
            tracer.configure(enabled=False)
            tracer.clear()
    assert spans["port"] == spans["ref"]
    assert {"search", "traversal", "store-read", "hop-kernel",
            "rerank"} <= spans["port"]
    assert ("hop_superstep" if hops > 1 else "hop") in spans["port"]
    got = _names(obs.REGISTRY.snapshot(), port)
    assert got == _names(ref_obs.REGISTRY.snapshot(), ref)
    assert {"api_searches_total", "api_queries_total", "csd_queries_total",
            "store_block_reads_total", "store_cache_peak_bytes",
            "traversal_fused_hops"} <= got
