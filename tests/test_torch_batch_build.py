"""The batched graph build (`core/batch_build.py`) and the graph path's
spans, on the CPU.

On integer-valued clustered rows, 1,000 a partition, built at P = 1 and
P = 4 by `build_graphs` (the plain traversal, since the tensors are on
the CPU) and by the host's `build_hnsw`: the levels, entry point and
upper-table rows are `build_hnsw`'s; every list holds unique, valid ids,
no self-link and at most maxM0 / maxM; every point is reachable at layer
0; builds are byte-identical, and a partition of a P = 4 build is the
P = 1 build of its rows; recall@10 at ef 40 holds to the host graph's.
`select_heuristic` is the host's `_select_heuristic` where no two
distances tie. The `partitioned-batched` service builds, searches, saves
and reloads to identical answers, and records `build` > `insert` and
`search` > `descend`, `layer0`, `merge` with their attrs.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.api.backends import PartitionedBatchedBackend
from repro_torch.core import batch_build as bb
from repro_torch.core import hnsw_graph as hg
from repro_torch.core.bruteforce import bruteforce_topk
from repro_torch.core.partitioned import (build_partitioned_db,
                                          search_partitioned)
from repro_torch.core.search import SearchParams
from repro_torch.obs.trace import TRACER

torch.set_num_threads(1)

N_PART, DIM, K, EF = 1000, 16, 10, 40
CFG = hg.HNSWConfig(M=8, ef_construction=32, seed=3)


def _rows(n: int, seed: int) -> np.ndarray:
    """Integer-valued clustered rows in [0, 255] (float32)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 200, (64, DIM))
    x = centres[rng.integers(0, 64, n)] + rng.normal(0, 40, (n, DIM))
    return np.rint(np.clip(x, 0, 255)).astype(np.float32)


ROWS = _rows(4 * N_PART, 0)
QUERIES = _rows(200, 1)


def _cfgs(p: int) -> list:
    return [hg.HNSWConfig(**{**CFG.__dict__, "seed": CFG.seed + i})
            for i in range(p)]


def _parts(p: int) -> list:
    return [ROWS[i * N_PART:(i + 1) * N_PART] for i in range(p)]


@pytest.fixture(scope="module")
def host():
    """build_hnsw's graph of each of the 4 partitions."""
    return [hg.build_hnsw(v, c) for v, c in zip(_parts(4), _cfgs(4))]


@pytest.fixture(scope="module")
def batched():
    """P -> the batched build's graphs."""
    return {p: bb.build_graphs(_parts(p), _cfgs(p), "cpu") for p in (1, 4)}


def _db(graphs, p):
    pdb = build_partitioned_db(ROWS[:p * N_PART], p, CFG,
                               lambda parts, cfgs: graphs[:p])
    return pdb._replace(db=hg.device_db(pdb.db, "cpu"))


def _recall(pdb, p):
    ids, _, _ = search_partitioned(pdb, torch.as_tensor(QUERIES),
                                   SearchParams(ef=EF, k=K))
    x = torch.as_tensor(ROWS[:p * N_PART])
    n_pad = -(-len(x) // 512) * 512
    xp = torch.zeros((n_pad, DIM))
    xp[:len(x)] = x
    sq = torch.full((n_pad,), float("inf"))
    sq[:len(x)] = (x * x).sum(1)
    gt, _ = bruteforce_topk(xp, sq, torch.as_tensor(QUERIES), k=K, chunk=512)
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                    for a, b in zip(ids, gt)])


@pytest.mark.parametrize("p", [1, 4])
def test_levels_entry_and_upper_rows_are_build_hnsws(host, batched, p):
    for g, h, c in zip(batched[p], host, _cfgs(p)):
        np.testing.assert_array_equal(g.levels, h.levels)
        np.testing.assert_array_equal(g.levels, hg.draw_levels(N_PART, c))
        np.testing.assert_array_equal(g.up_ptr, h.up_ptr)
        assert g.up_nbrs.shape == h.up_nbrs.shape
        assert (g.entry, g.max_level) == (h.entry, h.max_level)
        assert g.entry == int(np.argmax(g.levels))


def _check_lists(table, ids_ok, width):
    """Each row: unique ids of `ids_ok` (bool over ids), then -1 only."""
    for r, row in enumerate(table):
        live = row[row >= 0]
        assert len(live) <= width
        assert (row[:len(live)] >= 0).all() and (row[len(live):] == -1).all()
        assert len(set(live.tolist())) == len(live)
        assert r not in set(live.tolist())
        assert ids_ok[live].all()


@pytest.mark.parametrize("p", [1, 4])
def test_lists_are_unique_valid_and_within_width(batched, p):
    for g in batched[p]:
        n = len(g.levels)
        assert g.l0_nbrs.shape == (n, CFG.maxM0)
        _check_lists(g.l0_nbrs, np.ones(n, bool), CFG.maxM0)
        assert (g.l0_nbrs >= 0).sum(1).min() >= 1
        up_ids = np.flatnonzero(g.levels >= 1)
        for layer in range(1, CFG.max_level_cap):
            rows = g.up_nbrs[layer - 1, g.up_ptr[up_ids]]
            reach = g.levels >= layer
            # rows are indexed by point id, so self-links show as `r`
            full = np.full((n, rows.shape[1]), -1, np.int32)
            full[up_ids] = rows
            _check_lists(full, reach, CFG.maxM)
            assert (full[~reach] == -1).all()
            if reach.sum() > 1:
                assert (full[reach] >= 0).any(1).all()


def _unreachable(g) -> set:
    """The points no path from the entry reaches at layer 0."""
    seen = np.zeros(len(g.levels), bool)
    seen[g.entry] = True
    front = np.array([g.entry])
    while front.size:
        nxt = g.l0_nbrs[front].ravel()
        nxt = np.unique(nxt[nxt >= 0])
        front = nxt[~seen[nxt]]
        seen[front] = True
    return set(np.flatnonzero(~seen).tolist())


@pytest.mark.parametrize("p", [1, 4])
def test_every_point_is_reachable_at_layer0(host, batched, p):
    """Every point is reachable wherever build_hnsw's graph of the same
    rows reaches every point. hnswlib's insertion itself can leave a point
    that no list names (the heuristic prunes the last link to it): here
    point 29 of partition 1, in both builds; the batched build leaves no
    more such points than build_hnsw does."""
    lost = [(_unreachable(g), _unreachable(h))
            for g, h in zip(batched[p], host)]
    for got, want in lost:
        assert len(got) <= len(want)
        if not want:
            assert not got
    assert sum(not want for _, want in lost) >= max(1, p - 1)


def _same(a, b):
    for f in ("vectors", "levels", "l0_nbrs", "up_nbrs", "up_ptr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.entry, a.max_level, a.cfg) == (b.entry, b.max_level, b.cfg)


def test_builds_are_byte_identical(batched):
    again = bb.build_graphs(_parts(1), _cfgs(1), "cpu")
    _same(again[0], batched[1][0])
    # the partitions of one build are lanes that never meet: partition 0
    # of the P = 4 build is the P = 1 build of its rows
    _same(batched[4][0], batched[1][0])


@pytest.mark.parametrize("p", [1, 4])
def test_recall_at_ef40_holds_to_build_hnsw(host, batched, p):
    got = _recall(_db(batched[p], p), p)
    want = _recall(_db(host, p), p)
    assert got >= want - 0.01, (got, want)
    assert got >= 0.9


def _host_select(x, ids, ds, m):
    return hg._select_heuristic(x, list(ids), list(ds), m)


@pytest.mark.parametrize("m", [4, 8])
def test_select_heuristic_is_the_hosts(m):
    rng = np.random.default_rng(m)
    x = rng.integers(0, 256, (300, DIM)).astype(np.float32)
    xt, sq = torch.as_tensor(x), torch.as_tensor((x * x).sum(1))
    rows, want = [], []
    for _ in range(40):
        q = rng.integers(0, 256, DIM).astype(np.float32)
        k = int(rng.integers(1, 30))
        ids = rng.choice(300, k, replace=False)
        ds = ((x[ids] - q) ** 2).sum(1)
        if len(set(ds.tolist())) < k:      # the host's order on a tie
            continue                       # is numpy's unstable argsort
        o = np.argsort(ds)
        rows.append((ds[o], ids[o]))
        want.append(_host_select(x, ids, ds, m))
    k_max = max(len(r[0]) for r in rows)
    cd = torch.full((len(rows), k_max), float("inf"))
    ci = torch.full((len(rows), k_max), -1, dtype=torch.int32)
    for r, (ds, ids) in enumerate(rows):
        cd[r, :len(ds)] = torch.as_tensor(ds)
        ci[r, :len(ids)] = torch.as_tensor(ids)
    got = bb.select_heuristic(xt, sq, cd, ci, m).numpy()
    for g, w in zip(got, want):
        assert g[g >= 0].tolist() == w
        assert (g[len(w):] == -1).all()


@pytest.mark.parametrize("n", [1, 2, 9, 1000, 250_000])
def test_batch_schedule(n):
    sched = bb.batch_schedule(n)
    assert sched[0] == (0, 1)
    assert [s for s, _ in sched[1:]] == [e for _, e in sched[:-1]]
    assert sched[-1][1] == n
    for s, e in sched[1:]:
        assert 1 <= e - s <= min(bb.BATCH_CAP, max(1, s // bb.BATCH_FRACTION))


@pytest.fixture(scope="module")
def traced():
    """(service, its build's spans, one search's spans, the queries)."""
    x = ROWS[:2000]
    spec = IndexSpec(backend="partitioned-batched", dtype="uint8",
                     num_partitions=4, hnsw=CFG)
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    try:
        svc = SearchService.build(x, spec, device="cpu")
        built = TRACER.spans()
        TRACER.clear()
        svc.search(SearchRequest(QUERIES, k=K, ef=EF))
        searched = TRACER.spans()
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()
    return svc, built, searched


def test_service_searches_saves_and_reloads(traced, tmp_path):
    svc = traced[0]
    assert isinstance(svc.backend, PartitionedBatchedBackend)
    assert svc.backend.pdb.db.vectors.dtype == torch.uint8
    req = SearchRequest(QUERIES, k=K, ef=EF, with_stats=True)
    a = svc.search(req)
    assert a.ids.shape == (len(QUERIES), K) and (a.ids >= 0).all()
    assert (a.stats.dist_calcs > 0).all()
    svc.save(str(tmp_path))
    b = SearchService.load(str(tmp_path), device="cpu")
    assert b.spec == svc.spec and isinstance(b.backend,
                                             PartitionedBatchedBackend)
    r = b.search(req)
    assert torch.equal(a.ids, r.ids) and torch.equal(a.dists, r.dists)
    for f in hg.DeviceDB._fields:
        assert torch.equal(getattr(svc.backend.pdb.db, f),
                           getattr(b.backend.pdb.db, f))


def _parents(spans):
    by_id = {ev["id"]: ev["name"] for ev in spans}
    return {(ev["name"], by_id.get(ev["parent"])) for ev in spans}


def test_build_and_search_spans_nest_with_their_attrs(traced):
    _, built, searched = traced
    assert _parents(built) == {("build", None), ("insert", "build")}
    (root,) = [ev for ev in built if ev["name"] == "build"]
    assert root["attrs"] == {"backend": "partitioned-batched", "rows": 2000,
                             "partitions": 4}
    ins = [ev for ev in built if ev["name"] == "insert"]
    assert len(ins) == len(bb.batch_schedule(500))
    assert sum(ev["attrs"]["rows"] for ev in ins) == 2000
    for ev in ins:
        assert set(ev["attrs"]) == {"rows", "ef_construction",
                                    "reverse_prunes"}
        assert ev["attrs"]["ef_construction"] == CFG.ef_construction
        assert root["t0"] <= ev["t0"] <= ev["t1"] <= root["t1"]
        assert "dev_ms" not in ev                # the CPU: no events
    assert sum(ev["attrs"]["reverse_prunes"] for ev in ins) > 0
    assert _parents(searched) == {("search", None), ("encode", "search"),
                                  ("descend", "search"),
                                  ("layer0", "search"), ("merge", "search")}
    by = {ev["name"]: ev for ev in searched}
    lanes = 4 * len(QUERIES)
    assert by["descend"]["attrs"]["lanes"] == lanes
    assert 0 < by["descend"]["attrs"]["hops"] <= by["descend"]["attrs"][
        "syncs"]
    assert by["layer0"]["attrs"]["lanes"] == lanes
    assert by["layer0"]["attrs"]["supersteps"] >= 1
    assert by["merge"]["attrs"] == {"candidates": 4 * K}
    assert by["descend"]["t1"] <= by["layer0"]["t0"]
    assert by["layer0"]["t1"] <= by["merge"]["t0"]
