"""The port's search engine against the reference on the same tables.

One partitioned DB (P=2) is built once with the port's numpy builder (it
is byte-identical to the reference's, see test_torch_graph.py) and handed
to both packages. On integer-valued data every result must match bitwise:
ids, distances, hops and distance evaluations. Inside the port the
results are identical at every fused_hops. On general float data the two
frameworks sum the 128-term dot products in different orders, so the
gate is top-10 id overlap >= 0.95 and recall@10 >= 0.90 against exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.rerank import batched_rerank as ref_rerank
from repro.core import partitioned as rpart
from repro.core import search as rsearch
from repro.core.bruteforce import bruteforce_topk as ref_bruteforce
from repro_torch.api.rerank import batched_rerank
from repro_torch.core import hnsw_graph as thg
from repro_torch.core.bruteforce import bruteforce_topk
from repro_torch.core.partitioned import (
    build_partitioned_db,
    merge_topk,
    search_partitioned,
    search_partitioned_candidates,
)
from repro_torch.core.search import SearchParams, batch_search
from repro_torch.data import VectorDataset

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

K, EF = 10, 40
CFG = thg.HNSWConfig(M=8, ef_construction=40)


def _data(n, integer, seed=0):
    ds = VectorDataset(n, 32, 12, seed=seed)
    v, q = ds.vectors(), np.clip(ds.queries(24), 0, 255)
    return (np.rint(v), np.rint(q)) if integer else (v, q)


@pytest.fixture(scope="module")
def int_case():
    v, q = _data(1000, integer=True)
    pdb = build_partitioned_db(v, 2, CFG)
    return v, q, pdb


def _ref_pdb(pdb):
    return pdb._replace(db=jax.tree.map(jnp.asarray, pdb.db))


def _port_pdb(pdb):
    return pdb._replace(db=thg.device_db(pdb.db, "cpu"))


def _unstack(db, p):
    return thg.DeviceDB(*(a[p] for a in db))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_batch_search_bitwise(int_case, metric):
    """One partition, reference hop-stepped (fused_hops=1) vs the port."""
    _, q, pdb = int_case
    db0 = _unstack(pdb.db, 0)
    p = SearchParams(ef=EF, k=K, metric=metric, fused_hops=4)
    rp = rsearch.SearchParams(ef=EF, k=K, metric=metric)
    ri, rd, rs = rsearch.batch_search(jax.tree.map(jnp.asarray, db0),
                                      jnp.asarray(q), rp)
    ti, td, ts = batch_search(thg.device_db(db0, "cpu"), q, p)
    assert ti.dtype == torch.int32 and ts.hops.dtype == torch.int32
    _eq(ti, ri)
    _eq(td, rd)
    _eq(ts.hops, rs.hops)
    _eq(ts.dist_calcs, rs.dist_calcs)


def test_batch_search_matches_reference_fused_kernel(int_case):
    """The reference's own fused path (Pallas, interpret) at fused_hops=4."""
    _, q, pdb = int_case
    db0 = _unstack(pdb.db, 1)
    ri, rd, rs = rsearch.batch_search(
        jax.tree.map(jnp.asarray, db0), jnp.asarray(q[:8]),
        rsearch.SearchParams(ef=EF, k=K, fused_hops=4))
    ti, td, ts = batch_search(thg.device_db(db0, "cpu"), q[:8],
                              SearchParams(ef=EF, k=K))
    _eq(ti, ri)
    _eq(td, rd)
    _eq(ts.hops, rs.hops)
    _eq(ts.dist_calcs, rs.dist_calcs)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_search_partitioned_bitwise(int_case, metric):
    _, q, pdb = int_case
    rp = rsearch.SearchParams(ef=EF, k=K, metric=metric)
    ri, rd, rs = rpart.search_partitioned(_ref_pdb(pdb), jnp.asarray(q), rp)
    ti, td, ts = search_partitioned(
        _port_pdb(pdb), q, SearchParams(ef=EF, k=K, metric=metric))
    _eq(ti, ri)
    _eq(td, rd)
    _eq(ts.hops, rs.hops)                  # [P, B] per-partition stats
    _eq(ts.dist_calcs, rs.dist_calcs)


def test_search_partitioned_candidates_bitwise(int_case):
    _, q, pdb = int_case
    ri, rd, rs = rpart.search_partitioned_candidates(
        _ref_pdb(pdb), jnp.asarray(q), rsearch.SearchParams(ef=EF, k=K))
    ti, td, ts = search_partitioned_candidates(
        _port_pdb(pdb), q, SearchParams(ef=EF, k=K))
    assert tuple(ti.shape) == (q.shape[0], 2 * K)
    _eq(ti, ri)
    _eq(td, rd)
    _eq(ts.dist_calcs, rs.dist_calcs)


def test_fused_hops_never_changes_results(int_case):
    """The reference's contract, held inside the port: H in {1, 2, 4, 8}."""
    _, q, pdb = int_case
    port = _port_pdb(pdb)
    outs = [search_partitioned(port, q, SearchParams(ef=EF, k=K,
                                                     fused_hops=h))
            for h in (1, 2, 4, 8)]
    for ids, ds, st in outs[1:]:
        assert torch.equal(ids, outs[0][0])
        assert torch.equal(ds, outs[0][1])
        assert torch.equal(st.hops, outs[0][2].hops)
        assert torch.equal(st.dist_calcs, outs[0][2].dist_calcs)


def test_merge_topk_matches_reference():
    rng = np.random.default_rng(0)
    d = np.sort(rng.integers(0, 20, (7, 3, 5)).astype(np.float32), axis=-1)
    d[:, :, -1] = np.inf
    ids = rng.permutation(7 * 3 * 5).reshape(7, 3, 5).astype(np.int32)
    ri, rd = rpart.merge_topk(jnp.asarray(ids), jnp.asarray(d), 6)
    ti, td = merge_topk(torch.from_numpy(ids), torch.from_numpy(d), 6)
    _eq(ti, ri)
    _eq(td, rd)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_bruteforce_topk_bitwise(int_case, metric):
    """Chunked exact scan with ties (duplicated rows): lowest id wins."""
    v, q, _ = int_case
    v = np.concatenate([v, v[:100]])                 # exact duplicates
    n_pad = 1536
    vp = np.zeros((n_pad, v.shape[1]), np.float32)
    vp[: len(v)] = v
    sq = np.full(n_pad, np.inf, np.float32)
    sq[: len(v)] = np.einsum("nd,nd->n", v, v)
    ri, rd = ref_bruteforce(jnp.asarray(vp), jnp.asarray(sq), jnp.asarray(q),
                            k=K, chunk=512, metric=metric)
    ti, td = bruteforce_topk(torch.from_numpy(vp), torch.from_numpy(sq),
                             torch.from_numpy(q), k=K, chunk=512,
                             metric=metric)
    assert ti.dtype == torch.int32
    _eq(ti, ri)
    _eq(td, rd)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_batched_rerank_bitwise(int_case, metric):
    """Pools with duplicates and -1 pads; smallest id wins equal distances."""
    v, q, _ = int_case
    rng = np.random.default_rng(1)
    pool = rng.integers(-1, 200, (q.shape[0], 20)).astype(np.int32)
    pool[:, 5] = pool[:, 4]                          # duplicate ids
    vv = np.concatenate([v[:100], v[:100]])          # equal distances
    sq = np.einsum("nd,nd->n", vv, vv).astype(np.float32)
    ri, rd = ref_rerank(jnp.asarray(vv), jnp.asarray(sq), jnp.asarray(q),
                        jnp.asarray(pool), K, metric)
    ti, td = batched_rerank(torch.from_numpy(vv), torch.from_numpy(sq),
                            torch.from_numpy(q), torch.from_numpy(pool), K,
                            metric)
    _eq(ti, ri)
    _eq(td, rd)


def test_float_data_overlap_and_recall():
    """General float data: near-ties may part the two frameworks' beams,
    so the gate is overlap with the reference and recall against exact."""
    v, q = _data(1000, integer=False, seed=5)
    pdb = build_partitioned_db(v, 2, CFG)
    ri, _, _ = rpart.search_partitioned(_ref_pdb(pdb), jnp.asarray(q),
                                        rsearch.SearchParams(ef=EF, k=K))
    ti, _, _ = search_partitioned(_port_pdb(pdb), q,
                                  SearchParams(ef=EF, k=K, fused_hops=4))
    ri, ti = np.asarray(ri), ti.numpy()
    d2 = (np.einsum("nd,nd->n", v, v)[None] - 2 * q @ v.T
          + np.einsum("bd,bd->b", q, q)[:, None])
    gt = np.argsort(d2, axis=1, kind="stable")[:, :K]
    overlap = np.mean([len(set(a) & set(b)) / K for a, b in zip(ti, ri)])
    recall = np.mean([len(set(a) & set(b)) / K for a, b in zip(ti, gt)])
    assert overlap >= 0.95, overlap
    assert recall >= 0.90, recall


def test_quantized_tables_not_yet_ported(int_case):
    """8-bit code tables are ported: on byte data (0..255) a uint8 table
    answers bitwise like the float32 one. A row type the search does not
    take still raises."""
    _, q, pdb = int_case
    db = thg.device_db(_unstack(pdb.db, 0), "cpu")
    want = batch_search(db, q, SearchParams(ef=EF, k=K))
    got = batch_search(db._replace(vectors=db.vectors.to(torch.uint8)), q,
                       SearchParams(ef=EF, k=K, fused_hops=4))
    for a, b in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="not searchable"):
        batch_search(db._replace(vectors=db.vectors.to(torch.int16)), q,
                     SearchParams())
