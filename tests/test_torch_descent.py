"""The upper-layer greedy descent: its plain version against the
reference, and the route `ops.greedy_descent` takes.

On the card the descent is one launch of `csrc/descent.cu` a search
(`kernels/descent.py` `greedy_descent_cuda`); on the CPU it is the plain
lockstep loop `kernels/descent.py` `greedy_upper`, which a
product-quantized DB takes on every device. Here the plain version is held
bitwise to the reference's `_greedy_upper` on a small multi-level,
multi-partition graph over lattice rows, where many distances tie and the
upper rows are -1 padded; the route is checked by what each call reaches.
The kernel itself is held to the plain version on the card by
`chip_smoke.py`'s descent phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as rsearch
from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.core import hnsw_graph as thg
from repro_torch.core import search as cs
from repro_torch.core.partitioned import build_partitioned_db
from repro_torch.kernels import _build, descent, ops
from repro_torch.obs.trace import TRACER

torch.set_num_threads(1)

P, N, D, B = 3, 400, 6, 24
CFG = thg.HNSWConfig(M=4, ef_construction=24)
UPPER_HOPS = 32


def _lattice(n, seed):
    """Rows of small integers in D = 6 dims: distances are small integers,
    so equal distances are common."""
    return np.random.default_rng(seed).integers(0, 4, (n, D)).astype(
        np.float32)


@pytest.fixture(scope="module")
def graph():
    """The stacked numpy DB of P partitions over lattice rows (the port's
    builder, byte-identical to the reference's) and the queries."""
    pdb = build_partitioned_db(_lattice(P * N, 0), P, CFG)
    return pdb.db, _lattice(B, 1)


def _tables(db, q, dtype):
    """The DB's tables and the queries in `dtype`'s code space: float32
    rows as built, uint8 the same values, int8 shifted by -2 (so signed),
    with the sqnorms of the stored rows and the +inf pads kept."""
    shift = {"float32": 0.0, "uint8": 0.0, "int8": -2.0}[dtype]
    vec = np.asarray(db.vectors) + np.float32(shift)
    sq = np.asarray(db.sqnorms)
    sq = np.where(np.isinf(sq), sq, np.einsum("pnd,pnd->pn", vec, vec))
    qq = np.pad(q + np.float32(shift), ((0, 0), (0, vec.shape[-1] - D)))
    return (db._replace(vectors=vec.astype(dtype),
                        sqnorms=sq.astype(np.float32)),
            qq.astype(np.float32))


def _ref(db, q, metric):
    """The reference's descent of every (partition, query): [P, B] each."""
    rp = rsearch.SearchParams(upper_hops=UPPER_HOPS, metric=metric)
    out = []
    for p in range(P):
        dbp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[p]), db)
        out.append(jax.vmap(lambda x: rsearch._greedy_upper(
            dbp, x, x @ x, rp))(jnp.asarray(q)))
    return [np.stack([np.asarray(o[i]) for o in out]) for i in range(3)]


def _port(db, q, metric, span=None):
    tdb = thg.device_db(db, "cpu")
    tq = torch.from_numpy(q)
    return ops.greedy_descent(tdb.vectors, tdb.sqnorms, tdb.up_ptr,
                              tdb.up_nbrs, tdb.entry, tdb.max_level, tq,
                              (tq * tq).sum(-1), upper_hops=UPPER_HOPS,
                              metric=metric, span=span)


def test_the_graph_has_levels_padding_and_ties(graph):
    """The fixture exercises what the descent must get right: partitions
    several layers deep with different tops, -1 padded upper rows, and
    upper rows whose nearest neighbours tie for a query."""
    db, q = graph
    levels = np.asarray(db.max_level)
    assert levels.min() >= 2 and len(set(levels.tolist())) > 1
    up, ptr = np.asarray(db.up_nbrs), np.asarray(db.up_ptr)
    assert (up[:, 0] == -1).any() and (up[:, 0] >= 0).any()
    vec = np.asarray(db.vectors)[..., :D]
    ties = 0
    for p in range(P):
        rows = up[p, 0][ptr[p][ptr[p] >= 0]]                # layer-1 rows
        for r in rows:
            ids = r[r >= 0]
            d = ((vec[p][ids][None] - q[:, None]) ** 2).sum(-1)
            ties += int(((d == d.min(1, keepdims=True)).sum(1) > 1).sum())
    assert ties > 100


@pytest.mark.parametrize("dtype", ["float32", "uint8", "int8"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_plain_descent_equals_the_reference(graph, dtype, metric):
    """Entries, distances and evaluations bitwise equal to the
    reference's `_greedy_upper`, lane l = (partition l // B, query l % B);
    `greedy_upper` over the same distances, as the PQ path calls it,
    too."""
    db, q = _tables(*graph, dtype)
    want = _ref(db, q, metric)
    got = _port(db, q, metric)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.reshape(-1))
    assert got[0].dtype == got[2].dtype == torch.int32
    tdb = thg.device_db(db, "cpu")
    tq = torch.from_numpy(q)
    lane = torch.arange(P * B)
    rows = (lane // B)[:, None]
    qs, qsq = tq[lane % B][:, None], (tq * tq).sum(-1)[lane % B][:, None]

    def dist(idx):
        dot = (tdb.vectors[rows, idx].float() * qs).sum(-1)
        return cs.metric_distance(metric, dot, tdb.sqnorms[rows, idx], qsq)

    again = descent.greedy_upper(tdb.up_ptr, tdb.up_nbrs, tdb.entry,
                                 tdb.max_level, lane // B, dist, UPPER_HOPS)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _no_kernel(*a, **kw):
    raise AssertionError("the kernel's library was loaded")


def test_cpu_tensors_take_the_plain_loop(graph, monkeypatch):
    """`ops.greedy_descent` on CPU tensors runs `greedy_upper`, loads no
    kernel and counts no launch."""
    db, q = _tables(*graph, "uint8")
    calls = []
    plain = descent.greedy_upper

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(descent, "greedy_upper", counted)
    monkeypatch.setattr(_build, "load", _no_kernel)
    before = descent.DESCENT_LAUNCHES
    _port(db, q, "l2")
    assert calls == [1] and descent.DESCENT_LAUNCHES == before


def test_pq_tables_take_the_plain_loop(graph, monkeypatch):
    """A `lut` (dtype="pq") sends `search_lanes` to `greedy_upper` over
    LUT distances whatever the device: `ops.greedy_descent` is never
    called."""
    db, _ = graph
    g = np.random.default_rng(2)
    codes = g.integers(0, 256, (P, np.asarray(db.vectors).shape[1], 4))
    tdb = thg.device_db(db._replace(vectors=codes.astype(np.uint8)), "cpu")
    lut = torch.from_numpy(g.integers(0, 64, (B, 4, 256)).astype(np.float32))

    def refused(*a, **kw):
        raise AssertionError("ops.greedy_descent was called with a lut")

    calls = []
    plain = cs.greedy_upper

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(cs, "greedy_descent", refused)
    monkeypatch.setattr(cs, "greedy_upper", counted)
    ids, _, stats = cs.search_lanes(tdb, None, cs.SearchParams(), lut)
    assert calls == [1] and ids.shape == (P, B, 10)
    assert (stats.dist_calcs > 0).all()


def _kernel_operands(db, q):
    tdb = thg.device_db(db, "cpu")
    tq = torch.from_numpy(q)
    return dict(vectors=tdb.vectors, sqnorms=tdb.sqnorms, up_ptr=tdb.up_ptr,
                up_nbrs=tdb.up_nbrs, entry=tdb.entry,
                max_level=tdb.max_level, queries=tq, qsq=(tq * tq).sum(-1))


@pytest.mark.parametrize("case,err", [
    ("float16 rows", TypeError),
    ("int32 rows", TypeError),
    ("uint8 rows of 64 bytes", ValueError),
    ("float32 rows of 96 bytes", ValueError),
    ("queries past shared memory", ValueError),
    ("int64 neighbour rows", TypeError),
    ("unstacked tables", ValueError),
    ("strided queries", ValueError),
    ("float64 sqnorms", TypeError),
    ("an unknown metric", ValueError),
])
def test_the_kernel_wrapper_refuses_before_any_launch(graph, monkeypatch,
                                                      case, err):
    """Each dtype, shape and layout `csrc/descent.cu` does not take raises
    in the wrapper, before the library is loaded; what it takes on CPU
    tensors raises for the device, last."""
    db, q = _tables(*graph, "uint8")
    monkeypatch.setattr(_build, "load", _no_kernel)
    o = _kernel_operands(db, q)
    v, tq = o["vectors"], o["queries"]
    metric = "l2"
    if case == "float16 rows":
        o["vectors"] = v.half()
    elif case == "int32 rows":
        o["vectors"] = v.int()
    elif case == "uint8 rows of 64 bytes":
        o["vectors"], o["queries"] = v[..., :64].contiguous(), tq[:, :64]
        o["qsq"] = (o["queries"] ** 2).sum(-1)
    elif case == "float32 rows of 96 bytes":
        o["vectors"] = v[..., :24].float().contiguous()
        o["queries"] = tq[:, :24].contiguous()
    elif case == "queries past shared memory":
        o["vectors"] = torch.zeros((P, 32, 8192))      # 256 KB a CTA
        o["queries"] = torch.zeros((B, 8192))
    elif case == "int64 neighbour rows":
        o["up_nbrs"] = o["up_nbrs"].long()
    elif case == "unstacked tables":
        o["vectors"] = v[0]
    elif case == "strided queries":
        o["queries"] = torch.zeros((B, 256))[:, ::2]
    elif case == "float64 sqnorms":
        o["sqnorms"] = o["sqnorms"].double()
    else:
        metric = "hamming"
    with pytest.raises(err):
        descent.greedy_descent_cuda(**o, upper_hops=UPPER_HOPS,
                                    metric=metric)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        descent.greedy_descent_cuda(**_kernel_operands(db, q),
                                    upper_hops=UPPER_HOPS)


def test_a_cpu_search_counts_no_launch_and_spans_the_plain_route():
    """Through the service on the CPU: no `DESCENT_LAUNCHES`, and the
    `descend` span carries `route` "plain" with its lockstep hops and the
    syncs that decided them."""
    x = _lattice(1200, 3) * np.float32(40)
    svc = SearchService.build(x, IndexSpec(backend="partitioned",
                                           num_partitions=2, hnsw=CFG),
                              device="cpu")
    before = descent.DESCENT_LAUNCHES
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    try:
        svc.search(SearchRequest(_lattice(B, 4) * np.float32(40), k=10,
                                 ef=40))
        spans = TRACER.spans()
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()
    assert descent.DESCENT_LAUNCHES == before
    (span,) = [ev for ev in spans if ev["name"] == "descend"]
    attrs = span["attrs"]
    assert set(attrs) == {"lanes", "route", "hops", "syncs"}
    assert attrs["route"] == "plain" and attrs["lanes"] == 2 * B
    assert 0 < attrs["hops"] <= attrs["syncs"]
