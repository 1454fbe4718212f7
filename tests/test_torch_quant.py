"""The quantized storage path (uint8 / int8 codes and PQ) against the
reference.

* quantizers: scale / zero-point, codes, PQ codebooks and LUTs equal the
  reference's byte for byte under a pinned seed;
* the traversal superstep on 8-bit code rows: the port's plain version
  bitwise against the reference's Pallas kernel (interpret mode);
* services: uint8 / int8 / pq on `exact`, `hnsw` and `partitioned`,
  rerank off and on, against the reference's services on integer-valued
  data — ids, dists, hops and dist_calcs bitwise. PQ specs carry
  integer-valued codebooks (`np.rint` of a fit), so every LUT entry and
  every sum is an exact integer and the two frameworks' summation orders
  cannot part;
* inside the port: fused_hops 1 == 4, uint8 == float32 on byte data with
  max 255, non-l2 metrics refused;
* manifests: a quantized v1 and a PQ v3 index saved by one package load
  into the other; code leaves round-trip byte-identically.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import IndexSpec as RefSpec
from repro.api import SearchRequest as RefRequest
from repro.api import SearchService as RefService
from repro.api.service import read_step_leaves as ref_read_leaves
from repro.core import partitioned as rpart
from repro.core.hnsw_graph import HNSWConfig as RefHNSW
from repro.kernels.traversal import fused_traversal_pallas
from repro.optim import compression as rq
from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.api.service import MANIFEST_NAME, read_step_leaves
from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import hnsw_graph as thg
from repro_torch.core.partitioned import (
    build_partitioned_db,
    quantize_db_vectors,
)
from repro_torch.core.search import bitmap_words
from repro_torch.data import VectorDataset
from repro_torch.kernels import traversal as tr
from repro_torch.optim import compression as tq

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

K, EF, PQ_M = 10, 40, 8
HNSW = dict(M=8, ef_construction=40)


@pytest.fixture(scope="module")
def data():
    """Integer-valued rows in 0..255 (d=32) and queries."""
    ds = VectorDataset(600, 32, 12, seed=1)
    return np.rint(ds.vectors()), np.rint(np.clip(ds.queries(12), 0, 255))


@pytest.fixture(scope="module")
def int_codebooks(data):
    """A PQ fit rounded to integers: LUTs over integer queries are then
    exact integers in both frameworks."""
    v, _ = data
    return np.rint(tq.PQQuantizer.fit(v, PQ_M, seed=0).codebooks).tolist()


def _exact_scale_data(v, dtype):
    """Rows whose quantizer has an exact scale, so that decoded rows (the
    rerank's) are integers too: max 255 gives uint8 scale 1, max 254 gives
    int8 scale 254/127 = 2."""
    top = {"uint8": 255.0, "int8": 254.0}.get(dtype)
    if top is None:
        return v
    v = np.minimum(v, top)
    v[0, 0] = top
    return v


def _specs(backend, dtype, codebooks, **kw):
    common = dict(backend=backend, num_partitions=2, dtype=dtype, pq_m=PQ_M,
                  keep_vectors=True,
                  pq_codebooks=codebooks if dtype == "pq" else None, **kw)
    return (RefSpec(hnsw=RefHNSW(**HNSW), **common),
            IndexSpec(hnsw=thg.HNSWConfig(**HNSW), **common))


@pytest.fixture(scope="module")
def services(data, int_codebooks):
    """services(backend, dtype) -> (reference, port) services over the
    same data and spec, each pair built once per module."""
    built = {}

    def get(backend, dtype):
        if (backend, dtype) not in built:
            v = _exact_scale_data(data[0], dtype)
            ref_spec, spec = _specs(backend, dtype, int_codebooks)
            built[backend, dtype] = (RefService.build(v, ref_spec),
                                     SearchService.build(v, spec,
                                                         device="cpu"))
        return built[backend, dtype]

    return get


def _ref_answer(svc, q, rerank):
    r = svc.search(RefRequest(queries=q, k=K, ef=EF, rerank=rerank,
                              with_stats=True))
    return [np.asarray(a) for a in (r.ids, r.dists, r.stats.hops,
                                    r.stats.dist_calcs)]


def _port_answer(svc, q, rerank):
    r = svc.search(SearchRequest(queries=q, k=K, ef=EF, rerank=rerank,
                                 with_stats=True))
    return [t.numpy() for t in (r.ids, r.dists, r.stats.hops,
                                r.stats.dist_calcs)]


def _assert_same(got, want):
    for name, a, b in zip(("ids", "dists", "hops", "dist_calcs"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["uint8", "int8"])
@pytest.mark.parametrize("signed", [False, True])
def test_vector_quantizer_bytes_match_reference(dtype, signed):
    rng = np.random.default_rng(0)
    x = rng.normal(scale=20.0, size=(512, 32)).astype(np.float32)
    if not signed:
        x = np.abs(x)
    ref = rq.VectorQuantizer.fit(x, dtype)
    port = tq.VectorQuantizer.fit(x, dtype)
    assert port.to_json() == ref.to_json()
    assert port.dist_scale == ref.dist_scale
    codes = port.encode(x)
    assert codes.dtype == ref.encode(x).dtype
    np.testing.assert_array_equal(codes, ref.encode(x))
    np.testing.assert_array_equal(port.encode_f32(x), ref.encode_f32(x))
    np.testing.assert_array_equal(port.decode(codes), ref.decode(codes))
    # the torch path of decode: one rounding, as the reference's jnp path
    np.testing.assert_array_equal(
        port.decode(torch.from_numpy(codes)).numpy(),
        np.asarray(ref.decode(jnp.asarray(codes))))
    assert port.decode(torch.from_numpy(codes)).dtype == torch.float32


def test_sift_style_bytes_quantize_to_themselves():
    """Integer bytes with max 255: scale 1, zero-point 0, codes == data."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, size=(256, 128)).astype(np.float32)
    x[0, 0] = 255.0
    q = tq.VectorQuantizer.fit(x, "uint8")
    assert q.scale == 1.0 and q.zero_point == 0
    np.testing.assert_array_equal(q.encode(x), x.astype(np.uint8))


def test_code_dtype_and_unknown_names():
    assert tq.code_dtype("pq") == np.uint8 and tq.code_dtype("int8") == np.int8
    with pytest.raises(ValueError, match="unknown"):
        tq.code_dtype("int4")
    with pytest.raises(KeyError):
        tq.VectorQuantizer.fit(np.zeros((4, 4), np.float32), "int4")


@pytest.mark.parametrize("m", [4, 8])
def test_pq_quantizer_bytes_match_reference(data, m):
    v, q = data
    ref = rq.PQQuantizer.fit(v, m, seed=3)
    port = tq.PQQuantizer.fit(v, m, seed=3)
    assert port.codebooks.dtype == np.float32
    np.testing.assert_array_equal(port.codebooks, ref.codebooks)
    codes = port.encode(v)
    np.testing.assert_array_equal(codes, ref.encode(v))
    np.testing.assert_array_equal(port.encode(v[0]), ref.encode(v[0]))
    np.testing.assert_array_equal(port.decode(codes), ref.decode(codes))
    np.testing.assert_array_equal(
        port.decode(torch.from_numpy(codes)).numpy(), ref.decode(codes))
    np.testing.assert_array_equal(port.lut_np(q[0]), ref.lut_np(q[0]))
    assert port.to_json() == ref.to_json()
    back = tq.PQQuantizer.from_json(json.loads(json.dumps(port.to_json())))
    np.testing.assert_array_equal(back.codebooks, ref.codebooks)
    with pytest.raises(ValueError, match="divisor"):
        tq.PQQuantizer.fit(v, 7)


def test_build_pq_lut_matches_reference(data, int_codebooks):
    """Integer codebooks and queries: bitwise. General floats: the two
    frameworks may sum the dsub squares in another order, so within a few
    float32 ulps (rtol 1e-6)."""
    v, q = data
    cb = np.asarray(int_codebooks, np.float32)
    want = np.asarray(rq.build_pq_lut(jnp.asarray(q), jnp.asarray(cb)))
    got = tq.build_pq_lut(torch.from_numpy(q), torch.from_numpy(cb))
    assert got.shape == (q.shape[0], PQ_M, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    fit = tq.PQQuantizer.fit(v, PQ_M, seed=0).codebooks
    qf = q + np.float32(0.37)
    want = np.asarray(rq.build_pq_lut(jnp.asarray(qf), jnp.asarray(fit)))
    got = tq.build_pq_lut(qf, fit)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "pq"])
def test_quantize_db_vectors_matches_reference(data, dtype):
    v, _ = data
    if dtype == "int8":
        v = np.clip(v - 128, -127, 127)
    pdb = build_partitioned_db(v, 2, thg.HNSWConfig(**HNSW))
    quant = tq.PQQuantizer.fit(v, PQ_M, seed=0) if dtype == "pq" else None
    rquant = rq.PQQuantizer.fit(v, PQ_M, seed=0) if dtype == "pq" else None
    got = quantize_db_vectors(pdb, dtype, quant)
    want = rpart.quantize_db_vectors(pdb, dtype, rquant)
    assert got.db.vectors.dtype == np.asarray(want.db.vectors).dtype
    np.testing.assert_array_equal(got.db.vectors, np.asarray(want.db.vectors))
    assert quantize_db_vectors(got, dtype, quant) is got       # no-op
    if dtype == "pq":
        assert got.db.vectors.shape[-1] == PQ_M


# ---------------------------------------------------------------------------
# the traversal superstep on 8-bit code rows
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["uint8", "int8"])
def code_db(request, data):
    """Two partitions of 8-bit code rows; int8 rows are signed."""
    v, _ = data
    if request.param == "int8":
        v = np.clip(v - 128, -127, 127)
    pdb = build_partitioned_db(v, 2, thg.HNSWConfig(M=4, ef_construction=32))
    return quantize_db_vectors(pdb, request.param).db


def _beam(db, seed, B=5, EF_=16):
    rng = np.random.default_rng(seed)
    P, N, D = db.vectors.shape
    C = EF_ + db.l0_nbrs.shape[-1]
    lo = -127 if db.vectors.dtype == np.int8 else 0
    q = np.zeros((B, D), np.float32)
    q[:, :32] = rng.integers(lo, 128, (B, 32))
    qsq = (q * q).sum(-1)
    L = P * B
    part = np.arange(L) // B
    ep = rng.integers(0, np.asarray(db.n_valid).reshape(-1)[part]).astype(
        np.int32)
    dot = (db.vectors[part, ep].astype(np.float32) * q[np.arange(L) % B]).sum(-1)
    ep_d = np.maximum(db.sqnorms[part, ep] - 2 * dot + qsq[np.arange(L) % B],
                      0).astype(np.float32)
    cand_d = np.full((L, C), np.inf, np.float32)
    cand_i = np.full((L, C), -1, np.int32)
    fin_d = np.full((L, EF_), np.inf, np.float32)
    fin_i = np.full((L, EF_), -1, np.int32)
    cand_d[:, 0], cand_i[:, 0], fin_d[:, 0], fin_i[:, 0] = ep_d, ep, ep_d, ep
    vis = np.zeros((L, bitmap_words(N)), np.uint32)
    vis[np.arange(L), ep >> 5] = np.uint32(1) << (ep & 31).astype(np.uint32)
    z = np.zeros(L, np.int32)
    return q, qsq, [cand_d, cand_i, fin_d, fin_i, vis, z, z.copy()]


@pytest.mark.parametrize("H", [1, 4])
def test_code_row_superstep_matches_reference_kernel(code_db, H):
    """Supersteps to the end on uint8 / int8 rows, compared after each."""
    db, max_hops, B = code_db, 176, 5
    q, qsq, ref = _beam(db, seed=H)
    tables = [torch.from_numpy(np.ascontiguousarray(getattr(db, f)))
              for f in ("vectors", "sqnorms", "l0_nbrs")]
    assert tables[0].dtype == {np.dtype(np.uint8): torch.uint8,
                               np.dtype(np.int8): torch.int8}[db.vectors.dtype]
    port = [torch.from_numpy(a.copy()) for a in ref]
    port[4] = torch.from_numpy(ref[4].view(np.int32).copy())
    steps = 0
    while bool(((ref[0][:, 0] < ref[2][:, -1]) & (ref[5] < max_hops)).any()):
        new = [[] for _ in ref]
        for p in range(db.vectors.shape[0]):
            lanes = slice(p * B, (p + 1) * B)
            out = fused_traversal_pallas(
                db.vectors[p], db.sqnorms[p], db.l0_nbrs[p], q, qsq,
                *[a[lanes] for a in ref], fused_hops=H, max_hops=max_hops,
                interpret=True)
            for acc, a in zip(new, out):
                acc.append(np.asarray(a))
        ref = [np.concatenate(a) for a in new]
        tr.fused_traversal_ref(*tables, torch.from_numpy(q),
                               torch.from_numpy(qsq), *port, fused_hops=H,
                               max_hops=max_hops)
        steps += 1
        got = [t.numpy() for t in port]
        got[4] = got[4].view(np.uint32)
        for name, a, b in zip(("cand_d", "cand_i", "fin_d", "fin_i",
                               "visited", "hops", "calcs"), got, ref):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} @ {steps}")
    assert steps >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 4])
def test_cuda_code_row_kernel_matches_plain_version(code_db, H):
    """On a card: the 8-bit instantiations equal the plain version bitwise
    after every superstep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    q, qsq, state = _beam(code_db, seed=H)
    tables = [torch.from_numpy(np.ascontiguousarray(getattr(code_db, f))).to(dev)
              for f in ("vectors", "sqnorms", "l0_nbrs")]
    state[4] = state[4].view(np.int32)
    sk = [torch.from_numpy(a.copy()).to(dev) for a in state]
    sr = [t.clone() for t in sk]
    tq_, tqsq = torch.from_numpy(q).to(dev), torch.from_numpy(qsq).to(dev)
    launches = tr.ASYNC_LAUNCHES, tr.LAUNCHES
    while bool(((sr[0][:, 0] < sr[2][:, -1]) & (sr[5] < 176)).any()):
        tr.fused_traversal_cuda(*tables, tq_, tqsq, *sk, fused_hops=H,
                                max_hops=176)
        tr.fused_traversal_ref(*tables, tq_, tqsq, *sr, fused_hops=H,
                               max_hops=176)
        torch.cuda.synchronize()
        for a, b in zip(sk, sr):
            assert torch.equal(a, b)
    # 8-bit rows at these shapes take traversal_async.cu
    assert tr.ASYNC_LAUNCHES > launches[0] and tr.LAUNCHES == launches[1]


# ---------------------------------------------------------------------------
# services against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("dtype", ["uint8", "int8", "pq"])
def test_partitioned_service_matches_reference(data, services, dtype, rerank):
    _, q = data
    ref, port = services("partitioned", dtype)
    assert port.spec.to_json() == ref.spec.to_json()
    _assert_same(_port_answer(port, q, rerank), _ref_answer(ref, q, rerank))


@pytest.mark.parametrize("dtype", ["uint8", "int8", "pq"])
def test_exact_service_matches_reference(data, services, dtype):
    _, q = data
    ref, port = services("exact", dtype)
    want = ref.search(RefRequest(queries=q, k=K, with_stats=True))
    got = port.search(SearchRequest(queries=q, k=K, with_stats=True))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    np.testing.assert_array_equal(got.stats.dist_calcs.numpy(),
                                  np.asarray(want.stats.dist_calcs))


@pytest.mark.parametrize("dtype", ["uint8", "pq"])
def test_hnsw_service_matches_reference(data, services, dtype):
    _, q = data
    ref, port = services("hnsw", dtype)
    for rerank in (False, True):
        _assert_same(_port_answer(port, q, rerank),
                     _ref_answer(ref, q, rerank))


@pytest.mark.parametrize("dtype", ["uint8", "int8", "pq"])
def test_fused_hops_never_changes_quantized_results(data, services,
                                                    dtype):
    _, q = data
    _, port = services("partitioned", dtype)
    be = port.backend
    spec = be.spec
    outs = []
    try:
        for h in (1, 4):
            be.spec = dataclasses.replace(spec, fused_hops=h)
            outs.append(_port_answer(port, q, False))
    finally:
        be.spec = spec
    _assert_same(outs[1], outs[0])


def test_uint8_equals_float32_on_bytes_with_max_255():
    """Byte data whose max is 255 quantizes to itself (scale 1, zero-point
    0): the uint8 index returns the float32 index's answers bitwise."""
    ds = VectorDataset(500, 32, 12, seed=4)
    v = np.rint(ds.vectors())
    v[0, 0] = 255.0
    q = np.rint(np.clip(ds.queries(10), 0, 255))
    out = {}
    for dtype in ("float32", "uint8"):
        spec = IndexSpec(num_partitions=2, dtype=dtype, fused_hops=4,
                         hnsw=thg.HNSWConfig(**HNSW))
        svc = SearchService.build(v, spec, device="cpu")
        out[dtype] = _port_answer(svc, q, False)
        if dtype == "uint8":
            assert (svc.spec.qscale, svc.spec.qzero) == (1.0, 0)
            assert svc.backend.pdb.db.vectors.dtype == torch.uint8
    _assert_same(out["uint8"], out["float32"])


@pytest.mark.parametrize("dtype", ["uint8", "pq"])
def test_quantized_rejects_non_l2_metrics(data, dtype):
    v, _ = data
    with pytest.raises(ValueError, match="metric='l2' only"):
        SearchService.build(v, IndexSpec(metric="cosine", dtype=dtype),
                            device="cpu")


def test_pq_spec_without_codebooks_is_refused():
    with pytest.raises(ValueError, match="pq_codebooks"):
        IndexSpec(dtype="pq").quantizer()
    with pytest.raises(ValueError, match="qscale"):
        IndexSpec(dtype="uint8").quantizer()


# ---------------------------------------------------------------------------
# manifests and code leaves, across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["uint8", "pq"])
def test_port_save_loads_into_reference(data, services, dtype,
                                        tmp_path):
    _, q = data
    ref, port = services("partitioned", dtype)
    port.save(str(tmp_path))
    with open(os.path.join(tmp_path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == (3 if dtype == "pq" else 1)
    back = RefService.load(str(tmp_path))
    for rerank in (False, True):
        _assert_same(_ref_answer(back, q, rerank), _ref_answer(ref, q, rerank))


@pytest.mark.parametrize("backend", ["partitioned", "exact"])
@pytest.mark.parametrize("dtype", ["int8", "pq"])
def test_reference_save_loads_into_port(data, services, dtype, backend,
                                        tmp_path):
    _, q = data
    ref, _ = services(backend, dtype)
    ref.save(str(tmp_path))
    port = SearchService.load(str(tmp_path), device="cpu")
    assert port.spec.to_json() == ref.spec.to_json()
    if backend == "exact":
        want = ref.search(RefRequest(queries=q, k=K))
        got = port.search(SearchRequest(queries=q, k=K))
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.dists.numpy(),
                                      np.asarray(want.dists))
    else:
        for rerank in (False, True):
            _assert_same(_port_answer(port, q, rerank),
                         _ref_answer(ref, q, rerank))


def test_code_leaves_roundtrip_byte_identically(tmp_path):
    rng = np.random.default_rng(7)
    tree = {"db": {"u8": torch.from_numpy(
                rng.integers(0, 256, (2, 64, 128)).astype(np.uint8)),
                   "i8": rng.integers(-127, 128, (2, 64, 128)).astype(np.int8),
                   "pq": torch.from_numpy(
                rng.integers(0, 256, (300, 16)).astype(np.uint8))}}
    save_checkpoint(str(tmp_path), 0, tree)
    for leaves in (read_step_leaves(str(tmp_path), 0),
                   ref_read_leaves(str(tmp_path), 0)):
        for name, want in tree["db"].items():
            want = np.asarray(want)
            got = leaves[f"db/{name}"]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
