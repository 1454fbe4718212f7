"""The fused layer-0 traversal superstep: the port against the reference.

The port's plain version (`fused_traversal_ref`, batched torch ops over
P*B lanes) is held bitwise to the reference's Pallas kernel, run in
interpret mode as the reference's own tests run it, from the same beam
state, superstep after superstep until every lane has finished. The data
are integer-valued float32 rows (0..255, d=32), so every dot product and
every ||x||^2 - 2 x.q + ||q||^2 is an exact integer below 2^24 and the
two summation orders cannot part. Bitmaps are compared as uint32.

The CUDA kernels against the plain version and each other run only where
there is a card (the `cuda` marker); here they skip. Which kernel a shape
takes (`traversal_route`) and the new kernel's shared-memory count are
pure functions of shapes and are checked here.
"""

import numpy as np
import pytest
import torch

from repro.kernels.traversal import fused_traversal_pallas
from repro_torch.core import hnsw_graph as thg
from repro_torch.core.partitioned import build_partitioned_db
from repro_torch.core.search import bitmap_words
from repro_torch.data import clustered_vectors
from repro_torch.kernels import ops, traversal as tr

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

B, EF, MAX_HOPS = 6, 16, 176


@pytest.fixture(scope="module")
def pdb():
    """Two partitions of 300 integer-valued 32-d rows (N_pad 320, M0 8)."""
    v = np.rint(clustered_vectors(600, 32, 12, seed=3))
    return build_partitioned_db(v, 2, thg.HNSWConfig(M=4, ef_construction=32))


@pytest.fixture(scope="module")
def odd_db():
    """One graph padded to 2040 rows — 2040 % 32 != 0, so the bitmap has a
    partial last word (ceil(N/32) = 64 words)."""
    v = np.rint(clustered_vectors(300, 32, 12, seed=4))
    g = thg.build_hnsw(v, thg.HNSWConfig(M=4, ef_construction=32))
    db = thg.restructure(g, n_pad=2040)
    assert db.vectors.shape[0] % 32 != 0
    return thg.DeviceDB(*(np.stack([a]) for a in db))


@pytest.fixture(scope="module")
def wide_db():
    """One graph padded to 65,540 rows: W = ceil(65540/32) = 2049 bitmap
    words, one past the largest bitmap kept in shared memory, and a partial
    last word."""
    v = np.rint(clustered_vectors(300, 32, 12, seed=5))
    g = thg.build_hnsw(v, thg.HNSWConfig(M=4, ef_construction=32))
    db = thg.restructure(g, n_pad=65540)
    return thg.DeviceDB(*(np.stack([a]) for a in db))


def _beam_state(db, metric, seed):
    """Queries and the initial beam state of P*B lanes, in numpy: each lane
    starts from a random valid row of its partition."""
    rng = np.random.default_rng(seed)
    P, N, D = db.vectors.shape
    M0 = db.l0_nbrs.shape[-1]
    C = EF + M0
    q = np.zeros((B, D), np.float32)
    q[:, :32] = np.rint(np.clip(rng.normal(110, 50, (B, 32)), 0, 255))
    qsq = (q * q).sum(-1)
    L = P * B
    part = np.arange(L) // B
    ep = rng.integers(0, np.asarray(db.n_valid).reshape(-1)[part]).astype(np.int32)
    dot = (db.vectors[part, ep] * q[np.arange(L) % B]).sum(-1)
    xsq, qs = db.sqnorms[part, ep], qsq[np.arange(L) % B]
    ep_d = {"l2": np.maximum(xsq - 2 * dot + qs, 0), "ip": -dot,
            "cosine": 1 - dot}[metric].astype(np.float32)
    cand_d = np.full((L, C), np.inf, np.float32)
    cand_i = np.full((L, C), -1, np.int32)
    fin_d = np.full((L, EF), np.inf, np.float32)
    fin_i = np.full((L, EF), -1, np.int32)
    cand_d[:, 0], cand_i[:, 0], fin_d[:, 0], fin_i[:, 0] = ep_d, ep, ep_d, ep
    vis = np.zeros((L, bitmap_words(N)), np.uint32)
    vis[np.arange(L), ep >> 5] = np.uint32(1) << (ep & 31).astype(np.uint32)
    zeros = np.zeros(L, np.int32)
    return q, qsq, [cand_d, cand_i, fin_d, fin_i, vis, zeros, zeros.copy()]


def _to_torch(state):
    out = [torch.from_numpy(a.copy()) for a in state]
    out[4] = torch.from_numpy(state[4].view(np.int32).copy())
    return out


def _to_numpy(state):
    out = [t.numpy() for t in state]
    out[4] = out[4].view(np.uint32)
    return out


def _live(state, max_hops):
    return bool(((state[0][:, 0] < state[2][:, -1])
                 & (state[5] < max_hops)).any())


def _run_both(db, metric, H, max_hops, seed=0):
    """Supersteps to the end with both packages, compared after each one.
    Returns the number of supersteps and the final (numpy) state."""
    P = db.vectors.shape[0]
    q, qsq, state = _beam_state(db, metric, seed)
    tables = [torch.from_numpy(np.ascontiguousarray(getattr(db, f)))
              for f in ("vectors", "sqnorms", "l0_nbrs")]
    tq, tqsq = torch.from_numpy(q), torch.from_numpy(qsq)
    port = _to_torch(state)
    ref = state
    steps = 0
    while _live(ref, max_hops):
        new = [[] for _ in ref]
        for p in range(P):
            lanes = slice(p * B, (p + 1) * B)
            out = fused_traversal_pallas(
                db.vectors[p], db.sqnorms[p], db.l0_nbrs[p], q, qsq,
                *[a[lanes] for a in ref], fused_hops=H, max_hops=max_hops,
                metric=metric, interpret=True)
            for acc, a in zip(new, out):
                acc.append(np.asarray(a))
        ref = [np.concatenate(a) for a in new]
        tr.fused_traversal_ref(*tables, tq, tqsq, *port, fused_hops=H,
                               max_hops=max_hops, metric=metric)
        steps += 1
        got = _to_numpy(port)
        for name, a, b in zip(("cand_d", "cand_i", "fin_d", "fin_i",
                               "visited", "hops", "calcs"), got, ref):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=f"{name} @ {steps}")
    assert not _live(_to_numpy(port), max_hops)
    return steps, ref


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("H", [1, 2, 4])
def test_superstep_matches_reference_kernel(pdb, metric, H):
    steps, final = _run_both(pdb.db, metric, H, MAX_HOPS)
    assert steps >= 2
    assert (final[5] > H).any(), "beams ended within one superstep"


def test_odd_pad_bitmap_matches_reference(odd_db):
    """2040 rows -> 64 bitmap words; tables and bitmaps stay in range."""
    assert bitmap_words(2040) == 64
    _run_both(odd_db, "l2", 1, MAX_HOPS, seed=1)


def test_odd_pad_above_the_shared_bitmap_threshold_matches_reference(wide_db):
    """65,540 rows: the bitmap (2049 words) is one word past what the new
    kernel keeps in shared memory, so the card takes its global
    placement; the plain version stays bitwise equal to the reference."""
    assert bitmap_words(65540) == tr.MAX_SHARED_BITMAP_WORDS + 1
    M0 = wide_db.l0_nbrs.shape[-1]
    assert tr.traversal_route(torch.float32, wide_db.vectors.shape[-1], M0,
                              EF + M0, EF, 65540) == ("async", "global")
    _run_both(wide_db, "l2", 4, MAX_HOPS, seed=3)


def test_max_hops_reached_mid_superstep(pdb):
    """max_hops=5 at H=2: lanes stop in the middle of the third superstep
    and stay frozen after it."""
    steps, final = _run_both(pdb.db, "l2", 2, 5, seed=2)
    assert steps == 3 and (final[5] == 5).all()


def test_merge_sorted_matches_reference():
    """Ties keep `a` first (searchsorted left vs right), batched over rows."""
    import jax

    from repro.core.search import merge_sorted as ref_merge

    rng = np.random.default_rng(0)
    ad = np.sort(rng.integers(0, 6, (5, 9)).astype(np.float32), axis=1)
    bd = np.sort(rng.integers(0, 6, (5, 4)).astype(np.float32), axis=1)
    ad[:, -2:], bd[:, -1] = np.inf, np.inf
    ai = rng.integers(0, 100, (5, 9)).astype(np.int32)
    bi = rng.integers(100, 200, (5, 4)).astype(np.int32)
    rd, ri = jax.vmap(ref_merge)(ad, ai, bd, bi)
    td, ti = tr.merge_sorted(*map(torch.from_numpy, (ad, ai, bd, bi)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))


def test_visited_test_and_set_matches_reference():
    """int32 words hold the reference's uint32 bits, bit 31 included."""
    import jax

    from repro.core.search import visited_test_and_set as ref_tas

    bm = np.zeros((2, 3), np.uint32)
    ids = np.array([[31, 0, 33, 5, 95], [63, 62, 2, 1, 64]], np.int32)
    valid = np.array([[1, 1, 1, 0, 1], [1, 1, 1, 1, 0]], bool)
    tbm = torch.from_numpy(bm.view(np.int32).copy())
    for _ in range(2):                      # second pass: all visited
        rwas, bm = jax.vmap(ref_tas)(bm, ids, valid)
        twas, tbm = tr.visited_test_and_set(tbm, torch.from_numpy(ids),
                                            torch.from_numpy(valid))
        np.testing.assert_array_equal(twas.numpy(), np.asarray(rwas))
        np.testing.assert_array_equal(tbm.numpy().view(np.uint32),
                                      np.asarray(bm))
    assert np.asarray(bm)[0].tolist() == [0x80000001, 0x2, 0x80000000]


def test_cpu_tensors_take_the_plain_version(pdb, monkeypatch):
    """ops.fused_layer0 dispatches on the device: CPU -> plain version,
    and the CUDA wrapper refuses CPU tensors instead of falling back."""
    calls = []
    monkeypatch.setattr(ops, "fused_traversal_ref",
                        lambda *a, **k: calls.append(1))
    tables = [torch.from_numpy(np.ascontiguousarray(getattr(pdb.db, f)))
              for f in ("vectors", "sqnorms", "l0_nbrs")]
    q, qsq, state = _beam_state(pdb.db, "l2", 0)
    args = (*tables, torch.from_numpy(q), torch.from_numpy(qsq),
            *_to_torch(state))
    ops.fused_layer0(*args, fused_hops=2, max_hops=MAX_HOPS)
    assert calls == [1]
    with pytest.raises(ValueError, match="CUDA"):
        tr.fused_traversal_cuda(*args, fused_hops=2, max_hops=MAX_HOPS)


F32, U8, I8 = torch.float32, torch.uint8, torch.int8
SHARED, GLOBAL, LDG = ("async", "shared"), ("async", "global"), ("ldg",
                                                                  "global")


@pytest.mark.parametrize("dtype,d_pad,m0_pad,C,EF,n_pad,route", [
    # the main path's shapes (P=4 partitions of 8,192 rows, M=16, ef=40)
    (F32, 128, 32, 72, 40, 8192, SHARED),
    (U8, 128, 32, 72, 40, 8192, SHARED),
    (I8, 128, 32, 72, 40, 8192, SHARED),
    # N_pad: 65,536 rows (W = 2048 words) keep the bitmap in shared memory,
    # one row more goes to global memory, as do 1M-row tables
    (F32, 128, 32, 72, 40, 65536, SHARED),
    (F32, 128, 32, 72, 40, 65537, GLOBAL),
    (U8, 128, 32, 72, 40, 65537, GLOBAL),
    (F32, 128, 32, 72, 40, 1_000_000, GLOBAL),
    # C: beside an 8 KB bitmap, 119 fits the 28,160-byte budget, 120 not;
    # without the bitmap, 631 fits and 632 goes to traversal.cu
    (F32, 128, 32, 119, 40, 65536, SHARED),
    (F32, 128, 32, 120, 40, 65536, GLOBAL),
    (F32, 128, 32, 631, 40, 1_000_000, GLOBAL),
    (F32, 128, 32, 632, 40, 1_000_000, LDG),
    # M0_pad: a lane of warp 0 a neighbour, 32 at most
    (U8, 128, 24, 64, 40, 8192, SHARED),
    (F32, 128, 40, 80, 40, 8192, LDG),
    # D_pad and dtype: 32 staged float32 rows of 256 take 32 KB, past the
    # budget; 8-bit rows of 512 take 16 KB and stay
    (F32, 256, 32, 72, 40, 8192, LDG),
    (U8, 512, 32, 72, 40, 8192, SHARED),
    (I8, 512, 32, 72, 40, 8192, SHARED),
    (U8, 1024, 32, 72, 40, 8192, LDG),
    (F32, 64, 32, 72, 40, 8192, LDG),          # D_pad % 128 != 0
    (torch.float64, 128, 32, 72, 40, 8192, LDG),
    (F32, 128, 32, 40, 41, 8192, LDG),         # EF > C
])
def test_route_rule(dtype, d_pad, m0_pad, C, EF, n_pad, route):
    """The kernel and bitmap placement on each side of each threshold."""
    assert tr.traversal_route(dtype, d_pad, m0_pad, C, EF, n_pad) == route


@pytest.mark.parametrize("dtype,want", [(F32, 20_240), (U8, 7_952),
                                        (I8, 7_952)])
def test_shared_memory_at_the_path_shapes_fits_eight_ctas(dtype, want):
    """The Python mirror of the kernel's shared-memory layout at the main
    path's shapes (D_pad 128, M0_pad 32, C 72, EF 40, W 256): 8 CTAs an
    SM, each with the card's 1 KB reservation, fit its 228 KB."""
    got = tr.async_smem_bytes(dtype, 128, 32, 72, 40, 256)
    assert got == want
    assert got <= tr.SMEM_BUDGET and 8 * (got + 1024) <= 228 * 1024
    # the widest shared bitmap still fits beside float32 rows
    assert 8 * (tr.async_smem_bytes(F32, 128, 32, 72, 40, 2048)
                + 1024) <= 228 * 1024


def test_cuda_wrapper_routes_by_shape(pdb, monkeypatch):
    """fused_traversal_cuda hands each shape to the route's kernel, on
    shapes alone (the launchers are stubbed: no card here)."""
    calls = []
    for name in ("fused_traversal_async_cuda", "fused_traversal_ldg_cuda"):
        monkeypatch.setattr(tr, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    q, qsq, state = _beam_state(pdb.db, "l2", 0)
    tables = [torch.from_numpy(np.ascontiguousarray(getattr(pdb.db, f)))
              for f in ("vectors", "sqnorms", "l0_nbrs")]
    args = (*tables, torch.from_numpy(q), torch.from_numpy(qsq),
            *_to_torch(state))
    tr.fused_traversal_cuda(*args, fused_hops=2, max_hops=MAX_HOPS)
    # float32 rows of 1,024: 8 staged rows take 32 KB, past the budget
    wide = torch.zeros((2, 320, 1024))
    tr.fused_traversal_cuda(wide, *args[1:], fused_hops=2, max_hops=MAX_HOPS)
    assert calls == ["fused_traversal_async_cuda", "fused_traversal_ldg_cuda"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("which", ["pdb", "wide_db"])
def test_async_kernel_matches_plain_and_ldg(request, which, H, metric):
    """On a card: traversal_async.cu at both bitmap placements (320 rows:
    shared memory; 65,540 rows: global memory) equals the plain version
    and traversal.cu bitwise after every superstep, each launch on its
    own counter."""
    dev = _card()
    db = request.getfixturevalue(which)
    db = db.db if which == "pdb" else db
    tables = [torch.from_numpy(np.ascontiguousarray(getattr(db, f))).to(dev)
              for f in ("vectors", "sqnorms", "l0_nbrs")]
    P, N, D = db.vectors.shape
    M0 = db.l0_nbrs.shape[-1]
    want = SHARED if which == "pdb" else GLOBAL
    assert tr.traversal_route(F32, D, M0, EF + M0, EF, N) == want
    q, qsq, state = _beam_state(db, metric, 0)
    tq, tqsq = torch.from_numpy(q).to(dev), torch.from_numpy(qsq).to(dev)
    sa = [t.to(dev) for t in _to_torch(state)]
    sl, sr = [t.clone() for t in sa], [t.clone() for t in sa]
    a0, l0 = tr.ASYNC_LAUNCHES, tr.LAUNCHES
    steps = 0
    kw = dict(fused_hops=H, max_hops=MAX_HOPS, metric=metric)
    while _live(sr, MAX_HOPS):
        tr.fused_traversal_cuda(*tables, tq, tqsq, *sa, **kw)
        tr.fused_traversal_ldg_cuda(*tables, tq, tqsq, *sl, **kw)
        tr.fused_traversal_ref(*tables, tq, tqsq, *sr, **kw)
        torch.cuda.synchronize()
        steps += 1
        for a, b, c in zip(sa, sl, sr):
            assert torch.equal(a, c) and torch.equal(b, c)
    assert steps >= 2
    assert (tr.ASYNC_LAUNCHES - a0, tr.LAUNCHES - l0) == (steps, steps)


@pytest.mark.cuda
def test_async_shared_memory_count_matches_the_kernel():
    """On a card: the Python mirror equals the kernel's own layout count,
    and the path's shapes keep 8 CTAs resident on an SM."""
    _card()
    for dt in (F32, U8, I8):
        for shape in ((128, 32, 72, 40, 256), (128, 32, 72, 40, 0),
                      (512, 24, 100, 60, 2048)):
            assert tr.async_smem_bytes(dt, *shape) == \
                tr.async_smem_bytes_cuda(dt, *shape)
        assert tr.async_blocks_per_sm(dt, 128, 32, 72, 40, 8192) >= 8
        assert tr.async_blocks_per_sm(dt, 128, 32, 72, 40, 1_000_000) >= 8


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_cuda_kernel_matches_plain_version(pdb, metric):
    """On a card: the CUDA kernel equals the plain version bitwise after
    every superstep (at the full table size this runs in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    tables = [torch.from_numpy(np.ascontiguousarray(getattr(pdb.db, f))).to(dev)
              for f in ("vectors", "sqnorms", "l0_nbrs")]
    q, qsq, state = _beam_state(pdb.db, metric, 0)
    tq, tqsq = torch.from_numpy(q).to(dev), torch.from_numpy(qsq).to(dev)
    sk = [t.to(dev) for t in _to_torch(state)]
    sr = [t.clone() for t in sk]
    launches = tr.ASYNC_LAUNCHES, tr.LAUNCHES
    while _live(sr, MAX_HOPS):
        tr.fused_traversal_cuda(*tables, tq, tqsq, *sk, fused_hops=4,
                                max_hops=MAX_HOPS, metric=metric)
        tr.fused_traversal_ref(*tables, tq, tqsq, *sr, fused_hops=4,
                               max_hops=MAX_HOPS, metric=metric)
        torch.cuda.synchronize()
        for a, b in zip(sk, sr):
            assert torch.equal(a, b)
    # these shapes take traversal_async.cu, with the bitmap in shared memory
    assert tr.ASYNC_LAUNCHES > launches[0] and tr.LAUNCHES == launches[1]
