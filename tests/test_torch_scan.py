"""The exact-scan kernels' plain versions against the reference's kernels.

`repro_torch.kernels.ops.{l2dist, l2topk, l2dist_q, l2topk_q}` on CPU
tensors (the plain versions) are held to the reference's `repro.kernels.ops`
functions, whose Pallas kernels run in interpret mode as
`tests/test_kernels.py` and `tests/test_quantization.py` run them. Inputs
are made by numpy from a seed, at unaligned shapes.

- Integer-valued float32 rows and 8-bit codes: every dot product and norm
  is an exact integer below 2^24, so any summation order gives the same
  value and the two must agree bitwise, ids and distances.
- Gaussian rows: the reference sums in 128- or 512-wide MXU blocks, the
  port in BLAS order, so distances may differ in the last bits. Each
  order's rounding error is about sqrt(D) * 2^-24 * (|q|^2 + |x|^2) for
  random signs and at most D * 2^-24 * (|q|^2 + |x|^2) / 2; the gate is
  |d - d'| <= 1e-5 * (|q|^2 + |x|^2), and the ids agree except where the
  k-th and (k+1)-th distances lie within that tolerance.
- Where fewer than k rows are finite, the reference's +inf slots carry ids
  that depend on its block size; the port's hold -1 (pinned below; see
  ROADMAP.md Queue 3).

The CUDA kernels against the plain versions run only where there is a
card (the `cuda` marker); here they skip.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.core.bruteforce import bruteforce_topk
from repro_torch.kernels import l2dist, l2topk, ops, qdist

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

K = 10
TOL = 1e-5          # relative to |q|^2 + |x|^2 (module docstring)
INT8_SCALE2 = (255 / 127) ** 2
# (Bq, Bx, D): D = 600 takes five K-steps in the reference
SHAPES = [(1, 100, 48), (37, 1500, 128), (37, 100, 600), (1, 1500, 600)]


def _ints(shape, seed, lo=0, hi=256, dtype=np.float32):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(
        dtype)


def _int_data(bq, bx, d, seed):
    """Integer-valued float32 queries and rows; values 0..63 above D=256
    so that every sum stays below 2^24."""
    hi = 256 if d <= 256 else 64
    return _ints((bq, d), seed, hi=hi), _ints((bx, d), seed + 1, hi=hi)


def _gauss(bq, bx, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bq, d)).astype(np.float32),
            rng.normal(size=(bx, d)).astype(np.float32))


def _norm_sum(q, x):
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    return (q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :]


def _ref_topk(fn, *args, **kw):
    v, i = fn(*args, **kw)
    return np.asarray(v), np.asarray(i)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# l2dist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("bq,bx,d", SHAPES)
def test_l2dist_matches_reference_bitwise_on_integer_data(metric, bq, bx, d):
    q, x = _int_data(bq, bx, d, seed=bq + d)
    want = np.asarray(ref_ops.l2dist(q, x, metric=metric))
    got = ops.l2dist(*_t(q, x), metric=metric)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("bq,bx,d", SHAPES[:3])
def test_l2dist_gaussian_within_tolerance(metric, bq, bx, d):
    q, x = _gauss(bq, bx, d, seed=5)
    if metric == "cosine":               # cosine assumes unit-norm rows
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    want = np.asarray(ref_ops.l2dist(q, x, metric=metric))
    got = l2dist.l2dist_ref(*_t(q, x), metric=metric).numpy()
    assert (np.abs(got - want) <= TOL * _norm_sum(q, x)).all()


def test_l2dist_does_not_clamp_and_the_scans_do():
    """One dimension, so no summation order: fl(a^2) + fl(b^2) - 2 fl(ab)
    rounds below zero for this pair. l2dist keeps the negative value, as
    the reference does; l2dist_q, l2topk and l2topk_q clamp it to 0."""
    q = np.array([[1.5944831]], np.float32)
    x = np.array([[1.5944833]], np.float32)
    want = np.asarray(ref_ops.l2dist(q, x))
    got = ops.l2dist(*_t(q, x)).numpy()
    assert want[0, 0] < 0
    np.testing.assert_array_equal(got, want)
    gv, _ = ops.l2topk(*_t(q, x), k=1)
    np.testing.assert_array_equal(gv.numpy(),
                                  np.asarray(ref_ops.l2topk(q, x, k=1)[0]))
    assert gv.item() == 0.0
    assert l2dist.distance_matrix_ref(*_t(q, x), out_scale=2.0).item() == 0.0


def test_l2dist_xsq_given_equals_computed():
    q, x = _int_data(5, 300, 64, seed=3)
    tq, tx = _t(q, x)
    assert torch.equal(l2dist.l2dist_ref(tq, tx, l2dist.sqnorms(tx)),
                       ops.l2dist(tq, tx))


# ---------------------------------------------------------------------------
# l2topk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bq,bx,d", SHAPES)
@pytest.mark.parametrize("k", [1, 10, 64])
def test_l2topk_matches_reference_bitwise_on_integer_data(bq, bx, d, k):
    q, x = _int_data(bq, bx, d, seed=2 * bq + d)
    wv, wi = _ref_topk(ref_ops.l2topk, q, x, k=k)
    gv, gi = ops.l2topk(*_t(q, x), k=k)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_l2topk_padding_rows_excluded():
    """Caller-given xsq with +inf on every row from 100 on."""
    q, x = _int_data(6, 700, 32, seed=13)
    xsq = (x.astype(np.float32) ** 2).sum(1)
    xsq[100:] = np.inf
    wv, wi = _ref_topk(ref_ops.l2topk, q, x, xsq, k=K)
    gv, gi = ops.l2topk(*_t(q, x, xsq), k=K)
    assert gi.numpy().max() < 100
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_l2topk_ties_go_to_the_lower_row():
    """Each row appears three times and the values span 0..3: most
    distances tie, and the reference's order (lower row first) holds."""
    q = _ints((5, 24), 4, hi=4)
    x = np.tile(_ints((400, 24), 5, hi=4), (3, 1))
    wv, wi = _ref_topk(ref_ops.l2topk, q, x, k=32)
    gv, gi = ops.l2topk(*_t(q, x), k=32)
    assert len(np.unique(wv)) < wv.size / 3          # ties dominate
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


@pytest.mark.parametrize("n_valid,pad_rows", [(7, 0), (3, 50)])
def test_l2topk_tail_when_fewer_than_k_rows(n_valid, pad_rows):
    """Fewer than k finite rows (7 rows; or 3 rows before 50 xsq=+inf
    rows): the finite slots equal the reference's, and every other slot
    is (+inf, -1)."""
    q, x = _int_data(3, n_valid + pad_rows, 16, seed=15)
    xsq = (x ** 2).sum(1)
    xsq[n_valid:] = np.inf
    wv, wi = _ref_topk(ref_ops.l2topk, q, x, xsq, k=K)
    gv, gi = (t.numpy() for t in ops.l2topk(*_t(q, x, xsq), k=K))
    np.testing.assert_array_equal(gv[:, :n_valid], wv[:, :n_valid])
    np.testing.assert_array_equal(gi[:, :n_valid], wi[:, :n_valid])
    assert np.isinf(gv[:, n_valid:]).all() and np.isinf(wv[:, n_valid:]).all()
    assert (gi[:, n_valid:] == -1).all()


@pytest.mark.parametrize("bq,bx,d", SHAPES[:3])
def test_l2topk_gaussian_within_tolerance(bq, bx, d):
    q, x = _gauss(bq, bx, d, seed=6)
    wv, wi = _ref_topk(ref_ops.l2topk, q, x, k=K)
    gv, gi = (t.numpy() for t in ops.l2topk(*_t(q, x), k=K))
    full = _norm_sum(q, x)
    tol = TOL * np.take_along_axis(full, wi.astype(np.int64), 1)
    assert (np.abs(gv - wv) <= tol).all()
    # ids agree except where the k-th and (k+1)-th distances are within tol
    d = np.sort(np.maximum(np.asarray(ref_ops.l2dist(q, x)), 0), axis=1)
    near = (d[:, K] - d[:, K - 1]) <= 2 * TOL * full.max(1)
    for r in range(bq):
        if not near[r]:
            assert set(gi[r]) == set(wi[r]), r


def test_l2topk_plain_version_equals_the_exact_backend_scan():
    """On integer data the plain version equals `core/bruteforce.py`'s
    chunked scan (the exact backend's ground truth), ids and distances."""
    q, x = _int_data(9, 2048, 128, seed=21)
    tq, tx = _t(q, x)
    ids, dists = bruteforce_topk(tx, l2dist.sqnorms(tx), tq, k=K, chunk=512)
    gv, gi = l2topk.l2topk_ref(tq, tx, k=K)
    assert torch.equal(gi, ids) and torch.equal(gv, dists)


# ---------------------------------------------------------------------------
# l2dist_q / l2topk_q over 8-bit codes
# ---------------------------------------------------------------------------

CODES = [(np.uint8, 0, 256), (np.int8, -127, 128)]


@pytest.mark.parametrize("np_dtype,lo,hi", CODES)
@pytest.mark.parametrize("out_scale", [1.0, INT8_SCALE2])
@pytest.mark.parametrize("bq,bx,d", SHAPES[:2] + [(37, 100, 200)])
def test_l2dist_q_matches_reference_bitwise(np_dtype, lo, hi, out_scale, bq,
                                            bx, d):
    q = _ints((bq, d), 31, lo, hi, np_dtype)
    x = _ints((bx, d), 32, lo, hi, np_dtype)
    want = np.asarray(ref_ops.l2dist_q(q, x, out_scale=out_scale))
    got = ops.l2dist_q(*_t(q, x), out_scale=out_scale)
    np.testing.assert_array_equal(got.numpy(), want)
    # code-valued float32 queries give the same matrix
    got_f = ops.l2dist_q(*_t(q.astype(np.float32), x), out_scale=out_scale)
    assert torch.equal(got_f, got)


@pytest.mark.parametrize("np_dtype,lo,hi", CODES)
@pytest.mark.parametrize("out_scale", [1.0, INT8_SCALE2])
@pytest.mark.parametrize("bq,bx,d,k", [(1, 100, 48, 10), (37, 1500, 128, 10),
                                       (37, 1500, 200, 64)])
def test_l2topk_q_matches_reference_bitwise(np_dtype, lo, hi, out_scale, bq,
                                            bx, d, k):
    q = _ints((bq, d), 41, lo, hi, np_dtype)
    x = _ints((bx, d), 42, lo, hi, np_dtype)
    wv, wi = _ref_topk(ref_ops.l2topk_q, q, x, k=k, out_scale=out_scale)
    gv, gi = ops.l2topk_q(*_t(q, x), k=k, out_scale=out_scale)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


@pytest.mark.parametrize("np_dtype,lo,hi", CODES)
def test_l2topk_q_pads_ties_and_tail(np_dtype, lo, hi):
    """Duplicate code rows (ties), +inf xsq pad rows, and a query set whose
    k exceeds the finite rows of a second table (the pinned tail)."""
    q = _ints((6, 32), 51, lo, hi, np_dtype)
    base = _ints((300, 32), 52, lo, hi, np_dtype)
    x = np.concatenate([base, base[::-1]])
    xsq = (x.astype(np.float32) ** 2).sum(1)
    xsq[450:] = np.inf
    wv, wi = _ref_topk(ref_ops.l2topk_q, q, x, xsq, k=20,
                       out_scale=INT8_SCALE2)
    gv, gi = ops.l2topk_q(*_t(q, x, xsq), k=20, out_scale=INT8_SCALE2)
    assert gi.numpy().max() < 450
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)
    few = x[:5]
    wv, wi = _ref_topk(ref_ops.l2topk_q, q, few, k=8)
    gv, gi = (t.numpy() for t in ops.l2topk_q(*_t(q, few), k=8))
    np.testing.assert_array_equal(gv[:, :5], wv[:, :5])
    np.testing.assert_array_equal(gi[:, :5], wi[:, :5])
    assert np.isinf(gv[:, 5:]).all() and (gi[:, 5:] == -1).all()


def test_uint8_codes_of_byte_data_equal_the_float32_scan():
    """Byte data quantizes to itself at scale 1: l2topk_q over its uint8
    codes gives l2topk's ids and distances."""
    q, x = _int_data(7, 900, 128, seed=61)
    fv, fi = ops.l2topk(*_t(q, x), k=K)
    uv, ui = ops.l2topk_q(*_t(q.astype(np.uint8), x.astype(np.uint8)), k=K)
    assert torch.equal(fi, ui) and torch.equal(fv, uv)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """ops dispatch on the device: CPU -> plain version; the CUDA wrappers
    refuse CPU tensors instead of falling back."""
    calls = []
    for name in ("l2dist_ref", "l2topk_ref", "l2dist_q_ref", "l2topk_q_ref"):
        monkeypatch.setattr(ops, name,
                            lambda *a, _n=name, **kw: calls.append(_n))
    q, x = _t(*_int_data(2, 50, 16, seed=1))
    qc, xc = q.to(torch.uint8), x.to(torch.uint8)
    ops.l2dist(q, x)
    ops.l2topk(q, x, k=3)
    ops.l2dist_q(qc, xc)
    ops.l2topk_q(qc, xc, k=3)
    assert calls == ["l2dist_ref", "l2topk_ref", "l2dist_q_ref",
                     "l2topk_q_ref"]
    for fn, args in ((l2dist.l2dist_cuda, (q, x)), (l2topk.l2topk_cuda, (q, x)),
                     (qdist.l2dist_q_cuda, (qc, xc)),
                     (qdist.l2topk_q_cuda, (qc, xc))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


# ---------------------------------------------------------------------------
# on a card: the kernels against the plain versions
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bx,d", SHAPES + [(256, 70000, 128), (3, 5, 7)])
@pytest.mark.parametrize("row_dtype", [torch.float32, torch.uint8, torch.int8])
def test_cuda_scan_kernels_match_plain_versions(bq, bx, d, row_dtype):
    dev = _cuda()
    q, x = _int_data(bq, bx, d, seed=71)
    if row_dtype == torch.int8:                      # signed codes
        q, x = np.clip(q - 128, -127, 127), np.clip(x - 128, -127, 127)
    q, x = (t.to(dev) for t in _t(q, x))
    x = x.to(row_dtype)
    counts = (l2dist.TC_LAUNCHES, l2dist.LAUNCHES, l2topk.TC_LAUNCHES,
              l2topk.LAUNCHES, qdist.L2DIST_Q_LAUNCHES,
              qdist.L2TOPK_Q_LAUNCHES)
    tc = l2dist.takes_tensor_cores(q, x)       # by dtype and shape
    tc_topk = l2topk.takes_tensor_cores(q, x)
    xsq = l2dist.sqnorms(x)
    xsq[bx // 2:] = float("inf")
    for metric in ("l2", "ip", "cosine"):
        assert torch.equal(l2dist.l2dist_cuda(q, x, metric=metric),
                           l2dist.l2dist_ref(q, x, metric=metric))
    for k in (1, 10, 64):
        for xs in (None, xsq):
            got = l2topk.l2topk_cuda(q, x, xs, k=k)
            want = l2topk.l2topk_ref(q, x, xs, k=k)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    if row_dtype != torch.float32:
        assert torch.equal(qdist.l2dist_q_cuda(q, x, out_scale=INT8_SCALE2),
                           qdist.l2dist_q_ref(q, x, out_scale=INT8_SCALE2))
        got = qdist.l2topk_q_cuda(q, x, xsq, k=10, out_scale=INT8_SCALE2)
        want = qdist.l2topk_q_ref(q, x, xsq, k=10, out_scale=INT8_SCALE2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    # the queries are float32, so the 8-bit scans take their FMA kernels
    quant = row_dtype != torch.float32
    assert (l2dist.TC_LAUNCHES, l2dist.LAUNCHES, l2topk.TC_LAUNCHES,
            l2topk.LAUNCHES, qdist.L2DIST_Q_LAUNCHES,
            qdist.L2TOPK_Q_LAUNCHES) == (
        counts[0] + 3 * tc, counts[1] + 3 * (not tc), counts[2] + 6 * tc_topk,
        counts[3] + 6 * (not tc_topk), counts[4] + quant, counts[5] + quant)


@pytest.mark.cuda
def test_cuda_scan_kernels_gaussian_within_tolerance():
    dev = _cuda()
    q, x = (t.to(dev) for t in _t(*_gauss(64, 20000, 128, seed=8)))
    full = (l2dist.sqnorms(q)[:, None] + l2dist.sqnorms(x)[None, :])
    d_k, d_r = l2dist.l2dist_cuda(q, x), l2dist.l2dist_ref(q, x)
    assert bool(((d_k - d_r).abs() <= TOL * full).all())
    (gv, gi), (wv, wi) = l2topk.l2topk_cuda(q, x, k=K), l2topk.l2topk_ref(
        q, x, k=K)
    assert bool(((gv - wv).abs() <= TOL * full.max(1).values[:, None]).all())
    assert (gi == wi).float().mean() > 0.99


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_operands():
    dev = _cuda()
    q = torch.zeros((4, 16), device=dev)
    x = torch.zeros((100, 16), device=dev)
    with pytest.raises(TypeError):
        l2dist.l2dist_cuda(q, x.double())
    with pytest.raises(TypeError):
        qdist.l2topk_q_cuda(q, x, k=5)               # float rows: not codes
    with pytest.raises(ValueError):
        l2topk.l2topk_cuda(q, x[:, :8].contiguous(), k=5)
    with pytest.raises(ValueError):
        l2topk.l2topk_cuda(q, x, k=65)
    with pytest.raises(ValueError):
        l2dist.l2dist_cuda(q.cpu(), x)
    with pytest.raises(ValueError):
        l2topk.l2topk_cuda(q, x, torch.zeros(99, device=dev), k=5)
    with pytest.raises(ValueError):                  # not contiguous
        l2dist.l2dist_cuda(q, torch.zeros((16, 100), device=dev).t())
