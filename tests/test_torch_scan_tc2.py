"""The exact scans' second pair of tensor-core routes: `l2topk` on float32
rows (3 x TF32 with selection warps, `csrc/l2topk_tc.cu`) and `l2dist_q`
on 8-bit code queries (u8 / s8 `wgmma` with a TMA-stored output,
`csrc/l2dist_q_tc.cu`).

On the CPU:
- the route predicates by dtype, D, Bx and alignment:
  `l2topk.takes_tensor_cores` has no rule on Bx (the kernel stores no
  [Bq, Bx] matrix), `qdist.takes_tensor_cores_dist` needs Bx % 4 == 0 (the
  output's row pitch);
- `ops.l2topk` over integer-valued float32 rows at D = 48 and 128 (the
  tensor-core route's operands) with +inf pad rows, bitwise against the
  reference's `ops.l2topk` in interpret mode at k = 1, 10 and 64;
- `ops.l2dist_q` over uint8 and int8 code queries at out_scale = (255 /
  127)^2, bitwise against the reference's `l2dist_q_pallas` in interpret
  mode, with and without +inf xsq pad rows.

On a card (the `cuda` marker; skipped here): each new kernel against its
plain version at 3 x 70,000 x 128 and x 48, which counter each shape
moves, Gaussian rows within the scan's tolerance, and both wrappers
raising on shapes they refuse.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.qdist import l2dist_q_pallas
from repro_torch.kernels import l2dist, l2topk, ops, qdist

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

TOL = 1e-5              # the scan's gate, relative to |q|^2 + |x|^2
INT8_SCALE2 = (255 / 127) ** 2
CODES = [(torch.uint8, np.uint8, 0, 256), (torch.int8, np.int8, -128, 128)]


def _ints(shape, seed, lo=0, hi=256, dtype=np.float32):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(
        dtype)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# route predicates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_dtype,x_dtype,d,bx,want", [
    (torch.float32, torch.float32, 128, 1000, True),
    (torch.float32, torch.float32, 48, 70_000, True),
    (torch.float32, torch.float32, 128, 70_001, True),   # no Bx rule
    (torch.float32, torch.float32, 4, 1, True),
    (torch.float32, torch.float32, 128, 0, False),       # no rows
    (torch.float32, torch.float32, 132, 1000, False),    # D > 128
    (torch.float32, torch.float32, 130, 1000, False),    # D % 4
    (torch.float32, torch.float32, 200, 1000, False),
    (torch.float32, torch.uint8, 128, 1000, False),      # 8-bit rows
    (torch.float32, torch.int8, 128, 1000, False),
    (torch.uint8, torch.float32, 128, 1000, False),
    (torch.float64, torch.float32, 128, 1000, False),
])
def test_l2topk_route_by_dtype_and_shape(q_dtype, x_dtype, d, bx, want):
    q = torch.zeros((3, d), dtype=q_dtype)
    x = torch.zeros((bx, d), dtype=x_dtype)
    assert l2topk.takes_tensor_cores(q, x) is want


def test_l2topk_route_by_alignment_and_layout():
    q, x = torch.zeros((3, 128)), torch.zeros((1001, 128))
    assert l2topk.takes_tensor_cores(q, x[1:])
    # a base 4 bytes past a 16-byte boundary
    flat = torch.zeros(1000 * 128 + 4)
    assert flat.data_ptr() % 16 == 0
    assert not l2topk.takes_tensor_cores(q, flat[1:-3].view(1000, 128))
    assert not l2topk.takes_tensor_cores(flat[1:129].view(1, 128), x)
    # not contiguous: a column slice of wider rows
    assert not l2topk.takes_tensor_cores(q, torch.zeros((100, 256))[:, :128])
    assert not l2topk.takes_tensor_cores(torch.zeros((3, 256))[:, :128], x)


@pytest.mark.parametrize("q_dtype,x_dtype,d,bx,want", [
    (torch.uint8, torch.uint8, 128, 70_000, True),
    (torch.int8, torch.int8, 128, 70_000, True),
    (torch.uint8, torch.uint8, 48, 1000, True),
    (torch.int8, torch.int8, 256, 1000, True),
    (torch.uint8, torch.uint8, 16, 4, True),
    (torch.uint8, torch.uint8, 128, 70_001, False),      # the output pitch
    (torch.int8, torch.int8, 128, 1002, False),
    (torch.uint8, torch.uint8, 128, 0, False),           # no rows
    (torch.uint8, torch.uint8, 272, 1000, False),        # D > 256
    (torch.uint8, torch.uint8, 200, 1000, False),        # D % 16
    (torch.float32, torch.uint8, 128, 1000, False),      # code-valued floats
    (torch.float32, torch.int8, 128, 1000, False),
    (torch.uint8, torch.int8, 128, 1000, False),         # another code dtype
    (torch.float32, torch.float32, 128, 1000, False),    # float rows
])
def test_l2dist_q_route_by_dtype_and_shape(q_dtype, x_dtype, d, bx, want):
    q = torch.zeros((3, d), dtype=q_dtype)
    x = torch.zeros((bx, d), dtype=x_dtype)
    assert qdist.takes_tensor_cores_dist(q, x) is want
    # l2topk_q's route has no Bx rule: it differs only where Bx % 4 != 0
    if want or bx % 4 == 0:
        assert qdist.takes_tensor_cores(q, x) is want


def test_l2dist_q_route_by_alignment():
    q = torch.zeros((3, 128), dtype=torch.uint8)
    flat = torch.zeros(700 * 128 + 16, dtype=torch.uint8)
    assert flat.data_ptr() % 16 == 0
    assert qdist.takes_tensor_cores_dist(q, flat[16:].view(700, 128))
    assert not qdist.takes_tensor_cores_dist(q, flat[8:-8].view(700, 128))
    assert not qdist.takes_tensor_cores_dist(flat[8:8 + 384].view(3, 128),
                                             flat[16:].view(700, 128))


# ---------------------------------------------------------------------------
# the tensor-core routes' operands against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [48, 128])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_l2topk_float_rows_match_reference_bitwise(d, k):
    """Integer-valued float32 rows up to 255 (the TF32 split's lo piece is
    0 there) with 16 +inf pad rows: ids and distances bitwise."""
    q = _ints((5, d), 101 + d)
    x = _ints((1300, d), 102 + d)
    xsq = (x ** 2).sum(1)
    xsq[-16:] = np.inf
    wv, wi = (np.asarray(a) for a in ref_ops.l2topk(q, x, xsq, k=k))
    tq, tx, txsq = _t(q, x, xsq)
    assert l2topk.takes_tensor_cores(tq, tx)
    gv, gi = ops.l2topk(tq, tx, txsq, k=k)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)
    assert gi.numpy().max() < 1300 - 16


@pytest.mark.parametrize("t_dtype,np_dtype,lo,hi", CODES)
@pytest.mark.parametrize("d", [48, 128])
@pytest.mark.parametrize("pads", [False, True])
def test_l2dist_q_code_queries_match_reference_bitwise(t_dtype, np_dtype, lo,
                                                       hi, d, pads):
    """Code queries of the rows' dtype (int8 codes of -128 included), the
    scale applied after the clamp; a pad row's column reads +inf."""
    q = _ints((8, d), 111 + d, lo, hi, np_dtype)
    x = _ints((1024, d), 112 + d, lo, hi, np_dtype)
    xsq = None
    if pads:
        xsq = (x.astype(np.float32) ** 2).sum(1)
        xsq[-16:] = np.inf
    want = np.asarray(l2dist_q_pallas(
        q, x, xsq=xsq, block_q=8, block_x=512, block_d=d, interpret=True,
        out_scale=INT8_SCALE2))
    tq, tx = _t(q, x)
    assert tq.dtype == t_dtype and qdist.takes_tensor_cores_dist(tq, tx)
    got = ops.l2dist_q(tq, tx, None if xsq is None else _t(xsq)[0],
                       out_scale=INT8_SCALE2)
    np.testing.assert_array_equal(got.numpy(), want)
    if pads:
        assert np.isinf(got.numpy()[:, -16:]).all()
        assert np.isfinite(got.numpy()[:, :-16]).all()


# ---------------------------------------------------------------------------
# on a card: the tensor-core kernels against their plain versions
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _counts():
    return {"l2topk_tc": l2topk.TC_LAUNCHES, "l2topk_fma": l2topk.LAUNCHES,
            "l2dist_q_tc": qdist.L2DIST_Q_TC_LAUNCHES,
            "l2dist_q_fma": qdist.L2DIST_Q_LAUNCHES}


def _moved(before):
    return {n: v - before[n] for n, v in _counts().items() if v != before[n]}


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bx,d", [(3, 70_000, 128), (3, 70_000, 48),
                                     (3, 70_001, 128), (256, 70_000, 128),
                                     (70, 1000, 4), (3, 70_000, 200)])
def test_cuda_l2topk_routes_match_plain_version(bq, bx, d):
    """Integer rows: bitwise at k = 1, 10, 64, with and without +inf pad
    rows, on the route the shape takes (Bx = 70,001 stays on the tensor
    cores, D = 200 goes to the FMA kernel)."""
    dev = _cuda()
    q, x = (t.to(dev) for t in _t(_ints((bq, d), 121), _ints((bx, d), 122)))
    tc = d % 4 == 0 and d <= 128
    assert l2topk.takes_tensor_cores(q, x) is tc
    xsq = l2dist.sqnorms(x)
    xsq[-16:] = float("inf")
    before = _counts()
    for k in (1, 10, 64):
        for xs in (None, xsq):
            got = l2topk.l2topk_cuda(q, x, xs, k=k)
            want = l2topk.l2topk_ref(q, x, xs, k=k)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (k, xs)
            if xs is not None:
                assert int(got[1].max()) < bx - 16
    torch.cuda.synchronize()
    assert _moved(before) == {"l2topk_tc" if tc else "l2topk_fma": 6}


@pytest.mark.cuda
def test_cuda_l2topk_tc_gaussian_within_tolerance():
    """Gaussian rows: distances within TOL x (|q|^2 + |x|^2) of the plain
    version's, ids the same wherever the k-th and (k+1)-th distances are
    clear of each other by twice that."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((70_000, 128), generator=g, device=dev)
    q = torch.randn((64, 128), generator=g, device=dev)
    k = 10
    (gv, gi), (wv, wi) = l2topk.l2topk_tc_cuda(q, x, k=k), \
        l2topk.l2topk_ref(q, x, k=k + 1)
    tol = TOL * (l2dist.sqnorms(q) + l2dist.sqnorms(x).max())[:, None]
    assert bool(((gv - wv[:, :k]).abs() <= tol).all())
    clear = (wv[:, k] - wv[:, k - 1]) > 2 * tol[:, 0]
    same = (torch.sort(gi, 1).values == torch.sort(wi[:, :k], 1).values).all(1)
    assert bool(same[clear].all())


@pytest.mark.cuda
@pytest.mark.parametrize("t_dtype,np_dtype,lo,hi", CODES)
@pytest.mark.parametrize("bq,bx,d", [(3, 70_000, 128), (3, 70_000, 48),
                                     (256, 70_000, 128), (70, 5000, 256),
                                     (3, 70_001, 128), (3, 70_000, 200)])
def test_cuda_l2dist_q_routes_match_plain_version(t_dtype, np_dtype, lo, hi,
                                                  bq, bx, d):
    """Code queries: bitwise, with and without +inf pad rows, on the route
    the shape takes (Bx = 70,001 and D = 200 go to the FMA kernel); the
    same queries as float32 always take the FMA kernel."""
    dev = _cuda()
    q, x = (t.to(dev) for t in _t(_ints((bq, d), 131, lo, hi, np_dtype),
                                  _ints((bx, d), 132, lo, hi, np_dtype)))
    tc = d % 16 == 0 and d <= 256 and bx % 4 == 0
    assert qdist.takes_tensor_cores_dist(q, x) is tc
    assert not qdist.takes_tensor_cores_dist(q.float(), x)
    xsq = l2dist.sqnorms(x)
    xsq[-16:] = float("inf")
    before = _counts()
    for xs in (None, xsq):
        want = qdist.l2dist_q_ref(q, x, xs, out_scale=INT8_SCALE2)
        for qq in (q, q.float()):
            got = qdist.l2dist_q_cuda(qq, x, xs, out_scale=INT8_SCALE2)
            assert torch.equal(got, want), (qq.dtype, xs is None)
    torch.cuda.synchronize()
    want_moved = {"l2dist_q_tc": 2, "l2dist_q_fma": 2} if tc else \
        {"l2dist_q_fma": 4}
    assert _moved(before) == want_moved


@pytest.mark.cuda
def test_cuda_new_tc_wrappers_raise_on_shapes_they_refuse():
    dev = _cuda()
    q = torch.zeros((4, 200), device=dev)
    with pytest.raises(ValueError, match="tensor-core"):
        l2topk.l2topk_tc_cuda(q, torch.zeros((100, 200), device=dev), k=5)
    with pytest.raises(TypeError):              # 8-bit rows
        l2topk.l2topk_tc_cuda(q[:, :128].contiguous(),
                              torch.zeros((100, 128), dtype=torch.uint8,
                                          device=dev), k=5)
    with pytest.raises(ValueError):
        l2topk.l2topk_tc_cuda(q[:, :128].contiguous(),
                              torch.zeros((100, 128), device=dev), k=65)
    c = torch.zeros((101, 128), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="tensor-core"):
        qdist.l2dist_q_tc_cuda(c[:4].contiguous(), c)          # Bx % 4
    with pytest.raises(ValueError, match="tensor-core"):
        qdist.l2dist_q_tc_cuda(c[:4].float(), c[:100])         # float queries
