"""The exact scans' tensor-core routes: `l2dist` on float32 rows (3 x TF32,
`csrc/l2dist_tc.cu`) and `l2topk_q` on 8-bit code queries (u8 / s8
`wgmma`, `csrc/l2topk_q_tc.cu`).

On the CPU:
- the plain model of the TF32 split (`l2dist.tf32_split`): hi + lo == x
  exactly, lo == 0 on integers up to 2048, and the three-product dot the
  kernel forms (hi.hi + hi.lo + lo.hi, each lo read as TF32 by the units)
  within 3e-6 * (qsq + xsq) of the exact dot on Gaussian rows;
- the route predicates by dtype, D, Bx and alignment (`takes_tensor_cores`
  in `kernels/l2dist.py` and `kernels/qdist.py`);
- `ops.l2topk_q` over uint8 and int8 code queries (the tensor-core route's
  operands) held bitwise to the reference's `l2topk_q_pallas` in interpret
  mode at k = 1, 10 and 64, with and without +inf pad rows.

On a card (the `cuda` marker; skipped here): each new kernel against its
plain version at ragged shapes, and which route and counter each shape
takes.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import l2dist, ops, qdist

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

TOL = 1e-5              # the scan's gate, relative to |q|^2 + |x|^2
SPLIT_TOL = 3e-6        # the 3 x TF32 dot's error, relative to the same
INT8_SCALE2 = (255 / 127) ** 2
CODES = [(torch.uint8, np.uint8, 0, 256), (torch.int8, np.int8, -127, 128)]


def _ints(shape, seed, lo=0, hi=256, dtype=np.float32):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(
        dtype)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the TF32 split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e6, 1e30])
def test_tf32_pieces_sum_back_exactly(scale):
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=200_000).astype(np.float32) * np.float32(scale))
    hi, lo = l2dist.tf32_split(x)
    assert torch.equal(hi + lo, x)
    # hi keeps 10 bits of mantissa: its low 13 bits are zero
    assert int((hi.view(torch.int32) & ((1 << 13) - 1)).abs().max()) == 0
    # lo is below hi's last bit
    fin = hi != 0
    assert bool((lo[fin].abs() <= hi[fin].abs() * 2.0 ** -10).all())


def test_tf32_lo_is_zero_on_integers_up_to_2048():
    x = torch.arange(-2048, 2049, dtype=torch.float32)
    hi, lo = l2dist.tf32_split(x)
    assert torch.equal(hi, x) and bool((lo == 0).all())
    # 2049 needs 12 bits: it is the first integer whose lo is not zero
    assert l2dist.tf32_split(torch.tensor([2049.0]))[1].item() == 1.0


@pytest.mark.parametrize("d,seed", [(48, 2), (128, 3), (128, 4), (100, 5)])
def test_three_tf32_products_stay_within_3e6(d, seed):
    """The kernel's dot: hi.hi + hi.lo + lo.hi, where the units read each
    lo to TF32 too (`tf32_split(lo)[0]`), summed here in float64 from the
    pieces, against the exact float64 dot of the float32 rows."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(16, d)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32))
    (qh, ql), (xh, xl) = l2dist.tf32_split(q), l2dist.tf32_split(x)
    ql, xl = l2dist.tf32_split(ql)[0], l2dist.tf32_split(xl)[0]
    f = torch.float64
    dot3 = (qh.to(f) @ xh.to(f).T + qh.to(f) @ xl.to(f).T
            + ql.to(f) @ xh.to(f).T)
    exact = q.to(f) @ x.to(f).T
    norms = (q.to(f) ** 2).sum(1)[:, None] + (x.to(f) ** 2).sum(1)[None, :]
    err = ((dot3 - exact).abs() / norms).max().item()
    assert err <= SPLIT_TOL
    # a single TF32 product would not: it is off by ~2^-11 relative
    err1 = ((qh.to(f) @ xh.to(f).T - exact).abs() / norms).max().item()
    assert err1 > 10 * TOL


# ---------------------------------------------------------------------------
# route predicates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_dtype,x_dtype,d,bx,want", [
    (torch.float32, torch.float32, 128, 1000, True),
    (torch.float32, torch.float32, 48, 70_000, True),
    (torch.float32, torch.float32, 4, 8, True),
    (torch.float32, torch.float32, 132, 1000, False),    # D > 128
    (torch.float32, torch.float32, 130, 1000, False),    # D % 4
    (torch.float32, torch.float32, 7, 1000, False),
    (torch.float32, torch.float32, 128, 1001, False),    # the output pitch
    (torch.float32, torch.uint8, 128, 1000, False),      # 8-bit rows
    (torch.uint8, torch.float32, 128, 1000, False),
    (torch.float64, torch.float32, 128, 1000, False),
])
def test_l2dist_route_by_dtype_and_shape(q_dtype, x_dtype, d, bx, want):
    q = torch.zeros((3, d), dtype=q_dtype)
    x = torch.zeros((bx, d), dtype=x_dtype)
    assert l2dist.takes_tensor_cores(q, x) is want


def test_l2dist_route_by_alignment():
    q, x = torch.zeros((3, 128)), torch.zeros((1001, 128))
    assert l2dist.takes_tensor_cores(q, x[1:])
    # a base 4 bytes past a 16-byte boundary
    flat = torch.zeros(1000 * 128 + 4)
    assert flat.data_ptr() % 16 == 0
    assert not l2dist.takes_tensor_cores(q, flat[1:-3].view(1000, 128))
    assert not l2dist.takes_tensor_cores(flat[1:129].view(1, 128), x[1:])


@pytest.mark.parametrize("q_dtype,x_dtype,d,want", [
    (torch.uint8, torch.uint8, 128, True),
    (torch.int8, torch.int8, 128, True),
    (torch.uint8, torch.uint8, 48, True),
    (torch.int8, torch.int8, 256, True),
    (torch.uint8, torch.uint8, 272, False),      # D > 256: sums past 2^24
    (torch.uint8, torch.uint8, 200, False),      # D % 16
    (torch.float32, torch.uint8, 128, False),    # code-valued float queries
    (torch.float32, torch.int8, 128, False),
    (torch.uint8, torch.int8, 128, False),       # another code dtype
    (torch.float32, torch.float32, 128, False),  # float rows: not codes
])
def test_l2topk_q_route_by_dtype_and_shape(q_dtype, x_dtype, d, want):
    q = torch.zeros((3, d), dtype=q_dtype)
    x = torch.zeros((700, d), dtype=x_dtype)
    assert qdist.takes_tensor_cores(q, x) is want


def test_l2topk_q_route_needs_a_row():
    q = torch.zeros((3, 128), dtype=torch.uint8)
    assert not qdist.takes_tensor_cores(q, torch.zeros((0, 128),
                                                       dtype=torch.uint8))


def test_l2topk_q_route_by_alignment():
    q = torch.zeros((3, 128), dtype=torch.uint8)
    flat = torch.zeros(700 * 128 + 16, dtype=torch.uint8)
    assert flat.data_ptr() % 16 == 0
    assert qdist.takes_tensor_cores(q, flat[16:].view(700, 128))
    assert not qdist.takes_tensor_cores(q, flat[8:-8].view(700, 128))


# ---------------------------------------------------------------------------
# l2topk_q over code queries against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t_dtype,np_dtype,lo,hi", CODES)
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("pads", [False, True])
def test_l2topk_q_code_queries_match_reference_bitwise(t_dtype, np_dtype, lo,
                                                       hi, k, pads):
    q = _ints((5, 128), 81, lo, hi, np_dtype)
    x = _ints((1300, 128), 82, lo, hi, np_dtype)
    xsq = None
    if pads:
        xsq = (x.astype(np.float32) ** 2).sum(1)
        xsq[-16:] = np.inf
    args = (q, x) if xsq is None else (q, x, xsq)
    wv, wi = (np.asarray(a) for a in ref_ops.l2topk_q(
        *args, k=k, out_scale=INT8_SCALE2))
    tq, tx = _t(q, x)
    assert tq.dtype == t_dtype and qdist.takes_tensor_cores(tq, tx)
    gv, gi = ops.l2topk_q(tq, tx, None if xsq is None else _t(xsq)[0], k=k,
                          out_scale=INT8_SCALE2)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)
    if pads:
        assert gi.numpy().max() < 1300 - 16


# ---------------------------------------------------------------------------
# on a card: the tensor-core kernels against their plain versions
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _counts():
    return (l2dist.TC_LAUNCHES, l2dist.LAUNCHES, qdist.L2TOPK_Q_TC_LAUNCHES,
            qdist.L2TOPK_Q_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bx,d", [(3, 70_000, 128), (3, 70_000, 48),
                                     (256, 70_000, 128), (70, 1000, 4),
                                     (3, 1001, 128), (3, 70_000, 200)])
def test_cuda_l2dist_routes_match_plain_version(bq, bx, d):
    """Integer rows: bitwise, l2 / ip / cosine, with and without +inf pad
    rows, on the route the shape takes; Bx = 1001 and D = 200 go to the
    FMA kernel."""
    dev = _cuda()
    rng = np.random.default_rng(bq + bx + d)
    q, x = (torch.from_numpy(rng.integers(0, 256, size=s).astype(
        np.float32)).to(dev) for s in ((bq, d), (bx, d)))
    tc = bx % 4 == 0 and d % 4 == 0 and d <= 128
    assert l2dist.takes_tensor_cores(q, x) is tc
    xsq = l2dist.sqnorms(x)
    xsq[-16:] = float("inf")
    before = _counts()
    for metric in ("l2", "ip", "cosine"):
        assert torch.equal(l2dist.l2dist_cuda(q, x, metric=metric),
                           l2dist.l2dist_ref(q, x, metric=metric))
    assert torch.equal(l2dist.l2dist_cuda(q, x, xsq),
                       l2dist.l2dist_ref(q, x, xsq))
    torch.cuda.synchronize()
    after = _counts()
    assert (after[0] - before[0], after[1] - before[1]) == \
        ((4, 0) if tc else (0, 4))


@pytest.mark.cuda
def test_cuda_l2dist_tc_gaussian_within_tolerance():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((70_000, 128), generator=g, device=dev)
    q = torch.randn((3, 128), generator=g, device=dev)
    for xs, qs, metric in ((x, q, "l2"), (x, q, "ip"),
                           (x / x.norm(dim=1, keepdim=True),
                            q / q.norm(dim=1, keepdim=True), "cosine")):
        full = l2dist.sqnorms(qs)[:, None] + l2dist.sqnorms(xs)[None, :]
        got = l2dist.l2dist_tc_cuda(qs, xs, metric=metric)
        want = l2dist.l2dist_ref(qs, xs, metric=metric)
        assert bool(((got - want).abs() <= TOL * full).all()), metric


@pytest.mark.cuda
@pytest.mark.parametrize("t_dtype,np_dtype,lo,hi", CODES)
@pytest.mark.parametrize("bq,bx,d", [(3, 70_000, 128), (3, 70_000, 48),
                                     (256, 70_000, 128), (70, 5000, 256),
                                     (3, 70_000, 200)])
def test_cuda_l2topk_q_routes_match_plain_version(t_dtype, np_dtype, lo, hi,
                                                  bq, bx, d):
    """Code queries: bitwise at k = 1, 10, 64, with and without pad rows,
    on the route the shape takes (D = 200 goes to the FMA kernel); the
    same queries as float32 always take the FMA kernel."""
    dev = _cuda()
    q, x = (t.to(dev) for t in _t(_ints((bq, d), 91, lo, hi, np_dtype),
                                  _ints((bx, d), 92, lo, hi, np_dtype)))
    tc = d % 16 == 0 and d <= 256
    assert qdist.takes_tensor_cores(q, x) is tc
    assert not qdist.takes_tensor_cores(q.float(), x)
    xsq = l2dist.sqnorms(x)
    xsq[-16:] = float("inf")
    before = _counts()
    for k in (1, 10, 64):
        for xs in (None, xsq):
            want = qdist.l2topk_q_ref(q, x, xs, k=k, out_scale=INT8_SCALE2)
            for qq in (q, q.float()):
                got = qdist.l2topk_q_cuda(qq, x, xs, k=k,
                                          out_scale=INT8_SCALE2)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    after = _counts()
    assert (after[2] - before[2], after[3] - before[3]) == \
        ((6, 6) if tc else (0, 12))


@pytest.mark.cuda
def test_cuda_tc_wrappers_raise_on_shapes_they_refuse():
    dev = _cuda()
    q = torch.zeros((4, 200), device=dev)
    with pytest.raises(ValueError, match="tensor-core"):
        l2dist.l2dist_tc_cuda(q, torch.zeros((100, 200), device=dev))
    with pytest.raises(ValueError, match="tensor-core"):
        l2dist.l2dist_tc_cuda(q[:, :128].contiguous(),
                              torch.zeros((101, 128), device=dev))
    c = torch.zeros((100, 128), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="tensor-core"):
        qdist.l2topk_q_tc_cuda(c[:4].float(), c, k=5)
    with pytest.raises(ValueError):
        qdist.l2topk_q_tc_cuda(c[:4], c, k=65)
