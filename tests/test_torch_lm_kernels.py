"""The LM substrate's two kernels, `topk` and `flash_attention`: the
port's plain versions against the reference's kernels, and the CUDA
kernels against the plain versions.

`repro_torch.kernels.ops.{topk, flash_attention}` on CPU tensors (the
plain versions) are held to the reference's `repro.kernels.ops` functions,
whose Pallas kernels run in interpret mode as `tests/test_kernels.py` runs
them, at that file's shapes. Inputs are made by numpy from a seed.

- `topk`: values and ids bitwise equal. Selection only compares and
  copies, so nothing rounds. Ties go to the lower column in both.
  Where fewer than k entries are finite, the reference's +inf slots carry
  ids that depend on its block size (a 2,500-wide row whose only finite
  entry is at column 5 gives ids [5, 5, 5, 5] at k = 4); the port's hold
  -1 (pinned below; ROADMAP.md Queue 3).
- `flash_attention`, float32: both sum `q . k` and `p @ v` in float32 in
  other orders and over other key blocks (the reference's 256 x 256
  tiles, the plain version's 256-key steps); the gate is the reference's
  own against its naive oracle, |d| <= 2e-5 + 2e-5 |want|.
- `flash_attention`, bf16: both compute in float32 and round once to
  bf16, so they may land on neighbouring bf16 values: |d| <= 2^-7 x
  max(|got|, |want|) (one bf16 spacing) + 1e-6.

The CUDA kernels against the plain versions run only where there is a
card (the `cuda` marker); here they skip. There `topk` is bitwise and
`flash_attention` is held to 1e-5 + 1e-5 |want| in float32 (sums in
another order) and to one bf16 spacing in bf16, also on every mask of
`blockwise_attn` (windows, prefixes, query offsets, a window without the
causal mask) with G = 1, 2, 5 and 8 query heads a KV head and hd 64, 120,
128 and 256, on rows that see no key (zeros: a CTA whose tile range is
empty) and at danube's [2, 8192, 120] with its 4,096 window. bf16 with
hd a multiple of 8 goes to the tensor-core kernel, the rest to the
FP32-FMA kernel;
which shapes go where is checked here (`takes_tensor_cores`), and the
tensor-core kernel's premise for P.V too: a float32 P in [0, 1] is the
exact sum of three bf16 pieces.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import attention, ops, topk

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

BF16_SPACING = 2.0 ** -7


def _gauss(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ref_topk(x, k):
    v, i = ref_ops.topk(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i)


def _port_topk(x, k):
    v, i = ops.topk(torch.from_numpy(x), k)
    return v.numpy(), i.numpy()


# ---------------------------------------------------------------------------
# topk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,k", [
    (4, 100, 5), (16, 3000, 10), (3, 1024, 32), (8, 4096, 1),
])
def test_topk_matches_reference_bitwise(b, n, k):
    x = _gauss((b, n), seed=b * n + k)
    wv, wi = _ref_topk(x, k)
    gv, gi = _port_topk(x, k)
    assert gi.dtype == np.int32 and gv.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("b,n,k", [(5, 2100, 12), (8, 64, 6)])
def test_topk_ties_go_to_the_lower_column(b, n, k):
    """Integer values 0..7: every selected value is tied many times over,
    within and across the reference's 1,024-column blocks."""
    x = np.random.default_rng(n).integers(0, 8, size=(b, n)).astype(
        np.float32)
    wv, wi = _ref_topk(x, k)
    gv, gi = _port_topk(x, k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)
    order = np.lexsort((np.arange(n)[None].repeat(b, 0), x), axis=1)
    np.testing.assert_array_equal(gi, order[:, :k])


def test_topk_on_router_probabilities():
    """The router's call: ops.topk(-softmax(logits), k) on [S, E] rows."""
    logits = _gauss((48, 64), seed=3)
    p = np.exp(logits - logits.max(1, keepdims=True))
    neg = -(p / p.sum(1, keepdims=True))
    wv, wi = _ref_topk(neg, 6)
    gv, gi = _port_topk(neg, 6)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)


def test_topk_tail_when_fewer_than_k_are_finite():
    """One finite entry in a 2,500-wide row, and two in another."""
    x = np.full((2, 2500), np.inf, np.float32)
    x[0, 5] = 0.25
    x[1, [7, 2048]] = [-1.0, 3.0]
    wv, wi = _ref_topk(x, 4)
    gv, gi = _port_topk(x, 4)
    np.testing.assert_array_equal(gv, wv)          # values agree everywhere
    np.testing.assert_array_equal(wi[0], [5, 5, 5, 5])
    np.testing.assert_array_equal(gi[0], [5, -1, -1, -1])
    np.testing.assert_array_equal(gi[1], [7, 2048, -1, -1])
    np.testing.assert_array_equal(wi[1, :2], gi[1, :2])


def test_topk_k_above_n_and_nan():
    x = np.array([[2.0, np.nan, 1.0], [np.nan, np.nan, np.nan]], np.float32)
    gv, gi = _port_topk(x, 5)
    np.testing.assert_array_equal(gi, [[2, 0, -1, -1, -1], [-1] * 5])
    np.testing.assert_array_equal(gv[0, :2], [1.0, 2.0])
    assert np.isinf(gv[0, 2:]).all() and np.isinf(gv[1]).all()


def test_topk_signed_zeros_nan_and_minus_inf_against_reference():
    """-0.0 and +0.0 tie by column and keep their signs; -inf comes first.
    The reference's `_select_k` takes `jnp.argmin`, which picks a NaN
    first; the port never selects NaN (as it never selects +inf), so its
    row is the reference's with the NaN slots taken out and (+inf, -1)
    after (ROADMAP.md Queue 3)."""
    x = np.array([[0.0, -0.0, 1.0, -np.inf, np.nan, -0.0, 0.0, 2.0],
                  [np.nan, 3.0, np.nan, -1.0, -0.0, 0.0, np.inf, -np.inf],
                  [-0.0, 0.0, -0.0, 0.0, -np.inf, -np.inf, 0.5, -0.5]],
                 np.float32)
    x = np.tile(x, (1, 8))                       # 64 columns: the router's
    x[:, 8:] = np.abs(x[:, 8:]) + 4.0            # later copies rank last
    x[1, 8:] = np.nan
    k = 9
    wv, wi = _ref_topk(x, 64)                    # the whole row, in order
    gv, gi = _port_topk(x, k)
    for r in range(len(x)):
        keep = np.isfinite(wv[r]) | (wv[r] == -np.inf)
        n = min(k, int(keep.sum()))
        np.testing.assert_array_equal(gi[r, :n], wi[r, keep][:n])
        np.testing.assert_array_equal(gv[r, :n], wv[r, keep][:n])
        np.testing.assert_array_equal(np.signbit(gv[r, :n]),
                                      np.signbit(wv[r, keep][:n]))
        assert (gi[r, n:] == -1).all() and np.isinf(gv[r, n:]).all()
    assert np.isnan(wv[1, :2]).all()             # the reference takes NaN
    np.testing.assert_array_equal(gi[1, :5], [7, 3, 4, 5, 1])
    np.testing.assert_array_equal(gi[2, :6], [4, 5, 7, 0, 1, 2])
    np.testing.assert_array_equal(np.signbit(gv[2, 3:6]), [True, False, True])


@pytest.mark.parametrize("n,k,short", [
    (1, 1, True), (33, 6, True), (64, 6, True), (64, 64, True),
    (256, 64, True), (256, 1, True), (257, 6, False), (2048, 10, False),
    (64, 0, False), (64, 65, False),
])
def test_topk_short_row_rule(n, k, short):
    """Rows of at most SHORT_MAX_N = 256 columns (8 entries a lane) go to
    select_k_short.cu, longer ones to select_k.cu; k outside 1..64 goes to
    neither kernel (select_k.cu's wrapper raises)."""
    assert topk.SHORT_MAX_N == 256
    assert topk.takes_short_rows(n, k) is short


def test_topk_warps_per_row():
    assert [topk.warps_per_row(n) for n in (1, 64, 2047, 2048, 4096, 8192,
                                             10**6)] == [1, 1, 1, 2, 4, 8, 8]


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


def _qkv(bh, t, hd, seed, s=None):
    s = t if s is None else s
    return (_gauss((bh, t, hd), seed), _gauss((bh, s, hd), seed + 1),
            _gauss((bh, s, hd), seed + 2))


@pytest.mark.parametrize("bh,t,hd,causal", [
    (4, 128, 64, True), (2, 100, 32, True), (3, 257, 128, False),
    (1, 31, 16, False), (8, 300, 64, True),
])
def test_flash_attention_matches_reference_f32(bh, t, hd, causal):
    q, k, v = _qkv(bh, t, hd, seed=t + hd)
    want = np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    assert got.dtype == torch.float32 and got.shape == (bh, t, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bh,t,hd,causal", [(2, 64, 32, True),
                                            (3, 300, 48, True),
                                            (2, 70, 32, False)])
def test_flash_attention_matches_reference_bf16(bh, t, hd, causal):
    q, k, v = _qkv(bh, t, hd, seed=7 + t)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(ref_ops.flash_attention(qj, kj, vj, causal=causal),
                      np.float32)
    qt, kt, vt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (qj, kj, vj))
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    tol = BF16_SPACING * np.maximum(np.abs(got), np.abs(want)) + 1e-6
    assert (np.abs(got - want) <= tol).all()


def test_flash_attention_plain_equals_naive_softmax():
    """Against a one-shot softmax (no blocks) where S spans several of the
    plain version's 256-key steps and the keys outnumber the queries."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 600, 24, seed=5, s=700))
    for causal in (True, False):
        s = torch.einsum("btd,bsd->bts", q, k) / np.sqrt(24)
        if causal:
            s = s.masked_fill(torch.ones(600, 700).triu(1).bool(),
                              float("-inf"))
        want = torch.einsum("bts,bsd->btd", s.softmax(-1), v)
        got = attention.flash_attention_ref(q, k, v, causal=causal)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _split3(p):
    """The tensor-core kernel's split of a float32 P (`split3` in
    csrc/flash_attention_tc.cu): p1 = bf16(P), p2 = bf16(P - p1),
    p3 = bf16(P - p1 - p2), each subtraction in float32."""
    p1 = p.to(torch.bfloat16)
    r = p - p1.float()
    p2 = r.to(torch.bfloat16)
    return p1, p2, (r - p2.float()).to(torch.bfloat16)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1e-30, 1e-20), (1e-12, 1e-3)])
def test_three_bf16_pieces_sum_back_to_p_exactly(lo, hi):
    """P.V as three bf16 products is P.V in float32 only if p1 + p2 + p3
    is P itself: 8 significant bits a piece cover float32's 24, and each
    residue is exact in float32. Checked on random values, log-uniform in
    [lo, hi], and on 0, 1, the largest float32 below 1 and 1e-30."""
    rng = np.random.default_rng(int(-np.log10(hi + 1e-40) * 10))
    x = np.exp(rng.uniform(np.log(max(lo, 1e-30)), np.log(hi), 200_000))
    edge = np.array([0.0, 1.0, np.nextafter(np.float32(1), np.float32(0)),
                     1e-30], np.float32)
    p = torch.from_numpy(np.concatenate([x.astype(np.float32), edge]))
    p1, p2, p3 = _split3(p)
    total = p1.double() + p2.double() + p3.double()
    assert torch.equal(total, p.double())
    # summed in float32 in the order the accumulator takes them, too
    assert torch.equal(p1.float() + p2.float() + p3.float(), p)
    assert bool((p1.float() <= 1).all())


def test_tensor_core_kernel_takes_bf16_with_hd_a_multiple_of_8():
    def qkv(dtype, hd, offset=0):
        flat = torch.zeros(3 * 5 * hd + offset, dtype=dtype)[offset:]
        return flat.view(3, 5, hd)

    for hd in (8, 24, 40, 128, 192, 256):
        x = qkv(torch.bfloat16, hd)
        assert attention.takes_tensor_cores(x, x, x), hd
    for hd in (1, 17, 100, 252):
        x = qkv(torch.bfloat16, hd)
        assert not attention.takes_tensor_cores(x, x, x), hd
    x = qkv(torch.float32, 192)
    assert not attention.takes_tensor_cores(x, x, x)
    # a base 2 bytes past a 16-byte boundary: TMA cannot address it
    y = qkv(torch.bfloat16, 192, offset=1)
    x = qkv(torch.bfloat16, 192)
    assert x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 2
    assert not attention.takes_tensor_cores(x, y, x)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a CUDA wrapper was called for CPU tensors")

    monkeypatch.setattr(ops, "topk_cuda", boom)
    monkeypatch.setattr(ops, "flash_attention_cuda", boom)
    x = torch.from_numpy(_gauss((3, 40), 1))
    ops.topk(x, 4)
    ops.flash_attention(x[None], x[None], x[None])
    for fn in (topk.topk_cuda, topk.topk_short_cuda, topk.topk_stream_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention_cuda(x[None], x[None], x[None])


# ---------------------------------------------------------------------------
# The CUDA kernels against the plain versions (on the card only)
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k", [
    (1, 1, 1), (7, 33, 6), (16384, 64, 6), (9, 2047, 64), (10, 2048, 64),
    (5, 5000, 10), (3, 9000, 33), (256, 100_000, 10),
])
def test_cuda_topk_matches_plain_bitwise(b, n, k):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n + k)
    cases = {"gauss": torch.randn((b, n), generator=g, device=dev),
             "ties": torch.randint(0, 5, (b, n), generator=g,
                                   device=dev).float()}
    pad = cases["gauss"].clone()
    pad[:, ::3] = float("inf")
    pad[0, :] = float("inf")
    pad[-1, 1::7] = float("nan")
    cases["inf and nan"] = pad
    for what, x in cases.items():
        got, want = topk.topk_cuda(x, k), topk.topk_ref(x, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), (what, b, n, k)
        assert torch.equal(got[1], want[1]), (what, b, n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 64, 256])
@pytest.mark.parametrize("k", [1, 6, 64])
def test_cuda_topk_both_routes_match_plain_bitwise(n, k):
    """select_k_short.cu and select_k.cu on the same short rows, bitwise
    equal to the plain version (computed on the CPU, whose sort ties -0.0
    with +0.0): Gaussian rows, ties, NaN and +/-inf, signed zeros; each
    launch on its own counter, and topk_cuda on the short-row kernel."""
    dev = _cuda()
    g = np.random.default_rng(n * 100 + k)
    b = 37
    cases = {"gauss": g.normal(size=(b, n)),
             "ties": g.integers(0, 5, size=(b, n)).astype(np.float64)}
    pad = g.normal(size=(b, n))
    pad[:, ::3] = np.inf
    pad[0, :] = np.inf
    pad[-1, 1::7] = np.nan
    pad[2, ::5] = -np.inf
    cases["inf and nan"] = pad
    cases["signed zeros"] = g.choice([0.0, -0.0, 1.0, -1.0, np.nan],
                                     size=(b, n))
    for what, xn in cases.items():
        x = torch.from_numpy(xn.astype(np.float32))
        want = topk.topk_ref(x, k)
        xd = x.to(dev)
        before = topk.SHORT_LAUNCHES, topk.LAUNCHES
        outs = [topk.topk_short_cuda(xd, k), topk.topk_stream_cuda(xd, k),
                topk.topk_cuda(xd, k)]
        torch.cuda.synchronize()
        assert (topk.SHORT_LAUNCHES - before[0],
                topk.LAUNCHES - before[1]) == (2, 1)
        for got in outs:
            gv, gi = (t.cpu() for t in got)
            assert torch.equal(gv, want[0]), (what, n, k)
            assert torch.equal(gi, want[1]), (what, n, k)
            assert torch.equal(torch.signbit(gv), torch.signbit(want[0]))


@pytest.mark.cuda
def test_cuda_topk_picks_the_kernel_by_shape():
    """The router's [16,384, 64] rows and a decode step's [8, 64] go to
    select_k_short.cu; [4, 257] and [3, 5000] to select_k.cu."""
    dev = _cuda()
    for (b, n), short in (((16384, 64), True), ((8, 64), True),
                          ((4, 257), False), ((3, 5000), False)):
        x = torch.randn((b, n), device=dev)
        before = topk.SHORT_LAUNCHES, topk.LAUNCHES
        got = topk.topk_cuda(x, 6)
        want = topk.topk_ref(x, 6)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (topk.SHORT_LAUNCHES - before[0],
                topk.LAUNCHES - before[1]) == ((1, 0) if short else (0, 1))
    with pytest.raises(ValueError, match="short-row"):
        topk.topk_short_cuda(torch.randn((2, 257), device=dev), 6)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,s,hd,causal", [
    (3, 1, 1, 16, True), (2, 100, 100, 17, True), (3, 257, 257, 128, False),
    (4, 130, 200, 48, False), (2, 200, 200, 48, True), (1, 64, 64, 256, True),
    (5, 333, 333, 192, True), (2, 65, 129, 64, True),
    # the tensor-core kernel's edges in bf16: one 64-column box part
    # filled, ragged S past the last key tile, a full model-sized head
    (3, 130, 130, 24, True), (2, 77, 300, 40, False), (2, 300, 300, 256, True),
    (3, 777, 1000, 192, False), (2, 2048, 2048, 192, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(bh, t, s, hd, causal, dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(t * hd + s)
    q, k, v = (torch.randn((bh, n, hd), generator=g, device=dev).to(dtype)
               for n in (t, s, s))
    got = attention.flash_attention_cuda(q, k, v, causal=causal)
    want = attention.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        tol = 1e-5 + 1e-5 * want.abs()
    else:
        tol = BF16_SPACING * torch.maximum(got.abs(), want.abs()) + 1e-6
    assert bool(((got - want).abs() <= tol).all()), float(
        (got - want).abs().max())


# the masks of `blockwise_attn` the kernels must compute: windows, prefixes,
# query offsets, both together, a window without the causal mask
MASKS = [
    {}, {"window": 1}, {"window": 5}, {"window": 7, "q_offset": 7},
    {"window": 40}, {"prefix_len": 1}, {"prefix_len": 9},
    {"prefix_len": 35, "q_offset": 7}, {"q_offset": 40},
    {"window": 5, "prefix_len": 9, "q_offset": 7},
    {"causal": False, "window": 7}, {"causal": False, "window": 40,
                                     "q_offset": 40},
]


def _check_kernel(q, k, v, kernel, **kw):
    """flash_attention_cuda on q, k, v within the plain version's
    tolerance, on `kernel` ("tc" or "fma") by the launch counters."""
    before = attention.TC_LAUNCHES, attention.FMA_LAUNCHES
    got = attention.flash_attention_cuda(q, k, v, **kw)
    want = attention.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    took = (attention.TC_LAUNCHES - before[0], attention.FMA_LAUNCHES
            - before[1])
    assert took == ((1, 0) if kernel == "tc" else (0, 1)), (took, kw)
    got, want = got.float(), want.float()
    if q.dtype == torch.float32:
        tol = 1e-5 + 1e-5 * want.abs()
    else:
        tol = BF16_SPACING * torch.maximum(got.abs(), want.abs()) + 1e-6
    assert bool(((got - want).abs() <= tol).all()), (kw, float(
        (got - want).abs().max()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kw", MASKS)
@pytest.mark.parametrize("g", [1, 2, 5, 8])
@pytest.mark.parametrize("hd", [64, 120, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_masks_and_grouped_heads(kw, g, hd, dtype):
    """Both kernels (bf16: the tensor cores; float32: FP32 FMAs) against
    the plain version on every mask, G query heads a KV head, T != S
    (150 queries over 170 keys: three 64-key tiles, two 128-row CTAs)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(hd * 10 + g)
    q = torch.randn((2 * g, 150, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((2, 170, hd), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    _check_kernel(q, k, v, "tc" if dtype == torch.bfloat16 else "fma", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [16, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_rows_with_no_live_key_are_zero(t, dtype):
    """window 4 at q_offset 40 over 16 keys masks every row: no tile is
    live, the producer loads nothing and both consumers wait on nothing
    (the tensor-core kernel), and every row is 0. At T = 200 the later
    rows see no key either; with the causal mask off they see all."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(t)
    q = torch.randn((10, t, 128), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((2, 16, 128), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    kernel = "tc" if dtype == torch.bfloat16 else "fma"
    got = _check_kernel(q, k, v, kernel, window=4, q_offset=40)
    assert bool((got == 0).all())
    got = _check_kernel(q, k, v, kernel, window=4, q_offset=40, causal=False)
    assert bool((got == 0).all())
    got = _check_kernel(q, k, v, kernel, window=60, q_offset=40)
    assert bool((got[:, :7] != 0).any(-1).all())     # rows 40..46 see keys
    assert bool((got[:, 35:] == 0).all())            # rows 75.. see none


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_long_window(dtype):
    """[2, 8,192, 120] with window 4,096 (danube's): every row past 4,096
    is cut by the window and the tiles behind it are never visited."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(4096)
    q, k, v = (torch.randn((2, 8192, 120), generator=gen, device=dev).to(
        dtype) for _ in range(3))
    _check_kernel(q, k, v, "tc" if dtype == torch.bfloat16 else "fma",
                  window=4096)


@pytest.mark.cuda
def test_cuda_flash_attention_picks_the_kernel_by_shape():
    """MLA prefill's heads ([B*16, 2048, 192] bf16) go to the tensor-core
    kernel; float32 and hd = 100 in bf16 to the FP32-FMA kernel."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    for (bh, t, hd), dtype, kernel in (
            ((2, 2048, 192), torch.bfloat16, "tc"),
            ((2, 300, 100), torch.bfloat16, "fma"),
            ((2, 300, 192), torch.float32, "fma")):
        q = torch.randn((bh, t, hd), generator=g, device=dev).to(dtype)
        before = attention.TC_LAUNCHES, attention.FMA_LAUNCHES
        attention.flash_attention_cuda(q, q, q)
        torch.cuda.synchronize()
        after = attention.TC_LAUNCHES, attention.FMA_LAUNCHES
        assert (after[0] - before[0], after[1] - before[1]) == (
            (1, 0) if kernel == "tc" else (0, 1)), (bh, t, hd, dtype)


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_operands():
    dev = _cuda()
    x = torch.randn((4, 100), device=dev)
    with pytest.raises(ValueError, match="k="):
        topk.topk_cuda(x, 65)
    with pytest.raises(ValueError, match="contiguous"):
        topk.topk_cuda(x.T, 3)
    q = torch.randn((2, 10, 300), device=dev)
    with pytest.raises(ValueError, match="hd"):
        attention.flash_attention_cuda(q, q, q)
    q = torch.randn((2, 10, 32), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        attention.flash_attention_cuda(q, q.bfloat16(), q)
    kv = torch.randn((3, 10, 32), device=dev)
    with pytest.raises(ValueError, match="dividing"):
        attention.flash_attention_cuda(torch.randn((4, 10, 32), device=dev),
                                       kv, kv)
    with pytest.raises(ValueError, match=">= 0"):
        attention.flash_attention_cuda(q, q, q, window=-1)
