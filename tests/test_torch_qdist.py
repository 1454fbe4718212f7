"""The PQ ADC kernels' plain versions against the reference's kernels.

The port's `pq_adc_ref` / `pq_topk_ref` (and `ops.pq_adc` / `ops.pq_topk`
on CPU tensors, which dispatch to them) are held bitwise to the
reference's `ops.pq_adc` / `ops.pq_topk`, whose Pallas kernels run in
interpret mode as `tests/test_pq.py` runs them. Both sum one table entry
per subspace in subspace order, so the distances agree on any float
input; the top-k agrees on ids too, ties included (the lower row wins).
Where fewer than k rows are finite, the reference's +inf slots carry ids
that depend on its block size; the port's hold -1, and only the finite
slots are compared.

`pq_topk_cuda` and `pq_adc_cuda` each pick one of two kernels by shape
and alignment (`pq_topk_route`, `pq_adc_route`): the rules, the
shared-memory mirrors of `csrc/pq_topk_smem.cu` and `csrc/pq_adc_smem.cu`
and the top-k's splits are checked here. The CUDA kernels
against the plain versions run only where there is a card (the `cuda`
marker); here they skip.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops, qdist

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

K = 10


def _luts_codes(bq, bx, m, seed, hi=50.0):
    rng = np.random.default_rng(seed)
    luts = rng.uniform(0, hi, size=(bq, m, 256)).astype(np.float32)
    codes = rng.integers(0, 256, size=(bx, m)).astype(np.uint8)
    return luts, codes


def _ref_topk(luts, codes, xpad=None, k=K):
    v, i = ref_ops.pq_topk(luts, codes, xpad, k=k)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("bq,bx,m", [(3, 100, 8), (9, 600, 4), (1, 1024, 16)])
def test_pq_adc_matches_reference_bitwise(bq, bx, m):
    luts, codes = _luts_codes(bq, bx, m, seed=11)
    want = np.asarray(ref_ops.pq_adc(luts, codes))
    got = qdist.pq_adc_ref(torch.from_numpy(luts), torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    # ops on CPU tensors is the plain version
    via_ops = ops.pq_adc(torch.from_numpy(luts), torch.from_numpy(codes))
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("bq,bx,m", [(3, 100, 8), (9, 600, 4), (1, 1024, 16),
                                     (5, 1500, 8)])
def test_pq_topk_matches_reference_bitwise(bq, bx, m):
    luts, codes = _luts_codes(bq, bx, m, seed=12)
    wv, wi = _ref_topk(luts, codes)
    gv, gi = ops.pq_topk(torch.from_numpy(luts), torch.from_numpy(codes), k=K)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_pq_topk_ties_go_to_the_lower_row():
    """Integer tables over a tiny range: most distances tie, and the
    reference's lax.top_k order (lower row first) must hold."""
    rng = np.random.default_rng(3)
    luts = rng.integers(0, 3, size=(6, 4, 256)).astype(np.float32)
    codes = rng.integers(0, 256, size=(900, 4)).astype(np.uint8)
    wv, wi = _ref_topk(luts, codes, k=20)
    gv, gi = qdist.pq_topk_ref(torch.from_numpy(luts),
                               torch.from_numpy(codes), k=20)
    assert len(np.unique(wv)) < wv.size / 3          # ties dominate
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_pq_adc_with_xpad_matches_reference():
    luts, codes = _luts_codes(4, 700, 8, seed=14)
    xpad = np.zeros(700, np.float32)
    xpad[::7] = 3.5
    xpad[600:] = np.inf
    want = np.asarray(ref_ops.pq_adc(luts, codes, xpad))
    got = qdist.pq_adc_ref(*map(torch.from_numpy, (luts, codes, xpad)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isinf(got.numpy()[:, 600:]).all()


def test_pq_topk_padding_rows_excluded():
    luts, codes = _luts_codes(4, 700, 8, seed=13)
    xpad = np.zeros(700, np.float32)
    xpad[100:] = np.inf
    wv, wi = _ref_topk(luts, codes, xpad)
    gv, gi = ops.pq_topk(*map(torch.from_numpy, (luts, codes, xpad)), k=K)
    assert gi.numpy().max() < 100
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


@pytest.mark.parametrize("n_valid,xpad_rows", [(7, 0), (3, 50)])
def test_pq_topk_tail_when_fewer_than_k_rows(n_valid, xpad_rows):
    """Fewer than k finite rows (7 rows; or 3 rows before 50 padding
    rows): the finite slots equal the reference's, and every other slot is
    (+inf, -1)."""
    luts, codes = _luts_codes(3, n_valid + xpad_rows, 8, seed=15)
    xpad = np.zeros(n_valid + xpad_rows, np.float32)
    xpad[n_valid:] = np.inf
    wv, wi = _ref_topk(luts, codes, xpad)
    gv, gi = ops.pq_topk(*map(torch.from_numpy, (luts, codes, xpad)), k=K)
    gv, gi = gv.numpy(), gi.numpy()
    np.testing.assert_array_equal(gv[:, :n_valid], wv[:, :n_valid])
    np.testing.assert_array_equal(gi[:, :n_valid], wi[:, :n_valid])
    assert np.isinf(gv[:, n_valid:]).all() and np.isinf(wv[:, n_valid:]).all()
    assert (gi[:, n_valid:] == -1).all()


@pytest.mark.parametrize("bq,bx,k", [(9, 2083, 1), (9, 2083, 10),
                                     (9, 2083, 64)])
def test_pq_topk_m16_ragged_matches_reference_bitwise(bq, bx, k):
    """M = 16 (the shared-memory kernel's main shape) with Bq not a multiple
    of its 8 queries a CTA and Bx not a multiple of its 32-row tiles or of
    the 4-row xpad copies; integer tables in [0, 8) (ties) and 20 padding
    rows."""
    rng = np.random.default_rng(16)
    luts = rng.integers(0, 8, size=(bq, 16, 256)).astype(np.float32)
    codes = rng.integers(0, 256, size=(bx, 16)).astype(np.uint8)
    xpad = np.zeros(bx, np.float32)
    xpad[-20:] = np.inf
    wv, wi = _ref_topk(luts, codes, xpad, k=k)
    gv, gi = ops.pq_topk(*map(torch.from_numpy, (luts, codes, xpad)), k=k)
    assert gi.numpy().max() < bx - 20
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


@pytest.mark.parametrize("bq,bx", [(9, 2083), (1, 31), (17, 4100)])
def test_pq_adc_m16_ragged_matches_reference_bitwise(bq, bx):
    """ops.pq_adc at M = 16 (the shared-memory kernel's main shape) with
    Bq not a multiple of its 8 queries a CTA and Bx not a multiple of its
    32-row tiles or of the 4-row xpad copies, float tables and +inf
    padding rows, against the reference's Pallas kernel."""
    luts, codes = _luts_codes(bq, bx, 16, seed=bq + bx)
    xpad = np.zeros(bx, np.float32)
    xpad[bx - bx // 5:] = np.inf
    want = np.asarray(ref_ops.pq_adc(luts, codes, xpad))
    got = ops.pq_adc(*map(torch.from_numpy, (luts, codes, xpad)))
    assert np.isinf(want[:, bx - bx // 5:]).all()
    np.testing.assert_array_equal(got.numpy(), want)


def _aligned(shape, dtype, offset=0):
    """A tensor of `shape` whose data starts `offset` elements into a
    256-byte aligned buffer."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + offset + 64, dtype=dtype)
    return buf[offset:offset + n].view(shape)


@pytest.mark.parametrize("case,taken", [
    ("m16", True), ("m32", True), ("m64", True), ("m16 xpad", True),
    ("m8", False), ("m48", False), ("m128", False), ("m4", False),
    ("codes unaligned", False), ("xpad unaligned", False), ("k=0", False),
    ("k=65", False), ("no rows", False), ("int8 codes", False),
])
def test_pq_topk_route_rule(case, taken):
    """The shared-memory kernel takes M in {16, 32, 64} (whole 16-byte
    rows; 128 / M queries' tables in 128 KB), 1 <= k <= 64, Bx >= 1 and
    16-byte aligned codes and xpad; everything else goes to qdist.cu."""
    m = int(case.split()[0][1:]) if case[0] == "m" else 16
    bx = 0 if case == "no rows" else 100
    k = {"k=0": 0, "k=65": 65}.get(case, 10)
    luts = torch.zeros((3, m, 256))
    codes = _aligned((bx, m), torch.int8 if case == "int8 codes"
                     else torch.uint8, 1 if case == "codes unaligned" else 0)
    xpad = None
    if "xpad" in case:
        xpad = _aligned((bx,), torch.float32, 1 if "unaligned" in case else 0)
    assert codes.data_ptr() % 16 == (1 if case == "codes unaligned" else 0)
    assert qdist.pq_topk_route(luts, codes, xpad, k) is taken


@pytest.mark.parametrize("case,taken", [
    ("m16", True), ("m32", True), ("m64", True), ("m16 xpad", True),
    ("m8", False), ("m48", False), ("m128", False), ("m4", False),
    ("codes unaligned", False), ("xpad unaligned", False), ("no rows", False),
    ("int8 codes", False), ("float64 luts", False),
])
def test_pq_adc_route_rule(case, taken):
    """The shared-memory ADC kernel takes M in {16, 32, 64}, float32
    tables, uint8 codes, Bx >= 1 and 16-byte aligned codes and xpad; the
    output needs nothing more (plain coalesced row segments). Everything
    else goes to qdist.cu."""
    m = int(case.split()[0][1:]) if case[0] == "m" else 16
    bx = 0 if case == "no rows" else 100
    luts = torch.zeros((3, m, 256), dtype=torch.float64 if "float64" in case
                       else torch.float32)
    codes = _aligned((bx, m), torch.int8 if case == "int8 codes"
                     else torch.uint8, 1 if case == "codes unaligned" else 0)
    xpad = None
    if "xpad" in case:
        xpad = _aligned((bx,), torch.float32, 1 if "unaligned" in case else 0)
    assert qdist.pq_adc_route(luts, codes, xpad) is taken


def test_pq_adc_smem_bytes_hand_count():
    """The Python mirror of pq_adc_smem.cu's layout against a hand count:
    tables, 16 warps' stage rings of 32-row code and xpad tiles, a
    mbarrier a stage, and each warp's staged distances (128 / M queries x
    (32 + M / 4) words); every M fits the H100's 232,448 bytes."""
    tables = 128 * 1024
    assert qdist.pq_adc_smem_bytes(16) == (
        tables + 16 * 3 * 32 * 16 + 16 * 3 * 128 + 16 * 3 * 8
        + 16 * 8 * 36 * 4) == 180_608
    assert qdist.pq_adc_smem_bytes(32) == (
        tables + 16 * 3 * 32 * 32 + 16 * 3 * 128 + 16 * 3 * 8
        + 16 * 4 * 40 * 4)
    assert qdist.pq_adc_smem_bytes(64) == (
        tables + 16 * 2 * 32 * 64 + 16 * 2 * 128 + 16 * 2 * 8
        + 16 * 2 * 48 * 4)
    for m in qdist.SMEM_M:
        assert qdist.pq_adc_smem_bytes(m) <= qdist.SMEM_BUDGET


def test_pq_topk_smem_bytes_hand_count():
    """The Python mirror of pq_topk_smem.cu's layout against a hand count:
    tables, 16 warps' stage rings of 32-row code and xpad tiles, a
    mbarrier a stage, a count a (query, warp), 32 buffered 8-byte
    candidates a (warp, query), a 64-entry merge scratch a warp; every M
    fits the H100's 232,448 bytes, one CTA an SM."""
    tables = 128 * 1024                        # 128 / M queries x M KB
    lists = 16 * 64 * 8
    assert qdist.pq_topk_smem_bytes(16) == (
        tables + 16 * 3 * 32 * 16 + 16 * 3 * 128 + 16 * 3 * 8 + 8 * 16 * 4
        + 16 * 8 * 32 * 8 + lists)
    assert qdist.pq_topk_smem_bytes(16) == 203_648
    assert qdist.pq_topk_smem_bytes(32) == (
        tables + 16 * 3 * 32 * 32 + 16 * 3 * 128 + 16 * 3 * 8 + 4 * 16 * 4
        + 16 * 4 * 32 * 8 + lists)
    assert qdist.pq_topk_smem_bytes(64) == (
        tables + 16 * 2 * 32 * 64 + 16 * 2 * 128 + 16 * 2 * 8 + 2 * 16 * 4
        + 16 * 2 * 32 * 8 + lists)
    for m in qdist.SMEM_M:
        assert 2 * qdist.pq_topk_smem_bytes(m) > qdist.SMEM_BUDGET
        assert qdist.pq_topk_smem_bytes(m) <= qdist.SMEM_BUDGET


@pytest.mark.parametrize("bq,bx,m", [(256, 32768, 16), (256, 1_000_000, 16),
                                     (8, 100, 16), (3, 33, 32), (9, 2083, 16),
                                     (256, 70001, 64), (2000, 5000, 32),
                                     (1, 1, 16)])
def test_pq_topk_splits(bq, bx, m):
    """Whole 32-row tiles a split, no empty split, and query groups x
    splits within the card's 132 SMs (or one split where the groups pass
    them)."""
    s, chunk = qdist.pq_topk_splits(bq, bx, m)
    groups = -(-bq // (128 // m))
    assert chunk % 32 == 0 and 1 <= s <= qdist.MAX_SPLITS
    assert (s - 1) * chunk < bx <= s * chunk
    assert s == 1 or groups * s <= 132
    if (bq, bx, m) == (256, 32768, 16):
        assert (s, chunk) == (4, 8192)           # 128 CTAs of 8 queries


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """ops dispatch on the device: CPU -> plain version; the CUDA wrappers
    refuse CPU tensors instead of falling back."""
    calls = []
    monkeypatch.setattr(ops, "pq_adc_ref", lambda *a, **k: calls.append("a"))
    monkeypatch.setattr(ops, "pq_topk_ref", lambda *a, **k: calls.append("t"))
    luts, codes = map(torch.from_numpy, _luts_codes(2, 50, 8, seed=1))
    ops.pq_adc(luts, codes)
    ops.pq_topk(luts, codes, k=3)
    assert calls == ["a", "t"]
    for fn in (qdist.pq_adc_cuda, qdist.pq_adc_v1_cuda,
               qdist.pq_adc_smem_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(luts, codes)
    with pytest.raises(ValueError, match="CUDA"):
        qdist.pq_topk_cuda(luts, codes, k=3)


# ---------------------------------------------------------------------------
# on a card: the kernels against the plain versions
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bx,m", [(3, 100, 8), (9, 600, 4), (1, 1024, 16),
                                     (37, 5000, 32), (5, 777, 3)])
@pytest.mark.parametrize("with_xpad", [False, True])
def test_cuda_pq_adc_matches_plain_version(bq, bx, m, with_xpad):
    dev = _cuda()
    luts, codes = _luts_codes(bq, bx, m, seed=21)
    xpad = None
    if with_xpad:
        xpad = torch.zeros(bx, device=dev)
        xpad[bx // 2:] = float("inf")
    tl, tc = torch.from_numpy(luts).to(dev), torch.from_numpy(codes).to(dev)
    launches = qdist.ADC_LAUNCHES, qdist.ADC_SMEM_LAUNCHES
    got = qdist.pq_adc_cuda(tl, tc, xpad)
    want = qdist.pq_adc_ref(tl, tc, xpad)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    smem = qdist.pq_adc_route(tl, tc, xpad)
    assert (qdist.ADC_LAUNCHES - launches[0],
            qdist.ADC_SMEM_LAUNCHES - launches[1]) == (
        (0, 1) if smem else (1, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bx,m", [
    (3, 5, 16), (1, 1, 16), (9, 2083, 16), (256, 32768, 16), (8, 31, 16),
    (5, 777, 32), (17, 4100, 32), (3, 1000, 64), (4, 2049, 64), (2, 33, 64),
])
@pytest.mark.parametrize("tables", ["float", "integer"])
@pytest.mark.parametrize("with_xpad", [False, True])
def test_cuda_pq_adc_both_routes_match_plain_version(bq, bx, m, tables,
                                                     with_xpad):
    """Both ADC kernels bitwise equal to the plain version at the
    shared-memory kernel's edges: Bx < 32 (one short tile), ragged Bq (not
    a multiple of 128 / M) and Bx (not a multiple of 32 or 4), every M it
    takes, float tables and integer tables in [0, 8), +inf padding rows."""
    dev = _cuda()
    rng = np.random.default_rng(bq * bx + m)
    lut_np = (rng.integers(0, 8, size=(bq, m, 256)).astype(np.float32)
              if tables == "integer"
              else rng.uniform(0, 50, size=(bq, m, 256)).astype(np.float32))
    tl = torch.from_numpy(lut_np).to(dev)
    tc = torch.from_numpy(rng.integers(0, 256, size=(bx, m)).astype(
        np.uint8)).to(dev)
    xpad = None
    if with_xpad:
        xpad = torch.zeros(bx, device=dev)
        xpad[bx - bx // 5:] = float("inf")
    assert qdist.pq_adc_route(tl, tc, xpad)
    want = qdist.pq_adc_ref(tl, tc, xpad)
    launches = qdist.ADC_LAUNCHES, qdist.ADC_SMEM_LAUNCHES
    for fn in (qdist.pq_adc_smem_cuda, qdist.pq_adc_v1_cuda,
               qdist.pq_adc_cuda):
        got = fn(tl, tc, xpad)
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__
    assert (qdist.ADC_LAUNCHES - launches[0],
            qdist.ADC_SMEM_LAUNCHES - launches[1]) == (1, 2)


@pytest.mark.cuda
def test_cuda_pq_adc_routes_by_shape_and_the_layout_mirror():
    """M = 8 and unaligned codes go to qdist.cu, M = 16 to the shared-memory
    kernel; the kernel's own byte count equals the Python mirror."""
    from repro_torch.kernels import _build

    dev = _cuda()
    lib = _build.load("pq_adc_smem", qdist._ADC_SMEM_SIGNATURES)
    for m in qdist.SMEM_M:
        assert lib.repro_pq_adc_smem_bytes(m) == qdist.pq_adc_smem_bytes(m)
    assert lib.repro_pq_adc_smem_bytes(48) == 0
    buf = torch.zeros(16 * 101, dtype=torch.uint8, device=dev)
    for m, codes, smem in ((8, buf[:800].view(100, 8), False),
                           (16, buf[1:1601].view(100, 16), False),
                           (16, buf[:1600].view(100, 16), True)):
        luts = torch.ones((3, m, 256), device=dev)
        before = qdist.ADC_LAUNCHES, qdist.ADC_SMEM_LAUNCHES
        got = qdist.pq_adc_cuda(luts, codes)
        torch.cuda.synchronize()
        assert torch.equal(got, qdist.pq_adc_ref(luts, codes))
        assert (qdist.ADC_LAUNCHES - before[0],
                qdist.ADC_SMEM_LAUNCHES - before[1]) == (
            (0, 1) if smem else (1, 0)), (m, codes.data_ptr() % 16)
    with pytest.raises(ValueError, match="shared-memory"):
        qdist.pq_adc_smem_cuda(torch.ones((3, 8, 256), device=dev),
                               buf[:800].view(100, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bx,m,k", [(3, 100, 8, 10), (9, 600, 4, 64),
                                       (256, 32768, 16, 10), (2, 5, 8, 10),
                                       (5, 777, 3, 7)])
def test_cuda_pq_topk_matches_plain_version(bq, bx, m, k):
    dev = _cuda()
    luts, codes = _luts_codes(bq, bx, m, seed=22, hi=4.0)
    tl = torch.from_numpy(np.rint(luts)).to(dev)      # many ties
    tc = torch.from_numpy(codes).to(dev)
    launches = qdist.TOPK_LAUNCHES, qdist.TOPK_SMEM_LAUNCHES
    gv, gi = qdist.pq_topk_cuda(tl, tc, k=k)
    wv, wi = qdist.pq_topk_ref(tl, tc, k=k)
    torch.cuda.synchronize()
    assert torch.equal(gv, wv) and torch.equal(gi, wi)
    smem = qdist.pq_topk_route(tl, tc, None, k)
    assert (qdist.TOPK_LAUNCHES - launches[0],
            qdist.TOPK_SMEM_LAUNCHES - launches[1]) == (
        (0, 1) if smem else (1, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bx,m,k", [
    (3, 5, 16, 10), (9, 2083, 16, 1), (9, 2083, 16, 10), (9, 2083, 16, 64),
    (256, 32768, 16, 10), (5, 777, 32, 10), (17, 4100, 32, 64),
    (3, 1000, 64, 10), (4, 2049, 64, 64), (1, 31, 16, 64),
])
@pytest.mark.parametrize("with_xpad", [False, True])
def test_cuda_pq_topk_both_routes_match_plain_version(bq, bx, m, k,
                                                      with_xpad):
    """Both kernels bitwise equal to the plain version at the
    shared-memory kernel's edges: Bx < k, ragged Bq (not a multiple of
    128 / M) and Bx (not a multiple of 32 or 4), k in {1, 10, 64}, every M
    it takes, integer tables in [0, 8) (ties), +inf padding rows."""
    dev = _cuda()
    rng = np.random.default_rng(bq * bx + m + k)
    tl = torch.from_numpy(rng.integers(0, 8, size=(bq, m, 256)).astype(
        np.float32)).to(dev)
    tc = torch.from_numpy(rng.integers(0, 256, size=(bx, m)).astype(
        np.uint8)).to(dev)
    xpad = None
    if with_xpad:
        xpad = torch.zeros(bx, device=dev)
        xpad[bx - bx // 5:] = float("inf")
    assert qdist.pq_topk_route(tl, tc, xpad, k)
    wv, wi = qdist.pq_topk_ref(tl, tc, xpad, k=k)
    launches = qdist.TOPK_SMEM_LAUNCHES
    for fn in (qdist.pq_topk_smem_cuda, qdist.pq_topk_v1_cuda,
               qdist.pq_topk_cuda):
        gv, gi = fn(tl, tc, xpad, k=k)
        torch.cuda.synchronize()
        assert torch.equal(gv, wv) and torch.equal(gi, wi), fn.__name__
    assert qdist.TOPK_SMEM_LAUNCHES == launches + 2


@pytest.mark.cuda
def test_cuda_pq_topk_routes_by_shape_and_the_layout_mirror():
    """M = 8 and unaligned codes go to qdist.cu, M = 16 to the shared-memory
    kernel; the kernel's own byte count equals the Python mirror."""
    from repro_torch.kernels import _build

    dev = _cuda()
    lib = _build.load("pq_topk_smem", qdist._SMEM_SIGNATURES)
    for m in qdist.SMEM_M:
        assert lib.repro_pq_topk_smem_bytes(m) == qdist.pq_topk_smem_bytes(m)
    assert lib.repro_pq_topk_smem_bytes(48) == 0
    buf = torch.zeros(16 * 101, dtype=torch.uint8, device=dev)
    for m, codes, smem in ((8, buf[:800].view(100, 8), False),
                           (16, buf[1:1601].view(100, 16), False),
                           (16, buf[:1600].view(100, 16), True)):
        luts = torch.ones((3, m, 256), device=dev)
        before = qdist.TOPK_LAUNCHES, qdist.TOPK_SMEM_LAUNCHES
        qdist.pq_topk_cuda(luts, codes, k=5)
        torch.cuda.synchronize()
        assert (qdist.TOPK_LAUNCHES - before[0],
                qdist.TOPK_SMEM_LAUNCHES - before[1]) == (
            (0, 1) if smem else (1, 0)), (m, codes.data_ptr() % 16)
    with pytest.raises(ValueError, match="shared-memory"):
        qdist.pq_topk_smem_cuda(torch.ones((3, 8, 256), device=dev),
                                buf[:800].view(100, 8), k=5)
