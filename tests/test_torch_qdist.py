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

The CUDA kernels against the plain versions run only where there is a
card (the `cuda` marker); here they skip.
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
    with pytest.raises(ValueError, match="CUDA"):
        qdist.pq_adc_cuda(luts, codes)
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
    launches = qdist.ADC_LAUNCHES
    got = qdist.pq_adc_cuda(tl, tc, xpad)
    want = qdist.pq_adc_ref(tl, tc, xpad)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert qdist.ADC_LAUNCHES == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bx,m,k", [(3, 100, 8, 10), (9, 600, 4, 64),
                                       (256, 32768, 16, 10), (2, 5, 8, 10),
                                       (5, 777, 3, 7)])
def test_cuda_pq_topk_matches_plain_version(bq, bx, m, k):
    dev = _cuda()
    luts, codes = _luts_codes(bq, bx, m, seed=22, hi=4.0)
    tl = torch.from_numpy(np.rint(luts)).to(dev)      # many ties
    tc = torch.from_numpy(codes).to(dev)
    launches = qdist.TOPK_LAUNCHES
    gv, gi = qdist.pq_topk_cuda(tl, tc, k=k)
    wv, wi = qdist.pq_topk_ref(tl, tc, k=k)
    torch.cuda.synchronize()
    assert torch.equal(gv, wv) and torch.equal(gi, wi)
    assert qdist.TOPK_LAUNCHES == launches + 1
