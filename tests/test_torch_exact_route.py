"""The exact backend's two scan routes, and the fused scans' split rule.

`ExactBackend.search` runs l2 over 8-bit code rows on a card as one fused
`ops.l2topk_q` launch (`csrc/l2topk_q_tc.cu` and its split merge at the
tensor cores' shapes, `csrc/l2topk.cu` at the others), and everything
else, and every search on the CPU, as the chunk loop `core/bruteforce.py`
`bruteforce_topk` (`backends._scan_route`). The two must answer bit for
bit alike: ids, distances, the lowest id first among equal distances, pad
rows never returned.

Here the route is taken as a card would take it (`as_on_a_card` patches
the device the rule reads) while the tensors stay on the CPU, so the
kernel route runs `ops.l2topk_q`'s plain version. The `cuda`-marked tests
hold the kernel itself to the chunk loop at 10,000 queries, count its
launches and skip here. `l2topk.splits_for` is arithmetic, checked here.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import IndexSpec
from repro_torch.api import backends
from repro_torch.api.backends import ExactBackend
from repro_torch.core.bruteforce import bruteforce_topk
from repro_torch.ingest.memtable import Memtable
from repro_torch.ingest.segments import seal_memtable
from repro_torch.kernels import l2topk, qdist
from repro_torch.obs.trace import TRACER

torch.set_num_threads(1)

# each row dtype's codes as the quantizer makes them (int8 clips at -127)
CODES = {"uint8": (0, 256), "int8": (-127, 128)}
QSCALE = 0.37          # a quantizer scale whose square is not 1
N, D, DUP = 1500, 128, 40   # 1,500 rows pad to 1,536; the last 40 repeat
KERNEL, CHUNKS = "l2topk_q", "chunks"


def _codes(n, d, dt, seed, dup=0):
    """n rows of `dt` codes from a seed; the last `dup` repeat the first."""
    lo, hi = CODES[dt]
    x = np.random.default_rng(seed).integers(lo, hi, (n, d)).astype(dt)
    if dup:
        x[n - dup:] = x[:dup]
    return x


def _queries(x, b, seed):
    """b code-valued float32 queries, as `SearchService.search` hands them
    on: the first 8 are rows 0..7, each at distance 0 from itself and from
    its repeat."""
    dt = str(x.dtype)
    return np.concatenate([x[:8], _codes(b - 8, x.shape[1], dt, seed)]
                          ).astype(np.float32)


def _backend(dt, device="cpu", metric="l2", n=N, d=D, seed=3):
    """An exact backend over n code rows, the last DUP repeating the
    first where there are enough; float32: the uint8 codes as floats."""
    dup = DUP if n > 2 * DUP else 0
    if dt == "float32":
        spec = IndexSpec(backend="exact", metric=metric)
        x = _codes(n, d, "uint8", seed, dup=dup).astype(np.float32)
    else:
        spec = IndexSpec(backend="exact", metric=metric, dtype=dt,
                         qscale=QSCALE, qzero=0)
        x = _codes(n, d, dt, seed, dup=dup)
    return ExactBackend(spec, x, device), x


@pytest.fixture
def as_on_a_card(monkeypatch):
    """Route every exact search as a CUDA device would, the tensors on
    the CPU."""
    rule = backends._scan_route
    monkeypatch.setattr(backends, "_scan_route",
                        lambda dtype, metric, k, d, device: rule(
                            dtype, metric, k, d, "cuda"))


@pytest.fixture
def tracing():
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    try:
        yield TRACER
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()


def _search(be, q, k):
    """One search under a root span (`scan` and `upload` are children)."""
    with TRACER.span("search"):
        ids, dists, _ = be.search(q, k, 0, False, False)
    return ids, dists


def _scan_span():
    (scan,) = [ev for ev in TRACER.spans() if ev["name"] == "scan"]
    (upload,) = [ev for ev in TRACER.spans() if ev["name"] == "upload"]
    return scan["attrs"], upload["attrs"]


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt,metric,k,d,want", [
    ("uint8", "l2", 1, 128, KERNEL), ("uint8", "l2", 10, 128, KERNEL),
    ("uint8", "l2", 64, 128, KERNEL), ("int8", "l2", 10, 128, KERNEL),
    ("int8", "l2", 64, 256, KERNEL), ("uint8", "l2", 10, 48, KERNEL),
    ("uint8", "l2", 65, 128, CHUNKS), ("int8", "l2", 65, 128, CHUNKS),
    ("uint8", "ip", 10, 128, CHUNKS), ("uint8", "cosine", 10, 128, CHUNKS),
    ("float32", "l2", 10, 128, CHUNKS),
    ("uint8", "l2", 10, 40, KERNEL),      # D % 16: the FMA kernel's
    ("uint8", "l2", 10, 129, KERNEL),     # the widest exact uint8 row
    ("uint8", "l2", 10, 144, CHUNKS),     # uint8 distances past 2^24
    ("int8", "l2", 10, 272, KERNEL),      # past TC_MAX_D: the FMA kernel's
    ("int8", "l2", 10, 512, CHUNKS),      # int8 distances reach 2^24
])
def test_route_rule(dt, metric, k, d, want):
    dtype = getattr(torch, dt)
    assert backends._scan_route(dtype, metric, k, d, "cuda") == want
    assert backends._scan_route(dtype, metric, k, d, "cuda:0") == want
    assert backends._scan_route(dtype, metric, k, d, "cpu") == CHUNKS


# ---------------------------------------------------------------------------
# the kernel route's plain version against the chunk loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [D, 40])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("dt", ["uint8", "int8"])
def test_kernel_route_answers_as_the_chunk_loop(dt, k, d, as_on_a_card,
                                                tracing):
    """Ids and distances bitwise those of the chunk loop on the same
    codes, rescaled as `ExactBackend` rescales the chunk loop's; at the
    tensor cores' width and at one only the FMA kernel takes."""
    be, x = _backend(dt, d=d)
    q = _queries(x, 32, seed=4)
    want_i, want_d = bruteforce_topk(be.vectors, be.sqnorms,
                                     torch.from_numpy(q), k=k,
                                     chunk=be.CHUNK)
    want_d = want_d * float(np.float32(be.quant.dist_scale))
    got_i, got_d = _search(be, q, k)
    scan, upload = _scan_span()
    assert scan == {"route": KERNEL, "rows": 1536, "queries": 32, "k": k}
    assert upload == {"bytes": 32 * d * 4}  # float32, cast on the device
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    assert int(got_i.max()) < N             # no pad row
    # ties: query i is row i and its repeat N - DUP + i; the lower id first
    assert torch.equal(got_i[:8, 0], torch.arange(8, dtype=torch.int32))
    assert bool((got_d[:8, 0] == 0).all())
    if k > 1:
        assert torch.equal(got_i[:8, 1], torch.arange(
            N - DUP, N - DUP + 8, dtype=torch.int32))
        assert bool((got_d[:8, 1] == 0).all())


@pytest.mark.parametrize("dt", ["uint8", "int8"])
def test_kernel_route_tail_when_fewer_than_k_rows(dt, as_on_a_card):
    """5 rows under k = 10: the chunk loop and the kernel both fill the
    empty slots with (+inf, -1)."""
    be, x = _backend(dt, n=5)
    q = _queries(_codes(64, D, dt, 9), 8, seed=5)
    ids, dists, _ = be.search(q, 10, 0, False, False)
    want_i, want_d = bruteforce_topk(be.vectors, be.sqnorms,
                                     torch.from_numpy(q), k=10,
                                     chunk=be.CHUNK)
    scale = float(np.float32(be.quant.dist_scale))
    assert torch.equal(ids, want_i) and torch.equal(dists, want_d * scale)
    assert bool((ids[:, 5:] == -1).all()) and bool(
        torch.isinf(dists[:, 5:]).all())


@pytest.mark.parametrize("dt,metric,k", [
    ("uint8", "l2", 65), ("int8", "l2", 65), ("float32", "l2", 10),
    ("uint8", "ip", 10), ("uint8", "cosine", 10), ("float32", "ip", 10)])
def test_chunk_route_runs_bruteforce_topk(dt, metric, k, as_on_a_card,
                                          monkeypatch, tracing):
    """Routed as on a card, these keep the chunk loop: bruteforce_topk is
    called once, the kernel never."""
    calls = []
    real = backends.bruteforce_topk

    def counted(*a, **kw):
        calls.append(kw["metric"])
        return real(*a, **kw)

    def no_kernel(*a, **kw):
        raise AssertionError("the chunk route launched l2topk_q")

    monkeypatch.setattr(backends, "bruteforce_topk", counted)
    monkeypatch.setattr(backends, "l2topk_q", no_kernel)
    be, x = _backend(dt, metric=metric)
    q = _queries(x.astype(np.uint8) if dt == "float32" else x, 16, seed=6)
    ids, dists = _search(be, q, k)
    assert calls == [metric] and ids.shape == (16, k)
    scan, upload = _scan_span()
    assert scan == {"route": CHUNKS, "rows": 1536, "chunks": 3,
                    "queries": 16, "k": k}
    assert upload == {"bytes": 16 * D * 4}


# ---------------------------------------------------------------------------
# a sealed uint8 segment against the memtable it came from
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("device,routed", [
    ("cpu", False), ("cpu", True),
    pytest.param("cuda", False, marks=pytest.mark.cuda)])
def test_sealed_uint8_segment_answers_as_its_memtable(device, routed,
                                                      request):
    """`seal_memtable` over byte codes (scale 1) gives an exact uint8
    segment; its answers equal the memtable's float32 chunk loop over the
    same rows, global ids and distances, bit for bit. On a card the
    segment takes the kernel, one launch a search; `routed` takes the
    kernel route's plain version on the CPU."""
    if device == "cuda":
        _cuda()
    if routed:
        request.getfixturevalue("as_on_a_card")
    x = _codes(3000, D, "uint8", seed=21, dup=64)
    gids = np.arange(100, 3100, dtype=np.int64)
    q = _queries(x, 48, seed=22)
    spec = IndexSpec(backend="exact", dtype="uint8", qscale=1.0, qzero=0)
    seg = seal_memtable(spec, "s0", x, gids, None, device=device)
    before = (qdist.L2TOPK_Q_TC_LAUNCHES, qdist.L2TOPK_Q_LAUNCHES)
    got_i, got_d, _ = seg.search(q, k=10, ef=0, rerank=False,
                                 with_stats=False)
    moved = (qdist.L2TOPK_Q_TC_LAUNCHES - before[0],
             qdist.L2TOPK_Q_LAUNCHES - before[1])
    want_i, want_d = Memtable.scan(x.astype(np.float32), gids, q, 10, "l2",
                                   device)
    assert np.array_equal(got_i, want_i) and np.array_equal(got_d, want_d)
    assert moved == ((1, 0) if device == "cuda" else (0, 0))
    assert np.array_equal(got_i[:8, :2], np.stack(
        [gids[:8], gids[3000 - 64:3000 - 56]], 1))


# ---------------------------------------------------------------------------
# on a card: the kernel route itself
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d,launches", [(D, (1, 0)), (40, (0, 1))])
@pytest.mark.parametrize("dt", ["uint8", "int8"])
def test_cuda_exact_backend_is_one_kernel_launch_a_search(dt, d, launches):
    """10,000 queries over 70,000 rows (pads to 70,144; DUP planted
    repeats): ids and distances bitwise those of bruteforce_topk on the
    same codes, one launch a search: at D = 128 of l2topk_q_tc and none
    of the FMA kernel; at D = 40, which the tensor cores refuse, of the
    FMA kernel (`ops.l2topk_q` picks)."""
    dev = _cuda()
    be, x = _backend(dt, device=dev, n=70_000, d=d, seed=11)
    q = _queries(x, 10_000, seed=12)
    before = (qdist.L2TOPK_Q_TC_LAUNCHES, qdist.L2TOPK_Q_LAUNCHES)
    for _ in range(2):
        ids, dists, _ = be.search(q, 10, 0, False, False)
    torch.cuda.synchronize()
    assert (qdist.L2TOPK_Q_TC_LAUNCHES - before[0],
            qdist.L2TOPK_Q_LAUNCHES - before[1]) == tuple(
                2 * n for n in launches)
    want_i, want_d = bruteforce_topk(be.vectors, be.sqnorms,
                                     torch.from_numpy(q).to(dev), k=10,
                                     chunk=be.CHUNK)
    scale = float(np.float32(be.quant.dist_scale))
    assert torch.equal(ids, want_i) and torch.equal(dists, want_d * scale)
    assert torch.equal(ids[:8, 1].cpu(), torch.arange(
        70_000 - DUP, 70_000 - DUP + 8, dtype=torch.int32))


@pytest.mark.cuda
def test_cuda_l2topk_q_tc_answers_alike_at_any_split(monkeypatch):
    """At 10,000 queries the split rule runs 5 splits; one split gives
    the same ids and distances."""
    dev = _cuda()
    x = torch.from_numpy(_codes(70_000, D, "uint8", 13, dup=512)).to(dev)
    q = torch.from_numpy(_queries(x.cpu().numpy(), 10_000, 14)).to(
        dev).to(torch.uint8)
    xsq = qdist.sqnorms(x)
    assert l2topk.splits_for(10_000, 70_000, 10, qdist._TC_CTAS) == 5
    got = qdist.l2topk_q_tc_cuda(q, x, xsq, k=10, out_scale=QSCALE ** 2)
    monkeypatch.setattr(qdist, "splits_for", lambda *a: 1)
    one = qdist.l2topk_q_tc_cuda(q, x, xsq, k=10, out_scale=QSCALE ** 2)
    assert all(torch.equal(a, b) for a, b in zip(got, one))


# ---------------------------------------------------------------------------
# the split rule of the fused scans
# ---------------------------------------------------------------------------


def _waves(bq, s, ctas):
    groups = -(-bq // 64)
    return -(-groups * s // ctas)


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("bx", [70_000, 1_000_000])
def test_split_rule_fills_the_last_wave(k, bx):
    """157 groups of 64 queries over 132 CTAs: the last wave is at least
    90 % full, and the scan takes fewer CTA lengths than one split's two
    waves."""
    s = l2topk.splits_for(10_000, bx, k, 132)
    groups = -(-10_000 // 64)
    last = groups * s - (_waves(10_000, s, 132) - 1) * 132
    assert last >= 0.9 * 132
    assert _waves(10_000, s, 132) / s < _waves(10_000, 1, 132)


@pytest.mark.parametrize("ctas", [132, 264])
def test_split_rule_below_the_card_is_unchanged(ctas):
    """Up to `ctas` groups the splits are as they were: enough to fill the
    card, capped."""
    for bq in range(1, ctas * 64 + 1, 97):
        for bx in (1, 64, 65, 5000, 70_000, 1_000_000):
            for k in (1, 10, 64):
                groups = -(-bq // 64)
                was = max(1, min(l2topk.MAX_SPLITS, -(-ctas // groups),
                                 -(-bx // 64),
                                 l2topk.MERGE_CANDIDATES // k))
                assert l2topk.splits_for(bq, bx, k, ctas) == was


@pytest.mark.parametrize("k", [1, 10, 33, 64])
def test_split_rule_keeps_its_caps(k):
    for bq in (1, 64, 8448, 8449, 10_000, 20_000, 100_000):
        for bx in (1, 64, 100, 6400, 70_000, 1_000_000):
            for ctas in (132, 264):
                s = l2topk.splits_for(bq, bx, k, ctas)
                assert 1 <= s <= l2topk.MAX_SPLITS
                assert s <= max(1, l2topk.MERGE_CANDIDATES // k)
                assert s <= max(1, -(-bx // 64))
