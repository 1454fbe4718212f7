"""Fused exact k-nearest scan (the reference's `l2topk_pallas`: distance
tiles folded into a running top-k, the [Bq, Bx] matrix never written):
the plain PyTorch version and the wrapper of its CUDA kernel.

    l2topk: queries [Bq, D] x rows [Bx, D] (+ xsq [Bx])
            -> (dists [Bq, k] float32 ascending, ids [Bq, k] int32)
            d = max((qsq + xsq) - 2 * q.x, 0)

`xsq` is the float32 sum of squares of each row, computed when absent;
+inf marks a padding row, which never enters the result. `l2topk_q`
(`kernels/qdist.py`) is the same scan over 8-bit code rows, its
distances multiplied by `out_scale` after the selection.

The order is by distance, then by row id: among equal distances the lower
row wins, as the reference's `_select_k` gives. A slot that no finite
distance fills (fewer than k rows, or padding rows) holds (+inf, -1);
there the reference returns ids that depend on its block size, and the
finite slots agree. The kernel takes 1 <= k <= 64 and raises above it;
the plain version takes any k.

`l2topk_ref` is the plain version: the CPU path and the yardstick the
kernels are compared with on the card (a float32 `q @ x.T` per chunk of
rows, TF32 off, then a stable sort). `l2topk_cuda` launches one of two
CUDA kernels (built by `_build.py`), chosen by dtype and shape:

- `csrc/l2topk_tc.cu`, 3 x TF32 on the tensor cores (wgmma, TMA) with
  selection warps beside the products, for float32 queries and rows with
  D a multiple of 4 up to 128, at least one row, and contiguous operands
  with 16-byte aligned bases (`takes_tensor_cores`). `l2topk_tc_cuda`
  launches it and counts in `TC_LAUNCHES`. Its split of each float32
  into two TF32 pieces (`l2dist.tf32_split`) keeps integer-valued rows up
  to 2048 exact, so it equals the plain version bitwise there; on float
  data its distances are within 3e-6 * (qsq + xsq) of the exact ones.
- `csrc/l2topk.cu`, FP32 FMAs, for 8-bit rows and the float32 shapes the
  tensor-core kernel refuses. `l2topk_fma_cuda` launches it and counts
  in `LAUNCHES`.

This is a choice by shape, not a fallback: a failed build or launch of
either raises. `ops.l2topk` picks the plain version or `l2topk_cuda` by
the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2dist import (
    ROW_DTYPES,
    as_f32,
    raise_on,
    row_operands,
    sqnorms,
)

__all__ = ["LAUNCHES", "MAX_K", "MAX_SPLITS", "MERGE_CANDIDATES",
           "TC_LAUNCHES", "TC_MAX_D", "fused_topk_ref", "launch_fused_topk",
           "l2topk_ref", "l2topk_cuda", "l2topk_fma_cuda", "l2topk_tc_cuda",
           "splits_for", "takes_tensor_cores"]

# launches of each CUDA kernel since import (or since a caller reset them)
LAUNCHES = 0                      # csrc/l2topk.cu (FP32 FMAs)
TC_LAUNCHES = 0                   # csrc/l2topk_tc.cu (3 x TF32)

# shape limits of csrc/l2topk.cu: k per query and splits of the rows
MAX_K, MAX_SPLITS = 64, 128
_QBLOCK, _TILE = 64, 64          # queries of a CTA, rows of a tile
# CTAs that fill the card: two per SM of the H100's 132 (at 127 registers
# a thread, two 256-thread CTAs fit an SM)
_CTAS = 2 * 132
# candidates a query the split merge takes at most: its rank counting
# outgrows a split's gain above this (at 256 x 1M, k=64: 6.6 ms with 32
# splits, 18.3 ms with 128; PERF.md §6)
MERGE_CANDIDATES = 2048
# where the query groups alone fill the card, more splits are worth it
# only if they save more than this share of the waves: each split's CTAs
# pay their lists' warm-up again (l2topk_q_tc at 10,000 x 1M, k = 10:
# 5 splits 10.37 ms, 10 11.53, 21 13.85, 95 28.68, though all run
# within 1 % of the same wave time; H100 80GB HBM3, PERF.md §6)
_WAVE_SLACK = 0.02
# rows a plain version takes at once: a [Bq, 65536] float32 tile
_CHUNK = 1 << 16
_INF = float("inf")
# the tensor-core kernel's widest D: the queries' two pieces, a 4-stage
# row ring and two distance tiles at 128 columns take 230,760 bytes of
# shared memory
TC_MAX_D = 128
# CTAs that fill the card with the tensor-core kernel: one per SM of the
# H100's 132 (896 threads, 225 KB of shared memory)
_TC_CTAS = 132


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def fused_topk_ref(queries, xs, xsq=None, *, k: int,
                   out_scale: float | None = None):
    """k smallest of max((qsq + xsq) - 2 q.x, 0) per query, a chunk of rows
    at a time: each chunk's k best by a stable sort, merged into the
    running list by a stable sort of [running, chunk] (the running ids are
    all lower, so ties keep the lower id). `out_scale` multiplies the
    selected distances (the `_q` variant)."""
    q = queries.float()
    bq = q.shape[0]
    qsq = sqnorms(q)
    run_d = q.new_full((bq, 0), _INF)
    run_i = torch.empty((bq, 0), dtype=torch.int32, device=q.device)
    for lo in range(0, xs.shape[0], _CHUNK):
        x = xs[lo:lo + _CHUNK].float()
        xn = sqnorms(x) if xsq is None else xsq[lo:lo + _CHUNK].float()
        d = (qsq[:, None] + xn[None, :] - 2.0 * (q @ x.T)).clamp_min(0.0)
        cd, ci = torch.sort(d, dim=1, stable=True)
        cat_d = torch.cat([run_d, cd[:, :k]], 1)
        cat_i = torch.cat([run_i, (ci[:, :k] + lo).to(torch.int32)], 1)
        run_d, order = torch.sort(cat_d, dim=1, stable=True)
        run_d, run_i = run_d[:, :k], cat_i.gather(1, order[:, :k])
    if run_d.shape[1] < k:
        pad = k - run_d.shape[1]
        run_d = torch.nn.functional.pad(run_d, (0, pad), value=_INF)
        run_i = torch.nn.functional.pad(run_i, (0, pad), value=-1)
    fin = run_d < _INF
    if out_scale is not None:
        run_d = run_d * as_f32(out_scale)
    return (torch.where(fin, run_d, _INF),
            torch.where(fin, run_i, torch.full_like(run_i, -1)))


def l2topk_ref(queries, xs, xsq=None, *, k: int = 10):
    """Plain version of `l2topk`: (dists [Bq, k] ascending, ids [Bq, k]
    int32); ties go to the lower row, unfilled slots are (+inf, -1)."""
    return fused_topk_ref(queries, xs, xsq, k=k)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_l2topk": (ctypes.c_int,
                     [_P] * 8 + [_I] * 9 + [ctypes.c_float, _P]),
    "repro_l2topk_error_string": (ctypes.c_char_p, [_I]),
}


_TC_SIGNATURES = {
    "repro_l2topk_tc": (ctypes.c_int, [_P] * 8 + [_I] * 6 + [_P]),
    "repro_l2topk_tc_error_string": (ctypes.c_char_p, [_I]),
}


def splits_for(bq: int, bx: int, k: int, ctas: int) -> int:
    """Row splits of a fused scan, at most one a 64-row tile, at most
    MAX_SPLITS, and at most MERGE_CANDIDATES candidates a query for the
    merge. Fewer groups of 64 queries than `ctas` (the CTAs that fill the
    card at once): enough splits to fill it. More: the grid runs in waves
    of `ctas`, so S splits take ceil(groups * S / ctas) waves of CTAs 1/S
    as long; the fewest splits within `_WAVE_SLACK` of the best such time,
    so that the last wave is nearly full (at 157 groups and 132 CTAs, 5
    splits: 5.95 waves of a fifth, where 1 split runs 2 waves, the second
    with 25 CTAs)."""
    groups = max(-(-bq // _QBLOCK), 1)
    cap = max(1, min(MAX_SPLITS, -(-bx // _TILE), MERGE_CANDIDATES // k))
    if groups <= ctas:
        return min(cap, -(-ctas // groups))
    # time of S splits in CTA lengths of one split: waves(S) / S
    waves = [-(-groups * s // ctas) for s in range(1, cap + 1)]
    best = min(w / s for s, w in enumerate(waves, 1))
    return next(s for s, w in enumerate(waves, 1)
                if w / s <= best * (1 + _WAVE_SLACK))


def launch_fused_topk(queries, xs, xsq, *, k: int, out_scale: float | None,
                      row_dtypes, what: str):
    """Launch `csrc/l2topk.cu`'s two passes on the current stream; returns
    (dists [Bq, k] float32, ids [Bq, k] int32). 1 <= k <= 64; raises on
    any other device, dtype, shape or layout."""
    q, qvec, xvec, dev = row_operands(queries, xs, xsq, row_dtypes, what)
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k}; the {what} kernel takes 1..{MAX_K}")
    (bq, d), bx = q.shape, xs.shape[0]
    qsq = sqnorms(q)
    xsq = sqnorms(xs) if xsq is None else xsq
    splits = splits_for(bq, bx, k, _CTAS)
    part_d = torch.empty((bq, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((bq, splits, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    lib = _build.load("l2topk", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_l2topk(
        q.data_ptr(), xs.data_ptr(), qsq.data_ptr(), xsq.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), dev.index or 0, bq, bx, d, ROW_DTYPES[xs.dtype],
        qvec, xvec, k, splits, as_f32(1.0 if out_scale is None else out_scale),
        stream)
    raise_on(lib, "repro_l2topk_error_string", err, what)
    return out_d, out_i


def takes_tensor_cores(queries, xs) -> bool:
    """Whether `l2topk_cuda` gives these operands to the tensor-core
    kernel: float32 queries and rows, D a multiple of 4 up to `TC_MAX_D`
    (TMA's 16-byte row pitch), at least one row (a tensor map has no empty
    dimension), and contiguous operands with 16-byte aligned bases. No
    rule on Bx: the kernel stores no [Bq, Bx] output, only each query's k
    best. Everything else goes to the FP32-FMA kernel."""
    d = xs.shape[-1]
    return (queries.dtype == torch.float32 and xs.dtype == torch.float32
            and d % 4 == 0 and d <= TC_MAX_D and xs.shape[0] > 0
            and queries.is_contiguous() and xs.is_contiguous()
            and queries.data_ptr() % 16 == 0 and xs.data_ptr() % 16 == 0)


def l2topk_fma_cuda(queries, xs, xsq=None, *, k: int = 10):
    """Launch `csrc/l2topk.cu` (FP32 FMAs) on the current stream over
    float32, uint8 or int8 rows: (dists [Bq, k] float32, ids [Bq, k]
    int32). k <= 64; raises on any other device, dtype, shape or
    layout."""
    out = launch_fused_topk(queries, xs, xsq, k=k, out_scale=None,
                            row_dtypes=ROW_DTYPES, what="l2topk")
    _build.count_launch(__name__, "LAUNCHES")
    return out


def l2topk_tc_cuda(queries, xs, xsq=None, *, k: int = 10):
    """Launch `csrc/l2topk_tc.cu` (3 x TF32 on the tensor cores) and its
    split merge on the current stream: (dists [Bq, k] float32, ids [Bq, k]
    int32). k <= 64; raises on operands `takes_tensor_cores` refuses, as
    `row_operands` does, and if the launch fails."""
    _, _, _, dev = row_operands(queries, xs, xsq, (torch.float32,), "l2topk")
    if not takes_tensor_cores(queries, xs):
        raise ValueError(f"l2topk: the tensor-core kernel takes contiguous "
                         f"float32 queries and rows with D % 4 == 0, D <= "
                         f"{TC_MAX_D}, at least one row and 16-byte aligned "
                         f"bases; got {queries.dtype} queries, rows "
                         f"{tuple(xs.shape)}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k}; the l2topk kernel takes 1..{MAX_K}")
    (bq, d), bx = queries.shape, xs.shape[0]
    qsq = sqnorms(queries)
    xsq = sqnorms(xs) if xsq is None else xsq
    splits = splits_for(bq, bx, k, _TC_CTAS)
    part_d = torch.empty((bq, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((bq, splits, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    lib = _build.load("l2topk_tc", _TC_SIGNATURES)
    err = lib.repro_l2topk_tc(
        queries.data_ptr(), xs.data_ptr(), qsq.data_ptr(), xsq.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), dev.index or 0, bq, bx, d, k, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "repro_l2topk_tc_error_string", err, "l2topk (tensor cores)")
    _build.count_launch(__name__, "TC_LAUNCHES")
    return out_d, out_i


def l2topk_cuda(queries, xs, xsq=None, *, k: int = 10):
    """(dists [Bq, k] float32, ids [Bq, k] int32) from one of the two CUDA
    kernels, chosen by dtype and shape: `l2topk_tc_cuda` where
    `takes_tensor_cores` holds, else `l2topk_fma_cuda`. Raises as they
    do."""
    if takes_tensor_cores(queries, xs):
        return l2topk_tc_cuda(queries, xs, xsq, k=k)
    return l2topk_fma_cuda(queries, xs, xsq, k=k)
