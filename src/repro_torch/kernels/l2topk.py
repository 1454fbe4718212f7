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
kernel is compared with on the card (a float32 `q @ x.T` per chunk of
rows, TF32 off, then a stable sort). `l2topk_cuda` launches
`csrc/l2topk.cu` (built by `_build.py`) and counts its launches in
`LAUNCHES`. `ops.l2topk` picks one by the tensors' device.
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
           "fused_topk_ref", "launch_fused_topk", "l2topk_ref", "l2topk_cuda"]

# launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

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
# rows a plain version takes at once: a [Bq, 65536] float32 tile
_CHUNK = 1 << 16
_INF = float("inf")


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
    groups = -(-bq // _QBLOCK)
    splits = max(1, min(MAX_SPLITS, -(-_CTAS // max(groups, 1)),
                        -(-bx // _TILE), MERGE_CANDIDATES // k))
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


def l2topk_cuda(queries, xs, xsq=None, *, k: int = 10):
    """Launch `csrc/l2topk.cu` on the current stream over float32, uint8 or
    int8 rows: (dists [Bq, k] float32, ids [Bq, k] int32). k <= 64; raises
    on any other device, dtype, shape or layout."""
    global LAUNCHES
    out = launch_fused_topk(queries, xs, xsq, k=k, out_scale=None,
                            row_dtypes=ROW_DTYPES, what="l2topk")
    LAUNCHES += 1
    return out
