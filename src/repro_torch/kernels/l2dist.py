"""Exact pairwise distances (the brute-force engine of the paper's Fig. 9
comparison): the plain PyTorch version and the wrapper of its CUDA kernel.

    l2dist: queries [Bq, D] x rows [Bx, D] -> d [Bq, Bx] float32
        l2:     (qsq + xsq) - 2 * q.x      (no clamp, as the reference)
        ip:     0 - q.x
        cosine: 1 - q.x                    (unit-norm inputs assumed)

`qsq` / `xsq` are the float32 sums of squares of the rows (`xsq` may be
given; the reference's `ops.l2dist` computes it). `l2dist_q`
(`kernels/qdist.py`) is the same matrix over 8-bit code rows under l2,
then `max(d, 0) * out_scale`.

Exactness: on integer-valued float32 rows with every partial sum an
integer below 2^24 (byte data at D <= 256, 8-bit codes) the dot product is
exact in any order, so the kernel, this plain version and the reference
agree bitwise. On general float data they sum in different orders; the
tests hold them within |d - d'| <= 1e-5 * (qsq + xsq).

`l2dist_ref` is the plain version: the CPU path and the yardstick the
kernels are compared with on the card (a float32 `q @ x.T` per chunk of
rows; TF32 must be off, `torch.backends.cuda.matmul.allow_tf32 = False`,
PyTorch's default). `l2dist_cuda` launches one of two CUDA kernels (built
by `_build.py`), chosen by dtype and shape:

- `csrc/l2dist_tc.cu`, 3 x TF32 on the tensor cores (wgmma, TMA), for
  float32 queries and rows with D a multiple of 4 up to 128, Bx a
  multiple of 4 and 16-byte aligned bases (`takes_tensor_cores`): TMA
  addresses rows in 16-byte steps, and 128 columns of queries, split in
  two pieces, fill the shared memory it leaves beside the row ring.
  `l2dist_tc_cuda` launches it and counts in `TC_LAUNCHES`. Its split
  (`tf32_split`) keeps integer-valued rows up to 2048 exact, so the
  bitwise agreement above holds; on float data it is within 3e-6 *
  (qsq + xsq) of the exact dot.
- `csrc/l2dist.cu`, FP32 FMAs, for 8-bit rows and the float32 shapes the
  tensor-core kernel refuses. `l2dist_fma_cuda` launches it and counts in
  `LAUNCHES`.

This is a choice by shape, not a fallback: a failed build or launch of
either raises. `ops.l2dist` picks the plain version or `l2dist_cuda` by
the tensors' device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "METRICS", "ROW_DTYPES", "TC_LAUNCHES", "as_f32",
           "data_ptr", "distance_matrix_ref", "launch_distance_matrix",
           "l2dist_ref", "l2dist_cuda", "l2dist_fma_cuda", "l2dist_tc_cuda",
           "raise_on", "row_operands", "sqnorms", "takes_tensor_cores",
           "tf32_split"]

# launches of each CUDA kernel since import (or since a caller reset them)
LAUNCHES = 0                      # csrc/l2dist.cu (FP32 FMAs)
TC_LAUNCHES = 0                   # csrc/l2dist_tc.cu (3 x TF32)

METRICS = {"l2": 0, "ip": 1, "cosine": 2}
# row types csrc/l2dist.cu and csrc/l2topk.cu are compiled for
ROW_DTYPES = {torch.float32: 0, torch.uint8: 1, torch.int8: 2}
_QUERY_DTYPES = tuple(ROW_DTYPES)
# rows a plain version takes at once: a [Bq, 65536] float32 tile
_CHUNK = 1 << 16


def sqnorms(t):
    """Float32 sum of squares of each row."""
    f = t.float()
    return (f * f).sum(-1)


def as_f32(x: float) -> float:
    """`x` rounded to float32, as the kernels receive it."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def distance_matrix_ref(queries, xs, xsq=None, *, metric: str = "l2",
                        out_scale: float | None = None):
    """The [Bq, Bx] matrix under `metric`, a chunk of rows at a time; with
    `out_scale`, `max(d, 0) * out_scale` (the `_q` variant)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    q = queries.float()
    qsq = sqnorms(q) if metric == "l2" else None
    out = q.new_empty((q.shape[0], xs.shape[0]))
    for lo in range(0, xs.shape[0], _CHUNK):
        x = xs[lo:lo + _CHUNK].float()
        dot = q @ x.T
        if metric == "l2":
            xn = sqnorms(x) if xsq is None else xsq[lo:lo + _CHUNK].float()
            d = qsq[:, None] + xn[None, :] - 2.0 * dot
        elif metric == "ip":
            d = 0.0 - dot
        else:
            d = 1.0 - dot
        if out_scale is not None:
            d = d.clamp_min(0.0) * as_f32(out_scale)
        out[:, lo:lo + _CHUNK] = d
    return out


def l2dist_ref(queries, xs, xsq=None, *, metric: str = "l2"):
    """Plain version of `l2dist`: d [Bq, Bx] float32 under `metric`."""
    return distance_matrix_ref(queries, xs, xsq, metric=metric)


def tf32_split(x):
    """(hi, lo) of float32 `x` as `csrc/l2dist_tc.cu` splits it: hi keeps
    the bits the TF32 units read (x & 0xffffe000), lo = x - hi, so hi + lo
    == x exactly; lo is 0 on integers up to 2048."""
    x = x.float().contiguous()
    hi = (x.view(torch.int32) & -(1 << 13)).view(torch.float32)
    return hi, x - hi


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_l2dist": (ctypes.c_int,
                     [_P] * 5 + [_I] * 9 + [ctypes.c_float, _P]),
    "repro_l2dist_error_string": (ctypes.c_char_p, [_I]),
}
_TC_SIGNATURES = {
    "repro_l2dist_tc": (ctypes.c_int, [_P] * 5 + [_I] * 5 + [_P]),
    "repro_l2dist_tc_error_string": (ctypes.c_char_p, [_I]),
}
# the tensor-core kernel's widest D: the queries' two pieces and a 3-stage
# row ring at 128 columns take 192 KB of shared memory
TC_MAX_D = 128


def takes_tensor_cores(queries, xs) -> bool:
    """Whether `l2dist_cuda` gives these operands to the tensor-core
    kernel: float32 queries and rows, D a multiple of 4 up to `TC_MAX_D`,
    Bx a multiple of 4 (TMA's row pitch, 16 bytes, of the rows and of the
    [Bq, Bx] output) and 16-byte aligned bases. Everything else goes to
    the FP32-FMA kernel."""
    d = xs.shape[-1]
    return (queries.dtype == torch.float32 and xs.dtype == torch.float32
            and d % 4 == 0 and d <= TC_MAX_D and xs.shape[0] % 4 == 0
            and queries.data_ptr() % 16 == 0 and xs.data_ptr() % 16 == 0)


def row_operands(queries, xs, xsq, row_dtypes, what: str):
    """Check the operands of an exact-scan kernel; returns (q, qvec, xvec,
    device): float32 contiguous queries (8-bit codes are cast, which
    is exact) and whether queries / rows may be staged 16 (float32) or 8
    (code) bytes at a time."""
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    if queries.device != dev:
        raise ValueError(f"queries are on {queries.device}, expected {dev}")
    if queries.dim() != 2 or xs.dim() != 2 or queries.shape[1] != xs.shape[1]:
        raise ValueError(f"{what} takes queries [Bq, D] and rows [Bx, D], got "
                         f"{tuple(queries.shape)} and {tuple(xs.shape)}")
    if xs.dtype not in row_dtypes:
        raise TypeError(f"rows have dtype {xs.dtype}; {what} takes "
                        f"{', '.join(map(str, row_dtypes))}")
    if queries.dtype not in _QUERY_DTYPES:
        raise TypeError(f"queries have dtype {queries.dtype}; {what} takes "
                        f"{', '.join(map(str, _QUERY_DTYPES))}")
    if not xs.is_contiguous():
        raise ValueError(f"{what}: rows must be contiguous")
    (bq, d), bx = queries.shape, xs.shape[0]
    if d < 1 or max(bq, bx, d) >= 2 ** 31 - 64:
        raise ValueError(f"Bq={bq}, Bx={bx}, D={d} exceed the kernels' range")
    if xsq is not None and (xsq.device != dev or xsq.dtype != torch.float32
                            or tuple(xsq.shape) != (bx,)
                            or not xsq.is_contiguous()):
        raise ValueError(f"xsq must be a contiguous float32 [{bx}] tensor on "
                         f"{dev}")
    q = queries.float().contiguous()
    qvec = d % 4 == 0 and q.data_ptr() % 16 == 0
    vec_bytes = 16 if xs.dtype == torch.float32 else 8
    xvec = (d % (vec_bytes // xs.element_size()) == 0
            and xs.data_ptr() % vec_bytes == 0)
    return q, int(qvec), int(xvec), dev


def data_ptr(t):
    """A tensor's device address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def raise_on(lib, fn: str, err: int, what: str) -> None:
    if err != 0:
        msg = getattr(lib, fn)(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def launch_distance_matrix(queries, xs, xsq, *, metric: str,
                           out_scale: float | None, row_dtypes, what: str):
    """Launch `csrc/l2dist.cu` on the current stream; returns d [Bq, Bx]
    float32. Raises on any other device, dtype, shape or layout."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    q, qvec, xvec, dev = row_operands(queries, xs, xsq, row_dtypes, what)
    (bq, d), bx = q.shape, xs.shape[0]
    qsq = None
    if metric == "l2":
        qsq = sqnorms(q)
        xsq = sqnorms(xs) if xsq is None else xsq
    out = torch.empty((bq, bx), dtype=torch.float32, device=dev)
    lib = _build.load("l2dist", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_l2dist(
        q.data_ptr(), xs.data_ptr(), data_ptr(qsq), data_ptr(xsq),
        out.data_ptr(), dev.index or 0, bq, bx, d, ROW_DTYPES[xs.dtype],
        qvec, xvec, METRICS[metric], int(out_scale is not None),
        as_f32(1.0 if out_scale is None else out_scale), stream)
    raise_on(lib, "repro_l2dist_error_string", err, what)
    return out


def l2dist_fma_cuda(queries, xs, xsq=None, *, metric: str = "l2"):
    """Launch `csrc/l2dist.cu` (FP32 FMAs) on the current stream: d [Bq,
    Bx] float32 under `metric` over float32, uint8 or int8 rows. Raises on
    any other device, dtype, shape or layout."""
    out = launch_distance_matrix(queries, xs, xsq, metric=metric,
                                 out_scale=None, row_dtypes=ROW_DTYPES,
                                 what="l2dist")
    _build.count_launch(__name__, "LAUNCHES")
    return out


def l2dist_tc_cuda(queries, xs, xsq=None, *, metric: str = "l2"):
    """Launch `csrc/l2dist_tc.cu` (3 x TF32 on the tensor cores) on the
    current stream: d [Bq, Bx] float32 under `metric`. Raises on operands
    `takes_tensor_cores` refuses, as `row_operands` does, and if the
    launch fails."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    q, _, _, dev = row_operands(queries, xs, xsq, (torch.float32,), "l2dist")
    if not takes_tensor_cores(q, xs):
        raise ValueError(f"l2dist: the tensor-core kernel takes float32 "
                         f"queries and rows with D % 4 == 0, D <= {TC_MAX_D}, "
                         f"Bx % 4 == 0 and 16-byte aligned bases; got "
                         f"{queries.dtype} queries, {tuple(xs.shape)}")
    (bq, d), bx = q.shape, xs.shape[0]
    qsq = None
    if metric == "l2":
        qsq = sqnorms(q)
        xsq = sqnorms(xs) if xsq is None else xsq
    out = torch.empty((bq, bx), dtype=torch.float32, device=dev)
    lib = _build.load("l2dist_tc", _TC_SIGNATURES)
    err = lib.repro_l2dist_tc(
        q.data_ptr(), xs.data_ptr(), data_ptr(qsq),
        data_ptr(xsq if metric == "l2" else None), out.data_ptr(),
        dev.index or 0, bq, bx, d, METRICS[metric],
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "repro_l2dist_tc_error_string", err,
             "l2dist (tensor cores)")
    _build.count_launch(__name__, "TC_LAUNCHES")
    return out


def l2dist_cuda(queries, xs, xsq=None, *, metric: str = "l2"):
    """d [Bq, Bx] float32 from one of the two CUDA kernels, chosen by
    dtype and shape: `l2dist_tc_cuda` where `takes_tensor_cores` holds,
    else `l2dist_fma_cuda`. Raises as they do."""
    if takes_tensor_cores(queries, xs):
        return l2dist_tc_cuda(queries, xs, xsq, metric=metric)
    return l2dist_fma_cuda(queries, xs, xsq, metric=metric)
