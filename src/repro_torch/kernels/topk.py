"""Per-row k smallest of a matrix (the reference's `topk_pallas`, which
the MoE router runs when `MoEConfig.router_use_kernel` is set): the plain
PyTorch version and the wrappers of its two CUDA kernels.

    topk: x [B, N] -> (values [B, k] float32 ascending, ids [B, k] int32)

x is read as float32 (the reference casts it). The order is by value,
then by column: among equal values the lower column wins, as the
reference's `_select_k` and `lax.top_k` give. A slot that no entry below
+inf fills (N < k, or +inf / NaN entries) holds (+inf, -1); there the
reference returns ids that depend on its block size, and the other slots
agree (ROADMAP.md Queue 3). The kernels take 1 <= k <= 64 and raise
above it; the plain version takes any k.

`topk_ref` is the plain version: the CPU path and the yardstick the
kernels are compared with on the card (a stable sort of each row).
`topk_cuda` picks a kernel by shape, never by value:

- rows of at most `SHORT_MAX_N` columns (`takes_short_rows`; the MoE
  router's [S, 64]) -> `topk_short_cuda`, `csrc/select_k_short.cu` (a
  warp a row, each entry written at its rank), counted in
  `SHORT_LAUNCHES`;
- longer rows -> `topk_stream_cuda`, `csrc/select_k.cu` (warps stream a
  row into a sorted list), counted in `LAUNCHES`.

Both are built by `_build.py`; a failed build or launch raises.
`ops.topk` picks the CUDA or the plain path by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2dist import raise_on

__all__ = ["LAUNCHES", "MAX_K", "SHORT_LAUNCHES", "SHORT_MAX_N",
           "takes_short_rows", "topk_cuda", "topk_ref", "topk_short_cuda",
           "topk_stream_cuda", "warps_per_row"]

# launches of each CUDA kernel since import (or since a caller reset them)
LAUNCHES = 0                      # csrc/select_k.cu
SHORT_LAUNCHES = 0                # csrc/select_k_short.cu

MAX_K = 64                        # csrc/select_k.cu keeps a warp's list
# the widest row csrc/select_k_short.cu takes: 8 entries a lane, 2 KB of
# keys a warp in shared memory
SHORT_MAX_N = 256
_INF = float("inf")


def topk_ref(x, k: int):
    """Plain version of `topk`: (values [B, k] ascending, ids [B, k]
    int32); ties go to the lower column, unfilled slots are (+inf, -1)."""
    x = x.float()
    b, n = x.shape
    vals, ids = torch.sort(x, dim=1, stable=True)
    vals, ids = vals[:, :k], ids[:, :k].to(torch.int32)
    if n < k:
        vals = torch.nn.functional.pad(vals, (0, k - n), value=_INF)
        ids = torch.nn.functional.pad(ids, (0, k - n), value=-1)
    fin = vals < _INF                                  # NaN compares False
    return (torch.where(fin, vals, _INF),
            torch.where(fin, ids, torch.full_like(ids, -1)))


def warps_per_row(n: int) -> int:
    """Warps of `select_k.cu` that share a row of n columns: one up to
    2,047 columns, up to 8 (one per 1,024 columns) above."""
    w = 1
    while w < 8 and 2 * w * 1024 <= n:
        w *= 2
    return w


def takes_short_rows(n: int, k: int) -> bool:
    """Whether `topk_cuda` gives rows of n columns to the short-row kernel
    (`csrc/select_k_short.cu`): 1 <= n <= `SHORT_MAX_N` and 1 <= k <=
    `MAX_K`. Longer rows go to `csrc/select_k.cu`."""
    return 0 < n <= SHORT_MAX_N and 0 < k <= MAX_K


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_select_k": (ctypes.c_int, [_P, _P, _P, _I, _L, _L, _I, _I, _P]),
    "repro_select_k_error_string": (ctypes.c_char_p, [_I]),
}
_SHORT_SIGNATURES = {
    "repro_select_k_short": (ctypes.c_int, [_P, _P, _P, _I, _L, _I, _I, _P]),
    "repro_select_k_short_error_string": (ctypes.c_char_p, [_I]),
}


def _operand(x, k: int):
    """x as a contiguous float32 CUDA matrix with columns, checked; raises
    on any other device, dtype, shape or layout, or k outside 1..64."""
    if x.device.type != "cuda":
        raise ValueError(f"topk: the kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 2 or not x.is_floating_point():
        raise ValueError(f"topk: x must be a 2-D float tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k}; the topk kernel takes 1..{MAX_K}")
    x = x.float()
    if not x.is_contiguous():
        raise ValueError("topk: x must be contiguous")
    if x.shape[1] == 0:
        raise ValueError("topk: x has no columns")
    return x


def _outputs(x, k: int):
    b, dev = x.shape[0], x.device
    return (torch.empty((b, k), dtype=torch.float32, device=dev),
            torch.empty((b, k), dtype=torch.int32, device=dev))


def topk_stream_cuda(x, k: int):
    """Launch `csrc/select_k.cu` on the current stream: (values [B, k]
    float32, ids [B, k] int32). Floating x is cast to float32 as the
    reference's kernel does; 1 <= k <= 64; raises on any other device,
    dtype, shape or layout."""
    x = _operand(x, k)
    (b, n), dev = x.shape, x.device
    out_d, out_i = _outputs(x, k)
    lib = _build.load("select_k", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_select_k(x.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                             dev.index or 0, b, n, k, warps_per_row(n), stream)
    raise_on(lib, "repro_select_k_error_string", err, "topk")
    _build.count_launch(__name__, "LAUNCHES")
    return out_d, out_i


def topk_short_cuda(x, k: int):
    """Launch `csrc/select_k_short.cu` on the current stream: (values
    [B, k] float32, ids [B, k] int32). Raises as `topk_stream_cuda` does,
    and on rows that `takes_short_rows` refuses."""
    x = _operand(x, k)
    (b, n), dev = x.shape, x.device
    if not takes_short_rows(n, k):
        raise ValueError(f"topk: the short-row kernel takes 1..{SHORT_MAX_N} "
                         f"columns, got {n}")
    out_d, out_i = _outputs(x, k)
    lib = _build.load("select_k_short", _SHORT_SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_select_k_short(x.data_ptr(), out_d.data_ptr(),
                                   out_i.data_ptr(), dev.index or 0, b, n, k,
                                   stream)
    raise_on(lib, "repro_select_k_short_error_string", err, "topk (short rows)")
    _build.count_launch(__name__, "SHORT_LAUNCHES")
    return out_d, out_i


def topk_cuda(x, k: int):
    """(values [B, k] float32, ids [B, k] int32) from one of the two CUDA
    kernels, chosen by shape: `topk_short_cuda` where `takes_short_rows`
    holds, else `topk_stream_cuda`. Raises as they do."""
    if x.dim() == 2 and takes_short_rows(x.shape[1], k):
        return topk_short_cuda(x, k)
    return topk_stream_cuda(x, k)
