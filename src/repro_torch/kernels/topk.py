"""Per-row k smallest of a matrix (the reference's `topk_pallas`, which
the MoE router runs when `MoEConfig.router_use_kernel` is set): the plain
PyTorch version and the wrapper of its CUDA kernel.

    topk: x [B, N] -> (values [B, k] float32 ascending, ids [B, k] int32)

x is read as float32 (the reference casts it). The order is by value,
then by column: among equal values the lower column wins, as the
reference's `_select_k` and `lax.top_k` give. A slot that no entry below
+inf fills (N < k, or +inf / NaN entries) holds (+inf, -1); there the
reference returns ids that depend on its block size, and the other slots
agree (ROADMAP.md Queue 3). The kernel takes 1 <= k <= 64 and raises
above it; the plain version takes any k.

`topk_ref` is the plain version: the CPU path and the yardstick the kernel
is compared with on the card (a stable sort of each row). `topk_cuda`
launches `csrc/select_k.cu` (built by `_build.py`) and counts its launches
in `LAUNCHES`. `ops.topk` picks one by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2dist import raise_on

__all__ = ["LAUNCHES", "MAX_K", "topk_ref", "topk_cuda", "warps_per_row"]

# launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

MAX_K = 64                        # csrc/select_k.cu keeps a warp's list
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


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_select_k": (ctypes.c_int, [_P, _P, _P, _I, _L, _L, _I, _I, _P]),
    "repro_select_k_error_string": (ctypes.c_char_p, [_I]),
}


def topk_cuda(x, k: int):
    """Launch `csrc/select_k.cu` on the current stream: (values [B, k]
    float32, ids [B, k] int32). Floating x is cast to float32 as the
    reference's kernel does; 1 <= k <= 64; raises on any other device,
    dtype, shape or layout."""
    global LAUNCHES
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
    (b, n), dev = x.shape, x.device
    if n == 0:
        raise ValueError("topk: x has no columns")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _build.load("select_k", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_select_k(x.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                             dev.index or 0, b, n, k, warps_per_row(n), stream)
    raise_on(lib, "repro_select_k_error_string", err, "topk")
    LAUNCHES += 1
    return out_d, out_i
