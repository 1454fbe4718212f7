"""Flash attention over flattened heads (the reference's
`flash_attention_pallas`, the Pallas twin of `models/layers.py`'s
`blockwise_attn`): the plain PyTorch version and the wrappers of its two
CUDA kernels.

    flash_attention: q [BH, T, hd], k, v [BH, S, hd] -> out [BH, T, hd]

float32 or bf16 in, q's dtype out. Scores are `q . k / sqrt(hd)` in
float32 (the reference casts q, k and v to float32); keys s >= S are
masked, and with `causal` keys s > t too (queries and keys both start at
position 0). The softmax runs online over key blocks, as the reference's:
masked scores are -1e30 and the final divide takes max(l, 1e-20), where
`blockwise_attn` uses -inf guards. The two agree on every row that has a
valid key, and a causal prefill has no other kind.

`flash_attention_ref` is the plain version: the CPU path and the
yardstick the kernels are compared with on the card (a float32 `bmm` per
block of 256 keys; TF32 off). `flash_attention_cuda` launches one of two
CUDA kernels (built by `_build.py`), chosen by shape:

- `csrc/flash_attention_tc.cu`, bf16 on the tensor cores (wgmma, TMA),
  for bf16 operands with hd a multiple of 8 and 16-byte aligned bases
  (`takes_tensor_cores`): TMA addresses rows in 16-byte steps.
  `flash_attention_tc_cuda` launches it and counts in `TC_LAUNCHES`.
- `csrc/flash_attention.cu`, FP32 FMAs, for float32 (whose 1e-5 gate no
  bf16 product meets) and the bf16 shapes above it refuses: hd not a
  multiple of 8, or an unaligned base. `flash_attention_fma_cuda`
  launches it and counts in `FMA_LAUNCHES`.

This is a choice by shape, not a fallback: a failed build or launch of
either raises. `ops.flash_attention` picks the plain version or
`flash_attention_cuda` by the tensors' device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2dist import as_f32, raise_on

__all__ = ["FMA_LAUNCHES", "MAX_HEAD_DIM", "NEG_INF", "TC_LAUNCHES",
           "flash_attention_ref", "flash_attention_cuda",
           "flash_attention_fma_cuda", "flash_attention_tc_cuda",
           "takes_tensor_cores"]

# launches of each CUDA kernel since import (or since a caller reset them)
TC_LAUNCHES = 0                   # csrc/flash_attention_tc.cu
FMA_LAUNCHES = 0                  # csrc/flash_attention.cu

MAX_HEAD_DIM = 256
NEG_INF = -1e30                   # the reference's masked score
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_K = 256                    # keys a plain-version step takes


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain version of `flash_attention`: the reference's online softmax
    over 256-key blocks, every query row at once. Blocks wholly in a
    row's causal future add exactly nothing there (p = 0, corr = 1), so
    the result is the reference's, which skips them."""
    bh, t, hd = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    m = qf.new_full((bh, t, 1), NEG_INF)
    l = qf.new_zeros((bh, t, 1))
    acc = qf.new_zeros((bh, t, v.shape[2]))
    row = torch.arange(t, device=q.device)[:, None]
    for k0 in range(0, min(s, t) if causal else s, _BLOCK_K):
        kb, vb = k[:, k0:k0 + _BLOCK_K].float(), v[:, k0:k0 + _BLOCK_K].float()
        sc = torch.bmm(qf, kb.transpose(1, 2)) * scale
        if causal:
            col = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            sc = torch.where(col <= row, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.bmm(p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-20)).to(q.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FMA_SIGNATURES = {
    "repro_flash_attention": (ctypes.c_int, [_P] * 4 + [_I] * 7 +
                              [ctypes.c_float, _I, _P]),
    "repro_flash_attention_error_string": (ctypes.c_char_p, [_I]),
}
_TC_SIGNATURES = {
    "repro_flash_attention_tc": (ctypes.c_int, [_P] * 4 + [_I] * 6 +
                                 [ctypes.c_float, _P]),
    "repro_flash_attention_tc_error_string": (ctypes.c_char_p, [_I]),
}


def takes_tensor_cores(q, k, v) -> bool:
    """Whether `flash_attention_cuda` gives these operands to the
    tensor-core kernel: bf16, hd a multiple of 8 (a TMA row pitch is a
    multiple of 16 bytes) and every base 16-byte aligned (TMA's rule).
    Everything else goes to the FP32-FMA kernel."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0
            and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))


def _operands(q, k, v):
    """(BH, T, S, hd, device index, stream) of checked operands: q, k and
    v contiguous, on one CUDA device, all float32 or all bf16, hd <= 256;
    raises on anything else."""
    if not all(t.device.type == "cuda" for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q [BH, T, hd], k and v [BH, S, "
                         f"hd]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k and v on different devices")
    bh, t, hd = q.shape
    s = k.shape[1]
    if not 0 < hd <= MAX_HEAD_DIM or s == 0:
        raise ValueError(f"flash_attention: hd={hd}, S={s}; the kernel takes "
                         f"1 <= hd <= {MAX_HEAD_DIM} and S >= 1")
    dev = q.device
    return (bh, t, s, hd, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)


def flash_attention_tc_cuda(q, k, v, *, causal: bool = True):
    """Launch `csrc/flash_attention_tc.cu` (bf16 on the tensor cores) on
    the current stream: out [BH, T, hd] bf16. Raises on operands
    `takes_tensor_cores` refuses, as `_operands` does, and if the launch
    fails."""
    bh, t, s, hd, index, stream = _operands(q, k, v)
    if not takes_tensor_cores(q, k, v):
        raise ValueError(f"flash_attention: the tensor-core kernel takes bf16 "
                         f"with hd % 8 == 0 and 16-byte aligned bases; got "
                         f"{q.dtype}, hd={hd}")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention_tc", _TC_SIGNATURES)
    err = lib.repro_flash_attention_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), index, bh,
        t, s, hd, int(causal), as_f32(math.log2(math.e) / math.sqrt(hd)),
        stream)
    raise_on(lib, "repro_flash_attention_tc_error_string", err,
             "flash_attention (tensor cores)")
    _build.count_launch(__name__, "TC_LAUNCHES")
    return out


def flash_attention_fma_cuda(q, k, v, *, causal: bool = True):
    """Launch `csrc/flash_attention.cu` (FP32 FMAs, any operands
    `_operands` accepts) on the current stream: out [BH, T, hd] in q's
    dtype. Raises if the launch fails."""
    bh, t, s, hd, index, stream = _operands(q, k, v)
    out = torch.empty_like(q)
    vec = int(hd * q.element_size() % 16 == 0
              and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    lib = _build.load("flash_attention", _FMA_SIGNATURES)
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), index, bh,
        t, s, hd, _DTYPES[q.dtype], int(causal), as_f32(1.0 / math.sqrt(hd)),
        vec, stream)
    raise_on(lib, "repro_flash_attention_error_string", err,
             "flash_attention (FP32 FMA)")
    _build.count_launch(__name__, "FMA_LAUNCHES")
    return out


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """out [BH, T, hd] in q's dtype from one of the two CUDA kernels,
    chosen by shape: `flash_attention_tc_cuda` where `takes_tensor_cores`
    holds, else `flash_attention_fma_cuda`. Raises as they do."""
    if takes_tensor_cores(q, k, v):
        return flash_attention_tc_cuda(q, k, v, causal=causal)
    return flash_attention_fma_cuda(q, k, v, causal=causal)
