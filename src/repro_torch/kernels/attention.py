"""Flash attention over flattened heads (the reference's
`flash_attention_pallas`, the Pallas twin of `models/layers.py`'s
`blockwise_attn`): the plain PyTorch version and the wrapper of its CUDA
kernel.

    flash_attention: q [BH, T, hd], k, v [BH, S, hd] -> out [BH, T, hd]

float32 or bf16 in, q's dtype out. Scores are `q . k / sqrt(hd)` in
float32 (the reference casts q, k and v to float32); keys s >= S are
masked, and with `causal` keys s > t too (queries and keys both start at
position 0). The softmax runs online over key blocks, as the reference's:
masked scores are -1e30 and the final divide takes max(l, 1e-20), where
`blockwise_attn` uses -inf guards. The two agree on every row that has a
valid key, and a causal prefill has no other kind.

`flash_attention_ref` is the plain version: the CPU path and the
yardstick the kernel is compared with on the card (a float32 `bmm` per
block of 256 keys; TF32 off). `flash_attention_cuda` launches
`csrc/flash_attention.cu` (built by `_build.py`) and counts its launches
in `LAUNCHES`. `ops.flash_attention` picks one by the tensors' device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2dist import as_f32, raise_on

__all__ = ["LAUNCHES", "MAX_HEAD_DIM", "NEG_INF", "flash_attention_ref",
           "flash_attention_cuda"]

# launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

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
_SIGNATURES = {
    "repro_flash_attention": (ctypes.c_int, [_P] * 4 + [_I] * 7 +
                              [ctypes.c_float, _I, _P]),
    "repro_flash_attention_error_string": (ctypes.c_char_p, [_I]),
}


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """Launch `csrc/flash_attention.cu` on the current stream: out
    [BH, T, hd] in q's dtype. q, k and v contiguous, on one CUDA device,
    all float32 or all bf16, hd <= 256; raises on anything else."""
    global LAUNCHES
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
    out = torch.empty_like(q)
    vec = int(hd * q.element_size() % 16 == 0
              and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    dev = q.device
    lib = _build.load("flash_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dev.index or 0, bh, t, s, hd, _DTYPES[q.dtype], int(causal),
        as_f32(1.0 / math.sqrt(hd)), vec, stream)
    raise_on(lib, "repro_flash_attention_error_string", err,
             "flash_attention")
    LAUNCHES += 1
    return out
