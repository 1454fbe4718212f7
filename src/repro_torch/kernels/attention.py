"""Flash attention over flattened heads (the reference's
`flash_attention_pallas` and the mask of `models/layers.py`'s
`blockwise_attn`): the plain PyTorch version and the wrappers of its two
CUDA kernels.

    flash_attention: q [BH, T, hd], k, v [BKV, S, hd] -> out [BH, T, hd]

BH is a multiple of BKV and G = BH / BKV: query row bh reads KV row
bh // G (`blockwise_attn` flattens heads as b * H + kv * G + g, so
bh // G = b * KV + kv), and the KV heads are never repeated in memory.
float32 or bf16 in, q's dtype out. Scores are `q . k / sqrt(hd)` in
float32 (the reference casts q, k and v to float32). Query row t sits at
global position r = q_offset + t, key column c at local position c; key
c is live for row r when all of these hold (`_mask_block`):

- c < S;
- with `causal`: c <= r, or c < prefix_len;
- with window > 0: c > r - window (with or without `causal`).

The softmax runs online over key blocks, as the reference's: masked
scores are -1e30 and the final divide takes max(l, 1e-20); a row with no
live key returns 0, as `blockwise_attn`'s -inf guards give it. Key
blocks outside the live range of every row in a block of rows are never
visited; each such block adds exactly nothing there.

`flash_attention_ref` is the plain version: the CPU path and the
yardstick the kernels are compared with on the card (a float32 `bmm` per
block of 256 keys over [BKV, G * T] query rows; TF32 off).
`flash_attention_cuda` launches one of two CUDA kernels (built by
`_build.py`), chosen by shape:

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

`flash_attention_vjp` is the backward of `flash_attention` for training
(`ops.flash_attention_differentiable`, a `torch.autograd.Function` whose
forward is `ops.flash_attention`). It is plain PyTorch by design: the
TPU kernel has no backward (the reference differentiates its plain-jnp
`blockwise_attn` under `jax.checkpoint`, a query block at a time), and
a CUDA backward kernel is queued in ROADMAP.md. It recomputes one block
of `block_q` query rows at a time through `flash_attention_ref` in
float32, with the block's own `q_offset` so that its mask is the whole
sequence's, and takes `torch.autograd.grad` of that block: memory stays
O(block_q x S), as the reference's per-block rematerialization keeps it.
dk and dv are float32 sums over the blocks in block order; under grouped
KV heads each sums over its G query heads by the plain version's
[BKV, G * T] grouping, with nothing repeated in memory.
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
           "flash_attention_vjp", "live_keys", "takes_tensor_cores"]

# launches of each CUDA kernel since import (or since a caller reset them)
TC_LAUNCHES = 0                   # csrc/flash_attention_tc.cu
FMA_LAUNCHES = 0                  # csrc/flash_attention.cu

MAX_HEAD_DIM = 256
NEG_INF = -1e30                   # the reference's masked score
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_K = 256                    # keys a plain-version step takes


def _prefix(prefix_len) -> int:
    """prefix_len as the kernels take it: None is 0 (no key is below 0)."""
    return 0 if prefix_len is None else int(prefix_len)


def live_keys(r_lo: int, r_hi: int, s: int, *, causal: bool, window: int,
              prefix: int) -> tuple[int, int]:
    """[lo, hi], the key columns any row r_lo..r_hi (global positions) may
    see; empty when lo > hi. The kernels bound their key tiles by it, a
    block of rows at a time, and so does the plain version."""
    lo = max(0, r_lo - window + 1) if window > 0 else 0
    hi = min(s - 1, max(r_hi, prefix - 1)) if causal else s - 1
    return lo, hi


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        prefix_len=None, q_offset: int = 0):
    """Plain version of `flash_attention`: the reference's online softmax
    over 256-key blocks, every query row of a KV head at once, over the
    blocks in `live_keys` of all rows. A block outside a row's own live
    range adds exactly nothing there (p = 0 and corr = 1, or, before the
    row's first live key, a correction of exactly 0), so the result is
    the reference's, which visits every block."""
    bh, t, hd = q.shape
    bkv, s, _ = k.shape
    g = bh // bkv
    prefix, window, q_offset = _prefix(prefix_len), int(window), int(q_offset)
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(bkv, g * t, hd)         # row bkv * G + g, then t
    m = qf.new_full((bkv, g * t, 1), NEG_INF)
    l = qf.new_zeros((bkv, g * t, 1))
    acc = qf.new_zeros((bkv, g * t, v.shape[2]))
    row = q_offset + torch.arange(t, device=q.device).repeat(g)[:, None]
    lo, hi = live_keys(q_offset, q_offset + t - 1, s, causal=causal,
                       window=window, prefix=prefix)
    for k0 in range(lo - lo % _BLOCK_K, hi + 1, _BLOCK_K):
        kb, vb = k[:, k0:k0 + _BLOCK_K].float(), v[:, k0:k0 + _BLOCK_K].float()
        sc = torch.bmm(qf, kb.transpose(1, 2)) * scale
        col = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
        ok = None
        if causal:
            ok = col <= row
            if prefix > 0:
                ok = ok | (col < prefix)
        if window > 0:
            near = col > row - window
            ok = near if ok is None else ok & near
        if ok is not None:
            sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.bmm(p, vb)
        m = m_new
    out = torch.where(m == NEG_INF, 0.0, acc / l.clamp_min(1e-20))
    return out.reshape(bh, t, -1).to(q.dtype)


def flash_attention_vjp(q, k, v, dout, *, causal: bool = True,
                        window: int = 0, prefix_len=None, q_offset: int = 0,
                        block_q: int = 512):
    """(dq, dk, dv) of `flash_attention(q, k, v, ...)` against the
    cotangent dout [BH, T, hd_v], each in its input's dtype: the
    recompute the module's docstring describes, `block_q` query rows at
    a time."""
    t = q.shape[1]
    q_offset = int(q_offset)
    with torch.enable_grad():
        kf = k.detach().float().requires_grad_()
        vf = v.detach().float().requires_grad_()
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros_like(kf)
        dv = torch.zeros_like(vf)
        for t0 in range(0, t, block_q):
            qb = q[:, t0:t0 + block_q].detach().float().requires_grad_()
            out = flash_attention_ref(qb, kf, vf, causal=causal,
                                      window=window, prefix_len=prefix_len,
                                      q_offset=q_offset + t0)
            if not out.requires_grad:         # no row of the block sees a key
                dq[:, t0:t0 + block_q] = 0.0
                continue
            gq, gk, gv = torch.autograd.grad(
                out, (qb, kf, vf), dout[:, t0:t0 + block_q].float(),
                allow_unused=True, materialize_grads=True)
            dq[:, t0:t0 + block_q] = gq
            dk += gk
            dv += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FMA_SIGNATURES = {
    "repro_flash_attention": (ctypes.c_int, [_P] * 4 + [_I] * 11 +
                              [ctypes.c_float, _I, _P]),
    "repro_flash_attention_error_string": (ctypes.c_char_p, [_I]),
}
_TC_SIGNATURES = {
    "repro_flash_attention_tc": (ctypes.c_int, [_P] * 4 + [_I] * 10 +
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


def _operands(q, k, v, window, prefix_len, q_offset):
    """(BH, BKV, T, S, hd, mask ints, device index, stream) of checked
    operands: q [BH, T, hd], k and v [BKV, S, hd] with BKV dividing BH,
    contiguous, on one CUDA device, all float32 or all bf16, hd <= 256,
    window, prefix_len and q_offset >= 0; raises on anything else."""
    if not all(t.device.type == "cuda" for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or \
            k.shape[0] == 0 or q.shape[0] % k.shape[0] or \
            k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q [BH, T, hd], k and v [BKV, S, "
                         f"hd] with BKV dividing BH; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k and v on different devices")
    bh, t, hd = q.shape
    bkv, s = k.shape[0], k.shape[1]
    if not 0 < hd <= MAX_HEAD_DIM or s == 0:
        raise ValueError(f"flash_attention: hd={hd}, S={s}; the kernel takes "
                         f"1 <= hd <= {MAX_HEAD_DIM} and S >= 1")
    mask = (int(window), _prefix(prefix_len), int(q_offset))
    if min(mask) < 0 or max(mask) + t >= 2 ** 31:
        raise ValueError(f"flash_attention: window, prefix_len and q_offset "
                         f"must be >= 0 and fit an int; got {mask}")
    dev = q.device
    return (bh, bkv, t, s, hd, mask, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)


def flash_attention_tc_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                            prefix_len=None, q_offset: int = 0):
    """Launch `csrc/flash_attention_tc.cu` (bf16 on the tensor cores) on
    the current stream: out [BH, T, hd] bf16. Raises on operands
    `takes_tensor_cores` refuses, as `_operands` does, and if the launch
    fails."""
    bh, bkv, t, s, hd, mask, index, stream = _operands(
        q, k, v, window, prefix_len, q_offset)
    if not takes_tensor_cores(q, k, v):
        raise ValueError(f"flash_attention: the tensor-core kernel takes bf16 "
                         f"with hd % 8 == 0 and 16-byte aligned bases; got "
                         f"{q.dtype}, hd={hd}")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention_tc", _TC_SIGNATURES)
    err = lib.repro_flash_attention_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), index, bh,
        bkv, t, s, hd, int(causal), *mask,
        as_f32(math.log2(math.e) / math.sqrt(hd)), stream)
    raise_on(lib, "repro_flash_attention_tc_error_string", err,
             "flash_attention (tensor cores)")
    _build.count_launch(__name__, "TC_LAUNCHES")
    return out


def flash_attention_fma_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                             prefix_len=None, q_offset: int = 0):
    """Launch `csrc/flash_attention.cu` (FP32 FMAs, any operands
    `_operands` accepts) on the current stream: out [BH, T, hd] in q's
    dtype. Raises if the launch fails."""
    bh, bkv, t, s, hd, mask, index, stream = _operands(
        q, k, v, window, prefix_len, q_offset)
    out = torch.empty_like(q)
    vec = int(hd * q.element_size() % 16 == 0
              and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    lib = _build.load("flash_attention", _FMA_SIGNATURES)
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), index, bh,
        bkv, t, s, hd, _DTYPES[q.dtype], int(causal), *mask,
        as_f32(1.0 / math.sqrt(hd)), vec, stream)
    raise_on(lib, "repro_flash_attention_error_string", err,
             "flash_attention (FP32 FMA)")
    _build.count_launch(__name__, "FMA_LAUNCHES")
    return out


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         prefix_len=None, q_offset: int = 0):
    """out [BH, T, hd] in q's dtype from one of the two CUDA kernels,
    chosen by shape: `flash_attention_tc_cuda` where `takes_tensor_cores`
    holds, else `flash_attention_fma_cuda`. Raises as they do."""
    fn = (flash_attention_tc_cuda if takes_tensor_cores(q, k, v)
          else flash_attention_fma_cuda)
    return fn(q, k, v, causal=causal, window=window, prefix_len=prefix_len,
              q_offset=q_offset)
