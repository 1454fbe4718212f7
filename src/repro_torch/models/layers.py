"""Attention and MLP building blocks of the LM substrate (the
reference's `models/layers.py`).

Parameters live in `Params` modules whose parameter names are the
reference's dict keys (`p["wq"]` reads one), built on a device in one
dtype and drawn from an explicit `torch.Generator` at the reference's
scales. The apply functions are plain functions of (module, tensors).

Attention comes in three execution paths, as in the reference:
  * blockwise (flash-style) attention for prefill and training through
    `kernels.ops.flash_attention`, with the reference's whole mask
    (causal, sliding window, bidirectional prefix, query offset) and
    grouped KV heads: the hand-written kernel on a CUDA tensor, its plain
    version on a CPU tensor (in training, with a plain recompute as its
    backward);
  * single-token decode against a KV cache (`_decode_attn`): a full
    cache, a ring buffer for a sliding window, or an int8 cache
    (`quant_kv`) without one; plain torch, as the reference's is plain
    jnp;
  * MLA (DeepSeek-V2) with the compressed (c_kv, k_rope) cache and the
    absorbed decode (w_uk / w_uv folded into the query and output
    projections), plain torch as the reference's is plain jnp.

Caches are written in place through the views the stack hands in.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

__all__ = [
    "ACTS", "MLAConfig", "Params", "apply_rope", "attn_apply",
    "attn_cache_init", "attn_init", "blockwise_attn", "dequant_kv",
    "mla_apply", "mla_cache_init", "mla_init", "mlp_apply", "mlp_init",
    "quant_kv", "rms_norm",
]

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}

class Params(nn.Module):
    """A module whose parameters and children carry the reference's dict
    keys: `p["wq"]` reads one, `"ffn" in p` tests one. Parameters are
    built uninitialised (`torch.empty`) and frozen (serving needs no
    gradients; `models.model.make_train_state` turns requires_grad on);
    `draw_` fills them from a generator."""

    def __init__(self):
        super().__init__()
        self._init: dict[str, tuple] = {}

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def add(self, name: str, shape, std: float | None, *, dtype, device,
            mean: float = 0.0, fill=1.0):
        """Register parameter `name`, drawn N(mean, std^2); or, with `std`
        None, a constant: `fill`, a number (default ones, a norm scale) or
        a float32 tensor broadcast to the shape and cast to the dtype."""
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self._init[name] = (std, mean, fill)

    def draw_(self, generator: torch.Generator):
        """Draw every parameter, children first in registration order:
        N(mean, std^2) in the parameter's dtype, or its constant."""
        for child in self.children():
            child.draw_(generator)
        for name, (std, mean, fill) in self._init.items():
            p = self._parameters[name]
            if std is not None:
                p.normal_(mean, std, generator=generator)
            elif torch.is_tensor(fill):
                p.copy_(fill)
            else:
                p.fill_(fill)
        return self


class Children(Params):
    """Children named "0", "1", ... (the reference's `{str(i): ...}`)."""

    def __init__(self, modules):
        super().__init__()
        for i, m in enumerate(modules):
            self.add_module(str(i), m)


class _RMSNorm(torch.autograd.Function):
    """rms_norm with the reference's hand-written backward
    (`_rms_bwd`): rms recomputed rather than saved, dx = r (g - x^
    mean(x^ g)) with g = dy * scale in float32, dscale summed in
    float32."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        xf = x.float()
        xh = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (xh * scale.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        xf = x.float()
        r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + ctx.eps)
        xh = xf * r
        g = dy.float() * scale.float()
        proj = (xh * g).mean(-1, keepdim=True)
        dx = (r * (g - xh * proj)).to(x.dtype)
        dscale = (dy.float() * xh).sum(dim=tuple(range(dy.dim() - 1)))
        return dx, dscale.to(scale.dtype), None


def rms_norm(x, scale, eps: float = 1e-5):
    """x * rsqrt(mean(x^2) + eps) * scale in float32, cast back to x's
    dtype; differentiable through the reference's own backward."""
    return _RMSNorm.apply(x, scale, eps)


def _rope_angles(positions, dim: int, theta: float):
    """positions [..., T] -> (cos, sin) [..., T, dim / 2] float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float = 1e4):
    """Rotate the halves (x[..., :half], x[..., half:]) of x [B, T, H, hd]
    by the positions' angles (the reference's half-split rotation)."""
    half = x.shape[-1] // 2
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    cos, sin = cos[..., :, None, :], sin[..., :, None, :]   # head axis
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention: the flash kernel on the card, its plain version here
# ---------------------------------------------------------------------------


def blockwise_attn(q, k, v, *, causal: bool = True, window: int = 0,
                   prefix_len=None, q_offset=0, block_q: int = 512):
    """Softmax attention of q [B, T, H, hd] over k, v [B, S, KV, hd] ->
    [B, T, H, hd] in q's dtype, through `ops.flash_attention` over
    [B * H, T, hd] queries and [B * KV, S, hd] keys and values (query
    head h = kv * G + g reads KV head kv, the reference's [B, T, KV, G,
    hd] grouping; nothing is repeated): the kernel on CUDA tensors, its
    plain version on CPU tensors. The mask is the reference's
    `_mask_block`: queries at positions q_offset.., keys at 0..S-1,
    causal with an optional bidirectional prefix (`prefix_len`, an int or
    a 0-d tensor, read once), an optional sliding window; a query with no
    live key gives 0. The reference's `block_k` and `skip_masked_blocks`
    change no result and are not taken: the kernel fixes its own blocks
    and skips the dead ones.

    Where autograd records (grad enabled and an input requiring grad,
    training) the call goes through `ops.flash_attention_differentiable`,
    the same forward with a backward that recomputes `block_q` query rows
    at a time, the reference's per-block rematerialization; everywhere
    else (serving) straight to `ops.flash_attention`."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qh = q.transpose(1, 2).reshape(B * H, T, hd).contiguous()
    kh, vh = (t.transpose(1, 2).reshape(B * KV, S, hd).contiguous()
              for t in (k, v))
    mask = {"causal": causal, "window": int(window or 0),
            "prefix_len": None if prefix_len is None else int(prefix_len),
            "q_offset": int(q_offset)}
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = ops.flash_attention_differentiable(qh, kh, vh, **mask,
                                                 block_q=block_q)
    else:
        out = ops.flash_attention(qh, kh, vh, **mask)
    return out.reshape(B, H, T, hd).transpose(1, 2)


def _decode_attn(q, k, v, *, s_valid: int):
    """Single-token attention against the whole cache, keys >= s_valid
    masked (the reference's `_decode_attn`). q [B, 1, H, hd], k, v
    [B, S, KV, hd]."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qf = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bKgh,bsKh->bKgs", qf, k.float()) * (1.0 / math.sqrt(hd))
    ok = torch.arange(k.shape[1], device=q.device) < s_valid
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    out = torch.einsum("bKgs,bsKh->bKgh", p, v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (a scale per token and head)
# ---------------------------------------------------------------------------


def quant_kv(x):
    """[..., hd] -> (int8 values, bf16 scale [..., 1]): the reference's
    float32 max-abs scale over 127, values rounded half to even."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequant_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# GQA attention (full / sliding-window, optional qk_norm)
# ---------------------------------------------------------------------------


def attn_init(d_model: int, n_heads: int, n_kv: int, head_dim: int,
              qk_norm: bool = False, *, dtype=torch.float32,
              device=None) -> Params:
    p = Params()
    s = 1.0 / math.sqrt(d_model)
    kw = {"dtype": dtype, "device": device}
    p.add("wq", (d_model, n_heads, head_dim), s, **kw)
    p.add("wk", (d_model, n_kv, head_dim), s, **kw)
    p.add("wv", (d_model, n_kv, head_dim), s, **kw)
    p.add("wo", (n_heads, head_dim, d_model),
          1.0 / math.sqrt(n_heads * head_dim), **kw)
    if qk_norm:
        p.add("q_norm", (head_dim,), None, **kw)
        p.add("k_norm", (head_dim,), None, **kw)
    return p


def attn_apply(p, x, *, mode: str, cache=None, pos=0, window: int = 0,
               prefix_len=None, rope_theta: float = 1e4,
               block_q: int = 512):
    """GQA attention of x [B, T, d] -> (y [B, T, d], cache). The cache is
    {"k", "v": [B, S, KV, hd]}: every position (S = s_max), a ring buffer
    of the last S = min(window, s_max) positions at slot position % S, or
    int8 values with {"ks", "vs": bf16 [B, S, KV, 1]} scales (no window);
    it is written in place (prefill with a cache, and decode) and
    returned. mode "train" runs as prefill with no cache; `block_q` is
    the query block of attention's backward."""
    B, T, _ = x.shape
    pos = int(pos)
    window = int(window or 0)
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    positions = pos + torch.arange(T, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if mode == "decode":
        S = cache["k"].shape[1]
        if window > 0:                                 # ring-buffer write
            _write_kv(cache, k, v, pos % S)
            s_valid = min(pos + 1, S)
        else:
            _write_kv(cache, k, v, pos)
            s_valid = pos + 1
        k_all, v_all = cache["k"], cache["v"]
        if "ks" in cache:                              # int8 cache
            with torch.profiler.record_function("attn.dequant_kv"):
                k_all = dequant_kv(cache["k"], cache["ks"], k.dtype)
                v_all = dequant_kv(cache["v"], cache["vs"], v.dtype)
        with torch.profiler.record_function("attn.decode_attention"):
            out = _decode_attn(q, k_all, v_all, s_valid=s_valid)
    else:
        out = blockwise_attn(q, k, v, causal=True, window=window,
                             prefix_len=prefix_len, q_offset=pos,
                             block_q=block_q)
        if mode == "prefill" and cache is not None:
            S = cache["k"].shape[1]
            if window > 0:
                # the last min(S, T) positions, at slot position % S
                n = min(S, T)
                slots = (pos + T - n + torch.arange(n, device=x.device)) % S
                for name, new in (("k", k), ("v", v)):
                    cache[name][:, slots] = new[:, T - n:].to(
                        cache[name].dtype)
            else:
                _write_kv(cache, k, v, pos)
    y = torch.einsum("bthk,hkd->btd", out, p["wo"])
    return y, cache


def _write_kv(cache, k, v, pos: int):
    """k, v [B, T, KV, hd] into the cache at positions pos.. in place: as
    they are, or as int8 values and bf16 scales where the cache has
    them."""
    for name, new in (("k", k), ("v", v)):
        if "ks" in cache:
            new, scale = quant_kv(new)
            _write_cache(cache[name + "s"], scale, pos)
        _write_cache(cache[name], new, pos)


def attn_cache_init(batch: int, s_max: int, n_kv: int, head_dim: int,
                    window: int = 0, *, dtype=torch.float32, quant=False,
                    device=None) -> dict:
    """A full cache of s_max positions, a ring buffer of min(window,
    s_max) with a window, or (quant, no window) int8 values with bf16
    scales."""
    S = min(window, s_max) if window and window > 0 else s_max
    shape = (batch, S, n_kv, head_dim)
    if quant and not (window and window > 0):
        scales = (batch, S, n_kv, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(scales, dtype=torch.bfloat16, device=device),
                "vs": torch.zeros(scales, dtype=torch.bfloat16,
                                  device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV cache + absorbed decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


def mla_init(d_model: int, n_heads: int, mla: MLAConfig, *,
             dtype=torch.float32, device=None) -> Params:
    p = Params()
    s = 1.0 / math.sqrt(d_model)
    qd = mla.qk_nope + mla.qk_rope
    kw = {"dtype": dtype, "device": device}
    p.add("wq", (d_model, n_heads, qd), s, **kw)
    p.add("w_dkv", (d_model, mla.kv_lora + mla.qk_rope), s, **kw)
    p.add("kv_norm", (mla.kv_lora,), None, **kw)
    p.add("w_uk", (mla.kv_lora, n_heads, mla.qk_nope),
          1.0 / math.sqrt(mla.kv_lora), **kw)
    p.add("w_uv", (mla.kv_lora, n_heads, mla.v_dim),
          1.0 / math.sqrt(mla.kv_lora), **kw)
    p.add("wo", (n_heads, mla.v_dim, d_model),
          1.0 / math.sqrt(n_heads * mla.v_dim), **kw)
    return p


def _write_cache(buf, new, pos: int):
    """buf[:, pos:pos+T] = new in place (jax's dynamic_update_slice would
    clamp an out-of-range start; here it is an error)."""
    T, s_max = new.shape[1], buf.shape[1]
    if not 0 <= pos <= s_max - T:
        raise ValueError(f"cache write of {T} positions at {pos} overruns "
                         f"its {s_max} positions")
    buf[:, pos:pos + T] = new


def mla_apply(p, x, *, mode: str, cache=None, pos=0, mla: MLAConfig,
              rope_theta: float = 1e4, block_q: int = 512):
    """MLA attention of x [B, T, d] -> (y [B, T, d], cache). The cache
    {"c": [B, S, kv_lora], "kr": [B, S, qk_rope]} stores only the
    compressed latent and the shared rope key; it is written in place at
    `pos` and returned (prefill with a cache, and decode). mode "train"
    runs as prefill with no cache; `block_q` is the query block of
    attention's backward."""
    B, T, _ = x.shape
    H = p["wq"].shape[1]
    nope, rope_d, lora = mla.qk_nope, mla.qk_rope, mla.kv_lora
    scale_dim = nope + rope_d
    pos = int(pos)

    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = torch.einsum("btd,dk->btk", x, p["w_dkv"])
    c_kv = rms_norm(dkv[..., :lora], p["kv_norm"])
    k_rope = dkv[..., lora:][:, :, None, :]            # single shared head
    positions = pos + torch.arange(T, device=x.device)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    k_rope = apply_rope(k_rope, positions, rope_theta)

    if mode == "decode":
        # absorbed path: q_eff = q_nope @ w_uk, scored against cached c_kv.
        # The reference masks keys >= pos + 1 for every query row, also
        # when T > 1, so only keys [0, pos] are read
        _write_cache(cache["c"], c_kv, pos)
        _write_cache(cache["kr"], k_rope[:, :, 0, :], pos)
        with torch.profiler.record_function("mla.decode_attention"):
            c_all = cache["c"][:, :pos + 1].float()
            kr_all = cache["kr"][:, :pos + 1].float()
            q_eff = torch.einsum("bthn,lhn->bthl", q_nope, p["w_uk"])
            s = (torch.einsum("bthl,bsl->bhts", q_eff.float(), c_all)
                 + torch.einsum("bthr,bsr->bhts", q_rope.float(), kr_all)
                 ) / math.sqrt(scale_dim)
            pa = torch.softmax(s, dim=-1)
            out_c = torch.einsum("bhts,bsl->bthl", pa, c_all)
            out = torch.einsum("bthl,lhv->bthv", out_c, p["w_uv"].float())
        y = torch.einsum("bthv,hvd->btd", out.to(x.dtype), p["wo"])
        return y, cache

    # train / prefill: materialise per-head k, v; v padded to the qk width
    # so the flash kernel applies, then sliced
    k_nope = torch.einsum("btl,lhn->bthn", c_kv, p["w_uk"])
    v = torch.einsum("btl,lhv->bthv", c_kv, p["w_uv"])
    k_full = torch.cat([k_nope, k_rope.expand(B, T, H, rope_d)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    vd = mla.v_dim
    v_pad = F.pad(v, (0, scale_dim - vd))
    out = blockwise_attn(q_full, k_full, v_pad, causal=True,
                         q_offset=pos, block_q=block_q)[..., :vd]
    y = torch.einsum("bthv,hvd->btd", out, p["wo"])
    if mode == "prefill" and cache is not None:
        _write_cache(cache["c"], c_kv, pos)
        _write_cache(cache["kr"], k_rope[:, :, 0, :], pos)
        return y, cache
    return y, None


def mla_cache_init(batch: int, s_max: int, mla: MLAConfig, *,
                   dtype=torch.float32, device=None) -> dict:
    return {
        "c": torch.zeros((batch, s_max, mla.kv_lora), dtype=dtype,
                         device=device),
        "kr": torch.zeros((batch, s_max, mla.qk_rope), dtype=dtype,
                          device=device),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(d_model: int, d_ff: int, kind: str = "glu", *,
             dtype=torch.float32, device=None) -> Params:
    p = Params()
    s = 1.0 / math.sqrt(d_model)
    kw = {"dtype": dtype, "device": device}
    shape = (d_model, 2, d_ff) if kind == "glu" else (d_model, d_ff)
    p.add("w_in", shape, s, **kw)
    p.add("w_out", (d_ff, d_model), 1.0 / math.sqrt(d_ff), **kw)
    return p


def mlp_apply(p, x, act: str = "silu"):
    f = ACTS[act]
    if p["w_in"].dim() == 3:                           # gated
        h = torch.einsum("btd,dgf->btgf", x, p["w_in"])
        h = f(h[:, :, 0]) * h[:, :, 1]
    else:
        h = f(torch.einsum("btd,df->btf", x, p["w_in"]))
    return torch.einsum("btf,fd->btd", h, p["w_out"])
