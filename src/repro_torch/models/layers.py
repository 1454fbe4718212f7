"""Attention and MLP building blocks of the LM substrate: the parts the
MLA prefill / decode path runs (the reference's `models/layers.py`).

Parameters live in `Params` modules whose parameter names are the
reference's dict keys (`p["wq"]` reads one), built on a device in one
dtype and drawn from an explicit `torch.Generator` at the reference's
scales. The apply functions are plain functions of (module, tensors).

Attention comes in two execution paths here:
  * blockwise (flash-style) attention for prefill through
    `kernels.ops.flash_attention`: the hand-written kernel on a CUDA
    tensor, its plain version on a CPU tensor;
  * MLA (DeepSeek-V2) with the compressed (c_kv, k_rope) cache and the
    absorbed decode (w_uk / w_uv folded into the query and output
    projections), plain torch as the reference's is plain jnp.

The GQA layer (`attn_*`), its sliding-window ring buffer and the int8 KV
cache (`quant_kv`) are not on this path: they raise NotImplementedError
(ROADMAP.md Queue 1).
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
    "attn_cache_init", "attn_init", "blockwise_attn", "mla_apply",
    "mla_cache_init", "mla_init", "mlp_apply", "mlp_init", "quant_kv",
    "rms_norm",
]

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}

_QUEUED = "is not ported yet (ROADMAP.md Queue 1)"


class Params(nn.Module):
    """A module whose parameters and children carry the reference's dict
    keys: `p["wq"]` reads one, `"ffn" in p` tests one. Parameters are
    built uninitialised (`torch.empty`) and frozen (serving needs no
    gradients); `draw_` fills them from a generator."""

    def __init__(self):
        super().__init__()
        self._std: dict[str, float | None] = {}

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def add(self, name: str, shape, std: float | None, *, dtype, device):
        """Register parameter `name`; `std` is its normal draw's scale, or
        None for a norm scale of ones."""
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self._std[name] = std

    def draw_(self, generator: torch.Generator):
        """Draw every parameter, children first in registration order:
        N(0, std^2) in the parameter's dtype, or ones."""
        for child in self.children():
            child.draw_(generator)
        for name, std in self._std.items():
            p = self._parameters[name]
            if std is None:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
        return self


class Children(Params):
    """Children named "0", "1", ... (the reference's `{str(i): ...}`)."""

    def __init__(self, modules):
        super().__init__()
        for i, m in enumerate(modules):
            self.add_module(str(i), m)


def rms_norm(x, scale, eps: float = 1e-5):
    """x * rsqrt(mean(x^2) + eps) * scale in float32, cast back to x's
    dtype."""
    xf = x.float()
    xh = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xh * scale.float()).to(x.dtype)


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
                   prefix_len=None, q_offset=0):
    """Softmax attention of q [B, T, H, hd] over k, v [B, S, KV, hd] ->
    [B, T, H, hd] in q's dtype, through `ops.flash_attention` over
    [B * H, T, hd]: the kernel on CUDA tensors, its plain version on CPU
    tensors. Both compute a causal or full mask from position 0 with as
    many KV heads as heads (true of MLA); windows, prefixes, offsets and
    grouped heads raise on every device. The reference's `block_q`,
    `block_k` and `skip_masked_blocks` change no result and are not
    taken: the kernel fixes its own blocks and skips future ones."""
    B, T, H, hd = q.shape
    if (window and window > 0) or prefix_len is not None or \
            int(q_offset) != 0 or k.shape[2] != H:
        raise NotImplementedError(
            "blockwise_attn takes a causal or full mask from position 0 with "
            "KV heads == heads; windows, prefixes, offsets and grouped heads "
            "are queued in ROADMAP.md Queue 1")
    heads = [t.transpose(1, 2).reshape(B * H, -1, hd).contiguous()
             for t in (q, k, v)]
    out = ops.flash_attention(*heads, causal=causal)
    return out.reshape(B, H, T, hd).transpose(1, 2)


# ---------------------------------------------------------------------------
# GQA attention and the int8 KV cache: not on the MLA path
# ---------------------------------------------------------------------------


def attn_init(*args, **kwargs):
    raise NotImplementedError(f"the GQA attention layer {_QUEUED}")


def attn_apply(*args, **kwargs):
    raise NotImplementedError(f"the GQA attention layer (with its "
                              f"sliding-window ring buffer) {_QUEUED}")


def attn_cache_init(*args, **kwargs):
    raise NotImplementedError(f"the GQA KV cache {_QUEUED}")


def quant_kv(*args, **kwargs):
    raise NotImplementedError(f"the int8 KV cache (kv_quant) {_QUEUED}")


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
              rope_theta: float = 1e4):
    """MLA attention of x [B, T, d] -> (y [B, T, d], cache). The cache
    {"c": [B, S, kv_lora], "kr": [B, S, qk_rope]} stores only the
    compressed latent and the shared rope key; it is written in place at
    `pos` and returned (prefill with a cache, and decode)."""
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

    # prefill: materialise per-head k, v; v padded to the qk width so the
    # flash kernel applies, then sliced
    k_nope = torch.einsum("btl,lhn->bthn", c_kv, p["w_uk"])
    v = torch.einsum("btl,lhv->bthv", c_kv, p["w_uv"])
    k_full = torch.cat([k_nope, k_rope.expand(B, T, H, rope_d)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    vd = mla.v_dim
    v_pad = F.pad(v, (0, scale_dim - vd))
    out = blockwise_attn(q_full, k_full, v_pad, causal=True,
                         q_offset=pos)[..., :vd]
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
