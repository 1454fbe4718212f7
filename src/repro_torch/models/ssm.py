"""Recurrent blocks (the reference's `models/ssm.py`): Mamba-1 (Jamba's
sequence mixer), and xLSTM's mLSTM and sLSTM.

All three keep the attention layers' contract: apply(p, x, mode, cache,
pos) -> (y, cache), `pos` unused (a recurrent state has no positions, as
in the reference). With a cache, prefill and decode both write the final
state into the views the stack hands in, in place: the conv state (the
last d_conv - 1 rows of the zero-padded pre-conv input) and the scan's
float32 state.

The reference scans time with `lax.scan` under `chunked_scan`, whose
chunks matter only for train-time rematerialization. Here the scan is a
Python loop over time of torch ops on the tensors' device, with the
reference's arithmetic step for step. In mode "train" every layer scans
with the reference's own step function (out of place, so autograd can
differentiate it) under `chunked_scan(..., chunk)`, which runs each
chunk of `chunk` steps under one `torch.utils.checkpoint`: backward keeps
the state at the chunks' boundaries and recomputes the rest, so memory
grows as T / chunk states, not T, and the gradients are bitwise those of
the scan without chunks. Prefill and decode keep the blocked in-place
form below. The terms of a step that do not
read the state (Mamba's exp(dt A) and dt B x and its read-out h C;
mLSTM's stabilizer m, its gates i_p, f_p, i_p v k^T and i_p k, and its
read-out C q / denom) are computed for a block of SCAN_BLOCK steps in one
op each, so a step launches only the state's multiply and add, written
in place into the block's buffer of states. sLSTM's gates read its own h,
so its step runs whole. Plain PyTorch, as the
reference's scan is plain JAX: no Pallas kernel is involved.

Activations: softplus is `torch.logaddexp(x, 0)`, jax.nn.softplus's own
definition (F.softplus returns x past its threshold of 20, under 2e-9
away); log_sigmoid is `F.logsigmoid`; gelu(approximate=True) is
`F.gelu(approximate="tanh")`.

Dtypes follow jnp's promotion: an einsum of two dtypes runs in the wider
one (`_einsum`). A cache wider than the activations keeps its conv state
wide, and decode's conv then runs in the wider dtype, as the reference's
does on a fresh cache (after a prefill the reference's new cache takes the
activations' dtype; the port's cache keeps its own).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import Params, rms_norm

__all__ = [
    "MambaConfig", "mamba_init", "mamba_apply", "mamba_cache_init",
    "XLSTMConfig", "mlstm_init", "mlstm_apply", "mlstm_cache_init",
    "slstm_init", "slstm_apply", "slstm_cache_init", "chunked_scan",
    "SCAN_BLOCK",
]

# time steps whose state-free terms are computed in one op each
SCAN_BLOCK = 16


def _scan(step, carry, is_tuple: bool, *seq):
    """carry, y_t = step(carry, x_t) over the leading axis of seq; (carry,
    the y_t stacked on axis 0, a tuple of stacks where step returns a
    tuple)."""
    ys = []
    for x_t in zip(*(a.unbind(0) for a in seq)):
        carry, y = step(carry, x_t if is_tuple else x_t[0])
        ys.append(y)
    if isinstance(ys[0], tuple):
        return carry, tuple(torch.stack(c) for c in zip(*ys))
    return carry, torch.stack(ys)


def chunked_scan(step, init, xs, chunk: int | None = None):
    """The reference's scan over time: carry, y_t = step(carry, x_t) for
    each t of the leading axis of `xs` (a tensor, or a tuple of tensors
    passed to step as a tuple), a Python loop. Returns (carry, ys) with
    the y_t stacked on axis 0 (a tuple of stacks where step returns a
    tuple). With `chunk` (gcd(T, chunk) where it does not divide T, as
    the reference's) and autograd recording, each chunk runs under one
    `torch.utils.checkpoint`: the reference's per-chunk remat."""
    is_tuple = isinstance(xs, tuple)
    seq = xs if is_tuple else (xs,)
    T = seq[0].shape[0]
    if chunk is None or not torch.is_grad_enabled():
        return _scan(step, init, is_tuple, *seq)
    if T % chunk:
        chunk = math.gcd(T, chunk) or T
    carry, parts = init, []
    for t0 in range(0, T, chunk):
        carry, ys = checkpoint(_scan, step, carry, is_tuple,
                               *(a[t0:t0 + chunk] for a in seq),
                               use_reentrant=False)
        parts.append(ys)
    if isinstance(parts[0], tuple):
        return carry, tuple(torch.cat(c) for c in zip(*parts))
    return carry, torch.cat(parts)


def _einsum(eq: str, a, b):
    """torch.einsum with jnp.einsum's promotion: both operands in the
    wider dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _blocks(T: int):
    return (slice(t0, t0 + SCAN_BLOCK) for t0 in range(0, T, SCAN_BLOCK))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv along T. x [B, T, D], w [K, D], b [D], state
    [B, K-1, D] (the rows before x) or None (zeros) -> (out [B, T, D], the
    last K-1 rows of the padded input, or None for K = 1), in the dtype
    the inputs promote to."""
    K, T = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out + b, new_state


def _write(cache, **state):
    """The final state into the cache's views, in place."""
    for name, value in state.items():
        cache[name].copy_(value)
    return cache


# ---------------------------------------------------------------------------
# Mamba-1 (selective SSM): Jamba's sequence mixer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0      # 0 -> ceil(d_model / 16)
    chunk: int = 256

    def inner(self, d_model):
        return self.expand * d_model

    def rank(self, d_model):
        return self.dt_rank or -(-d_model // 16)


def mamba_init(d_model: int, mc: MambaConfig, *, dtype=torch.float32,
               device=None) -> Params:
    di, r, S = mc.inner(d_model), mc.rank(d_model), mc.d_state
    p = Params()
    kw = {"dtype": dtype, "device": device}
    p.add("in_proj", (d_model, 2, di), 1.0 / math.sqrt(d_model), **kw)
    p.add("conv_w", (mc.d_conv, di), 0.1, **kw)
    p.add("conv_b", (di,), None, fill=0.0, **kw)
    p.add("x_proj", (di, r + 2 * S), 1.0 / math.sqrt(di), **kw)
    p.add("dt_proj", (r, di), 1.0 / math.sqrt(r), **kw)
    p.add("dt_bias", (di,), None,
          fill=torch.log(torch.expm1(torch.tensor(0.01))), **kw)
    p.add("A_log", (di, S), None, fill=torch.log(
        torch.arange(1, S + 1, dtype=torch.float32)), **kw)
    p.add("D", (di,), None, **kw)
    p.add("out_proj", (di, d_model), 1.0 / math.sqrt(di), **kw)
    return p


def mamba_apply(p, x, *, mode: str, cache=None, pos=0, mc: MambaConfig):
    """Mamba-1 of x [B, T, d] -> (y [B, T, d], cache): {"conv": [B, K-1,
    di], "ssm": float32 [B, di, d_state]}, read in decode and written in
    place (prefill and decode), or None without one."""
    B, T, d_model = x.shape
    di, r, S = p["D"].shape[0], mc.rank(d_model), mc.d_state
    decode = cache is not None and mode == "decode"
    xz = _einsum("btd,dge->btge", x, p["in_proj"])
    xb, z = xz[:, :, 0], xz[:, :, 1]
    xc, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"],
                                cache["conv"] if decode else None)
    xc = F.silu(xc)
    proj = _einsum("bti,ie->bte", xc, p["x_proj"])
    dt = _softplus(_einsum("btr,ri->bti", proj[..., :r], p["dt_proj"])
                   + p["dt_bias"])                        # [B, T, di]
    Bm, Cm = proj[..., r:r + S], proj[..., r + S:]         # [B, T, S]
    A = -torch.exp(p["A_log"].float())                    # [di, S]
    h = (cache["ssm"] if decode
         else torch.zeros((B, di, S), dtype=torch.float32, device=x.device))
    xs = tuple(a.transpose(0, 1) for a in (dt, Bm, Cm, xc))  # [T, B, ..]
    with torch.profiler.record_function("ssm.scan"):
        if mode == "train":
            h, y = chunked_scan(lambda h, x_t: _mamba_step(A, h, x_t), h, xs,
                                mc.chunk)
        else:
            ys = []
            for blk in _blocks(T):
                dt_b, B_b, C_b, x_b = (a[blk] for a in xs)   # [c, B, ..]
                # dA becomes the block's states: h_t = dA_t h_{t-1} + dBx_t
                hs = torch.exp(dt_b[..., None] * A)       # float32
                dBx = dt_b[..., None] * B_b[:, :, None, :] * x_b[..., None]
                for t in range(hs.shape[0]):
                    h = hs[t].mul_(h).add_(dBx[t])
                ys.append(_einsum("cbis,cbs->cbi", hs, C_b))
            y = torch.cat(ys)
    y = y.transpose(0, 1) + xc * p["D"]                   # float32
    y = y * F.silu(z)
    out = _einsum("bti,id->btd", y.to(x.dtype), p["out_proj"])
    if cache is None:
        return out, None
    return out, _write(cache, conv=new_conv, ssm=h)


def _mamba_step(A, h, xs):
    """One Mamba step (the reference's `step`): h = exp(dt A) h + dt B x,
    y = h C."""
    dt_t, B_t, C_t, x_t = xs
    h = torch.exp(dt_t[..., None] * A) * h + \
        dt_t[..., None] * B_t[:, None, :] * x_t[..., None]
    return h, _einsum("bis,bs->bi", h, C_t)


def mamba_cache_init(batch: int, d_model: int, mc: MambaConfig, *,
                     dtype=torch.float32, device=None) -> dict:
    di = mc.inner(d_model)
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) + sLSTM (scalar, recurrent)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    m_proj_factor: float = 2.0
    s_ffn_factor: float = 4.0 / 3.0
    d_conv: int = 4
    chunk: int = 256


def mlstm_init(d_model: int, xc: XLSTMConfig, *, dtype=torch.float32,
               device=None) -> Params:
    di = int(xc.m_proj_factor * d_model)
    H = xc.n_heads
    s, si = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(di)
    p = Params()
    kw = {"dtype": dtype, "device": device}
    p.add("in_proj", (d_model, 2, di), s, **kw)
    p.add("conv_w", (xc.d_conv, di), 0.1, **kw)
    p.add("conv_b", (di,), None, fill=0.0, **kw)
    for name in ("wq", "wk", "wv"):
        p.add(name, (di, di), si, **kw)
    p.add("w_i", (di, H), si, **kw)
    p.add("w_f", (di, H), si, mean=3.0, **kw)             # open f-gate
    p.add("gn_scale", (di,), None, **kw)
    p.add("skip", (di,), None, **kw)
    p.add("out_proj", (di, d_model), si, **kw)
    return p


def _mlstm_stabilizer(m, xs):
    """m_new = max(log_f + m, log_i); yields (log_f + m, m_new)."""
    log_f, log_i = xs
    lfm = log_f + m
    m = torch.maximum(lfm, log_i)
    return m, (lfm, m)


def _mlstm_cell(state, xs):
    """One stabilized mLSTM step (the reference's `_mlstm_cell`): q, k, v
    [B, H, dh], log_i, log_f [B, H]; state (C, n, m)."""
    q, k, v, log_i, log_f = xs
    C, n, m = state
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)[..., None]
    f_p = torch.exp(log_f + m - m_new)[..., None]
    C = f_p[..., None] * C + i_p[..., None] * (v[..., :, None]
                                               * k[..., None, :])
    n = f_p * n + i_p * k
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                          torch.exp(-m_new))[..., None]
    return (C, n, m_new), torch.einsum("bhvd,bhd->bhv", C, q) / denom


def mlstm_apply(p, x, *, mode: str, cache=None, pos=0, xc: XLSTMConfig):
    """mLSTM of x [B, T, d] -> (y [B, T, d], cache): {"conv": [B, K-1,
    di], "C": [B, H, dh, dh], "n": [B, H, dh], "m": [B, H]} (the state
    float32), read in decode and written in place (prefill and decode)."""
    B, T, d_model = x.shape
    di = p["conv_b"].shape[0]
    H = xc.n_heads
    dh = di // H
    decode = cache is not None and mode == "decode"
    xz = _einsum("btd,dge->btge", x, p["in_proj"])
    xb, z = xz[:, :, 0], xz[:, :, 1]
    xcv, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"],
                                 cache["conv"] if decode else None)
    xcv = F.silu(xcv)
    q = _einsum("bti,ij->btj", xcv, p["wq"]).reshape(B, T, H, dh)
    k = _einsum("bti,ij->btj", xcv, p["wk"]).reshape(B, T, H, dh) / \
        math.sqrt(dh)
    v = _einsum("bti,ij->btj", xb, p["wv"]).reshape(B, T, H, dh)
    log_i = _einsum("bti,ih->bth", xb, p["w_i"]).float()
    log_f = F.logsigmoid(_einsum("bti,ih->bth", xb, p["w_f"]).float())
    if decode:
        C, n, m = cache["C"], cache["n"], cache["m"]
    else:
        f32 = {"dtype": torch.float32, "device": x.device}
        C = torch.zeros((B, H, dh, dh), **f32)
        n = torch.zeros((B, H, dh), **f32)
        m = torch.full((B, H), -math.inf, **f32)
    xs = tuple(a.transpose(0, 1).float() for a in (q, k, v, log_i, log_f))
    with torch.profiler.record_function("ssm.scan"):
        if mode == "train":
            (C, n, m), h = chunked_scan(_mlstm_cell, (C, n, m), xs, xc.chunk)
        else:
            hs = []
            for blk in _blocks(T):
                q_b, k_b, v_b, li, lf = (a[blk] for a in xs)
                m, (lfm, m_b) = chunked_scan(_mlstm_stabilizer, m, (lf, li))
                i_p = torch.exp(li - m_b)[..., None]      # [c, B, H, 1]
                f_p = torch.exp(lfm - m_b)[..., None]
                # i_p v k^T and i_p k become the block's states:
                # C_t = f_p C_{t-1} + i_p v k^T, n_t = f_p n_{t-1} + i_p k
                Cs = (v_b[..., :, None] * k_b[..., None, :]).mul_(
                    i_p[..., None])
                ns = i_p * k_b
                for t in range(Cs.shape[0]):
                    C = Cs[t].add_(f_p[t][..., None] * C)
                    n = ns[t].add_(f_p[t] * n)
                denom = torch.maximum(
                    torch.einsum("cbhd,cbhd->cbh", ns, q_b).abs(),
                    torch.exp(-m_b))[..., None]
                hs.append(torch.einsum("cbhvd,cbhd->cbhv", Cs, q_b) / denom)
            h = torch.cat(hs)
    h = h.transpose(0, 1).reshape(B, T, di)
    h = rms_norm(h.to(x.dtype), p["gn_scale"])            # per-channel norm
    h = h + p["skip"] * xcv
    h = h * F.silu(z)
    out = _einsum("bti,id->btd", h, p["out_proj"])
    if cache is None:
        return out, None
    return out, _write(cache, conv=new_conv, C=C, n=n, m=m)


def mlstm_cache_init(batch: int, d_model: int, xc: XLSTMConfig, *,
                     dtype=torch.float32, device=None) -> dict:
    di = int(xc.m_proj_factor * d_model)
    H, dh = xc.n_heads, di // xc.n_heads
    f32 = {"dtype": torch.float32, "device": device}
    return {
        "conv": torch.zeros((batch, xc.d_conv - 1, di), dtype=dtype,
                            device=device),
        "C": torch.zeros((batch, H, dh, dh), **f32),
        "n": torch.zeros((batch, H, dh), **f32),
        "m": torch.full((batch, H), -math.inf, **f32),
    }


def slstm_init(d_model: int, xc: XLSTMConfig, *, dtype=torch.float32,
               device=None) -> Params:
    H = xc.n_heads
    dh = d_model // H
    s = 1.0 / math.sqrt(d_model)
    ff = int(xc.s_ffn_factor * d_model)
    p = Params()
    kw = {"dtype": dtype, "device": device}
    p.add("w_gates", (d_model, 4, H, dh), s, **kw)
    p.add("r_gates", (4, H, dh, dh), 1.0 / math.sqrt(dh), **kw)
    p.add("b_gates", (4, H, dh), None,                    # open f-gate
          fill=torch.tensor([0.0, 3.0, 0.0, 0.0])[:, None, None], **kw)
    p.add("gn_scale", (d_model,), None, **kw)
    p.add("ffn_in", (d_model, 2, ff), s, **kw)
    p.add("ffn_out", (ff, d_model), 1.0 / math.sqrt(ff), **kw)
    return p


def _slstm_cell(gx, r, state):
    """gx [B, 4, H, dh] the inputs' gate terms (z, f, i, o); r [4, H, dh,
    dh] float32."""
    c, n, h, m = state
    z_in, f_in, i_in, o_in = (gx + torch.einsum("bhd,ghde->bghe", h, r)
                              ).unbind(1)
    z = torch.tanh(z_in)
    o = torch.sigmoid(o_in)
    lfm = F.logsigmoid(f_in) + m
    m_new = torch.maximum(lfm, i_in)
    i_p = torch.exp(i_in - m_new)
    f_p = torch.exp(lfm - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h = o * (c / n.clamp_min(1e-6))
    return (c, n, h, m_new), h


def slstm_apply(p, x, *, mode: str, cache=None, pos=0, xc: XLSTMConfig):
    """sLSTM of x [B, T, d] -> (y [B, T, d], cache): {"sc", "sn", "sh",
    "sm": float32 [B, H, dh]}, read in decode and written in place
    (prefill and decode)."""
    B, T, d_model = x.shape
    H = xc.n_heads
    dh = d_model // H
    gx = (_einsum("btd,dghe->btghe", x, p["w_gates"])
          + p["b_gates"]).float()
    r = p["r_gates"].float()
    if cache is not None and mode == "decode":
        state = (cache["sc"], cache["sn"], cache["sh"], cache["sm"])
    else:
        state = tuple(torch.zeros((B, H, dh), dtype=torch.float32,
                                  device=x.device) for _ in range(3)) + (
            torch.full((B, H, dh), -math.inf, device=x.device),)
    with torch.profiler.record_function("ssm.scan"):
        state, hs = chunked_scan(lambda s, g: _slstm_cell(g, r, s), state,
                                 gx.transpose(0, 1),
                                 xc.chunk if mode == "train" else None)
    h = hs.transpose(0, 1).reshape(B, T, d_model).to(x.dtype)
    h = rms_norm(h, p["gn_scale"])
    ff = _einsum("btd,dgf->btgf", h, p["ffn_in"])
    ff = F.gelu(ff[:, :, 0], approximate="tanh") * ff[:, :, 1]
    out = _einsum("btf,fd->btd", ff, p["ffn_out"])
    if cache is None:
        return out, None
    return out, _write(cache, sc=state[0], sn=state[1], sh=state[2],
                       sm=state[3])


def slstm_cache_init(batch: int, d_model: int, xc: XLSTMConfig, *,
                     dtype=torch.float32, device=None) -> dict:
    """Each leaf its own tensor (the reference aliases one zeros array
    three times; an in-place write here would change all three)."""
    H, dh = xc.n_heads, d_model // xc.n_heads
    cache = {name: torch.zeros((batch, H, dh), dtype=torch.float32,
                               device=device) for name in ("sc", "sn", "sh")}
    cache["sm"] = torch.full((batch, H, dh), -math.inf, dtype=torch.float32,
                             device=device)
    return cache
