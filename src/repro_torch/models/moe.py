"""Mixture-of-Experts with sort-based (dropping) token dispatch (the
reference's `models/moe.py`).

Routing is a 1-hop nearest-centroid search, so with
`MoEConfig.router_use_kernel` the router's top-k runs through the
hand-written `kernels.ops.topk` (the reference's `topk_pallas`).

Dispatch: tokens are split into G groups exactly as the reference
splits them (`_factor_groups`, which reads the data- and model-parallel
extents of `models.shard_ctx`: 1 and 1 with no context), repeated k times,
sorted by expert id (stably), truncated at the per-expert capacity
C = max(ceil(k * Sg / E * capacity_factor), 4), and moved with one
scatter and one gather; slots past capacity go to a spill row at E * C
and are dropped. Which tokens are dropped depends on G, so G is the
reference's.

Combine: the reference scatter-adds a token's k weighted expert outputs
in scatter order (`.at[t].add`, by expert id). Here each token's k
contributions are put back in (token, slot) order and summed in
increasing expert id, in the activations' dtype, one rounding an add:
the same order, and deterministic on the card, where a scatter-add of
atomics would not be. Training keeps that: the gates are the selected
probabilities (so the router gets gradients, also when the topk kernel
selects), and the dispatch's backward sums a token's k slots in a fixed
order. The Switch load-balancing aux loss is the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import shard_ctx
from repro_torch.models.layers import Params

__all__ = ["MoEConfig", "moe_init", "moe_apply"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 2
    d_ff: int = 1408          # per-expert hidden
    n_shared: int = 0         # always-on shared experts (DeepSeek)
    shared_d_ff: int = 0      # 0 -> n_shared * d_ff
    capacity_factor: float = 1.25
    router_use_kernel: bool = False   # route via kernels.ops.topk

    def shared_ff(self):
        return self.shared_d_ff or self.n_shared * self.d_ff


def moe_init(d_model: int, mc: MoEConfig, *, dtype=torch.float32,
             device=None) -> Params:
    p = Params()
    s = 1.0 / math.sqrt(d_model)
    E, Fd = mc.num_experts, mc.d_ff
    kw = {"dtype": dtype, "device": device}
    p.add("router", (d_model, E), s, **kw)
    p.add("w_in", (E, d_model, 2, Fd), s, **kw)
    p.add("w_out", (E, Fd, d_model), 1.0 / math.sqrt(Fd), **kw)
    if mc.n_shared > 0:
        Fs = mc.shared_ff()
        p.add("shared_w_in", (d_model, 2, Fs), s, **kw)
        p.add("shared_w_out", (Fs, d_model), 1.0 / math.sqrt(Fs), **kw)
    return p


def _top_k(probs, k: int):
    """The k largest of each row, the lower index first among equals (as
    `lax.top_k`, which `torch.topk` does not promise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits, k: int, use_kernel: bool):
    """Top-k expert choice and normalised gates. logits [S, E] -> (gate
    [S, k] float32, idx [S, k] int64, probs [S, E] float32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    if use_kernel:
        neg, idx = ops.topk(-probs.detach(), k)
        # in training the gates must carry gradients to the router: the
        # selected probabilities, bitwise the kernel's values
        gate = (probs.gather(-1, idx.long()) if probs.requires_grad
                else -neg)
    else:
        gate, idx = _top_k(probs, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate, idx.long(), probs


def _factor_groups(B: int, T: int) -> tuple[int, int]:
    """(Gb, Gt): the reference's batch-block x seq-block group factors.
    Gb is the first of (dp, 32, 16, ..., 1) that divides B; Gt the first
    of (8 tp, 4 tp, 2 tp, tp, 16, 8, 4, 2, 1) that divides T with Gb Gt a
    multiple of dp tp, else the first of (16, 8, 4, 2, 1) that divides T
    (dp, tp: `shard_ctx.dp_size()`, `tp_size()`). With no sharding context
    (dp = tp = 1) that is Gb = 1 and Gt the first of (8, 4, 2, 1) that
    divides T."""
    dpn, tpn = shard_ctx.dp_size(), shard_ctx.tp_size()
    world = max(dpn * tpn, 1)
    gb = next(g for g in (dpn, 32, 16, 8, 4, 2, 1) if g >= 1 and B % g == 0)
    for cand in (tpn * 8, tpn * 4, tpn * 2, tpn, 16, 8, 4, 2, 1):
        if cand >= 1 and T % cand == 0 and (gb * cand) % world == 0:
            return gb, cand
    return gb, next(g for g in (16, 8, 4, 2, 1) if T % g == 0)


def _dispatch_plan(idx, gate, E: int, C: int):
    """Sort-based routing plan of each group. idx, gate [G, Sg, K] ->
    (dest, st, sg, keep, order) [G, Sg * K]: slot p of the expert-sorted
    order is the flat (token, slot) `order[p]`, of token st, gate sg, at
    buffer row dest (E * C, the spill row, where keep is False)."""
    G, S, K = idx.shape
    dev = idx.device
    flat_e = idx.reshape(G, S * K)
    flat_t = torch.arange(S, device=dev).repeat_interleave(K).expand(G, -1)
    flat_g = gate.reshape(G, S * K)
    order = torch.sort(flat_e, dim=1, stable=True).indices
    se, st, sg = (a.gather(1, order) for a in (flat_e, flat_t, flat_g))
    start = torch.searchsorted(
        se, torch.arange(E, device=dev).expand(G, -1).contiguous(),
        side="left")
    pos = torch.arange(S * K, device=dev) - start.gather(1, se.clamp_max(E - 1))
    keep = (pos < C) & (se < E)                   # capacity drop
    dest = torch.where(keep, se * C + pos, E * C)
    return dest, st, sg, keep, order


def moe_apply(p, x, mc: MoEConfig, *, act=F.silu, train: bool = False):
    """x [B, T, d] -> (y [B, T, d], aux loss; 0.0 unless `train`)."""
    B, T, d = x.shape
    S = B * T
    E, K = mc.num_experts, mc.top_k
    Gb, Gt = _factor_groups(B, T)
    G = Gb * Gt
    Sg = S // G
    # [B, T, d] -> [Gb, B/Gb, Gt, T/Gt, d] -> [G, Sg, d]
    xf = x.reshape(Gb, B // Gb, Gt, T // Gt, d).permute(0, 2, 1, 3, 4)
    xf = xf.reshape(G, Sg, d)
    logits = torch.einsum("gsd,de->gse", xf, p["router"])
    gate, idx, probs = _route(logits.reshape(S, E), K, mc.router_use_kernel)
    gate, idx = gate.reshape(G, Sg, K), idx.reshape(G, Sg, K)

    C = max(int(math.ceil(K * Sg / E * mc.capacity_factor)), 4)
    dest, st, sg, keep, order = _dispatch_plan(idx, gate, E, C)
    # ---- dispatch: one gather, one scatter (spill-row writes collide and
    # are discarded) ------------------------------------------------------
    if xf.requires_grad and torch.is_grad_enabled():
        # each token repeated k times in (token, slot) order, then put in
        # expert order by a permutation: backward sums a token's k slots
        # in a fixed order, where a gather's backward (a scatter-add of
        # atomics on the card) would not
        rep = xf[:, :, None].expand(G, Sg, K, d).reshape(G, Sg * K, d)
        gathered = rep.gather(1, order[..., None].expand(-1, -1, d))
    else:
        gathered = xf.gather(1, st[..., None].expand(-1, -1, d))  # [G, SgK, d]
    buf = xf.new_zeros((G, E * C + 1, d)).scatter_(
        1, dest[..., None].expand(-1, -1, d), gathered)
    h = buf[:, :E * C].reshape(G, E, C, d)
    # ---- expert FFN (per-expert GLU) -------------------------------------
    with torch.profiler.record_function("moe.experts"):
        hh = torch.einsum("gecd,edif->gecif", h, p["w_in"])
        hh = act(hh[..., 0, :]) * hh[..., 1, :]
        out = torch.einsum("gecf,efd->gecd", hh, p["w_out"])
    # ---- combine ---------------------------------------------------------
    out = torch.cat([out.reshape(G, E * C, d), out.new_zeros((G, 1, d))], 1)
    contrib = out.gather(1, dest[..., None].expand(-1, -1, d))
    contrib = contrib * torch.where(keep, sg, 0.0)[..., None].to(out.dtype)
    # back to (token, slot) order, then each token's slots by expert id
    per_tok = torch.empty_like(contrib).scatter_(
        1, order[..., None].expand(-1, -1, d), contrib).reshape(G, Sg, K, d)
    per_tok = per_tok.gather(2, idx.argsort(-1)[..., None].expand(
        -1, -1, -1, d))
    y = per_tok[:, :, 0]
    for j in range(1, K):
        y = y + per_tok[:, :, j]
    y = y.reshape(Gb, Gt, B // Gb, T // Gt, d).permute(0, 2, 1, 3, 4)
    y = y.reshape(B, T, d)
    # ---- shared experts (DeepSeek) ---------------------------------------
    if "shared_w_in" in p:
        sh = torch.einsum("btd,dif->btif", x, p["shared_w_in"])
        sh = act(sh[..., 0, :]) * sh[..., 1, :]
        y = y + torch.einsum("btf,fd->btd", sh, p["shared_w_out"])
    # ---- load-balancing aux loss (Switch) --------------------------------
    aux = 0.0
    if train:
        me = probs.mean(0)                       # mean router prob / expert
        ce = torch.bincount(idx.reshape(-1), minlength=E)[:E].float() / (S * K)
        aux = E * torch.sum(me * ce)
    return y, aux
