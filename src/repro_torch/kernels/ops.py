"""Public kernel entry points, dispatched on the tensors' device.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the kernel's plain PyTorch version. There is no fallback
from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.attention import (
    flash_attention_cuda,
    flash_attention_ref,
    flash_attention_vjp,
)
from repro_torch.kernels.descent import (
    greedy_descent_cuda,
    greedy_descent_ref,
)
from repro_torch.kernels.l2dist import l2dist_cuda, l2dist_ref
from repro_torch.kernels.l2topk import l2topk_cuda, l2topk_ref
from repro_torch.kernels.qdist import (
    l2dist_q_cuda,
    l2dist_q_ref,
    l2topk_q_cuda,
    l2topk_q_ref,
    pq_adc_cuda,
    pq_adc_ref,
    pq_topk_cuda,
    pq_topk_ref,
)
from repro_torch.kernels.topk import topk_cuda, topk_ref
from repro_torch.kernels.traversal import (
    fused_traversal_cuda,
    fused_traversal_ref,
)

__all__ = ["flash_attention", "flash_attention_differentiable",
           "fused_layer0", "greedy_descent", "l2dist", "l2dist_q", "l2topk",
           "l2topk_q", "pq_adc", "pq_topk", "topk"]


def _pick(t, cuda_fn, plain_fn, what: str):
    fn = {"cuda": cuda_fn, "cpu": plain_fn}.get(t.device.type)
    if fn is None:
        raise ValueError(f"{what}: unsupported device {t.device}")
    return fn


def fused_layer0(vectors, sqnorms, l0_nbrs, queries, qsq,
                 cand_d, cand_i, fin_d, fin_i, visited, hops, calcs, *,
                 fused_hops: int, max_hops: int, metric: str = "l2"):
    """One H-hop superstep of the layer-0 traversal over every lane, in
    place (kernels/traversal.py — the paper's Fig. 6 engine). The tables
    are partition-stacked [P, N_pad, ...] float32 or 8-bit code rows; the
    state has L = P*B rows."""
    fn = _pick(vectors, fused_traversal_cuda, fused_traversal_ref,
               "fused_layer0")
    return fn(vectors, sqnorms, l0_nbrs, queries, qsq,
              cand_d, cand_i, fin_d, fin_i, visited, hops, calcs,
              fused_hops=fused_hops, max_hops=max_hops, metric=metric)


def greedy_descent(vectors, sqnorms, up_ptr, up_nbrs, entry, max_level,
                   queries, qsq, *, upper_hops: int, metric: str = "l2",
                   span=None):
    """The upper-layer greedy descent (ef = 1) of every lane, from each
    partition's entry point to its layer-0 entry (kernels/descent.py):
    (cur [L] int32, cur_d [L] float32, calcs [L] int32) for L = P*B lanes
    over partition-stacked float32 or 8-bit code rows. `span` (the
    `descend` span) gets the route's attrs."""
    fn = _pick(vectors, greedy_descent_cuda, greedy_descent_ref,
               "greedy_descent")
    return fn(vectors, sqnorms, up_ptr, up_nbrs, entry, max_level, queries,
              qsq, upper_hops=upper_hops, metric=metric, span=span)


def pq_adc(luts, codes, xpad=None):
    """PQ asymmetric distances [Bq, Bx] float32 (kernels/qdist.py): luts
    [Bq, M, 256] from `build_pq_lut`, codes [Bx, M] uint8, optional xpad
    [Bx] with +inf on padding rows."""
    return _pick(luts, pq_adc_cuda, pq_adc_ref, "pq_adc")(luts, codes, xpad)


def pq_topk(luts, codes, xpad=None, *, k: int = 10):
    """Fused PQ k-NN over code rows: (dists [Bq, k] ascending, ids [Bq, k]
    int32); unfilled slots are (+inf, -1) (kernels/qdist.py)."""
    fn = _pick(luts, pq_topk_cuda, pq_topk_ref, "pq_topk")
    return fn(luts, codes, xpad, k=k)


def l2dist(queries, xs, *, metric: str = "l2"):
    """Pairwise distances [Bq, Bx] float32 under `metric` (kernels/l2dist.py):
    l2 `(qsq + xsq) - 2 q.x` (no clamp), ip `-q.x`, cosine `1 - q.x` over
    unit-norm rows."""
    return _pick(xs, l2dist_cuda, l2dist_ref, "l2dist")(queries, xs,
                                                        metric=metric)


def l2topk(queries, xs, xsq=None, *, k: int = 10):
    """Fused exact k-NN (kernels/l2topk.py): (dists [Bq, k] ascending, ids
    [Bq, k] int32) of `max(l2, 0)`; `xsq` [Bx] defaults to the rows' sums
    of squares, +inf marks padding rows; ties go to the lower row, unfilled
    slots are (+inf, -1). The kernel takes k <= 64."""
    return _pick(xs, l2topk_cuda, l2topk_ref, "l2topk")(queries, xs, xsq, k=k)


def l2dist_q(queries, xs, xsq=None, *, out_scale: float = 1.0):
    """Code-space distance matrix over uint8 / int8 rows
    (kernels/qdist.py): `max(l2, 0) * out_scale`, [Bq, Bx] float32; `xsq`
    [Bx] defaults to the rows' sums of squares, +inf marks padding rows
    (their column reads +inf)."""
    fn = _pick(xs, l2dist_q_cuda, l2dist_q_ref, "l2dist_q")
    return fn(queries, xs, xsq, out_scale=out_scale)


def l2topk_q(queries, xs, xsq=None, *, k: int = 10, out_scale: float = 1.0):
    """Fused k-NN over uint8 / int8 code rows (kernels/qdist.py): selected
    in code space, distances times `out_scale` after; as `l2topk`
    otherwise."""
    fn = _pick(xs, l2topk_q_cuda, l2topk_q_ref, "l2topk_q")
    return fn(queries, xs, xsq, k=k, out_scale=out_scale)


def topk(x, k: int):
    """Per-row k smallest of x [B, N] (kernels/topk.py): (values [B, k]
    float32 ascending, ids [B, k] int32); ties go to the lower column,
    unfilled slots are (+inf, -1). The kernel takes k <= 64."""
    return _pick(x, topk_cuda, topk_ref, "topk")(x, k)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix_len=None, q_offset: int = 0):
    """Softmax attention over flattened heads (kernels/attention.py): q
    [BH, T, hd], k, v [BKV, S, hd] (BKV dividing BH: query row bh reads
    KV row bh // (BH / BKV)) float32 or bf16 -> [BH, T, hd] in q's dtype;
    scores scaled by 1 / sqrt(hd); query rows at positions q_offset.., keys
    at 0..S-1, masked as `blockwise_attn` masks them (causal, with a
    bidirectional prefix of `prefix_len` keys; a sliding window); a row
    with no live key is 0. The kernels take hd <= 256: bf16 with
    hd % 8 == 0 runs on the tensor cores, the rest on FP32 FMAs
    (`takes_tensor_cores`)."""
    fn = _pick(q, flash_attention_cuda, flash_attention_ref,
               "flash_attention")
    return fn(q, k, v, causal=causal, window=window, prefix_len=prefix_len,
              q_offset=q_offset)


class _FlashAttention(torch.autograd.Function):
    """`flash_attention` with a backward: the forward is `flash_attention`
    (looked up when called, so a caller that swaps it swaps this forward
    too), the backward `attention.flash_attention_vjp`'s plain recompute
    a query block at a time."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len, q_offset, block_q):
        ctx.save_for_backward(q, k, v)
        ctx.mask = {"causal": causal, "window": window,
                    "prefix_len": prefix_len, "q_offset": q_offset,
                    "block_q": block_q}
        return flash_attention(q, k, v, causal=causal, window=window,
                               prefix_len=prefix_len, q_offset=q_offset)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("attn.backward"):
            dq, dk, dv = flash_attention_vjp(q, k, v, dout, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_differentiable(q, k, v, *, causal: bool = True,
                                   window: int = 0, prefix_len=None,
                                   q_offset: int = 0, block_q: int = 512):
    """`flash_attention` that autograd can differentiate: the same forward
    (the kernel on CUDA tensors, the plain version on CPU tensors); the
    backward recomputes `block_q` query rows at a time through the plain
    version (`attention.flash_attention_vjp`)."""
    return _FlashAttention.apply(q, k, v, causal, int(window or 0),
                                 None if prefix_len is None
                                 else int(prefix_len), int(q_offset),
                                 int(block_q))
