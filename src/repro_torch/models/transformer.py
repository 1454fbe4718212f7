"""Period-structured decoder stack (the reference's
`models/transformer.py`) over every layer kind it has: GQA attention
(`attn`: full or sliding-window, a full, ring-buffer or int8 cache), MLA
attention, and the recurrent mixers (`models/ssm.py`: `mamba`, `mlstm`,
`slstm`, under the reference's key "mixer"), each with a GLU, non-gated
("dense"), MoE or no feed-forward; token or embedded inputs; a
bidirectional prefix (prefix-LM); one or several output heads.

A model is `prefix_pattern` (irregular leading layers, e.g. DeepSeek's
dense layer 0) followed by `num_periods` repetitions of `pattern`. The
reference stacks the periods' parameters on axis 0 for `lax.scan`; here
each period is a module of its own ("periods"/"<p>"/"<i>") and a Python
loop runs them. The cache keeps the reference's layout: the periods'
caches stacked on axis 0, updated in place (standing in for JAX's buffer
donation): every layer writes its cache views, the recurrent layers
their conv and scan state too.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.layers import Children, Params

__all__ = ["LayerSpec", "ModelConfig", "chunked_xent", "compute_logits",
           "embed_lookup", "forward", "init_cache", "init_params",
           "model_skeleton"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"        # attn | mla | mamba | mlstm | slstm
    ffn: str = "glu"          # glu | relu2 | moe | none
    window: int = 0           # sliding-window size for kind == attn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...]
    num_periods: int
    prefix_pattern: tuple[LayerSpec, ...] = ()
    qk_norm: bool = False
    rope_theta: float = 1e4
    act: str = "silu"
    mla: Any = None           # layers.MLAConfig
    moe: Any = None           # moe.MoEConfig
    mamba: Any = None         # ssm.MambaConfig
    xlstm: Any = None         # ssm.XLSTMConfig
    embed_inputs: bool = True
    num_output_heads: int = 1
    prefix_lm: bool = False   # bidirectional prefix (paligemma)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: Any = torch.float32
    remat: bool = True
    loss_chunk: int = 512
    block_q: int = 512        # the reference's attention blocks; the
    block_k: int = 1024       # port's flash kernel fixes its own
    family: str = "dense"     # dense | moe | ssm | vlm | audio | hybrid
    sub_quadratic: bool = False
    grad_accum: int = 1       # microbatches per step (activation memory / N)
    kv_quant: bool = False    # int8 KV cache (decode cells)
    skip_masked_blocks: bool = False  # causal block skipping (attn)

    @property
    def num_layers(self) -> int:
        return len(self.prefix_pattern) + self.num_periods * len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; the padded logit columns
        are -inf."""
        return -(-self.vocab_size // 256) * 256

    def all_specs(self):
        return list(self.prefix_pattern) + list(self.pattern) * self.num_periods


KINDS = ("attn", "mla", "mamba", "mlstm", "slstm")


def _check(spec: LayerSpec, cfg: ModelConfig):
    if spec.kind not in KINDS:
        raise ValueError(f"layer kind {spec.kind!r}")
    if spec.ffn not in ("glu", "dense", "moe", "none"):
        raise ValueError(f"feed-forward {spec.ffn!r}")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


def _layer_init(spec: LayerSpec, cfg: ModelConfig, device) -> Params:
    _check(spec, cfg)
    kw = {"dtype": cfg.param_dtype, "device": device}
    p = Params()
    p.add("ln1", (cfg.d_model,), None, **kw)
    if spec.kind == "attn":
        p.add_module("attn", L.attn_init(cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim,
                                         qk_norm=cfg.qk_norm, **kw))
    elif spec.kind == "mla":
        p.add_module("attn", L.mla_init(cfg.d_model, cfg.n_heads, cfg.mla,
                                        **kw))
    elif spec.kind == "mamba":
        p.add_module("mixer", S.mamba_init(cfg.d_model, cfg.mamba, **kw))
    elif spec.kind == "mlstm":
        p.add_module("mixer", S.mlstm_init(cfg.d_model, cfg.xlstm, **kw))
    else:
        p.add_module("mixer", S.slstm_init(cfg.d_model, cfg.xlstm, **kw))
    if spec.ffn in ("glu", "dense"):
        p.add("ln2", (cfg.d_model,), None, **kw)
        p.add_module("ffn", L.mlp_init(cfg.d_model, cfg.d_ff, spec.ffn, **kw))
    elif spec.ffn == "moe":
        p.add("ln2", (cfg.d_model,), None, **kw)
        p.add_module("moe", M.moe_init(cfg.d_model, cfg.moe, **kw))
    return p


def _layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int, s_max: int,
                 dtype, device) -> dict:
    _check(spec, cfg)
    kw = {"dtype": dtype, "device": device}
    if spec.kind == "attn":
        return L.attn_cache_init(batch, s_max, cfg.n_kv_heads, cfg.head_dim,
                                 window=spec.window, quant=cfg.kv_quant, **kw)
    if spec.kind == "mla":
        return L.mla_cache_init(batch, s_max, cfg.mla, **kw)
    if spec.kind == "mamba":
        return S.mamba_cache_init(batch, cfg.d_model, cfg.mamba, **kw)
    if spec.kind == "mlstm":
        return S.mlstm_cache_init(batch, cfg.d_model, cfg.xlstm, **kw)
    return S.slstm_cache_init(batch, cfg.d_model, cfg.xlstm, **kw)


def _layer_apply(p, spec: LayerSpec, cfg: ModelConfig, x, *, mode, cache,
                 pos, prefix_len=None):
    aux = 0.0
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "attn":
        h, new_cache = L.attn_apply(
            p["attn"], h, mode=mode, cache=cache, pos=pos, window=spec.window,
            prefix_len=prefix_len if cfg.prefix_lm else None,
            rope_theta=cfg.rope_theta, block_q=cfg.block_q)
    elif spec.kind == "mla":
        h, new_cache = L.mla_apply(
            p["attn"], h, mode=mode, cache=cache, pos=pos, mla=cfg.mla,
            rope_theta=cfg.rope_theta, block_q=cfg.block_q)
    elif spec.kind == "mamba":
        h, new_cache = S.mamba_apply(p["mixer"], h, mode=mode, cache=cache,
                                     pos=pos, mc=cfg.mamba)
    elif spec.kind == "mlstm":
        h, new_cache = S.mlstm_apply(p["mixer"], h, mode=mode, cache=cache,
                                     pos=pos, xc=cfg.xlstm)
    else:
        h, new_cache = S.slstm_apply(p["mixer"], h, mode=mode, cache=cache,
                                     pos=pos, xc=cfg.xlstm)
    x = x + h
    if "ffn" in p:
        x = x + L.mlp_apply(p["ffn"], L.rms_norm(x, p["ln2"], cfg.norm_eps),
                            act=cfg.act)
    elif "moe" in p:
        y, aux = M.moe_apply(p["moe"], L.rms_norm(x, p["ln2"], cfg.norm_eps),
                             cfg.moe, train=(mode == "train"))
        x = x + y
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


class _EmbedLookup(torch.autograd.Function):
    """A gather forward; the reference's backward (`_embed_bwd`): in place
    of a scatter-add, a one-hot [B, chunk, V] product per chunk of at most
    512 positions (the largest divisor of T not above 512), accumulated
    in chunk order in the gradient's dtype. On the card it is a plain
    matmul, deterministic where an atomic scatter-add is not."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.vocab = table.shape[0]
        ctx.table_dtype = table.dtype
        return F.embedding(tokens, table)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        V = ctx.vocab
        T = g.shape[1]
        chunk = min(T, 512)
        while T % chunk:
            chunk -= 1
        cols = torch.arange(V, device=g.device)
        acc = torch.zeros((V, g.shape[2]), dtype=g.dtype, device=g.device)
        for c0 in range(0, T, chunk):
            oh = (tokens[:, c0:c0 + chunk, None] == cols).to(g.dtype)
            acc = acc + torch.einsum("bcv,bcd->vd", oh,
                                     g[:, c0:c0 + chunk])
        return acc.to(ctx.table_dtype), None


def embed_lookup(table, tokens):
    """table [V, d], tokens [B, T] -> [B, T, d]: a gather, differentiable
    through the reference's chunked one-hot backward."""
    return _EmbedLookup.apply(table, tokens)


def model_skeleton(cfg: ModelConfig, device) -> Params:
    """The parameter module of `cfg` on `device`, uninitialised:
    "embed" (token inputs only), "prefix"/"<i>", "periods"/"<p>"/"<i>",
    "final_norm", "head" [d, heads, V] (unless tied to the embedding)
    (the reference's keys; its "periods" leaves are stacked on axis 0,
    here split by period)."""
    kw = {"dtype": cfg.param_dtype, "device": device}
    model = Params()
    if cfg.embed_inputs:
        model.add("embed", (cfg.padded_vocab, cfg.d_model), 0.02, **kw)
    if cfg.prefix_pattern:
        model.add_module("prefix", Children(
            _layer_init(s, cfg, device) for s in cfg.prefix_pattern))
    model.add_module("periods", Children(
        Children(_layer_init(s, cfg, device) for s in cfg.pattern)
        for _ in range(cfg.num_periods)))
    model.add("final_norm", (cfg.d_model,), None, **kw)
    if not (cfg.tie_embeddings and cfg.embed_inputs):
        model.add("head", (cfg.d_model, cfg.num_output_heads,
                           cfg.padded_vocab), cfg.d_model ** -0.5, **kw)
    return model


def init_params(cfg: ModelConfig, *, device=None,
                generator: torch.Generator | None = None) -> Params:
    """The model's parameters, built on `device` (default: the card; raises
    without one) in `cfg.param_dtype` and drawn from `generator` (default:
    seed 0 on that device) at the reference's scales: N(0, 1/d_model) for
    input projections, N(0, 1/fan_in) for output projections, 0.02 for
    the embedding, ones for norm scales."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        return model_skeleton(cfg, dev).draw_(generator)


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.float32, *, device=None) -> dict:
    """{"prefix": {"<i>": layer cache}, "periods": {"<i>": layer cache with
    every leaf stacked over the periods on axis 0}} on `device`."""
    dev = resolve_device(device)
    cache: dict = {}
    if cfg.prefix_pattern:
        cache["prefix"] = {str(i): _layer_cache(s, cfg, batch, s_max, dtype,
                                                dev)
                           for i, s in enumerate(cfg.prefix_pattern)}
    cache["periods"] = {
        str(i): {k: torch.stack([v] * cfg.num_periods) for k, v in
                 _layer_cache(s, cfg, batch, s_max, dtype, dev).items()}
        for i, s in enumerate(cfg.pattern)}
    return cache


def _period(pparams, cfg: ModelConfig, x, *, mode, pcache, pos,
            prefix_len):
    aux_p = 0.0
    for i, spec in enumerate(cfg.pattern):
        x, _, aux = _layer_apply(pparams[str(i)], spec, cfg, x, mode=mode,
                                 cache=None if pcache is None
                                 else pcache[str(i)], pos=pos,
                                 prefix_len=prefix_len)
        aux_p = aux_p + aux
    return x, aux_p


def forward(model, cfg: ModelConfig, inputs, *, mode: str, cache=None,
            pos=0, prefix_len=None):
    """inputs: tokens [B, T] (embed_inputs) or embeddings [B, T, d] ->
    (hidden [B, T, d], cache, aux loss sum). With a cache, each layer
    writes its positions pos.. in place. `prefix_len` (an int or a 0-d
    tensor, read once here) is the bidirectional prefix of a prefix-LM
    config; other configs ignore it, as the reference's do. mode "train"
    (no cache) with `cfg.remat` runs each period under one
    `torch.utils.checkpoint`, the reference's `jax.checkpoint` of a
    period: backward keeps the periods' inputs and recomputes the rest."""
    x = embed_lookup(model["embed"], inputs) if cfg.embed_inputs else inputs
    if prefix_len is not None:
        prefix_len = int(prefix_len)
    aux_total = 0.0
    for i, spec in enumerate(cfg.prefix_pattern):
        c = cache["prefix"][str(i)] if cache is not None else None
        x, _, aux = _layer_apply(model["prefix"][str(i)], spec, cfg, x,
                                 mode=mode, cache=c, pos=pos,
                                 prefix_len=prefix_len)
        aux_total = aux_total + aux
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    aux_periods = 0.0
    for per in range(cfg.num_periods):
        pcache = None
        if cache is not None:
            pcache = {i: {k: v[per] for k, v in layer.items()}
                      for i, layer in cache["periods"].items()}
        run = functools.partial(_period, model["periods"][str(per)], cfg,
                                mode=mode, pcache=pcache, pos=pos,
                                prefix_len=prefix_len)
        x, aux = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        aux_periods = aux_periods + aux
    aux_total = aux_total + aux_periods
    x = L.rms_norm(x, model["final_norm"], cfg.norm_eps)
    return x, cache, aux_total


def _head_matrix(model, cfg: ModelConfig):
    if "head" in model:
        return model["head"]
    return model["embed"].T[:, None, :]                 # tied: [d, 1, V]


def compute_logits(model, cfg: ModelConfig, hidden):
    """hidden [B, T, d] -> logits [B, T, (heads,) padded_V] float32 (the
    heads axis only when num_output_heads > 1); padded vocab columns are
    -inf so sampling / argmax never selects them."""
    head = _head_matrix(model, cfg)
    logits = torch.einsum("btd,dhv->bthv", hidden.float(), head.float())
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = float("-inf")
    return logits[:, :, 0] if cfg.num_output_heads == 1 else logits


def _xent_chunk(h_c, head, l_c, m_c, vocab_size: int):
    """Masked cross-entropy sum of one chunk: h_c [B, c, d], head [d, nH,
    V], labels l_c and mask m_c [B, c, nH]."""
    logits = torch.einsum("bcd,dhv->bchv", h_c.float(), head.float())
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(cols < vocab_size, logits, float("-inf"))
    logz = torch.logsumexp(logits, dim=-1)
    # the label's logit by a masked sum, as the reference takes it
    ll = torch.where(cols == l_c[..., None], logits, 0.0).sum(-1)
    return ((logz - ll) * m_c).sum()


def chunked_xent(model, cfg: ModelConfig, hidden, labels, mask=None):
    """Mean cross-entropy over the `mask`ed positions (all by default)
    without materialising [B, T, V] logits: chunks of cfg.loss_chunk
    positions (the largest divisor of T not above it), each under one
    `torch.utils.checkpoint` (the reference's `jax.checkpoint` of a scan
    step), so backward recomputes a chunk's logits. Padded vocab columns
    are -inf. labels [B, T] or [B, T, nH] (several output heads)."""
    B, T, _ = hidden.shape
    head = _head_matrix(model, cfg)
    chunk = min(cfg.loss_chunk, T)
    if T % chunk:
        chunk = 1 if T < 2 else next(c for c in range(chunk, 0, -1)
                                     if T % c == 0)
    if labels.dim() == 2:
        labels = labels[..., None]
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=hidden.device)
    elif mask.dim() == 2:
        mask = mask[..., None].float()
    loss_sum, count = 0.0, 0.0
    for c0 in range(0, T, chunk):
        part = (hidden[:, c0:c0 + chunk], head, labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk], cfg.vocab_size)
        loss = (checkpoint(_xent_chunk, *part, use_reentrant=False)
                if torch.is_grad_enabled() else _xent_chunk(*part))
        loss_sum = loss_sum + loss
        count = count + part[3].sum()
    return loss_sum / torch.clamp_min(torch.as_tensor(count), 1.0)
