"""Period-structured decoder stack (the reference's
`models/transformer.py`), for the kinds this port runs: MLA attention
with a GLU or MoE feed-forward (DeepSeek-V2-Lite).

A model is `prefix_pattern` (irregular leading layers, e.g. DeepSeek's
dense layer 0) followed by `num_periods` repetitions of `pattern`. The
reference stacks the periods' parameters on axis 0 for `lax.scan`; here
each period is a module of its own ("periods"/"<p>"/"<i>") and a Python
loop runs them. The cache keeps the reference's layout: the periods'
caches stacked on axis 0, updated in place (standing in for JAX's buffer
donation).

Other layer kinds (GQA `attn`, `mamba`, `mlstm`, `slstm`) raise
NotImplementedError (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.layers import Children, Params

__all__ = ["LayerSpec", "ModelConfig", "compute_logits", "embed_lookup",
           "forward", "init_cache", "init_params", "model_skeleton"]


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
    mamba: Any = None         # ssm.MambaConfig (the layer: ROADMAP.md Queue 1)
    xlstm: Any = None         # ssm.XLSTMConfig (the layer: ROADMAP.md Queue 1)
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


def _queued(what: str):
    return NotImplementedError(f"{what} is not ported yet "
                               f"(ROADMAP.md Queue 1)")


def _check(spec: LayerSpec, cfg: ModelConfig):
    if spec.kind != "mla":
        raise _queued(f"layer kind {spec.kind!r}")
    if spec.ffn not in ("glu", "moe", "none"):
        raise _queued(f"feed-forward {spec.ffn!r}")
    if cfg.kv_quant:
        raise _queued("the int8 KV cache (kv_quant)")
    if not cfg.embed_inputs or cfg.prefix_lm or cfg.num_output_heads != 1:
        raise _queued("embedded inputs, prefix-LM and multi-head outputs")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


def _layer_init(spec: LayerSpec, cfg: ModelConfig, device) -> Params:
    _check(spec, cfg)
    kw = {"dtype": cfg.param_dtype, "device": device}
    p = Params()
    p.add("ln1", (cfg.d_model,), None, **kw)
    p.add_module("attn", L.mla_init(cfg.d_model, cfg.n_heads, cfg.mla, **kw))
    if spec.ffn == "glu":
        p.add("ln2", (cfg.d_model,), None, **kw)
        p.add_module("ffn", L.mlp_init(cfg.d_model, cfg.d_ff, spec.ffn, **kw))
    elif spec.ffn == "moe":
        p.add("ln2", (cfg.d_model,), None, **kw)
        p.add_module("moe", M.moe_init(cfg.d_model, cfg.moe, **kw))
    return p


def _layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int, s_max: int,
                 dtype, device) -> dict:
    _check(spec, cfg)
    return L.mla_cache_init(batch, s_max, cfg.mla, dtype=dtype, device=device)


def _layer_apply(p, spec: LayerSpec, cfg: ModelConfig, x, *, mode, cache,
                 pos):
    aux = 0.0
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    h, new_cache = L.mla_apply(
        p["attn"], h, mode=mode, cache=cache, pos=pos, mla=cfg.mla,
        rope_theta=cfg.rope_theta)
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


def embed_lookup(table, tokens):
    """table [V, d], tokens [B, T] -> [B, T, d] (a gather)."""
    return F.embedding(tokens, table)


def model_skeleton(cfg: ModelConfig, device) -> Params:
    """The parameter module of `cfg` on `device`, uninitialised:
    "embed", "prefix"/"<i>", "periods"/"<p>"/"<i>", "final_norm",
    "head" [d, 1, V] (the reference's keys; its "periods" leaves are
    stacked on axis 0, here split by period)."""
    kw = {"dtype": cfg.param_dtype, "device": device}
    model = Params()
    model.add("embed", (cfg.padded_vocab, cfg.d_model), 0.02, **kw)
    if cfg.prefix_pattern:
        model.add_module("prefix", Children(
            _layer_init(s, cfg, device) for s in cfg.prefix_pattern))
    model.add_module("periods", Children(
        Children(_layer_init(s, cfg, device) for s in cfg.pattern)
        for _ in range(cfg.num_periods)))
    model.add("final_norm", (cfg.d_model,), None, **kw)
    if not cfg.tie_embeddings:
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


def forward(model, cfg: ModelConfig, inputs, *, mode: str, cache=None,
            pos=0):
    """inputs: tokens [B, T] -> (hidden [B, T, d], cache, aux loss sum).
    With a cache, each layer writes its positions pos.. in place."""
    x = embed_lookup(model["embed"], inputs)
    aux_total = 0.0
    for i, spec in enumerate(cfg.prefix_pattern):
        c = cache["prefix"][str(i)] if cache is not None else None
        x, _, aux = _layer_apply(model["prefix"][str(i)], spec, cfg, x,
                                 mode=mode, cache=c, pos=pos)
        aux_total = aux_total + aux
    for per in range(cfg.num_periods):
        pparams = model["periods"][str(per)]
        for i, spec in enumerate(cfg.pattern):
            c = None
            if cache is not None:
                c = {k: v[per] for k, v in cache["periods"][str(i)].items()}
            x, _, aux = _layer_apply(pparams[str(i)], spec, cfg, x,
                                     mode=mode, cache=c, pos=pos)
            aux_total = aux_total + aux
    x = L.rms_norm(x, model["final_norm"], cfg.norm_eps)
    return x, cache, aux_total


def _head_matrix(model, cfg: ModelConfig):
    if "head" in model:
        return model["head"]
    return model["embed"].T[:, None, :]                 # tied: [d, 1, V]


def compute_logits(model, cfg: ModelConfig, hidden):
    """hidden [B, T, d] -> logits [B, T, padded_V] float32; padded vocab
    columns are -inf so sampling / argmax never selects them."""
    head = _head_matrix(model, cfg)
    logits = torch.einsum("btd,dhv->bthv", hidden.float(), head.float())
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = float("-inf")
    return logits[:, :, 0]
