"""Step functions over a `ModelConfig` (the reference's `models/model.py`),
for all ten of its architectures:

  * train_step   — forward + chunked-vocab loss + backward + AdamW, with
                   gradient accumulation over microbatches;
  * prefill_step — fill the cache from a batch of prompts, return the last
                   position's logits;
  * decode_step  — one token against the cache.

The cache (KV positions, MLA's compressed latents, and the recurrent
layers' conv and scan state) and the train state are updated in place
(the reference donates them). A train state is {"params": the parameter
module (requires_grad on), "opt": {"m", "v": name -> float32 tensor,
"step": 0-d int32}} (`models/params.py` converts it to and from the
reference's layout).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import shard_ctx
from repro_torch.models.params import reference_order
from repro_torch.models.transformer import (
    ModelConfig,
    chunked_xent,
    compute_logits,
    forward,
    init_params,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["ModelConfig", "decode_step", "loss_fn", "make_train_state",
           "prefill_step", "train_step"]


def make_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None, *,
                     device=None, generator: torch.Generator | None = None
                     ) -> dict:
    """{"params": `init_params(cfg)` with requires_grad on, "opt":
    `adamw_init`} on `device` (default: the card; raises without one),
    drawn from `generator` (default: seed 0)."""
    model = init_params(cfg, device=device, generator=generator)
    model.requires_grad_(True)
    return {"params": model, "opt": adamw_init(model)}


def loss_fn(model, cfg: ModelConfig, batch: dict):
    """(xent + 0.01 aux, {"xent", "aux"}) of a batch {"inputs": tokens [B,
    T] or embeddings [B, T, d], "labels": [B, T] or [B, T, heads],
    optional "mask", optional "prefix_len"}."""
    hidden, _, aux = forward(model, cfg, batch["inputs"], mode="train",
                             prefix_len=batch.get("prefix_len"))
    loss = chunked_xent(model, cfg, hidden, batch["labels"],
                        mask=batch.get("mask"))
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


def train_step(state: dict, batch: dict, cfg: ModelConfig,
               opt_cfg: AdamWConfig):
    """One optimizer step on `batch` (tensors on the parameters' device;
    a 0-d entry such as prefix_len an int) -> (state, metrics {"loss",
    "xent", "aux", "grad_norm", "lr"}: 0-d tensors). The batch is split
    into M = gcd(grad_accum, B) microbatches of consecutive rows, M halved
    while a microbatch's rows are not a multiple of the data-parallel
    extent (`shard_ctx.dp_size()`, 1 with no sharding context); each
    microbatch's gradients are cast to float32, divided by M and added in
    microbatch order (the reference's accumulator); loss and metrics are
    the microbatches' means. The parameters, m, v and step are updated in
    place of the state's."""
    model = state["params"]
    named = dict(model.named_parameters())
    names = reference_order(named)
    params = [named[n] for n in names]
    if not all(p.requires_grad for p in params):
        raise ValueError("train_step: the parameters must require grad "
                         "(make_train_state / train_state_from_reference)")
    arrays = {k: v for k, v in batch.items()
              if isinstance(v, torch.Tensor) and v.dim() > 0}
    B = next(iter(arrays.values())).shape[0]
    M = math.gcd(max(cfg.grad_accum, 1), B)
    dpn = shard_ctx.dp_size()
    while M > 1 and (B // M) % dpn != 0:
        M //= 2
    if M == 1:
        loss, metrics = _loss_and_grads(model, cfg, batch, params)
        grads = metrics.pop("grads")
    else:
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params]
        losses, mets = [], []
        for i in range(M):
            rows = slice(i * (B // M), (i + 1) * (B // M))
            mb = {k: (v[rows] if k in arrays else v)
                  for k, v in batch.items()}
            loss_i, met = _loss_and_grads(model, cfg, mb, params)
            for a, g in zip(grads, met.pop("grads")):
                a.add_(g.float() / M)
            losses.append(loss_i)
            mets.append(met)
        loss = torch.stack(losses).mean()
        metrics = {k: torch.stack([m[k] for m in mets]).mean()
                   for k in mets[0]}
    with torch.profiler.record_function("train.optimizer"), torch.no_grad():
        _, _, opt_metrics = adamw_update(
            opt_cfg, dict(zip(names, params)), dict(zip(names, grads)),
            state["opt"])
    return state, {"loss": loss.detach(), **metrics, **opt_metrics}


def _loss_and_grads(model, cfg: ModelConfig, batch: dict, params):
    """(loss, {"xent", "aux", "grads": one per parameter}) of one
    microbatch. The forward runs in the range "train.forward" (the
    backward runs on autograd's device thread on the card, outside any
    range of this thread)."""
    with torch.profiler.record_function("train.forward"):
        loss, metrics = loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), {"xent": metrics["xent"].detach(),
                           "aux": metrics["aux"].detach(), "grads": grads}


@torch.no_grad()
def prefill_step(model, batch, cache, cfg: ModelConfig):
    """Fill the cache with batch["inputs"] ([B, T] token ids, or [B, T, d]
    embeddings for a config without embed_inputs) at positions 0..T-1,
    with batch["prefix_len"] as the bidirectional prefix of a prefix-LM
    config; returns (logits [B, 1, (heads,) padded_V] float32 of the last
    position, cache)."""
    hidden, cache, _ = forward(model, cfg, batch["inputs"], mode="prefill",
                               cache=cache, pos=0,
                               prefix_len=batch.get("prefix_len"))
    return compute_logits(model, cfg, hidden[:, -1:]), cache


@torch.no_grad()
def decode_step(model, tokens, cache, pos, cfg: ModelConfig):
    """One decode step: tokens [B, 1] (or embeddings [B, 1, d]) at position
    `pos` (an int or a 0-d tensor); returns (logits [B, 1, (heads,)
    padded_V] float32, cache)."""
    hidden, cache, _ = forward(model, cfg, tokens, mode="decode",
                               cache=cache, pos=int(pos))
    return compute_logits(model, cfg, hidden), cache
