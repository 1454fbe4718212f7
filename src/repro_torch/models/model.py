"""Serving step functions over a `ModelConfig` (the reference's
`models/model.py`), for all ten of its architectures: `prefill_step`
fills the cache from a batch of prompts and returns the last position's
logits; `decode_step` runs one token against the cache. The cache (KV
positions, MLA's compressed latents, and the recurrent layers' conv and
scan state) is updated in place (the reference donates it). `train_step`
is queued (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import (
    ModelConfig,
    compute_logits,
    forward,
)

__all__ = ["ModelConfig", "decode_step", "prefill_step", "train_step"]


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


def train_step(*args, **kwargs):
    raise NotImplementedError("train_step (and adamw, and the backward "
                              "through the flash kernel) is not ported yet "
                              "(ROADMAP.md Queue 1)")
