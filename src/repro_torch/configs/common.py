"""Shared helpers of the architecture config modules (the reference's
`repro/configs/common.py`)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig

__all__ = ["LayerSpec", "ModelConfig", "dense_lm", "reduce_dense"]


def dense_lm(name, *, layers, d_model, n_heads, n_kv, d_ff, vocab,
             head_dim=None, ffn="glu", act="silu", qk_norm=False, window=0,
             rope_theta=1e4, tie=False, family="dense", sub_quadratic=False,
             dtype=torch.bfloat16, **kw):
    head_dim = head_dim or d_model // n_heads
    return ModelConfig(
        name=name, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=head_dim, d_ff=d_ff, vocab_size=vocab,
        pattern=(LayerSpec("attn", ffn, window),), num_periods=layers,
        qk_norm=qk_norm, act=act, rope_theta=rope_theta, tie_embeddings=tie,
        family=family, sub_quadratic=sub_quadratic, param_dtype=dtype, **kw)


def reduce_dense(full: ModelConfig, *, layers=4, d_model=128, n_heads=4,
                 n_kv=2, head_dim=32, d_ff=256, vocab=512, window=0, **kw):
    """Structure-preserving shrink for CPU tests."""
    pat = tuple(
        dataclasses.replace(s, window=(window or (8 if s.window else 0)))
        for s in full.pattern)
    return dataclasses.replace(
        full, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=head_dim, d_ff=d_ff, vocab_size=vocab, pattern=pat,
        num_periods=layers, param_dtype=torch.float32, loss_chunk=16,
        block_q=16, block_k=32, **kw)
