"""The dry run's input shapes (the reference's `configs/shapes.py`), as
meta tensors: shapes and dtypes, no storage.

train_4k    : train_step,   seq 4096,    global_batch 256
prefill_32k : prefill_step, seq 32768,   global_batch 32
decode_32k  : decode_step,  KV 32768,    global_batch 128
long_500k   : decode_step,  KV 524288,   global_batch 1   (sub-quadratic only)
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import ModelConfig, init_cache

__all__ = ["SHAPES", "ShapeCfg", "input_specs", "cache_spec", "shape_runnable"]


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}


def shape_runnable(cfg: ModelConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (SWA / SSM / hybrid)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention architecture — "
                       "unbounded KV at 512k context (see DESIGN.md)")
    return True, ""


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeCfg,
                act_dtype=torch.bfloat16) -> dict:
    """Inputs of this cell's step function, as meta tensors: train
    {"inputs", "labels"(, "prefix_len")}, prefill {"inputs"(,
    "prefix_len")}, decode {"tokens", "pos"}. Tokens and labels are int32;
    a config without embed_inputs takes [B, T, d] embeddings in
    `act_dtype`; 0-d entries are int32."""
    B, T = shape.batch, shape.seq
    if shape.kind == "decode":   # one new token against a seq-length cache
        tokens = (_meta((B, 1)) if cfg.embed_inputs
                  else _meta((B, 1, cfg.d_model), act_dtype))
        return {"tokens": tokens, "pos": _meta(())}
    inputs = (_meta((B, T)) if cfg.embed_inputs
              else _meta((B, T, cfg.d_model), act_dtype))
    batch = {"inputs": inputs}
    if shape.kind == "train":
        batch["labels"] = (_meta((B, T)) if cfg.num_output_heads == 1
                           else _meta((B, T, cfg.num_output_heads)))
    if cfg.prefix_lm:
        batch["prefix_len"] = _meta(())
    return batch


def cache_spec(cfg: ModelConfig, shape: ShapeCfg,
               dtype=torch.bfloat16) -> dict:
    """The KV / recurrent cache of this cell on the meta device."""
    return init_cache(cfg, shape.batch, shape.seq, dtype, device="meta")
