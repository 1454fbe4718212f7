"""dbrx-132b [moe]: 40L d6144 48H (GQA kv=8) d_ff(expert)=10752 vocab=100352.

16 experts top-4, fine-grained [hf:databricks/dbrx-base; unverified].
Field for field the reference's `repro/configs/dbrx_132b.py`.
"""

import dataclasses

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    pattern=(LayerSpec("attn", "moe"),), num_periods=40,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff=10752),
    rope_theta=5e5, family="moe", param_dtype=torch.bfloat16, grad_accum=8)

REDUCED = dataclasses.replace(
    CONFIG, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
    vocab_size=512, num_periods=2,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=64, capacity_factor=8.0),
    param_dtype=torch.float32, loss_chunk=16, block_q=16, block_k=32)
