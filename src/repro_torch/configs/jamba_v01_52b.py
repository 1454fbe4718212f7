"""jamba-v0.1-52b [hybrid]: 32L d4096 32H (GQA kv=8) vocab=65536, MoE 16e top-2.

Mamba+attention 1:7 interleave with MoE every other layer
[arXiv:2403.19887; hf]. Period of 8: attention at index 4, mamba elsewhere;
odd indices are MoE (16 experts top-2, d_ff 14336), even are dense GLU.
Only 4/32 layers hold a KV cache and mamba state is O(1) in the sequence.
Field for field the reference's `repro/configs/jamba_v01_52b.py`.
"""

import dataclasses

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import MambaConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

_PERIOD = tuple(
    LayerSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "glu")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=65536,
    pattern=_PERIOD, num_periods=4,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=64),
    family="hybrid", sub_quadratic=True, param_dtype=torch.bfloat16,
    grad_accum=16)

REDUCED = dataclasses.replace(
    CONFIG, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
    vocab_size=512, num_periods=1,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=64, capacity_factor=8.0),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk=8),
    param_dtype=torch.float32, loss_chunk=16, block_q=16, block_k=32)
