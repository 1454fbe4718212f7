"""deepseek-v2-lite-16b [moe]: 27L d2048 16H d_ff(expert)=1408 vocab=102400.

MLA with kv_lora=512 (+64 rope dims), 2 shared + 64 routed experts top-6
[arXiv:2405.04434; hf]. Layer 0 is a dense GLU layer (d_ff 10944), layers
1..26 are MoE — a prefix layer + 26 periods. The MLA compressed cache
(576 values a token) is what decode reads. Field for field the
reference's `repro/configs/deepseek_v2_lite_16b.py`.
"""

import dataclasses

import torch

from repro_torch.models.layers import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", d_model=2048, n_heads=16, n_kv_heads=16,
    head_dim=192, d_ff=10944, vocab_size=102400,
    prefix_pattern=(LayerSpec("mla", "glu"),),
    pattern=(LayerSpec("mla", "moe"),), num_periods=26,
    mla=MLAConfig(kv_lora=512, qk_nope=128, qk_rope=64, v_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408, n_shared=2,
                  shared_d_ff=2816),
    rope_theta=1e4, family="moe", param_dtype=torch.bfloat16)

REDUCED = dataclasses.replace(
    CONFIG, d_model=128, n_heads=4, head_dim=48, d_ff=256, vocab_size=512,
    num_periods=2,
    mla=MLAConfig(kv_lora=32, qk_nope=32, qk_rope=16, v_dim=32),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=64, n_shared=1, shared_d_ff=64,
                  capacity_factor=8.0),
    param_dtype=torch.float32, loss_chunk=16, block_q=16, block_k=32)
