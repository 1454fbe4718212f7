"""xlstm-350m [ssm]: 24 blocks d1024 4H vocab=50304, mLSTM:sLSTM = 7:1.

sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]. Blocks carry their own
projections (d_ff=0 in the assignment): LayerSpec.ffn="none". Recurrent
state is O(1) in sequence length (state: C[B,H,dh,dh]). Field for field
the reference's `repro/configs/xlstm_350m.py`.
"""

import dataclasses

import torch

from repro_torch.models.ssm import XLSTMConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

_PERIOD = tuple([LayerSpec("mlstm", "none")] * 7 + [LayerSpec("slstm", "none")])

CONFIG = ModelConfig(
    name="xlstm-350m", d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    pattern=_PERIOD, num_periods=3,
    xlstm=XLSTMConfig(n_heads=4, m_proj_factor=2.0, d_conv=4, chunk=64),
    family="ssm", sub_quadratic=True, param_dtype=torch.bfloat16,
    tie_embeddings=True, grad_accum=2)

REDUCED = dataclasses.replace(
    CONFIG, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, vocab_size=512,
    num_periods=1,
    xlstm=XLSTMConfig(n_heads=2, m_proj_factor=2.0, d_conv=4, chunk=8),
    param_dtype=torch.float32, loss_chunk=16, block_q=16, block_k=32)
