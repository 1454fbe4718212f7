"""paligemma-3b [vlm]: 18L d2048 8H (MQA kv=1) d_ff=16384 vocab=257216.

SigLIP + gemma [arXiv:2407.07726; hf]. The SigLIP frontend is a stub, as
in the reference: the inputs are patch and text embeddings [B, T, d], and
the first `prefix_len` positions (the image patches) attend
bidirectionally (prefix-LM). head_dim 256. Field for field the
reference's `repro/configs/paligemma_3b.py`.
"""

import dataclasses

import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216,
    pattern=(LayerSpec("attn", "glu"),), num_periods=18,
    act="gelu", embed_inputs=False, prefix_lm=True,
    family="vlm", param_dtype=torch.bfloat16)

REDUCED = dataclasses.replace(
    CONFIG, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256,
    vocab_size=512, num_periods=2,
    param_dtype=torch.float32, loss_chunk=16, block_q=16, block_k=32)
