"""musicgen-large [audio]: 48L d2048 32H (MHA kv=32) d_ff=8192 vocab=2048.

Decoder-only over EnCodec tokens [arXiv:2306.05284; hf]. The EnCodec
frontend is a stub, as in the reference: the inputs are frame
embeddings [B, T, d], the output 4 codebook heads of vocab 2,048 each.
A non-gated GELU MLP; an int8 KV cache. Field for field the reference's
`repro/configs/musicgen_large.py`.
"""

import dataclasses

import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", d_model=2048, n_heads=32, n_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=2048,
    pattern=(LayerSpec("attn", "dense"),), num_periods=48,
    act="gelu", embed_inputs=False, num_output_heads=4,
    family="audio", param_dtype=torch.bfloat16, kv_quant=True)

REDUCED = dataclasses.replace(
    CONFIG, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
    vocab_size=512, num_periods=2,
    param_dtype=torch.float32, loss_chunk=16, block_q=16, block_k=32,
    kv_quant=False)
