"""qwen3-14b [dense]: 40L d5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

qk_norm + GQA [hf:Qwen/Qwen3-8B; hf]. head_dim fixed at 128 (Qwen3
style). Field for field the reference's `repro/configs/qwen3_14b.py`.
"""

from repro_torch.configs.common import dense_lm, reduce_dense

CONFIG = dense_lm(
    "qwen3-14b", layers=40, d_model=5120, n_heads=40, n_kv=8,
    d_ff=17408, vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6)

REDUCED = reduce_dense(CONFIG)
