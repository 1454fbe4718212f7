"""minitron-8b [dense]: 32L d4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Pruned Nemotron [arXiv:2407.14679; hf]: a non-gated squared-ReLU MLP.
Field for field the reference's `repro/configs/minitron_8b.py`.
"""

from repro_torch.configs.common import dense_lm, reduce_dense

CONFIG = dense_lm(
    "minitron-8b", layers=32, d_model=4096, n_heads=32, n_kv=8,
    d_ff=16384, vocab=256000, head_dim=128, ffn="dense", act="relu2")

REDUCED = reduce_dense(CONFIG)
