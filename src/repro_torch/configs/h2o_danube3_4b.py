"""h2o-danube-3-4b [dense]: 24L d3840 32H (GQA kv=8) d_ff=10240 vocab=32000.

llama + mistral with sliding-window attention [arXiv:2401.16818;
unverified]: every layer attends over a window of 4,096, so the decode
cache is a ring buffer of the window. head_dim = 3840 / 32 = 120. Field
for field the reference's `repro/configs/h2o_danube3_4b.py`.
"""

from repro_torch.configs.common import dense_lm, reduce_dense

CONFIG = dense_lm(
    "h2o-danube3-4b", layers=24, d_model=3840, n_heads=32, n_kv=8,
    d_ff=10240, vocab=32000, head_dim=120, window=4096,
    rope_theta=5e5, sub_quadratic=True)

REDUCED = reduce_dense(CONFIG, window=8)
