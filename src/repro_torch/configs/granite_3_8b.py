"""granite-3-8b [dense]: 40L d4096 32H (GQA kv=8) d_ff=12800 vocab=49155.

GQA [hf:ibm-granite/granite-3.0-2b-base; hf], a SiLU-GLU llama-style
stack with the head tied to the embedding; the vocab pads to 49,408.
Field for field the reference's `repro/configs/granite_3_8b.py`.
"""

from repro_torch.configs.common import dense_lm, reduce_dense

CONFIG = dense_lm(
    "granite-3-8b", layers=40, d_model=4096, n_heads=32, n_kv=8,
    d_ff=12800, vocab=49155, head_dim=128, tie=True)

REDUCED = reduce_dense(CONFIG)
