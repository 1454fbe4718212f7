"""Configurations of the recurrent layer kinds (the reference's
`models/ssm.py`): Mamba-1 (Jamba's sequence mixer) and xLSTM's mLSTM /
sLSTM blocks, field for field.

Only the configurations are here, so that `launch/costmodel.py` can price
those layer kinds. The layers themselves are not ported yet (ROADMAP.md
Queue 1): `models/transformer.py` refuses a `mamba`, `mlstm` or `slstm`
layer.
"""

from __future__ import annotations

import dataclasses

__all__ = ["MambaConfig", "XLSTMConfig"]


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0      # 0 -> ceil(d_model / 16)
    chunk: int = 256

    def inner(self, d_model):
        return self.expand * d_model

    def rank(self, d_model):
        return self.dt_rank or -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    m_proj_factor: float = 2.0
    s_ffn_factor: float = 4.0 / 3.0
    d_conv: int = 4
    chunk: int = 256
