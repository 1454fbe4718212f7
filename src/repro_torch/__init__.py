"""repro_torch — the PyTorch / CUDA port of the partitioned HNSW engine.

The JAX package `repro` is the reference; this package re-implements its
float32 `exact` / `hnsw` / `partitioned` search path in PyTorch, with the
layer-0 beam traversal as a hand-written CUDA kernel for Hopper
(`kernels/csrc/traversal.cu`). It imports `torch` and numpy only — never
`jax`, and nothing from `repro`.

Entry points run on the card unless the caller asks for the CPU:
`resolve_device(None)` is `cuda` and raises when no CUDA device is
visible; `device="cpu"` must be passed explicitly (the tests do).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means the card.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and `torch.cuda.is_available()` is False — there is no silent fallback
    to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
