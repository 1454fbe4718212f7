"""repro_torch — the PyTorch / CUDA port of the partitioned HNSW engine.

The JAX package `repro` is the reference; this package re-implements its
`exact` / `hnsw` / `partitioned` / `csd` search paths, its telemetry core
and its DeepSeek-V2-Lite serving path in PyTorch, with every Pallas
kernel of the reference rewritten by hand for Hopper (`kernels/csrc/`).
It imports `torch` and numpy only — never `jax`, and nothing from
`repro`.

Entry points run on the card unless the caller asks for the CPU:
`resolve_device(None)` is `cuda` and raises when no CUDA device is
visible; `device="cpu"` must be passed explicitly (the tests do), and so
must `device="meta"` (shapes and dtypes without storage, what the dry
run builds its state on).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means the card.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and `torch.cuda.is_available()` is False — there is no silent fallback
    to the CPU. "meta" is accepted only when passed explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or "
                         f"'meta'")
    return dev
