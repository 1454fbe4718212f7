"""Peaks of the card and the operations and bytes of the exact scan.

The peaks are NVIDIA's data-sheet figures for one H100 SXM (80 GB HBM3)
at its full 700 W limit, dense rates without sparsity, as the port's
`launch/roofline.py` holds them; they are copied here so that a change
to the program cannot move the yardstick.
"""

from __future__ import annotations

__all__ = ["INT8_OPS", "HBM_BW", "scan_bound_s"]

INT8_OPS = 1979e12    # int8 tensor-core operations a second
HBM_BW = 3.35e12      # HBM bytes a second


def scan_bound_s(n: int, d: int, b: int, k: int) -> float:
    """The least time one exact k-NN request over n rows of d 8-bit
    components can take on the card: the larger of its 2*b*n*d operations
    at the int8 tensor-core rate (the fastest exact arithmetic for 8-bit
    codes) and its bytes at the HBM rate, each read once: the n*d rows and
    the b*d queries of a byte a component, and b*k outputs of 8 bytes (an
    int32 id and a float32 distance)."""
    ops = 2.0 * b * n * d
    nbytes = n * d + b * d + b * k * 8
    return max(ops / INT8_OPS, nbytes / HBM_BW)
