"""Public kernel entry points, dispatched on the tensors' device.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the kernel's plain PyTorch version. There is no fallback
from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels.traversal import (
    fused_traversal_cuda,
    fused_traversal_ref,
)

__all__ = ["fused_layer0"]


def fused_layer0(vectors, sqnorms, l0_nbrs, queries, qsq,
                 cand_d, cand_i, fin_d, fin_i, visited, hops, calcs, *,
                 fused_hops: int, max_hops: int, metric: str = "l2"):
    """One H-hop superstep of the layer-0 traversal over every lane, in
    place (kernels/traversal.py — the paper's Fig. 6 engine). The tables
    are partition-stacked [P, N_pad, ...]; the state has L = P*B rows."""
    kind = vectors.device.type
    fn = {"cuda": fused_traversal_cuda, "cpu": fused_traversal_ref}.get(kind)
    if fn is None:
        raise ValueError(f"fused_layer0: unsupported device {vectors.device}")
    return fn(vectors, sqnorms, l0_nbrs, queries, qsq,
              cand_d, cand_i, fin_d, fin_i, visited, hops, calcs,
              fused_hops=fused_hops, max_hops=max_hops, metric=metric)
