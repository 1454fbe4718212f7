"""Batched stage-2 rerank (paper Fig. 4 stage 2).

The whole [B, C] candidate pool (C = P*K stage-1 intermediates) is
deduplicated, gathered and exactly re-scored in one call. Dedup sorts the
ids within each row — duplicates become adjacent and are masked to +inf —
which also makes the smallest id win among equal distances.
"""

from __future__ import annotations

import torch

from repro_torch.core.search import metric_distance

__all__ = ["batched_rerank"]


def batched_rerank(vectors, sqnorms, queries, cand_ids, k: int,
                   metric: str = "l2"):
    """Exact top-k over per-query candidate pools.

    vectors : [N, D] raw (metric-prepared) database vectors
    sqnorms : [N] ||x||^2 (only read for metric="l2")
    queries : [B, D]
    cand_ids: [B, C] int32 global ids; -1 marks empty slots
    returns : ids [B, k] int32 (-1 padded), dists [B, k] f32 (+inf padded)
    """
    ids_s = torch.sort(cand_ids, dim=1).values      # -1s first, dups adjacent
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    valid = (ids_s >= 0) & ~dup
    safe = ids_s.clamp_min(0).long()

    q = queries.float()
    qsq = (q * q).sum(-1)
    dot = (vectors[safe] * q[:, None, :]).sum(-1)   # [B, C]
    d = metric_distance(metric, dot, sqnorms[safe], qsq[:, None])
    d = torch.where(valid, d, float("inf"))

    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    out_d = d.gather(1, order)
    out_i = torch.where(torch.isfinite(out_d), ids_s.gather(1, order), -1)
    return out_i.to(torch.int32), out_d
