"""Exact brute-force top-K (paper Fig. 9 baseline; the ground truth).

A chunked scan with a running top-k merge: only [B, chunk] distance tiles
exist at once. Each chunk's k best come from a stable sort and are merged
with `merge_sorted` (ties keep the running list), so among equal
distances the lowest id wins, as in the reference. The reference computes
this in plain jnp outside any Pallas kernel; the product here is a plain
`torch.matmul` in float32 (TF32 must stay off for exact distances).

This is the exact backend's CPU path and plain version; on a card its l2
scan over 8-bit code rows is one fused kernel launch instead
(`api/backends.py` `_scan_route`), which answers bit for bit alike.
"""

from __future__ import annotations

import torch

from repro_torch.core.search import merge_sorted, metric_distance

__all__ = ["bruteforce_topk"]


def bruteforce_topk(vectors, sqnorms, queries, k: int = 10, chunk: int = 4096,
                    metric: str = "l2"):
    """Exact k smallest ids/distances for each query under `metric`.

    vectors: [N, D] float32 with N % chunk == 0; pad rows have sqnorm=+inf
             (the pad marker for every metric)
    queries: [B, D]
    returns: ids [B, k] int32, dists [B, k] float32
    """
    n = vectors.shape[0]
    if n % chunk:
        raise ValueError("pad the database to a multiple of `chunk`")
    queries = queries.float()
    b = queries.shape[0]
    qsq = (queries * queries).sum(-1)
    run_d = torch.full((b, k), float("inf"), device=queries.device)
    run_i = torch.full((b, k), -1, dtype=torch.int32, device=queries.device)
    for off in range(0, n, chunk):
        s = sqnorms[off:off + chunk]
        dot = queries @ vectors[off:off + chunk].float().T
        d2 = metric_distance(metric, dot, s[None, :], qsq[:, None])
        d2 = torch.where(torch.isinf(s)[None, :], float("inf"), d2)
        cd, ci = torch.sort(d2, dim=1, stable=True)
        cids = (ci[:, :k] + off).to(torch.int32)
        md, mi = merge_sorted(run_d, run_i, cd[:, :k], cids)
        run_d, run_i = md[:, :k], mi[:, :k]
    return run_i, run_d
