"""The plain reference: exact k nearest neighbours by squared L2.

Plain PyTorch in float64 on whatever device it is given. It imports
nothing of the program and takes only the rows and queries that the
benchmark made. Every product and sum of 8-bit rows is an integer below
2**53, so float64 gives each distance exactly, in any order of summation.

Ties: among equal distances the lowest row id comes first. Each candidate
is keyed `distance * n + id`, which is exact in float64 for n up to about
10**9 rows of 128 bytes, and the k smallest keys are taken.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["exact_topk", "exact_dists", "quantized_topk"]


def _as_f64(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device).double()


def exact_topk(base: np.ndarray, queries: np.ndarray, k: int, device, *,
               q_block: int = 2048, x_block: int = 65536):
    """ids [Q, k] int64 and distances [Q, k] int64 of the k nearest rows
    of `base` [N, D] for every row of `queries` [Q, D], both integer
    arrays (numpy)."""
    n = base.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} rows")
    x = _as_f64(base, device)
    xsq = (x * x).sum(1)
    out_i = np.empty((queries.shape[0], k), np.int64)
    out_d = np.empty((queries.shape[0], k), np.int64)
    for q0 in range(0, queries.shape[0], q_block):
        q = _as_f64(queries[q0:q0 + q_block], device)
        qsq = (q * q).sum(1)
        best = None
        for x0 in range(0, n, x_block):
            xb = x[x0:x0 + x_block]
            d = qsq[:, None] + xsq[None, x0:x0 + x_block] - 2.0 * (q @ xb.T)
            ids = torch.arange(x0, x0 + xb.shape[0], device=d.device,
                               dtype=torch.float64)
            key = d * float(n) + ids[None, :]
            kb = min(k, xb.shape[0])
            top = torch.topk(key, kb, dim=1, largest=False).values
            best = top if best is None else torch.topk(
                torch.cat([best, top], 1), k, dim=1, largest=False).values
        key = best.to(torch.int64).cpu().numpy()
        out_i[q0:q0 + q_block] = key % n
        out_d[q0:q0 + q_block] = key // n
    return out_i, out_d


def exact_dists(base: np.ndarray, queries: np.ndarray, ids: np.ndarray,
                device, *, q_block: int = 8192) -> np.ndarray:
    """Exact squared L2 [Q, k] float64 between each query and the rows
    `ids` [Q, k] names; NaN where an id names no row."""
    n = base.shape[0]
    x = torch.as_tensor(np.ascontiguousarray(base), device=device)
    out = np.empty(ids.shape, np.float64)
    for q0 in range(0, ids.shape[0], q_block):
        i = torch.as_tensor(ids[q0:q0 + q_block].astype(np.int64),
                            device=device)
        ok = (i >= 0) & (i < n)
        rows = x[i.clamp(0, n - 1)].to(torch.int64)
        q = torch.as_tensor(np.ascontiguousarray(queries[q0:q0 + q_block]),
                            device=device).to(torch.int64)
        diff = rows - q[:, None, :]
        d = (diff * diff).sum(-1).double()
        out[q0:q0 + q_block] = torch.where(ok, d, float("nan")).cpu().numpy()
    return out


def quantized_topk(base: np.ndarray, queries: np.ndarray, k: int, device, *,
                   bits: int):
    """The reference computed on `bits`-bit codes instead of the 8-bit
    rows: rows and queries rounded to codes of scale 255 / (2**bits - 1),
    the exact top-k in code space, distances rescaled to real space
    (float32). The control that a comparison has to fail."""
    scale = 255.0 / (2 ** bits - 1)

    def encode(a):
        return np.rint(a.astype(np.float32) / scale).astype(np.int16)

    ids, d = exact_topk(encode(base), encode(queries), k, device)
    return ids, (d * scale * scale).astype(np.float32)
