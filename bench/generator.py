"""Inputs of a run, made from `--seed`: the base rows and the query pool.

The rows are a frozen copy of the port's SIFT-like generator
(`repro_torch.data.pipeline.sift_like_vectors`: clustered, non-negative,
clipped to [0, 255]) rounded to the nearest integer, which is what
BIGANN's uint8 rows are. The copy is kept here so that a later change to
the program cannot change the yardstick; a test holds it byte for byte
to the program's generator at small sizes.

The queries come from the same distribution (the same cluster centres,
their own random stream), as the BIGANN query set comes from the same
descriptor extractor as its base set. The pool is `pool_requests`
slices of `queries_per_request` rows; request i of a run serves slice
i % pool_requests, so every seed gives the same sizes in the same order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["clustered_vectors", "sift_like_vectors", "base_rows",
           "query_pool"]


def _centers(k: int, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC]))
    return rng.uniform(0, 218, size=(k, dim)).astype(np.float32)


def clustered_vectors(n: int, dim: int = 128, k: int = 64, seed: int = 0):
    """SIFT-like: non-negative, bounded [0, 255], clustered (float32)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    centers = _centers(k, dim, seed)
    idx = rng.integers(0, k, n)
    out = centers[idx] + rng.normal(scale=12.0, size=(n, dim))
    return np.clip(out, 0, 255).astype(np.float32)


def sift_like_vectors(n: int, seed: int = 0) -> np.ndarray:
    return clustered_vectors(n, 128, _clusters(n), seed)


def _clusters(n: int) -> int:
    return max(8, n // 2000)


def base_rows(n: int, seed: int) -> np.ndarray:
    """The [n, 128] uint8 base set of seed `seed`."""
    return np.rint(sift_like_vectors(n, seed)).astype(np.uint8)


def query_pool(n_base: int, pool_requests: int, queries_per_request: int,
               seed: int) -> np.ndarray:
    """[pool_requests, queries_per_request, 128] uint8 queries around the
    cluster centres of the base set of `n_base` rows of seed `seed`."""
    k = _clusters(n_base)
    n_q = pool_requests * queries_per_request
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    centers = _centers(k, 128, seed)
    idx = rng.integers(0, k, n_q)
    q = centers[idx] + rng.normal(scale=12.0, size=(n_q, 128))
    q = np.rint(np.clip(q, 0, 255)).astype(np.uint8)
    return q.reshape(pool_requests, queries_per_request, 128)
