"""Deterministic synthetic vector data (numpy).

A copy of the vector half of the reference's data pipeline: the output is
byte-identical for the same arguments, so both packages index the same
data. Vectors mirror SIFT's statistics (128-dim uint8-range features,
clustered) so recall numbers are meaningful without the dataset download.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["VectorDataset", "clustered_vectors", "sift_like_vectors"]


@dataclasses.dataclass
class VectorDataset:
    """Clustered feature vectors (SIFT-like)."""

    n: int
    dim: int = 128
    n_clusters: int = 64
    seed: int = 0

    def vectors(self) -> np.ndarray:
        return clustered_vectors(self.n, self.dim, self.n_clusters, self.seed)

    def queries(self, n_q: int, seed: int = 1) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, seed]))
        centers = _centers(self.n_clusters, self.dim, self.seed)
        idx = rng.integers(0, self.n_clusters, n_q)
        return (centers[idx] + rng.normal(scale=12.0, size=(n_q, self.dim))
                ).astype(np.float32)


def _centers(k: int, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC]))
    return rng.uniform(0, 218, size=(k, dim)).astype(np.float32)


def clustered_vectors(n: int, dim: int = 128, k: int = 64, seed: int = 0):
    """SIFT-like: non-negative, bounded [0, 255], clustered."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    centers = _centers(k, dim, seed)
    idx = rng.integers(0, k, n)
    out = centers[idx] + rng.normal(scale=12.0, size=(n, dim))
    return np.clip(out, 0, 255).astype(np.float32)


def sift_like_vectors(n: int, seed: int = 0) -> np.ndarray:
    return clustered_vectors(n, 128, max(8, n // 2000), seed)
