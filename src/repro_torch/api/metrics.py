"""Metric registry: the one place that knows what each metric needs.

HNSW is metric-agnostic (Malkov & Yashunin 2016) — the traversal only ever
compares distances. Each registered metric states how the raw data and the
queries must be preprocessed at the edge, and the kernels
(core/search.py, core/bruteforce.py, kernels/l2dist.py) receive the metric
name and evaluate the matching distance-from-dot-product form:

  l2     : ||x||^2 - 2 x.q + ||q||^2       (the paper's metric)
  ip     : -x.q                            (MIPS as a minimization)
  cosine : 1 - x.q over unit-norm inputs   (so graph build == L2 on the
                                            normalized vectors; ranking is
                                            identical, values are 1 - cos)

Register a new metric with `register_metric` to make it available to the
spec/ground-truth machinery; the search code additionally needs a matching
branch in `core.search.metric_distance` and in the traversal kernel.

A numpy copy of the reference package's registry: the same names, the same
edge preprocessing, the same ground-truth helper.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

__all__ = ["Metric", "register_metric", "get_metric", "available_metrics",
           "exact_topk_np"]


def _l2_from_dot(dot, xsq, qsq):
    return xsq - 2.0 * dot + qsq


def _ip_from_dot(dot, xsq, qsq):
    return -dot


def _cos_from_dot(dot, xsq, qsq):
    return 1.0 - dot                             # unit-norm inputs


@dataclasses.dataclass(frozen=True)
class Metric:
    """name is what IndexSpec.metric / SearchParams.metric carry; the
    normalize flags are applied once at the build/search edge; dist_from_dot
    maps (q.x, ||x||^2, ||q||^2) to the distance being minimized.

    graph_safe: whether an L2-built HNSW graph searches correctly under
    this metric. True for l2 and cosine (normalization makes the L2 build
    equivalent); False for raw inner product, where the MIPS winners
    (large-norm points) need not be L2 neighbors of the query — graph
    backends reject such metrics at build time."""

    name: str
    dist_from_dot: Callable
    normalize_data: bool = False
    normalize_queries: bool = False
    graph_safe: bool = True

    def prepare_data(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        return _unit(vectors) if self.normalize_data else vectors

    def prepare_queries(self, queries: np.ndarray) -> np.ndarray:
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        return _unit(queries) if self.normalize_queries else queries

    def pairwise_np(self, queries: np.ndarray, vectors: np.ndarray) -> np.ndarray:
        """Reference distance matrix [B, N] (numpy; for ground truth)."""
        q = self.prepare_queries(queries)
        x = self.prepare_data(vectors)
        return self.dist_from_dot(
            q @ x.T,
            np.einsum("nd,nd->n", x, x)[None],
            np.einsum("bd,bd->b", q, q)[:, None])


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


_REGISTRY: dict[str, Metric] = {}


def register_metric(metric: Metric) -> Metric:
    _REGISTRY[metric.name] = metric
    return metric


def get_metric(name: str) -> Metric:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_metrics() -> list[str]:
    return sorted(_REGISTRY)


register_metric(Metric("l2", _l2_from_dot))
register_metric(Metric("ip", _ip_from_dot, graph_safe=False))
register_metric(Metric("cosine", _cos_from_dot,
                       normalize_data=True, normalize_queries=True))


def exact_topk_np(metric_name: str, vectors: np.ndarray, queries: np.ndarray,
                  k: int) -> np.ndarray:
    """Exact top-k ids under a metric (numpy; test/ground-truth helper)."""
    d = get_metric(metric_name).pairwise_np(queries, vectors)
    return np.argsort(d, axis=1, kind="stable")[:, :k]
