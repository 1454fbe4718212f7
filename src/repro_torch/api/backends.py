"""Backend registry: one search contract over the ported engines.

Every backend answers `search(queries, k, ef, rerank, with_stats)` over
metric-prepared queries and exposes `state_tree()` / `from_state()` for
versioned save/load, with the reference's leaf paths, so either package
loads an index the other saved:

  exact       : chunked brute-force scan (the ground truth); ignores ef
  hnsw        : one monolithic graph (partitioned with P=1)
  partitioned : the paper's two-stage engine — P sub-graphs, stage-2 merge,
                optional exact rerank

`distributed` and `csd` exist in the reference but are not ported yet:
asking for them raises NotImplementedError. Every backend holds its
tensors on one `device` (`cuda` unless the caller asked for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.rerank import batched_rerank
from repro_torch.api.types import IndexSpec, QueryStats
from repro_torch.core import hnsw_graph as hg
from repro_torch.core.bruteforce import bruteforce_topk
from repro_torch.core.partitioned import (
    PartitionedDB,
    build_partitioned_db,
    search_partitioned,
    search_partitioned_candidates,
)
from repro_torch.core.search import SearchParams

__all__ = ["register_backend", "get_backend", "available_backends",
           "ExactBackend", "HNSWBackend", "PartitionedBackend"]

_BACKENDS: dict[str, type] = {}
# in the reference, not yet in the port
_UNPORTED = ("distributed", "csd")


def register_backend(name: str):
    def deco(cls):
        cls.name = name
        _BACKENDS[name] = cls
        return cls
    return deco


def get_backend(name: str) -> type:
    if name in _UNPORTED:
        raise NotImplementedError(
            f"backend {name!r} is not yet ported; see ROADMAP.md")
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(_BACKENDS)}"
        ) from None


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def _float32_only(spec: IndexSpec) -> None:
    if spec.dtype != "float32":
        raise NotImplementedError(
            f"dtype={spec.dtype!r} (quantized storage) is not yet ported; "
            f"see ROADMAP.md")


def _device_vectors(vectors: np.ndarray, device):
    """Raw vectors + sqnorms on the device (rerank / exact scoring)."""
    v = torch.as_tensor(np.asarray(vectors, np.float32), device=device)
    return v, (v * v).sum(-1)


# ---------------------------------------------------------------------------
# exact
# ---------------------------------------------------------------------------


@register_backend("exact")
class ExactBackend:
    """Chunked exact scan; the ground-truth engine and the Fig. 9 baseline."""

    uses_graph = False
    CHUNK = 512

    def __init__(self, spec: IndexSpec, raw: np.ndarray, device):
        _float32_only(spec)
        self.spec = spec
        self.device = torch.device(device)
        self.raw = np.asarray(raw, np.float32)
        n, d = self.raw.shape
        n_pad = ((n + self.CHUNK - 1) // self.CHUNK) * self.CHUNK
        vp = np.zeros((n_pad, d), np.float32)
        vp[:n] = self.raw
        sq = np.full(n_pad, np.inf, np.float32)   # +inf == pad marker
        sq[:n] = np.einsum("nd,nd->n", self.raw, self.raw)
        self.vectors = torch.as_tensor(vp, device=self.device)
        self.sqnorms = torch.as_tensor(sq, device=self.device)
        self.n = n

    @classmethod
    def build(cls, vectors: np.ndarray, spec: IndexSpec, device):
        return cls(spec, vectors, device)

    def search(self, queries, k: int, ef: int, rerank: bool,
               with_stats: bool):
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        ids, dists = bruteforce_topk(self.vectors, self.sqnorms, q, k=k,
                                     chunk=self.CHUNK, metric=self.spec.metric)
        stats = None
        if with_stats:
            stats = QueryStats(dist_calcs=torch.full(
                (ids.shape[0],), self.n, dtype=torch.int32,
                device=self.device))
        return ids, dists, stats

    def state_tree(self) -> dict:
        return {"exact": {"raw": self.raw},
                "meta": {"n": np.int32(self.n),
                         "dim": np.int32(self.raw.shape[1])}}

    @classmethod
    def from_state(cls, spec: IndexSpec, leaves: dict, device):
        return cls(spec, leaves["exact/raw"], device)


# ---------------------------------------------------------------------------
# partitioned (and its P=1 alias, hnsw)
# ---------------------------------------------------------------------------


@register_backend("partitioned")
class PartitionedBackend:
    """The paper's engine: P device-resident sub-graphs searched as P*B
    lanes of one traversal, the stage-2 merge, optional exact rerank over
    the P*K intermediates."""

    uses_graph = True
    forced_partitions: int | None = None

    def __init__(self, spec: IndexSpec, pdb: PartitionedDB,
                 raw: np.ndarray | None, device):
        _float32_only(spec)
        self.spec = spec
        self.device = torch.device(device)
        self.pdb = pdb._replace(db=hg.device_db(pdb.db, self.device))
        self.raw = None if raw is None else np.asarray(raw, np.float32)
        if self.raw is not None:
            self.dev_vectors, self.dev_sqnorms = _device_vectors(
                self.raw, self.device)
        else:
            self.dev_vectors = self.dev_sqnorms = None

    @classmethod
    def build(cls, vectors: np.ndarray, spec: IndexSpec, device):
        _float32_only(spec)
        p = cls.forced_partitions or spec.num_partitions
        pdb = build_partitioned_db(vectors, p, spec.hnsw)
        return cls(spec, pdb, vectors if spec.keep_vectors else None, device)

    def params(self, k: int, ef: int) -> SearchParams:
        return SearchParams(ef=ef, k=k, metric=self.spec.metric,
                            fused_hops=self.spec.fused_hops)

    def search(self, queries, k: int, ef: int, rerank: bool,
               with_stats: bool):
        p = self.params(k, ef)
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if rerank:
            if self.dev_vectors is None:
                raise ValueError(
                    "rerank=True needs the raw vectors: build the index "
                    "with IndexSpec(keep_vectors=True)")
            cand, _, st = search_partitioned_candidates(self.pdb, q, p)
            ids, dists = batched_rerank(self.dev_vectors, self.dev_sqnorms,
                                        q, cand, k, self.spec.metric)
        else:
            ids, dists, st = search_partitioned(self.pdb, q, p)
        stats = None
        if with_stats:
            stats = QueryStats(hops=st.hops.sum(0, dtype=torch.int32),
                               dist_calcs=st.dist_calcs.sum(
                                   0, dtype=torch.int32))
        return ids, dists, stats

    def state_tree(self) -> dict:
        tree = {"db": {f: t.cpu().numpy()
                       for f, t in self.pdb.db._asdict().items()},
                "meta": {"num_partitions": np.int32(self.pdb.num_partitions),
                         "dim": np.int32(self.pdb.dim)}}
        if self.raw is not None:
            tree["vectors"] = {"raw": self.raw}
        return tree

    @classmethod
    def from_state(cls, spec: IndexSpec, leaves: dict, device):
        """Rebuild from the {leaf-path: np.ndarray} dict of a checkpoint
        step — the port's or the reference's (`read_step_leaves`)."""
        db = hg.DeviceDB(**{k.split("/", 1)[1]: np.asarray(v)
                            for k, v in leaves.items()
                            if k.startswith("db/")})
        pdb = PartitionedDB(db=db,
                            num_partitions=int(leaves["meta/num_partitions"]),
                            dim=int(leaves["meta/dim"]))
        return cls(spec, pdb, leaves.get("vectors/raw"), device)


@register_backend("hnsw")
class HNSWBackend(PartitionedBackend):
    """Single monolithic graph — partitioned with exactly one partition."""

    forced_partitions = 1
