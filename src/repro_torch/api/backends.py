"""Backend registry: one search contract over the ported engines.

Every backend answers `search(queries, k, ef, rerank, with_stats)` over
metric-prepared queries and exposes `state_tree()` / `from_state()` for
versioned save/load, with the reference's leaf paths, so either package
loads an index the other saved:

  exact       : chunked brute-force scan (the ground truth); ignores ef
  hnsw        : one monolithic graph (partitioned with P=1)
  partitioned : the paper's two-stage engine — P sub-graphs, stage-2 merge,
                optional exact rerank
  csd         : out-of-core over the block store (repro_torch.store) — the
                paper's computational-storage platform

Every backend serves float32, scalar-quantized (uint8 / int8) and
product-quantized (`pq`) rows, as `IndexSpec.dtype` says. `distributed`
exists in the reference but is not ported yet: asking for it raises
NotImplementedError. Every backend holds its tensors on one `device`
(`cuda` unless the caller asked for the CPU).
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
    quantize_db_vectors,
    search_partitioned,
    search_partitioned_candidates,
)
from repro_torch.core.search import SearchParams
from repro_torch.kernels.ops import pq_topk
from repro_torch.optim.compression import build_pq_lut

__all__ = ["register_backend", "get_backend", "available_backends",
           "CSDBackend", "ExactBackend", "HNSWBackend",
           "PartitionedBackend"]

_BACKENDS: dict[str, type] = {}
# in the reference, not yet in the port
_UNPORTED = ("distributed",)


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


def _device_vectors(vectors: np.ndarray, device):
    """Raw vectors + sqnorms on the device (rerank / exact scoring)."""
    v = torch.as_tensor(np.asarray(vectors, np.float32), device=device)
    return v, (v * v).sum(-1)


# ---------------------------------------------------------------------------
# exact
# ---------------------------------------------------------------------------


@register_backend("exact")
class ExactBackend:
    """Chunked exact scan; the ground-truth engine and the Fig. 9 baseline.

    uint8/int8: `raw` is the code table, scanned as is (exact: integer
    dot products below 2^24), and distances are rescaled by scale**2.
    pq: `raw` is the float32 rows (build) or the [n, M] code table
    (checkpoint); the scan is the fused ADC top-k over the codes."""

    uses_graph = False
    CHUNK = 512

    def __init__(self, spec: IndexSpec, raw: np.ndarray, device):
        self.spec = spec
        self.device = torch.device(device)
        self.quant = spec.quantizer()
        self.is_pq = spec.dtype == "pq"
        raw = np.asarray(raw)
        if self.is_pq:
            if raw.dtype != np.uint8 or raw.shape[-1] != self.quant.m:
                raw = self.quant.encode(np.asarray(raw, np.float32))
            self.raw = raw
            self.codes = torch.as_tensor(raw, device=self.device)
            self.codebooks = torch.as_tensor(self.quant.codebooks,
                                             device=self.device)
            self.n = raw.shape[0]
            self.vectors = self.sqnorms = None
            return
        if self.quant is None:
            raw = raw.astype(np.float32, copy=False)
        self.raw = raw
        n, d = self.raw.shape
        n_pad = ((n + self.CHUNK - 1) // self.CHUNK) * self.CHUNK
        vp = np.zeros((n_pad, d), self.raw.dtype)
        vp[:n] = self.raw
        rf = self.raw.astype(np.float32)
        sq = np.full(n_pad, np.inf, np.float32)   # +inf == pad marker
        sq[:n] = np.einsum("nd,nd->n", rf, rf)
        self.vectors = torch.as_tensor(vp, device=self.device)
        self.sqnorms = torch.as_tensor(sq, device=self.device)
        self.n = n

    @classmethod
    def build(cls, vectors: np.ndarray, spec: IndexSpec, device):
        return cls(spec, vectors, device)

    def search(self, queries, k: int, ef: int, rerank: bool,
               with_stats: bool):
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if self.is_pq:
            dists, ids = pq_topk(build_pq_lut(q, self.codebooks), self.codes,
                                 k=k)
        else:
            ids, dists = bruteforce_topk(self.vectors, self.sqnorms, q, k=k,
                                         chunk=self.CHUNK,
                                         metric=self.spec.metric)
            if self.quant is not None:    # code space -> real space
                dists = dists * float(np.float32(self.quant.dist_scale))
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
    the P*K intermediates.

    uint8/int8: the DB holds code rows and the queries arrive as codes;
    distances are rescaled by scale**2 after the merge, and rerank
    re-scores over the DEQUANTIZED rows (stage 2 stays float32). pq: the
    DB holds [N_pad, M] code rows searched through per-query LUTs, and
    `raw` is the TRUE float32 rows — re-scoring decoded PQ rows would
    change nothing, since ADC already is the distance to the
    reconstruction."""

    uses_graph = True
    forced_partitions: int | None = None

    def __init__(self, spec: IndexSpec, pdb: PartitionedDB,
                 raw: np.ndarray | None, device):
        self.spec = spec
        self.device = torch.device(device)
        self.quant = spec.quantizer()
        self.is_pq = spec.dtype == "pq"
        self.pdb = pdb._replace(db=hg.device_db(pdb.db, self.device))
        self.codebooks = (torch.as_tensor(self.quant.codebooks,
                                          device=self.device)
                          if self.is_pq else None)
        self.scalar = self.quant is not None and not self.is_pq
        self.raw = (None if raw is None else np.asarray(raw) if self.scalar
                    else np.asarray(raw, np.float32))
        if self.raw is not None:
            flt = self.quant.decode(self.raw) if self.scalar else self.raw
            self.dev_vectors, self.dev_sqnorms = _device_vectors(
                flt, self.device)
        else:
            self.dev_vectors = self.dev_sqnorms = None

    @classmethod
    def build(cls, vectors: np.ndarray, spec: IndexSpec, device):
        """`vectors` are codes for uint8/int8 (the service encodes them)
        and the original float32 rows for pq: the graphs are built at
        full precision and the code rows swapped in afterwards."""
        p = cls.forced_partitions or spec.num_partitions
        pdb = build_partitioned_db(vectors, p, spec.hnsw)
        pdb = quantize_db_vectors(
            pdb, spec.dtype, spec.quantizer() if spec.dtype == "pq" else None)
        return cls(spec, pdb, vectors if spec.keep_vectors else None, device)

    def params(self, k: int, ef: int) -> SearchParams:
        return SearchParams(ef=ef, k=k, metric=self.spec.metric,
                            fused_hops=self.spec.fused_hops)

    def search(self, queries, k: int, ef: int, rerank: bool,
               with_stats: bool):
        p = self.params(k, ef)
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        lut = build_pq_lut(q, self.codebooks) if self.is_pq else None
        if rerank:
            if self.dev_vectors is None:
                raise ValueError(
                    "rerank=True needs the raw vectors: build the index "
                    "with IndexSpec(keep_vectors=True)")
            cand, _, st = search_partitioned_candidates(self.pdb, q, p, lut)
            rq = self.quant.decode(q) if self.scalar else q
            ids, dists = batched_rerank(self.dev_vectors, self.dev_sqnorms,
                                        rq, cand, k, self.spec.metric)
        else:
            ids, dists, st = search_partitioned(self.pdb, q, p, lut)
            if self.scalar:               # code space -> real space
                dists = dists * float(np.float32(self.quant.dist_scale))
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


# ---------------------------------------------------------------------------
# csd — out-of-core over the block store (defined in repro_torch.store.csd,
# which imports this package's types only lazily)
# ---------------------------------------------------------------------------

from repro_torch.store.csd import CSDBackend  # noqa: E402

register_backend("csd")(CSDBackend)
