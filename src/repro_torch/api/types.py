"""Typed request/response surface of the search service.

The same objects as the reference package: an `IndexSpec` describes what
to build, a `SearchRequest` one batched call, a `SearchResponse` the
results plus optional per-query statistics. `IndexSpec` keeps every field
of the reference and the same JSON round-trip, so the port parses index
manifests the reference wrote (and the reference parses the port's).

`dtype` selects the stored rows: float32, scalar codes (uint8 / int8,
with the fitted `qscale` / `qzero`) or product-quantized codes ("pq",
with the fitted `pq_codebooks`). `SearchService.build` fits the quantizer
and writes its state back onto the spec, so it rides the manifest.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.optim.compression import PQQuantizer, VectorQuantizer

__all__ = ["IndexSpec", "SearchRequest", "SearchResponse", "QueryStats",
           "FORMAT_VERSION", "PQ_FORMAT_VERSION"]

# Version of the on-disk index layout (manifest + checkpoint step dirs).
FORMAT_VERSION = 1
# Product-quantized indexes (dtype="pq") are written as version 3: the
# manifest then carries the codebooks.
PQ_FORMAT_VERSION = 3


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Everything needed to build (or re-open) an index.

    metric  : "l2" | "ip" | "cosine" (see api.metrics)
    backend : "exact" | "hnsw" | "partitioned" | "distributed" | "csd" |
              "partitioned-batched" (partitioned with its graphs built on
              the index's device, a batch of points at a time; only the
              port reads it, so the reference cannot open such an index)
    num_partitions : stage-1 sub-graph count (paper §4.1)
    dtype   : "float32" | "uint8" | "int8" | "pq" (metric "l2" only for
              the quantized ones)
    qscale / qzero : the fitted scalar quantizer (uint8 / int8)
    pq_m / pq_codebooks : PQ subspaces and fitted codebooks; codebooks
              passed in are reused by `SearchService.build`
    hnsw    : graph construction knobs (ignored by the exact backend)
    keep_vectors : retain the raw vectors beside the graph — needed for
              `SearchRequest.rerank`, and saved with the index
    storage_path / block_size / cache_bytes / prefetch : `csd` knobs (the
              block store's directory, its block bytes, the page cache's
              bound and the next-hop prefetcher)
    fused_hops : layer-0 hops per traversal kernel launch; bit-identical
              results at every value, and it rides the manifest
    """

    metric: str = "l2"
    backend: str = "partitioned"
    num_partitions: int = 1
    hnsw: HNSWConfig = dataclasses.field(default_factory=HNSWConfig)
    keep_vectors: bool = False
    storage_path: str | None = None
    block_size: int = 4096
    cache_bytes: int = 64 << 20
    prefetch: bool = True
    dtype: str = "float32"
    qscale: float | None = None
    qzero: int | None = None
    fused_hops: int = 1
    pq_m: int = 8
    pq_codebooks: Any = None  # nested lists [pq_m][256][dsub], JSON-ready

    def quantizer(self):
        """The fitted quantizer (VectorQuantizer or PQQuantizer), or None
        for the float32 path."""
        if self.dtype == "float32":
            return None
        if self.dtype == "pq":
            if self.pq_codebooks is None:
                raise ValueError(
                    "dtype='pq' spec has no fitted pq_codebooks — build PQ "
                    "indexes through SearchService.build")
            cb = self.pq_codebooks
            dsub = len(cb[0][0])
            return PQQuantizer.from_json(
                {"m": self.pq_m, "dsub": dsub, "codebooks": cb})
        if self.qscale is None or self.qzero is None:
            raise ValueError(
                f"dtype={self.dtype!r} spec has no fitted qscale/qzero — "
                f"build quantized indexes through SearchService.build")
        return VectorQuantizer(dtype=self.dtype, scale=float(self.qscale),
                               zero_point=int(self.qzero))

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["hnsw"] = dataclasses.asdict(self.hnsw)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "IndexSpec":
        d = dict(d)
        hnsw_fields = {f.name for f in dataclasses.fields(HNSWConfig)}
        hnsw = HNSWConfig(**{k: v for k, v in d.pop("hnsw", {}).items()
                             if k in hnsw_fields})
        known = {f.name for f in dataclasses.fields(cls)} - {"hnsw"}
        return cls(hnsw=hnsw, **{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """One batched search call.

    queries : [B, D] array-like (numpy or a tensor)
    k       : results per query
    ef      : beam width (graph backends; the exact backend ignores it)
    rerank  : recompute exact distances over the stage-1 candidate pool
    with_stats : return per-query hop / distance-evaluation counts
    trace   : a parent span ctx handed across threads by the serving
              layer (the batcher stamps its batch span here); the
              `search` span parents on it when the thread that searches
              has no open span, else nests under that thread's span
    """

    queries: Any
    k: int = 10
    ef: int = 40
    rerank: bool = False
    with_stats: bool = False
    trace: Any = dataclasses.field(default=None, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class QueryStats:
    """Per-query counters; `None` where a backend does not track one. The
    storage counters are the csd backend's, over one request: block
    reads and bytes from the block store, the page cache's demand hits,
    misses and hit rate, and the host-synced traversal rounds
    (`supersteps`)."""

    hops: Any = None            # [B] candidate pops at layer 0
    dist_calcs: Any = None      # [B] distance evaluations == "vector reads"
    block_reads: Any = None
    cache_hits: Any = None
    cache_misses: Any = None
    cache_hit_rate: Any = None
    bytes_read: Any = None
    supersteps: Any = None
    segments: Any = None


@dataclasses.dataclass(frozen=True)
class SearchResponse:
    """ids/dists are [B, k] tensors on the service's device; -1 / +inf
    mark empty slots."""

    ids: Any
    dists: Any
    stats: QueryStats | None = None
