"""Sealed immutable segments: one `SearchService` + a local→global id map.

A sealed segment is *exactly* one more partition of the two-stage engine
(paper §4.1): internally it searches in a compact local id space
[0, n) — which keeps the block store's contiguous-gid rerank path and the
hop kernels untouched — and the ingest layer remaps local ids to global
ids through `gid_map` at merge time. `gid_map` is always sorted ascending
(ids are assigned monotonically and compaction merges in id order), so
membership tests and local-row lookups are one `searchsorted`.

Two ways a segment is born:

  seal_memtable : the memtable's incrementally-built graph (GraphBuilder)
                  is `restructure`d into a DeviceDB and moved to the
                  device — no rebuild. If the memtable carries tombstoned
                  rows they are dropped here and the graph is rebuilt over
                  the survivors instead (dead rows must never reach a
                  segment).
  build_segment : full `SearchService.build` over gathered survivor
                  vectors — the compactor's path, which is also what makes
                  `compact()` on the csd backend bit-identical to an
                  in-memory `partitioned` build over the same rows.

Every segment's service lives on the mutable index's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.service import SearchService
from repro_torch.api.types import IndexSpec, SearchRequest
from repro_torch.core import hnsw_graph as hg
from repro_torch.core.partitioned import PartitionedDB

__all__ = ["Segment", "seal_memtable", "build_segment", "segment_vectors"]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass(eq=False)
class Segment:
    """One immutable sealed segment of a mutable index (identity eq: the
    compactor swaps segment LISTS, never compares array contents)."""

    name: str
    service: SearchService
    gid_map: np.ndarray            # [n] int64, sorted: local id -> global id
    n_deleted: int = 0             # live tombstone debt (over-fetch sizing)

    @property
    def n(self) -> int:
        return int(self.gid_map.size)

    def contains(self, gids: np.ndarray) -> np.ndarray:
        """Membership mask of global ids in this segment (searchsorted)."""
        gids = np.asarray(gids, np.int64)
        pos = np.searchsorted(self.gid_map, gids)
        pos = np.minimum(pos, self.gid_map.size - 1)
        return self.gid_map[pos] == gids

    def search(self, queries, k: int, ef: int, rerank: bool,
               with_stats: bool):
        """One segment's stage-1 answer, remapped to GLOBAL ids on the
        host."""
        resp = self.service.search(SearchRequest(
            queries=queries, k=k, ef=ef, rerank=rerank,
            with_stats=with_stats))
        ids = _host(resp.ids)
        gids = np.where(ids >= 0, self.gid_map[np.maximum(ids, 0)],
                        np.int64(-1))
        return gids, _host(resp.dists), resp.stats


def _segment_spec(spec: IndexSpec, *, num_partitions: int,
                  storage_path: str | None,
                  cache_bytes: int | None) -> IndexSpec:
    backend = "partitioned" if spec.backend == "hnsw" else spec.backend
    kw = dict(backend=backend, num_partitions=num_partitions)
    if storage_path is not None:
        kw["storage_path"] = storage_path
    if cache_bytes is not None:
        kw["cache_bytes"] = cache_bytes
    return dataclasses.replace(spec, **kw)


def _stack_single(db: hg.DeviceDB) -> hg.DeviceDB:
    """[...] -> [1, ...]: one sealed graph as a P=1 stacked DeviceDB."""
    return hg.DeviceDB(*(np.stack([np.asarray(getattr(db, f))])
                         for f in hg.DeviceDB._fields))


def seal_memtable(spec: IndexSpec, name: str, vectors: np.ndarray,
                  gids: np.ndarray, graph: hg.HostGraph | None, *,
                  device, storage_path: str | None = None,
                  cache_bytes: int | None = None) -> Segment:
    """Restructure a memtable into a sealed segment (paper Fig. 5 tables)
    on `device`.

    `vectors`/`gids` are the SURVIVING rows (tombstones already dropped);
    `graph` is the memtable's incremental graph when no row was dropped
    (then sealing is restructure-only), else None to force a rebuild.
    """
    gids = np.asarray(gids, np.int64)
    seg_spec = _segment_spec(spec, num_partitions=1,
                             storage_path=storage_path,
                             cache_bytes=cache_bytes)
    if seg_spec.backend == "exact":
        from repro_torch.api.backends import ExactBackend
        return Segment(name, SearchService(
            seg_spec, ExactBackend(seg_spec, vectors, device)), gids)
    if graph is None:
        return build_segment(spec, name, vectors, gids, device=device,
                             storage_path=storage_path,
                             cache_bytes=cache_bytes, num_partitions=1)
    db = hg.restructure(graph)             # local arange gids inside
    pdb = PartitionedDB(db=_stack_single(db), num_partitions=1,
                        dim=vectors.shape[1])
    if seg_spec.backend == "csd":
        from repro_torch.store.csd import CSDBackend
        from repro_torch.store.layout import open_store, write_store
        write_store(seg_spec.storage_path, pdb,
                    block_size=seg_spec.block_size)
        backend = CSDBackend(seg_spec, open_store(
            seg_spec.storage_path, seg_spec.cache_bytes,
            prefetch=seg_spec.prefetch), device)
        return Segment(name, SearchService(seg_spec, backend), gids)
    from repro_torch.api.backends import PartitionedBackend
    # the backend moves the tables onto the device (hg.device_db)
    backend = PartitionedBackend(
        seg_spec, pdb, vectors if seg_spec.keep_vectors else None, device)
    return Segment(name, SearchService(seg_spec, backend), gids)


def build_segment(spec: IndexSpec, name: str, vectors: np.ndarray,
                  gids: np.ndarray, *, device,
                  storage_path: str | None = None,
                  cache_bytes: int | None = None,
                  num_partitions: int | None = None) -> Segment:
    """Full from-scratch build over survivor rows (the compactor's path)."""
    seg_spec = _segment_spec(
        spec,
        num_partitions=(spec.num_partitions if num_partitions is None
                        else num_partitions),
        storage_path=storage_path, cache_bytes=cache_bytes)
    svc = SearchService.build(vectors, seg_spec, device=device)
    return Segment(name, svc, np.asarray(gids, np.int64))


def segment_vectors(segment: Segment) -> np.ndarray:
    """All rows of a segment as float32 [n, dim] on the host, in local-id
    order — the compactor's gather. Reads through the page cache for csd
    segments (no full-DB materialization beyond the merge buffer itself)."""
    backend = segment.service.backend
    if hasattr(backend, "reader"):                       # csd
        r = backend.reader
        parts = []
        for p in range(r.num_partitions):
            n = int(np.atleast_1d(r.n_valid)[p])
            rows = r.row("vectors", p, np.arange(n))
            parts.append(r.read_rows("vectors", rows)[:, : r.dim]
                         .astype(np.float32))
        return np.concatenate(parts) if parts else np.zeros(
            (0, r.dim), np.float32)
    if hasattr(backend, "pdb"):                          # partitioned/hnsw
        db = backend.pdb
        vec = _host(db.db.vectors)
        n_valid = np.atleast_1d(_host(db.db.n_valid))
        return np.concatenate([vec[p, : int(n_valid[p]), : db.dim]
                               for p in range(vec.shape[0])])
    return np.asarray(backend.raw, np.float32)           # exact
