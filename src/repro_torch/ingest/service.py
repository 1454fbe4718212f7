"""MutableSearchService: streaming inserts + tombstone deletes over
`repro_torch.api`, with LSM-style sealed segments and background-able
compaction; the port of the reference's `repro.ingest.service`.

    from repro_torch.api import IndexSpec, MutableSearchService, SearchRequest

    svc = MutableSearchService(IndexSpec(backend="partitioned"),
                               seal_threshold=1024)     # on the card
    gids = svc.insert(vectors)          # global ids, assigned monotonically
    svc.delete(gids[:100])              # tombstoned; never surfaces again
    resp = svc.search(SearchRequest(queries, k=10, ef=40))
    svc.flush()                         # seal the memtable explicitly
    svc.compact()                       # merge segments + reclaim space
    svc.save(path); MutableSearchService.load(path)   # manifest v2

Every segment's service and the memtable's scan run on `device` (the card
unless the caller passes device="cpu"; without CUDA the default raises).
Results are host tensors: the fan-out merges on the host (numpy, as the
reference's), with int64 global ids.

Search fans out over the memtable (exact scan) and every sealed segment
(each one is a normal `SearchService` — partitioned/csd hop kernels
unchanged: a segment is just one more partition), filters tombstones, and
rank-merges the per-source top-k — the same stage-2 reduction as the
two-stage engine; `rerank=True` re-scores inside each segment first, so
the merged distances are exact.

Consistency: one lock guards all mutations; `search` snapshots (segment
list, tombstone bitmap, memtable rows) under that lock and then runs
lock-free, so a query batch always sees one atomic state — the snapshot
semantics `repro_torch.serve` relies on to interleave writes with batched reads.

Memory (csd backend): segment PageCaches share ONE `spec.cache_bytes`
budget — the budget is re-split (`PageCache.resize`) whenever the live
segment set changes — so peak resident store memory stays
`max(cache_bytes, n_segments * block_size)` + the memtable buffer no
matter how many rows stream in. `peak_resident_bytes` tracks the
high-water mark, and the tests assert the bound.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api import metrics as _metrics
from repro_torch.api.service import SearchService
from repro_torch.api.types import (IndexSpec, QueryStats, SearchRequest,
                                   SearchResponse)
from repro_torch.core.merge import mask_dead_lanes, rank_merge
from repro_torch.ingest.compactor import compact_segments
from repro_torch.ingest.memtable import Memtable
from repro_torch.ingest.segments import Segment, _host, seal_memtable
from repro_torch.ingest.tombstones import TombstoneSet
from repro_torch.obs.metrics import REGISTRY, next_uid
from repro_torch.obs.trace import TRACER

__all__ = ["MutableSearchService", "MUTABLE_FORMAT_VERSION",
           "MUTABLE_MANIFEST_NAME"]

# v1 is the immutable SearchService manifest; v2 adds the segment list,
# tombstones, and the memtable — a half-compacted index round-trips.
MUTABLE_FORMAT_VERSION = 2
MUTABLE_MANIFEST_NAME = "index_manifest.json"

_SUPPORTED = ("exact", "hnsw", "partitioned", "csd")
# Per-source over-fetch ceiling: k + tombstone-debt is clamped here so a
# pathological pile of deletes degrades recall instead of blowing up the
# scan kernels (compact() is the actual fix for that much debt).
_MAX_FETCH = 256


def _collect_ingest(svc: "MutableSearchService"):
    """Snapshot-time metric samples (repro_torch.obs registry collector)."""
    labels = {"index": svc.uid}
    return [
        ("counter", "ingest_rows_inserted_total", labels, svc._next_gid),
        ("counter", "ingest_rows_deleted_total", labels, svc._deleted_total),
        ("counter", "ingest_compactions_total", labels, svc._compactions),
        ("gauge", "ingest_segments", labels, svc.num_segments),
        ("gauge", "ingest_live_rows", labels, svc.size),
        ("gauge", "ingest_resident_bytes", labels, svc.resident_bytes()),
        ("gauge", "ingest_peak_resident_bytes", labels,
         svc.peak_resident_bytes),
    ]


class MutableSearchService:
    """A segmented, mutable index over one immutable-backend spec."""

    def __init__(self, spec: IndexSpec | None = None, *,
                 seal_threshold: int = 1024, device=None):
        device = resolve_device(device)
        spec = spec or IndexSpec()
        if spec.backend not in _SUPPORTED:
            raise ValueError(
                f"mutable indexes support backends {_SUPPORTED}; got "
                f"{spec.backend!r} (distributed segments would need a "
                f"mesh-wide seal — build those immutably)")
        if spec.dtype != "float32":
            raise ValueError(
                "mutable indexes are float32-only for now: per-segment "
                "quantizer fitting would make distances drift across "
                "segments as the data churns")
        metric = _metrics.get_metric(spec.metric)
        if spec.backend != "exact" and not metric.graph_safe:
            raise ValueError(
                f"metric {spec.metric!r} is not graph-safe: use "
                f"backend='exact' (same rule as SearchService.build)")
        if seal_threshold < 1:
            raise ValueError(f"seal_threshold must be >= 1, "
                             f"got {seal_threshold}")
        if spec.backend == "csd" and not spec.storage_path:
            raise ValueError(
                "backend='csd' needs IndexSpec(storage_path=...): the "
                "segment block stores live there")
        self.spec = spec
        self.metric = metric
        self.device = device
        self.seal_threshold = int(seal_threshold)
        self.backend = None               # duck-typing for serve stats
        self._lock = threading.RLock()
        self._compact_lock = threading.Lock()   # serializes compactions
        self._segments: list[Segment] = []
        self._tombstones = TombstoneSet()
        self._memtable: Memtable | None = None     # created on first insert
        self._dim: int | None = None
        self._next_gid = 0
        self._next_seg = 0
        self.peak_resident_bytes = 0
        self.peak_storage_resident_bytes = 0
        self._deleted_total = 0            # monotonic (tombstones shrink)
        self._compactions = 0
        self.uid = next_uid()
        REGISTRY.register_collector(self, _collect_ingest)

    # -- introspection -------------------------------------------------------

    @property
    def num_segments(self) -> int:
        with self._lock:
            return len(self._segments)

    @property
    def size(self) -> int:
        """Live (non-tombstoned) row count."""
        with self._lock:
            total = sum(s.n - s.n_deleted for s in self._segments)
            if self._memtable is not None and len(self._memtable):
                _, gids = self._memtable.snapshot()
                total += int((~self._tombstones.contains(gids)).sum())
            return total

    def storage_resident_bytes(self) -> int:
        """Bytes currently held by segment page caches. Structurally
        bounded by max(cache_bytes, n_segments * block_size): the one
        budget is re-split across readers as the segment set changes."""
        with self._lock:
            total = 0
            for seg in self._segments:
                reader = getattr(seg.service.backend, "reader", None)
                if reader is not None:
                    total += reader.cache.current_bytes
            return total

    def resident_bytes(self) -> int:
        """Current resident bytes: segment page caches + memtable buffer."""
        with self._lock:
            total = self.storage_resident_bytes()
            if self._memtable is not None:
                total += self._memtable.nbytes
            return total

    def _note_resident(self) -> None:
        self.peak_storage_resident_bytes = max(
            self.peak_storage_resident_bytes, self.storage_resident_bytes())
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self.resident_bytes())

    # -- mutations -----------------------------------------------------------

    def insert(self, vectors) -> np.ndarray:
        """Add rows; returns their newly-assigned global ids [n]. Seals the
        memtable into a segment whenever it reaches `seal_threshold`."""
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        prepared = self.metric.prepare_data(vectors)
        with self._lock:
            if self._dim is None:
                self._dim = int(prepared.shape[1])
            elif prepared.shape[1] != self._dim:
                raise ValueError(f"expected dim {self._dim}, "
                                 f"got {prepared.shape[1]}")
            gids = np.arange(self._next_gid,
                             self._next_gid + len(prepared), dtype=np.int64)
            self._next_gid += len(prepared)
            if self._memtable is None:
                self._memtable = Memtable(self._dim, self.spec.hnsw,
                                          build_graph=self.spec.backend
                                          != "exact")
            # seal in threshold-sized waves so one huge insert cannot grow
            # the memtable unboundedly past the threshold
            off = 0
            while off < len(prepared):
                room = self.seal_threshold - len(self._memtable)
                take = min(room, len(prepared) - off)
                self._memtable.insert(prepared[off: off + take],
                                      gids[off: off + take])
                off += take
                if len(self._memtable) >= self.seal_threshold:
                    self._seal_locked()
            self._note_resident()
        return gids

    def delete(self, gids) -> int:
        """Tombstone global ids; returns how many were newly deleted.
        Deleted ids never surface again (asserted in tests, including
        through rerank); space comes back at seal/compaction time."""
        gids = np.atleast_1d(np.asarray(gids, np.int64))
        with self._lock:
            known = np.unique(gids[(gids >= 0) & (gids < self._next_gid)])
            fresh_mask = ~self._tombstones.contains(known)
            fresh = known[fresh_mask]
            self._tombstones.add(known)
            for seg in self._segments:
                seg.n_deleted += int(seg.contains(fresh).sum())
            self._deleted_total += int(fresh.size)
            return int(fresh.size)

    def flush(self) -> None:
        """Seal the memtable into a segment now (no-op when empty)."""
        with self._lock:
            self._seal_locked()
            self._note_resident()

    def compact(self) -> dict:
        """Merge every live segment (memtable flushed first) plus the
        tombstones into one rebuilt segment; returns a summary dict. Space
        is reclaimed and per-query fan-out drops back to one segment.

        Concurrent compactions serialize on their own lock (two racing
        rebuilds over the same snapshot would publish every row twice);
        searches and mutations are NOT blocked by a running rebuild.

        csd note: compaction deletes the merged-away segment stores, so a
        `save()` taken earlier — whose manifests reference those stores
        without copying them, the block store's standing no-copy contract
        — is superseded; re-`save()` after compacting to keep a loadable
        snapshot."""
        with self._compact_lock:
            with self._lock:
                self._seal_locked()
                segments = list(self._segments)
                tomb = self._tombstones.copy()
                name = self._seg_name()
            # the expensive rebuild runs outside the service lock: searches
            # keep serving from the old segment list, mutations queue on
            # the lock only for the final swap below
            result = compact_segments(
                self.spec, segments, tomb, name, device=self.device,
                storage_path=self._seg_storage(name),
                cache_bytes=self._cache_budget(1))
            with self._lock:
                if self.spec.backend == "csd" and segments:
                    from repro_torch.store.segments import replace_segments
                    replace_segments(self.spec.storage_path,
                                     [s.name for s in segments],
                                     [result.merged.name]
                                     if result.merged else [])
                # retire only the tombstones this rebuild actually dropped
                # — a delete() that raced the lock-free rebuild keeps its
                # bit set and keeps filtering the merged segment's rows
                for s in segments:
                    was_dead = tomb.contains(s.gid_map)
                    self._tombstones.discard(s.gid_map[was_dead])
                merged = []
                if result.merged is not None:
                    result.merged.n_deleted = int(self._tombstones.contains(
                        result.merged.gid_map).sum())
                    merged = [result.merged]
                old_ids = set(map(id, segments))
                self._segments = merged + [s for s in self._segments
                                           if id(s) not in old_ids]
                self._rebalance_caches_locked()
                self._note_resident()
                self._compactions += 1
            return {"merged_segments": len(segments),
                    "rows_read": result.rows_read,
                    "rows_written": result.rows_written,
                    "rows_reclaimed": result.rows_reclaimed,
                    "live_segments": self.num_segments}

    def close(self) -> None:
        """Close segment store readers (csd); in-memory backends are GC'd."""
        with self._lock:
            for seg in self._segments:
                reader = getattr(seg.service.backend, "reader", None)
                if reader is not None:
                    reader.close()

    # -- sealing internals ---------------------------------------------------

    def _seg_name(self) -> str:
        name = f"seg_{self._next_seg:08d}"
        self._next_seg += 1
        return name

    def _seg_storage(self, name: str) -> str | None:
        if self.spec.backend != "csd":
            return None
        return os.path.join(self.spec.storage_path, name)

    def _cache_budget(self, n_segments: int) -> int | None:
        if self.spec.backend != "csd":
            return None
        return max(self.spec.block_size,
                   self.spec.cache_bytes // max(1, n_segments))

    def _rebalance_caches_locked(self) -> None:
        """Re-split the one cache_bytes budget over the live csd readers."""
        if self.spec.backend != "csd":
            return
        budget = self._cache_budget(len(self._segments))
        for seg in self._segments:
            reader = getattr(seg.service.backend, "reader", None)
            if reader is not None:
                reader.cache.resize(budget)

    def _seal_locked(self) -> None:
        mem = self._memtable
        if mem is None or len(mem) == 0:
            return
        vectors, gids = mem.snapshot()
        dead = self._tombstones.contains(gids)
        if dead.any():
            # dead rows never reach a segment: drop them now and retire
            # their tombstones (the space debt is settled at the source);
            # the incremental graph contains them, so rebuild the survivors
            self._tombstones.discard(gids[dead])
            vectors, gids = vectors[~dead], gids[~dead]
            graph = None
        else:
            graph = mem.graph() if mem.build_graph else None
        self._memtable = Memtable(self._dim, self.spec.hnsw,
                                  build_graph=mem.build_graph)
        if gids.size == 0:
            return
        name = self._seg_name()
        seg = seal_memtable(
            self.spec, name, vectors, gids, graph, device=self.device,
            storage_path=self._seg_storage(name),
            cache_bytes=self._cache_budget(len(self._segments) + 1))
        if self.spec.backend == "csd":
            from repro_torch.store.segments import append_segment
            append_segment(self.spec.storage_path, name)
        self._segments.append(seg)
        self._rebalance_caches_locked()

    # -- search --------------------------------------------------------------

    def search(self, request: SearchRequest) -> SearchResponse:
        """Snapshot-consistent fan-out over memtable + live segments; ids
        (int64, global) and dists come back as host tensors."""
        if not isinstance(request, SearchRequest):
            request = SearchRequest(queries=request)
        with self._lock:                       # one atomic snapshot
            segments = list(self._segments)
            tomb = self._tombstones.copy()
            mem = (self._memtable.snapshot() if self._memtable is not None
                   else None)
        queries = np.atleast_2d(np.asarray(request.queries, np.float32))
        b, k = queries.shape[0], request.k

        all_ids, all_ds = [], []
        seg_stats: list[dict] = []
        agg = {"hops": None, "dist_calcs": None, "block_reads": 0,
               "cache_hits": 0, "cache_misses": 0, "bytes_read": 0,
               "saw_cache": False}

        def _acc(stats, name: str, n: int):
            if stats is None:
                return
            row = {"segment": name, "n": n}
            for f in ("hops", "dist_calcs"):
                v = getattr(stats, f)
                if v is not None:
                    v = _host(v)
                    row[f] = float(v.mean())
                    agg[f] = v if agg[f] is None else agg[f] + v
            for f in ("block_reads", "cache_hits", "cache_misses",
                      "bytes_read"):
                v = getattr(stats, f)
                if v is not None:
                    row[f] = int(v)
                    agg[f] += int(v)
                    if f in ("cache_hits", "cache_misses"):
                        agg["saw_cache"] = True
            seg_stats.append(row)

        # the fan-out span: ambient nesting wins (replica dispatch span);
        # the batcher-stamped request ctx only parents on a cold thread
        if request.trace is not None and TRACER.current_ctx() is None:
            span = TRACER.span("search", parent=request.trace,
                               backend="mutable", k=request.k)
        else:
            span = TRACER.span("search", backend="mutable", k=request.k)
        with span:
            for seg in segments:
                # the clamp bounds tombstone OVER-fetch only — never k itself
                k_fetch = max(k, min(k + seg.n_deleted, _MAX_FETCH))
                with TRACER.child_span("segment", segment=seg.name):
                    gids, ds, stats = seg.search(
                        queries, k=k_fetch, ef=request.ef,
                        rerank=request.rerank,
                        with_stats=request.with_stats)
                gids, ds = mask_dead_lanes(gids, ds, tomb.contains(gids))
                all_ids.append(gids)
                all_ds.append(ds)
                if request.with_stats:
                    _acc(stats, seg.name, seg.n)

            if mem is not None and mem[1].size:
                mem_dead = int(tomb.contains(mem[1]).sum())
                k_fetch = max(k, min(k + mem_dead, _MAX_FETCH))
                mq = self.metric.prepare_queries(queries)
                with TRACER.child_span("memtable", rows=int(mem[1].size)):
                    ids, ds = Memtable.scan(mem[0], mem[1], mq, k_fetch,
                                            self.spec.metric, self.device)
                ids, ds = mask_dead_lanes(ids, ds, tomb.contains(ids))
                all_ids.append(ids)
                all_ds.append(ds)
                if request.with_stats:
                    calcs = np.full((b,), mem[1].size, np.int64)
                    _acc(QueryStats(dist_calcs=calcs), "memtable",
                         mem[1].size)

            if not all_ids:
                return SearchResponse(
                    ids=torch.full((b, k), -1, dtype=torch.int64),
                    dists=torch.full((b, k), float("inf")))
            # stage-2 rank merge across sources (core.merge.rank_merge — the
            # same reduction the cluster router uses): tombstoned lanes carry
            # +inf so they can never displace a live id
            out_i, out_d = rank_merge(all_ids, all_ds, k)
        stats = None
        if request.with_stats:
            self._note_resident()
            # demand-weighted hit rate over all csd segments — the same
            # formula as one cache (hits / (hits + misses)), computed from
            # the summed counters, never by averaging per-segment rates
            demand = agg["cache_hits"] + agg["cache_misses"]
            hit_rate = ((agg["cache_hits"] / demand if demand else 0.0)
                        if agg["saw_cache"] else None)
            as_t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a))
            stats = QueryStats(
                hops=as_t(agg["hops"]), dist_calcs=as_t(agg["dist_calcs"]),
                block_reads=agg["block_reads"] or None,
                cache_hits=agg["cache_hits"] or None,
                cache_misses=agg["cache_misses"] or None,
                cache_hit_rate=hit_rate,
                bytes_read=agg["bytes_read"] or None,
                segments=seg_stats)
        return SearchResponse(ids=torch.from_numpy(out_i),
                              dists=torch.from_numpy(out_d), stats=stats)

    # -- persistence (manifest v2) -------------------------------------------

    def save(self, path: str) -> str:
        """Persist the whole mutable state — segments, tombstones, and the
        un-sealed memtable — so a half-compacted index round-trips."""
        with self._lock:
            os.makedirs(path, exist_ok=True)
            seg_root = os.path.join(path, "segments")
            os.makedirs(seg_root, exist_ok=True)
            live = {s.name for s in self._segments}
            for stale in os.listdir(seg_root):        # dropped by compaction
                if stale not in live:
                    shutil.rmtree(os.path.join(seg_root, stale),
                                  ignore_errors=True)
            entries = []
            for seg in self._segments:
                d = os.path.join(seg_root, seg.name)
                seg.service.save(d)
                np.save(os.path.join(d, "gid_map.npy"), seg.gid_map)
                entries.append({"name": seg.name, "n": seg.n,
                                "n_deleted": int(seg.n_deleted)})
            np.save(os.path.join(path, "tombstones.npy"),
                    self._tombstones.words())
            if self._memtable is not None and len(self._memtable):
                mv, mg = self._memtable.snapshot()
            else:
                mv = np.zeros((0, self._dim or 0), np.float32)
                mg = np.zeros(0, np.int64)
            np.save(os.path.join(path, "memtable_vectors.npy"), mv)
            np.save(os.path.join(path, "memtable_gids.npy"), mg)
            manifest = {
                "format_version": MUTABLE_FORMAT_VERSION,
                "kind": "mutable-segmented-index",
                "spec": self.spec.to_json(),
                "seal_threshold": self.seal_threshold,
                "next_gid": int(self._next_gid),
                "next_seg": int(self._next_seg),
                "dim": self._dim,
                "segments": entries,
            }
            tmp = os.path.join(path, MUTABLE_MANIFEST_NAME + ".tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1)
            os.replace(tmp, os.path.join(path, MUTABLE_MANIFEST_NAME))
            return path

    @classmethod
    def load(cls, path: str, *, device=None) -> "MutableSearchService":
        """Re-open a saved mutable index (the port's or the reference's) on
        `device` (default: the card)."""
        with open(os.path.join(path, MUTABLE_MANIFEST_NAME)) as f:
            manifest = json.load(f)
        version = manifest.get("format_version")
        if version != MUTABLE_FORMAT_VERSION:
            raise ValueError(
                f"index at {path!r} has format_version={version}; mutable "
                f"indexes are version {MUTABLE_FORMAT_VERSION} "
                f"(SearchService.load reads version 1, and version 3 — "
                f"a product-quantized immutable index)")
        spec = IndexSpec.from_json(manifest["spec"])
        svc = cls(spec, seal_threshold=int(manifest["seal_threshold"]),
                  device=device)
        svc._dim = manifest["dim"]
        svc._next_gid = int(manifest["next_gid"])
        svc._next_seg = int(manifest["next_seg"])
        budget = svc._cache_budget(max(1, len(manifest["segments"])))
        for e in manifest["segments"]:
            d = os.path.join(path, "segments", e["name"])
            sub = SearchService.load(d, device=svc.device)
            if budget is not None:
                reader = getattr(sub.backend, "reader", None)
                if reader is not None:
                    reader.cache.resize(budget)
            gid_map = np.load(os.path.join(d, "gid_map.npy"))
            svc._segments.append(Segment(e["name"], sub, gid_map,
                                         n_deleted=int(e["n_deleted"])))
        svc._tombstones = TombstoneSet.from_words(
            np.load(os.path.join(path, "tombstones.npy")))
        mv = np.load(os.path.join(path, "memtable_vectors.npy"))
        mg = np.load(os.path.join(path, "memtable_gids.npy"))
        if len(mg):
            svc._memtable = Memtable(svc._dim, spec.hnsw,
                                     build_graph=spec.backend != "exact")
            svc._memtable.insert(mv, mg)   # replays the incremental graph
        return svc
