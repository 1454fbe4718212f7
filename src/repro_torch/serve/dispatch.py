"""Replica pool: dispatch packed batches across N SearchService replicas.

This models the paper's 4-SmartSSD scale-up (Fig. 10/11): one host-side
dispatcher, N independent engines, each holding the whole database (graph
parallelism's stage-1 unit here is a whole replica). Replication is
backend-aware, as the reference's:

  in-memory backends  : replicas place their tensors round-robin over the
                        visible CUDA devices; on one card (or on the CPU)
                        they share the (immutable, functionally-searched)
                        tensors, so replication costs nothing and still
                        buys overlap of host-side work with device compute;
  csd backend         : each replica opens its OWN StoreReader — an
                        independent PageCache + Prefetcher over the one
                        shared block store, exactly the paper's four
                        SmartSSD DRAMs in front of one logical database;
  mutable index       : every replica shares the one service (clones
                        would diverge on writes);
  cluster router      : every replica shares the router (its shards
                        replicate one layer down, with failover).

Selection is least-in-flight-depth with a round-robin tiebreak; each
replica runs a single worker thread, so batches on one replica serialize
(one engine == one accelerator queue) while distinct replicas overlap. On
CUDA each replica also issues its work on its own stream, so a replica's
host syncs (and the wait for its results) wait for its own kernels only,
never for another replica's.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.obs.metrics import REGISTRY, next_uid
from repro_torch.obs.profile import PROFILER
from repro_torch.obs.trace import TRACER

__all__ = ["Replica", "ReplicaPool"]


class Replica:
    """One SearchService plus its serial executor, stream and counters."""

    def __init__(self, service, rid: int, *, owns_backend: bool = False):
        self.service = service
        self.rid = rid
        self.owns_backend = owns_backend   # pool closes what it opened
        self.inflight = 0                  # guarded by the pool lock
        self.batches = 0
        self.queries = 0
        self.busy_s = 0.0
        dev = torch.device(service.device)
        self.stream = (torch.cuda.Stream(device=dev) if dev.type == "cuda"
                       else None)
        self._ex = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"serve-replica-{rid}")

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _wait(self) -> None:
        """Block until this replica's queued work (its results included)
        is done: an event on its own stream, never a device-wide sync."""
        if self.stream is not None:
            done = torch.cuda.Event()
            done.record(self.stream)
            done.synchronize()

    def _search(self, request, n_queries: int):
        # this runs on the replica's own thread: parent explicitly on the
        # batch ctx the batcher stamped (cross-thread handoff); no ctx ->
        # child_span, which is a no-op unless this thread is already traced
        ctx = getattr(request, "trace", None)
        if ctx is not None:
            sp = TRACER.span("dispatch", parent=ctx, replica=self.rid,
                             n=n_queries)
        else:
            sp = TRACER.child_span("dispatch", replica=self.rid)
        t0 = time.perf_counter()
        # every stage span closed on this thread (traversal, store-read,
        # rerank, hops) weights by the batch's real request count in the
        # continuous profiler: a stage shared by B co-riders is B requests'
        # worth of that stage
        with PROFILER.weighted(n_queries):
            with sp, self._on_stream():
                resp = self.service.search(request)
                self._wait()
        self.busy_s += time.perf_counter() - t0
        self.batches += 1
        self.queries += n_queries
        return resp

    def stats(self) -> dict:
        d = {"replica": self.rid, "backend": self.service.spec.backend,
             "batches": self.batches, "queries": self.queries,
             "busy_s": self.busy_s, "inflight": self.inflight}
        reader = getattr(self.service.backend, "reader", None)
        if reader is not None:             # csd: this replica's own cache
            snap = reader.cache.snapshot()
            demand = snap["hits"] + snap["misses"]
            d.update(block_reads=snap["block_reads"],
                     bytes_read=snap["bytes_read"],
                     cache_hits=snap["hits"],
                     cache_misses=snap["misses"],
                     cache_hit_rate=(snap["hits"] / demand if demand
                                     else 0.0))
        return d

    def close(self) -> None:
        self._ex.shutdown(wait=True)
        if self.owns_backend:
            reader = getattr(self.service.backend, "reader", None)
            if reader is not None:
                reader.close()


def _collect_pool(pool: "ReplicaPool"):
    """Snapshot-time metric samples for every replica of this pool."""
    out = []
    for r in pool.replicas:
        labels = {"pool": pool.uid, "replica": str(r.rid)}
        out.append(("counter", "serve_replica_batches_total", labels,
                    r.batches))
        out.append(("counter", "serve_replica_queries_total", labels,
                    r.queries))
        out.append(("counter", "serve_replica_busy_seconds_total", labels,
                    r.busy_s))
        out.append(("gauge", "serve_replica_inflight", labels, r.inflight))
    return out


class ReplicaPool:
    """N replicas behind one `submit(request) -> Future[SearchResponse]`."""

    def __init__(self, replicas: list[Replica]):
        if not replicas:
            raise ValueError("ReplicaPool needs at least one replica")
        self.replicas = replicas
        self._lock = threading.Lock()
        self._rr = 0                       # round-robin cursor for ties
        self.uid = next_uid()
        REGISTRY.register_collector(self, _collect_pool)

    # -- construction --------------------------------------------------------

    @classmethod
    def replicate(cls, service, n: int) -> "ReplicaPool":
        """Replica 0 is the given service; 1..n-1 are backend-aware clones."""
        reps = [Replica(service, 0)]
        for i in range(1, max(int(n), 1)):
            svc, owns = _clone_service(service, i)
            reps.append(Replica(svc, i, owns_backend=owns))
        return cls(reps)

    # -- dispatch ------------------------------------------------------------

    def submit(self, request, *, n_queries: int | None = None) -> Future:
        """Least-loaded replica (in-flight depth), round-robin on ties.

        `n_queries` is the real (pre-padding) request count for the
        replica's counters; defaults to the batch's row count."""
        if n_queries is None:
            n_queries = int(request.queries.shape[0]
                            if hasattr(request.queries, "shape")
                            else np.asarray(request.queries).shape[0])
        with self._lock:
            n = len(self.replicas)
            rep = min(self.replicas,
                      key=lambda r: (r.inflight, (r.rid - self._rr) % n))
            self._rr = (rep.rid + 1) % n
            rep.inflight += 1
        fut = rep._ex.submit(rep._search, request, n_queries)
        fut.add_done_callback(lambda _f, r=rep: self._done(r))
        return fut

    def _done(self, rep: Replica) -> None:
        with self._lock:
            rep.inflight -= 1

    # -- stats / lifecycle ---------------------------------------------------

    def stats(self) -> list[dict]:
        with self._lock:
            return [r.stats() for r in self.replicas]

    def close(self) -> None:
        for r in self.replicas:
            r.close()

    def __len__(self) -> int:
        return len(self.replicas)


# ---------------------------------------------------------------------------
# Backend-aware replication
# ---------------------------------------------------------------------------


def _clone_service(service, i: int):
    """Returns (service, owns_backend) for replica i of the given service.

    Sharing is always safe — `search` is functional over immutable state —
    so every branch that cannot (or need not) clone falls back to it."""
    from repro_torch.api.service import SearchService

    if hasattr(service, "shards"):
        # cluster router (repro_torch.cluster): replication already happens
        # one layer down (per-shard replica sets with failover), so server
        # lanes share the one router — it is thread-safe by construction.
        return service, False

    if hasattr(service, "insert") and hasattr(service, "compact"):
        # mutable segmented index (repro_torch.ingest): every replica MUST
        # share the one service — independent clones would diverge on
        # writes. Its search() snapshots under the service lock, so shared
        # serving stays snapshot-consistent per batch.
        return service, False

    spec = service.spec
    if spec.backend == "csd":
        # independent PageCache/Prefetcher over the one shared block store
        from repro_torch.store.csd import CSDBackend
        from repro_torch.store.layout import open_store
        reader = open_store(spec.storage_path, spec.cache_bytes,
                            prefetch=spec.prefetch)
        return SearchService(spec, CSDBackend(spec, reader,
                                              service.device)), True

    dev = torch.device(service.device)
    if (dev.type == "cuda" and torch.cuda.device_count() > 1
            and spec.backend in ("exact", "hnsw", "partitioned")):
        clone = _place_on_device(
            service, torch.device("cuda", i % torch.cuda.device_count()))
        if clone is not None:
            return clone, False
    # one card, or the CPU: share
    return service, False


def _place_on_device(service, dev):
    """In-memory backend copy with its tensors on `dev`; None if the
    backend shape is unrecognized (caller falls back to sharing). The
    backends' constructors move the graph tables (`hg.device_db`) and the
    rerank / scan tables from the host copies they keep."""
    from repro_torch.api.service import SearchService

    backend = service.backend
    if hasattr(backend, "pdb"):            # partitioned / hnsw
        return SearchService(service.spec, type(backend)(
            service.spec, backend.pdb, backend.raw, dev))
    if hasattr(backend, "vectors") and hasattr(backend, "sqnorms"):  # exact
        return SearchService(service.spec, type(backend)(
            service.spec, backend.raw, dev))
    return None
