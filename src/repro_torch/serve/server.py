"""Serving front end: queue + dynamic batcher + replica pool, one object.

    svc = SearchService.build(vectors, spec)            # on the card
    with SearchServer(svc, replicas=4, max_batch=64, max_wait_ms=2.0) as srv:
        fut = srv.submit(query, k=10, ef=40)        # returns immediately
        res = fut.result()                          # QueryResult
        srv.drain()                                 # wait for in-flight work
        print(srv.stats().summary())

Latency semantics (the reference's `src/repro/serve/README.md` has the
full table):

    queue_ms : enqueue -> the batcher flushed the batch containing this
               request (time spent waiting for co-riders / a flush slot)
    exec_ms  : flush -> this request's results materialized on the host
               (replica queueing + device compute + transfer)
    e2e_ms   : enqueue -> materialized == queue_ms + exec_ms

`ServeStats` is the rollup the paper's §6.4 deployment table needs: QPS
over the measurement window, p50/p99 of each latency, the batch-size
histogram (how well dynamic batching packs), and per-replica counters
(including each csd replica's own block_reads / cache_hit_rate).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import Counter
from concurrent.futures import Future

import numpy as np

from repro_torch.obs import export as _export
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.profile import PROFILER
from repro_torch.obs.slo import SLOTracker
from repro_torch.obs.stats import latency_summary
from repro_torch.obs.trace import TRACER
from repro_torch.serve.batcher import DynamicBatcher
from repro_torch.serve.dispatch import ReplicaPool
from repro_torch.serve.queue import QueryResult, RequestQueue, ServeClosed

__all__ = ["SearchServer", "ServeStats"]

# batch sizes are small powers of two (bucket padding) — histogram bounds
# to match, not the latency default
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """One rollup of a serving window."""

    completed: int                  # requests resolved
    wall_s: float                   # first enqueue -> last completion
    qps: float
    queue_ms: dict                  # latency_summary dict:
    exec_ms: dict                   # {"p50","p99","p999","mean","count"}
    e2e_ms: dict
    batch_sizes: dict               # {real batch size: count} (pre-padding)
    mean_batch: float
    replicas: list                  # per-replica dicts (dispatch.Replica.stats)

    def summary(self) -> str:
        per_rep = " ".join(
            f"r{r['replica']}:{r['queries']}q" for r in self.replicas)
        return (f"{self.completed} queries  {self.qps:.1f} QPS  "
                f"queue p50 {self.queue_ms['p50']:.2f}ms  "
                f"exec p50 {self.exec_ms['p50']:.2f}ms  "
                f"e2e p99 {self.e2e_ms['p99']:.2f}ms  "
                f"mean batch {self.mean_batch:.1f}  [{per_rep}]")


class _Collector:
    """Thread-safe sink the batcher reports into."""

    def __init__(self, slo: SLOTracker | None = None) -> None:
        self._slo = slo
        self._lock = threading.Lock()
        self.queue_ms: list[float] = []
        self.exec_ms: list[float] = []
        self.e2e_ms: list[float] = []
        self.batch_sizes: Counter = Counter()
        self.t_first: float | None = None   # first enqueue (set by server)
        self.t_last: float | None = None    # last completion
        # registry instruments (process-wide series — servers aggregate)
        self._m_requests = REGISTRY.counter("serve_requests_total")
        self._m_batches = REGISTRY.counter("serve_batches_total")
        self._m_queue = REGISTRY.histogram("serve_queue_ms")
        self._m_exec = REGISTRY.histogram("serve_exec_ms")
        self._m_e2e = REGISTRY.histogram("serve_e2e_ms")
        self._m_bsz = REGISTRY.histogram("serve_batch_size",
                                         buckets=_BATCH_BUCKETS)
        self._m_errors = REGISTRY.counter("serve_errors_total")

    def mark_enqueue(self, t: float) -> None:
        with self._lock:
            if self.t_first is None:
                self.t_first = t

    def record_batch(self, size: int) -> None:
        with self._lock:
            self.batch_sizes[size] += 1
        self._m_batches.inc()
        self._m_bsz.observe(size)

    def record_done(self, res: QueryResult, t_done: float) -> None:
        with self._lock:
            self.queue_ms.append(res.queue_ms)
            self.exec_ms.append(res.exec_ms)
            self.e2e_ms.append(res.e2e_ms)
            self.t_last = (t_done if self.t_last is None
                           else max(self.t_last, t_done))
        self._m_requests.inc()
        self._m_queue.observe(res.queue_ms)
        self._m_exec.observe(res.exec_ms)
        self._m_e2e.observe(res.e2e_ms)
        # the continuous profiler sees EVERY request here (the batcher's
        # retroactive request/queue/exec spans exist only when sampled)
        if PROFILER.enabled:
            PROFILER.request(res.queue_ms, res.exec_ms, res.e2e_ms)
        if self._slo is not None:
            self._slo.record_latency(res.e2e_ms)

    def record_error(self, n: int = 1) -> None:
        """Requests failed by a dispatch exception (batcher _fail path)."""
        self._m_errors.inc(n)
        if self._slo is not None:
            self._slo.record_error(n)

    def rollup(self, replica_stats: list[dict]) -> ServeStats:
        with self._lock:
            completed = len(self.e2e_ms)
            wall = ((self.t_last - self.t_first)
                    if self.t_first is not None and self.t_last is not None
                    else 0.0)
            sizes = dict(sorted(self.batch_sizes.items()))
            n_batches = sum(sizes.values())
            return ServeStats(
                completed=completed,
                wall_s=wall,
                qps=completed / wall if wall > 0 else 0.0,
                queue_ms=latency_summary(self.queue_ms),
                exec_ms=latency_summary(self.exec_ms),
                e2e_ms=latency_summary(self.e2e_ms),
                batch_sizes=sizes,
                mean_batch=(completed / n_batches) if n_batches else 0.0,
                replicas=replica_stats,
            )


class SearchServer:
    """Async serving over one SearchService (or a prebuilt ReplicaPool)."""

    def __init__(self, service, *, replicas: int = 1, max_batch: int = 32,
                 max_wait_ms: float = 2.0, pad_to_bucket: bool = True,
                 slo=None, flight: int | FlightRecorder | None = 16):
        """`slo` is an SLOTracker (or an iterable of SLO objects, wrapped
        into one); `flight` sizes the slow-query flight recorder
        (int capacity, a prebuilt FlightRecorder, or None/0 to disable)."""
        self.pool = (service if isinstance(service, ReplicaPool)
                     else ReplicaPool.replicate(service, replicas))
        self.queue = RequestQueue()
        if slo is not None and not isinstance(slo, SLOTracker):
            slo = SLOTracker(slo)
        self.slo = slo
        if isinstance(flight, int):
            flight = FlightRecorder(capacity=flight) if flight > 0 else None
        self.flight = flight
        self._collector = _Collector(slo=slo)
        self.batcher = DynamicBatcher(
            self.queue, self.pool.submit, max_batch=max_batch,
            max_wait_ms=max_wait_ms, pad_to_bucket=pad_to_bucket,
            collector=self._collector, flight=self.flight)
        self._outstanding = 0
        self._drain_cond = threading.Condition()
        self._shutdown = False
        self.batcher.start()

    # -- submission ----------------------------------------------------------

    def submit(self, query, *, k: int = 10, ef: int = 40,
               rerank: bool = False, with_stats: bool = False) -> Future:
        """Enqueue one query vector [D]; the future resolves to QueryResult."""
        p = self.queue.put(query, k=k, ef=ef, rerank=rerank,
                           with_stats=with_stats)
        self._collector.mark_enqueue(p.t_enqueue)
        with self._drain_cond:
            self._outstanding += 1
        p.future.add_done_callback(self._one_done)
        return p.future

    def submit_many(self, queries, **kw) -> list[Future]:
        """One future per row of `queries` [B, D] (arrival order = row order)."""
        return [self.submit(q, **kw) for q in np.asarray(queries)]

    # -- mutations (mutable segmented indexes only) --------------------------
    # Writes interleave with batched reads under snapshot consistency: the
    # mutable service applies each mutation atomically under its own lock,
    # and every dispatched batch snapshots (segments, tombstones, memtable)
    # under that same lock — a batch sees the whole write or none of it.
    # Replicas share the one mutable service (dispatch._clone_service), so
    # a mutation is visible to every replica the moment it returns.

    def _mutable(self):
        svc = self.pool.replicas[0].service
        if not (hasattr(svc, "insert") and hasattr(svc, "compact")):
            raise TypeError(
                f"the served index (backend="
                f"{getattr(svc.spec, 'backend', '?')!r}) is immutable — "
                f"serve a repro_torch.api.MutableSearchService to accept writes")
        if self._shutdown:
            raise ServeClosed("server is shut down; no new mutations")
        return svc

    def insert(self, vectors) -> np.ndarray:
        """Insert rows into the served mutable index; returns global ids.
        Synchronous: on return, every later-dispatched batch sees them."""
        return self._mutable().insert(vectors)

    def delete(self, ids) -> int:
        """Tombstone global ids; batches dispatched after the call can
        never return them. Returns the newly-deleted count."""
        return self._mutable().delete(ids)

    def flush_index(self) -> None:
        """Seal the served index's memtable into a segment."""
        self._mutable().flush()

    def compact_index(self) -> dict:
        """Compact the served index; in-flight batches keep serving from
        their pre-compaction snapshot while the rebuild runs."""
        return self._mutable().compact()

    def _one_done(self, _fut: Future) -> None:
        with self._drain_cond:
            self._outstanding -= 1
            if self._outstanding == 0:
                self._drain_cond.notify_all()

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted request has resolved (or timeout);
        returns True when fully drained."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._drain_cond:
            while self._outstanding > 0:
                left = (None if deadline is None
                        else deadline - time.perf_counter())
                if left is not None and left <= 0:
                    return False
                self._drain_cond.wait(timeout=left)
            return True

    def shutdown(self, drain: bool = True,
                 timeout: float | None = None) -> None:
        """Graceful stop: optionally drain, then close the queue (new
        submits raise ServeClosed), stop the batcher, close the pool.
        Without drain, already-queued requests are still flushed — a
        request is never dropped, only refused at the door."""
        if self._shutdown:
            return
        if drain:
            self.drain(timeout)
        self._shutdown = True
        self.queue.close()
        self.batcher.join(timeout=30)
        self.drain(timeout=30)             # flushed-at-close stragglers
        self.pool.close()

    def stats(self) -> ServeStats:
        return self._collector.rollup(self.pool.stats())

    def slo_status(self) -> list[dict] | None:
        """Evaluate the attached SLOs now (None when none attached)."""
        return None if self.slo is None else self.slo.evaluate()

    def debug_dump(self, path: str | None = None):
        """The flight recorder's Perfetto document: span trees of the
        slowest/errored captured requests + their records under
        otherData.flight. Writes to `path` when given (returns the path),
        else returns the document dict."""
        if self.flight is None:
            raise RuntimeError("flight recorder disabled (flight=None)")
        if path is not None:
            return self.flight.write(path, tracer=TRACER)
        return self.flight.export(tracer=TRACER)

    def metrics(self, fmt: str = "prometheus") -> str:
        """Process-wide metrics snapshot (this server's series included),
        rendered for scraping: fmt='prometheus' (text exposition) or
        'json'."""
        snap = REGISTRY.snapshot()
        if fmt == "prometheus":
            return _export.to_prometheus(snap)
        if fmt == "json":
            return _export.to_json(snap)
        raise ValueError(f"unknown metrics format {fmt!r}; "
                         f"use 'prometheus' or 'json'")

    def __enter__(self) -> "SearchServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # convenience re-export so callers can `except srv.Closed`
    Closed = ServeClosed
