"""Thread-safe request queue: one future per enqueued query.

This is the host-side front of the paper's deployment pipeline (Fig. 10):
clients hand over *single* queries and immediately get a
`concurrent.futures.Future`; the dynamic batcher drains the queue and packs
compatible requests into one `SearchRequest` for the accelerators. Each
`PendingQuery` carries everything the batcher needs to pack it (query row,
k/ef/rerank/stats knobs) and everything the stats rollup needs to attribute
latency (enqueue/dispatch timestamps, arrival sequence number).

Only requests that would traverse the graph identically may share a batch:
`batch_key` is (ef, rerank, with_stats). `k` is deliberately NOT part of
the key — the traversal shape is a function of `ef` alone
(`SearchParams.resolve`), so variable-k requests pack at k_max and slice
their own prefix back out, bit-identically.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any

import numpy as np

from repro_torch.obs.trace import TRACER

__all__ = ["ServeClosed", "PendingQuery", "QueryResult", "RequestQueue"]


class ServeClosed(RuntimeError):
    """Raised when submitting to a queue/server that has been shut down."""


@dataclasses.dataclass(eq=False)
class PendingQuery:
    """One enqueued query and the future its result will land in."""

    query: np.ndarray          # [D]
    k: int
    ef: int
    rerank: bool
    with_stats: bool
    future: Future
    seq: int                   # arrival order (global, monotonically rising)
    t_enqueue: float
    t_dispatch: float = 0.0    # stamped by the batcher at flush time
    trace: Any = None          # root SpanCtx (sampling decided at enqueue);
                               # the request/queue spans are recorded
                               # retroactively at scatter time

    @property
    def batch_key(self) -> tuple:
        """Requests may share a batch iff their traversal is identical;
        `k` is excluded on purpose (packed at max, sliced back)."""
        return (self.ef, self.rerank, self.with_stats)


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """What a resolved future carries: this request's own top-k slice plus
    the latency split (queueing vs execution vs end-to-end)."""

    ids: np.ndarray            # [k] global ids (-1 pads)
    dists: np.ndarray          # [k] distances (+inf pads)
    stats: Any = None          # per-query QueryStats row, if requested
    queue_ms: float = 0.0      # enqueue -> batch flush
    exec_ms: float = 0.0       # batch flush -> result materialized
    e2e_ms: float = 0.0        # enqueue -> result materialized


class RequestQueue:
    """FIFO of `PendingQuery` guarded by one condition variable.

    `collect` implements the dynamic-batching wait: it blocks until the
    head-of-line request either has `max_batch - 1` key-compatible followers
    or has waited `max_wait_s`, then atomically removes and returns that
    batch (arrival order preserved). Close flushes whatever is left
    immediately and makes further `put` calls raise `ServeClosed`.
    """

    def __init__(self) -> None:
        self._items: deque[PendingQuery] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._seq = 0

    def put(self, query, *, k: int = 10, ef: int = 40, rerank: bool = False,
            with_stats: bool = False) -> PendingQuery:
        q = np.asarray(query, np.float32)
        if q.ndim != 1:
            raise ValueError(
                f"RequestQueue.put takes one query vector [D], got shape "
                f"{q.shape}; use SearchServer.submit_many for a batch")
        with self._cond:
            if self._closed:
                raise ServeClosed("queue is shut down; no new requests")
            p = PendingQuery(query=q, k=k, ef=ef, rerank=rerank,
                             with_stats=with_stats, future=Future(),
                             seq=self._seq, t_enqueue=time.perf_counter(),
                             trace=TRACER.sample_request())
            self._seq += 1
            self._items.append(p)
            self._cond.notify_all()
        return p

    def collect(self, max_batch: int, max_wait_s: float
                ) -> list[PendingQuery] | None:
        """Block until a flushable batch exists; None == closed and empty.

        The batch is the first `max_batch` requests (in arrival order) that
        share the head-of-line request's `batch_key`; requests with other
        keys stay queued and form the next batches."""
        with self._cond:
            while True:
                if self._items:
                    head = self._items[0]
                    key = head.batch_key
                    matched = [p for p in self._items if p.batch_key == key]
                    wait_left = (head.t_enqueue + max_wait_s
                                 - time.perf_counter())
                    if (len(matched) >= max_batch or wait_left <= 0
                            or self._closed):
                        batch = matched[:max_batch]
                        taken = set(map(id, batch))
                        self._items = deque(
                            p for p in self._items if id(p) not in taken)
                        return batch
                    self._cond.wait(timeout=wait_left)
                elif self._closed:
                    return None
                else:
                    self._cond.wait()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)
