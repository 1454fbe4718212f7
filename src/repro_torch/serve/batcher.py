"""Dynamic batcher: flush on max_batch or max_wait_ms, scatter per-request.

The batcher thread drains the `RequestQueue` in arrival order, packs each
key-compatible batch into ONE `SearchRequest`, hands it to a dispatch
callable (typically `ReplicaPool.submit`, which returns a future so the
batcher keeps flushing while replicas work), and scatters the response back
onto the per-request futures:

  * variable k packs at k_max — the traversal only depends on `ef`
    (`SearchParams.resolve`), so each request's own top-k is the first k
    rows of the packed result, bit-identical to a direct search;
  * the query batch is padded with zero rows to the next power-of-two
    bucket (capped at max_batch), as the reference does for its compiled
    shapes — padded rows are dropped before scatter and never touch a
    future. Every backend answers each query lane on its own, so pad
    lanes change no real lane.

A response's ids and dists (tensors on the service's device) are copied
to the host once a batch, then sliced per request.

Any dispatch/scatter failure lands as `set_exception` on every future of
the batch — a request is never silently lost.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.api.types import QueryStats, SearchRequest
from repro_torch.obs.trace import TRACER
from repro_torch.serve.queue import PendingQuery, QueryResult, RequestQueue

__all__ = ["DynamicBatcher", "bucket_size", "slice_stats"]


def bucket_size(n: int, max_batch: int) -> int:
    """Next power-of-two >= n, capped at max_batch (compile-shape bucket)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch) if max_batch >= n else n


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _host_stats(stats: QueryStats) -> QueryStats:
    """The per-query stats tensors of a batch on the host, in one copy
    each; scalars and the segment list as they are."""
    moved = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            moved[f.name] = v.cpu().numpy()
    return dataclasses.replace(stats, **moved)


def slice_stats(stats: QueryStats, i: int) -> QueryStats:
    """Row `i` of the per-query stats (tensors on any device, or arrays),
    on the host; per-request scalars (the csd storage counters — shared
    PageCache, per-query attribution undefined) and the per-segment dict
    list (mutable indexes) pass through unchanged."""
    vals = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if v is None:
            vals[f.name] = None
            continue
        if f.name == "segments":       # per-request structure, not per-query
            vals[f.name] = v
            continue
        a = _host(v)
        vals[f.name] = a[i] if a.ndim >= 1 else v
    return QueryStats(**vals)


class DynamicBatcher:
    """One daemon thread turning queued single queries into packed batches.

    dispatch : called as dispatch(request, n_queries=<real batch size>) ->
        SearchResponse | Future. `n_queries` is the pre-padding request
        count, so per-replica accounting never counts bucket-padding rows.
        A future return (the replica pool) lets the batcher flush the next
        batch while this one executes; a plain response (direct service)
        makes the batcher synchronous.
    collector : optional stats sink with record_batch(size) /
        record_done(result, t_done) / record_error(n)
        (see server._Collector).
    flight : optional FlightRecorder capturing the slowest + errored
        requests at scatter time.
    """

    def __init__(self, queue: RequestQueue, dispatch, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0, pad_to_bucket: bool = True,
                 collector=None, flight=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.queue = queue
        self.dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.pad_to_bucket = pad_to_bucket
        self.collector = collector
        self.flight = flight
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-batcher")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    # -- the flush loop ------------------------------------------------------

    def _run(self) -> None:
        while True:
            batch = self.queue.collect(self.max_batch,
                                       self.max_wait_ms / 1e3)
            if batch is None:
                return
            try:
                self._flush(batch)
            except Exception as e:          # a failed batch fails loudly,
                self._fail(batch, e)        # on its own futures only

    def _flush(self, batch: list[PendingQuery]) -> None:
        t = time.perf_counter()
        for p in batch:
            p.t_dispatch = t
        head = batch[0]
        q = np.stack([p.query for p in batch])
        if self.pad_to_bucket:
            b = bucket_size(len(batch), self.max_batch)
            if b > len(batch):
                q = np.concatenate(
                    [q, np.zeros((b - len(batch), q.shape[1]), q.dtype)])
        # the batch span parents on the first sampled request's root; its
        # ctx rides the SearchRequest so the replica-thread dispatch/search
        # spans nest under this batch, not under some other thread's state
        head_ctx = next((p.trace for p in batch
                         if p.trace is not None and p.trace.sampled), None)
        batch_ctx = TRACER.child_ctx(head_ctx)
        req = SearchRequest(queries=q, k=max(p.k for p in batch),
                            ef=head.ef, rerank=head.rerank,
                            with_stats=head.with_stats, trace=batch_ctx)
        if self.collector is not None:
            self.collector.record_batch(len(batch))
        out = self.dispatch(req, n_queries=len(batch))
        if isinstance(out, Future):
            out.add_done_callback(
                lambda f, b=batch, c=batch_ctx: self._completed(b, f, c))
        else:
            self._scatter(batch, out, batch_ctx)

    def _completed(self, batch: list[PendingQuery], fut: Future,
                   batch_ctx=None) -> None:
        try:
            resp = fut.result()
        except Exception as e:
            self._fail(batch, e)
            return
        try:
            self._scatter(batch, resp, batch_ctx)
        except Exception as e:
            self._fail(batch, e)

    def _scatter(self, batch: list[PendingQuery], resp,
                 batch_ctx=None) -> None:
        ids = _host(resp.ids)              # one host copy a batch
        dists = _host(resp.dists)
        t_done = time.perf_counter()
        head = batch[0]
        if batch_ctx is not None:
            # retroactive: the batch window (flush -> results back), one
            # span per batch on a virtual "batch" lane
            TRACER.record_span("batch", head.t_dispatch, t_done,
                               ctx=batch_ctx, tid="batch",
                               size=len(batch), ef=head.ef)
        all_stats = None
        if head.with_stats and resp.stats is not None:
            all_stats = _host_stats(resp.stats)
        for i, p in enumerate(batch):
            stats = None
            if p.with_stats and all_stats is not None:
                stats = slice_stats(all_stats, i)
            res = QueryResult(ids=ids[i, :p.k], dists=dists[i, :p.k],
                              stats=stats,
                              queue_ms=(p.t_dispatch - p.t_enqueue) * 1e3,
                              exec_ms=(t_done - p.t_dispatch) * 1e3,
                              e2e_ms=(t_done - p.t_enqueue) * 1e3)
            if p.trace is not None and p.trace.sampled:
                # retroactive per-request spans, on a virtual per-request
                # lane so Perfetto nests request > queue/exec by containment
                lane = f"req-{p.seq % 16}"
                TRACER.record_span("request", p.t_enqueue, t_done,
                                   ctx=p.trace, tid=lane, seq=p.seq, k=p.k)
                TRACER.record_span("queue", p.t_enqueue, p.t_dispatch,
                                   parent=p.trace, tid=lane)
                TRACER.record_span("exec", p.t_dispatch, t_done,
                                   parent=p.trace, tid=lane)
            if self.collector is not None:
                self.collector.record_done(res, t_done)
            if self.flight is not None:
                self.flight.record(seq=p.seq, e2e_ms=res.e2e_ms,
                                   queue_ms=res.queue_ms,
                                   exec_ms=res.exec_ms, k=p.k, ef=head.ef,
                                   trace=p.trace, stats=stats)
            p.future.set_result(res)

    def _fail(self, batch: list[PendingQuery], exc: Exception) -> None:
        n = 0
        for p in batch:
            if not p.future.done():
                p.future.set_exception(exc)
                n += 1
                if self.flight is not None:
                    self.flight.record_error(
                        seq=p.seq, error=f"{type(exc).__name__}: {exc}",
                        k=p.k, trace=p.trace)
        if n and self.collector is not None:
            self.collector.record_error(n)
