"""Slow-query flight recorder: keep the evidence for the tail.

A p999 outlier is gone by the time anyone looks for it — the trace
buffer has rotated, the histogram only says "something was slow". The
flight recorder keeps a bounded record of exactly the requests worth
replaying:

  * the N SLOWEST completed requests (a min-heap keyed on e2e latency:
    a new request only displaces the fastest of the current captures),
    each with its latency split, parameters, per-query engine stats
    (`QueryStats`, JSON-safe), and — when the request was traced — its
    trace id;
  * every ERRORED request (a separate ring, newest-kept), because a
    failure is always worth more than a slow success.

`export(tracer)` turns the captures into one Perfetto/Chrome trace
document: the tracer's span trees filtered to just the captured trace
ids (`Tracer.export(trace_ids=...)`), with the capture records embedded
under `otherData.flight`. `SearchServer.debug_dump()` and the serve
CLI's `--flight-out` flag write exactly this document.

The hot-path cost is one lock + one float compare per completed request
(plus a heap push only when the request makes the cut).
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import threading
from collections import deque

import numpy as np

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry

__all__ = ["FlightRecorder"]


def _jsonable(v):
    """JSON-safe view of capture payloads (QueryStats carries numpy)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _jsonable(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    a = np.asarray(v)
    if a.ndim == 0:
        return a.item()
    return a.tolist()


def _collect_flight(fr: "FlightRecorder"):
    with fr._lock:
        return [
            ("counter", "flight_captured_total", {}, fr._captured),
            ("counter", "flight_errors_total", {}, fr._errored),
            ("gauge", "flight_slowest_ms", {},
             fr._heap[0][0] if len(fr._heap) == fr.capacity else 0.0),
        ]


class FlightRecorder:
    """Bounded capture of the slowest + errored requests (see module
    docstring). Thread-safe; one instance per SearchServer."""

    def __init__(self, capacity: int = 16,
                 registry: MetricsRegistry = REGISTRY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._heap: list = []          # (e2e_ms, uniq, record) min-heap
        self._errors: deque = deque(maxlen=self.capacity)
        self._uniq = 0                 # heap tie-break, monotone
        self._captured = 0             # lifetime records admitted
        self._errored = 0
        registry.register_collector(self, _collect_flight)

    # -- recording -----------------------------------------------------------

    def record(self, *, seq: int, e2e_ms: float, queue_ms: float = 0.0,
               exec_ms: float = 0.0, k: int | None = None,
               ef: int | None = None, trace=None, stats=None) -> bool:
        """Offer one completed request; returns True if it was kept.
        `trace` is the request's SpanCtx (trace id kept only when the
        request was actually sampled); `stats` its QueryStats, if any."""
        e2e_ms = float(e2e_ms)
        with self._lock:
            if len(self._heap) == self.capacity and e2e_ms <= self._heap[0][0]:
                return False           # faster than every current capture
            rec = {
                "seq": int(seq),
                "e2e_ms": round(e2e_ms, 3),
                "queue_ms": round(float(queue_ms), 3),
                "exec_ms": round(float(exec_ms), 3),
                "k": k, "ef": ef,
                "trace_id": (trace.trace_id
                             if trace is not None and trace.sampled else None),
                "stats": _jsonable(stats),
            }
            self._uniq += 1
            item = (e2e_ms, self._uniq, rec)
            if len(self._heap) < self.capacity:
                heapq.heappush(self._heap, item)
            else:
                heapq.heapreplace(self._heap, item)
            self._captured += 1
            return True

    def record_error(self, *, seq: int, error: str,
                     k: int | None = None, trace=None) -> None:
        """An errored request is always kept (newest `capacity` of them)."""
        with self._lock:
            self._errored += 1
            self._errors.append({
                "seq": int(seq), "error": str(error), "k": k,
                "trace_id": (trace.trace_id
                             if trace is not None and trace.sampled
                             else None),
            })

    # -- inspection / export -------------------------------------------------

    def snapshot(self) -> dict:
        """Current captures: slowest first, plus the errored ring."""
        with self._lock:
            slowest = [rec for (_, _, rec) in
                       sorted(self._heap, key=lambda it: -it[0])]
            return {"capacity": self.capacity,
                    "captured_total": self._captured,
                    "errors_total": self._errored,
                    "slowest": slowest,
                    "errored": list(self._errors)}

    def trace_ids(self) -> set:
        with self._lock:
            ids = {rec["trace_id"] for (_, _, rec) in self._heap}
            ids |= {r["trace_id"] for r in self._errors}
        ids.discard(None)
        return ids

    def export(self, tracer=None) -> dict:
        """One Perfetto/Chrome trace document: the captured requests'
        span trees (when `tracer` recorded them) + the capture records
        under otherData.flight. Valid trace JSON even with no tracer."""
        ids = self.trace_ids()
        if tracer is not None and ids:
            doc = tracer.export(trace_ids=ids)
        else:
            doc = {"traceEvents": [], "displayTimeUnit": "ms",
                   "otherData": {}}
        doc.setdefault("otherData", {})["flight"] = self.snapshot()
        return doc

    def write(self, path: str, tracer=None) -> str:
        with open(path, "w") as f:
            json.dump(self.export(tracer), f)
        return path
