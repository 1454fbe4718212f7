"""Hierarchical trace spans over the whole serving stack (Fig. 9-12 fuel).

The paper's evaluation is a per-stage attribution exercise — how much of a
query's latency is queueing, traversal, flash reads (P2P-DMA), rerank —
and every ROADMAP perf item needs the same breakdown to be validated.
`Tracer` provides it as one global object threaded through the hot path:

    from repro_torch.obs.trace import TRACER
    TRACER.configure(enabled=True, sample_rate=1.0)
    with TRACER.span("search", backend="csd"):
        with TRACER.child_span("traversal", partition=0):
            ...
    TRACER.write("trace.json")        # Chrome/Perfetto trace-event JSON

Design points (all load-bearing for the <5%-enabled / unmeasurable-
disabled overhead budget):

  * disabled        : `span()` is one attribute check returning a shared
                      no-op context manager — no allocation, no clock read,
                      no lock. This is the default state.
  * sampling        : the decision is made ONCE per trace, at the root
                      span (`sample_rate`); descendants inherit it through
                      a thread-local span stack, so an unsampled request
                      costs only a stack push/pop per span.
  * nesting         : implicit via the thread-local stack on one thread;
                      explicit via `parent=ctx` across threads (the
                      batcher -> replica handoff) and across the wire
                      (`SpanCtx.wire()` rides the shard message header).
  * retroactive     : stages whose timestamps already exist (queue wait,
                      batch windows) are recorded after the fact with
                      `record_span(t0, t1, ...)` — zero hot-path cost.
  * bounded         : at most `max_events` spans are kept; later spans are
                      counted in `dropped` instead of growing memory.
  * device clock    : a child span that launches device work may pass
                      `device_clock=<device>`; on a CUDA device it is then
                      bracketed by two CUDA events on the device's current
                      stream. They are resolved lazily, in `spans()`,
                      after waiting for them there, never in the request:
                      the span gains `dev_ms`, the device's time between
                      them.
  * profiler clock  : while a torch profiler is recording, every sampled
                      span also opens `record_function(<span name>)`, so
                      the program's layers are host ranges of the same
                      Kineto trace as the kernels.

torch is only looked up on the enabled path, and imported only there.

Span identity is exported into each trace event's `args` (`span_id`,
`parent_id`, `trace_id`) so tests and the per-stage benchmark can rebuild
the tree; Chrome/Perfetto nest visually by (tid, time containment).
"""

from __future__ import annotations

import json
import random
import sys
import threading
import time

__all__ = ["SpanCtx", "Tracer", "TRACER"]


class SpanCtx:
    """Lightweight handle to a span: enough to parent children anywhere
    (another thread, another process via `wire()`)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id: int, span_id: int, parent_id: int,
                 sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled

    def wire(self) -> list:
        """Wire-encodable form (rides the cluster message JSON header)."""
        return [self.trace_id, self.span_id, 1 if self.sampled else 0]

    @classmethod
    def from_wire(cls, w) -> "SpanCtx":
        return cls(int(w[0]), int(w[1]), 0, bool(w[2]))


class _NoopSpan:
    """Returned when tracing is disabled: does nothing, allocates nothing."""

    __slots__ = ()
    sampled = False
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NOOP = _NoopSpan()


class _UnsampledSpan:
    """Keeps the thread-local nesting bookkeeping for a sampled-out trace
    (so descendants see `sampled=False`) without recording anything."""

    __slots__ = ("_stack",)
    sampled = False
    ctx = None

    def __init__(self, stack: list):
        self._stack = stack

    def __enter__(self):
        self._stack.append(self)
        return self

    def __exit__(self, *exc):
        self._stack.pop()
        return False

    def set(self, **attrs):
        pass


class Span:
    """One live sampled span; records itself on exit."""

    __slots__ = ("_tracer", "_stack", "name", "attrs", "trace_id",
                 "span_id", "parent_id", "t0", "t1", "_clock", "_rf",
                 "_cuda")
    sampled = True

    def __init__(self, tracer: "Tracer", stack: list, name: str,
                 trace_id: int, span_id: int, parent_id: int, attrs: dict,
                 clock=None):
        self._tracer = tracer
        self._stack = stack
        self.name = name
        self.attrs = attrs
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = 0.0
        self.t1 = 0.0
        self._clock = clock      # a CUDA device to bracket with events
        self._rf = None          # the open record_function, under a profiler
        self._cuda = None        # (stream, start, end)

    @property
    def ctx(self) -> SpanCtx:
        return SpanCtx(self.trace_id, self.span_id, self.parent_id, True)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._stack.append(self)
        torch = sys.modules.get("torch")
        if torch is not None and torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter()
        if self._clock is not None:
            self._cuda = self._tracer._start_events(self._clock)
        return self

    def __exit__(self, *exc):
        events = None
        if self._cuda is not None:
            stream, start, end = self._cuda
            end.record(stream)
            events = (start, end)
        self.t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._stack.pop()
        self._tracer._record(self.name, self.t0, self.t1, self.trace_id,
                             self.span_id, self.parent_id, None, self.attrs,
                             events)
        return False


_AMBIENT = object()          # sentinel: "parent = current thread-local span"


class Tracer:
    """Process-wide span recorder. One instance (`TRACER`) serves the whole
    stack; tests may build private instances."""

    def __init__(self, enabled: bool = False, sample_rate: float = 1.0,
                 max_events: int = 1_000_000):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._events: list[dict] = []
        self._next_id = 1
        self._epoch = time.perf_counter()
        self._rng = random.Random()
        self.dropped = 0
        # Optional continuous profiler fed at span close (obs phase 2).
        # Left None on private tracers; repro_torch.obs.__init__ attaches the
        # global PROFILER to the global TRACER so stage timings keep
        # flowing even with tracing disabled (span() hands out a
        # lightweight profiler span instead of the shared no-op).
        self.profiler = None

    # -- configuration -------------------------------------------------------

    def configure(self, enabled: bool | None = None,
                  sample_rate: float | None = None,
                  max_events: int | None = None) -> "Tracer":
        if sample_rate is not None:
            if not 0.0 <= sample_rate <= 1.0:
                raise ValueError(
                    f"sample_rate must be in [0, 1], got {sample_rate}")
            self.sample_rate = float(sample_rate)
        if max_events is not None:
            self.max_events = int(max_events)
        if enabled is not None:
            self.enabled = bool(enabled)
        return self

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self.dropped = 0
            self._epoch = time.perf_counter()

    # -- internals -----------------------------------------------------------

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _ids(self, n: int = 1) -> int:
        with self._lock:
            i = self._next_id
            self._next_id += n
        return i

    def _sample(self) -> bool:
        r = self.sample_rate
        return r >= 1.0 or (r > 0.0 and self._rng.random() < r)

    def _record(self, name, t0, t1, trace_id, span_id, parent_id, tid,
                attrs, cuda=None) -> None:
        p = self.profiler
        if p is not None and p.enabled:
            # before the max_events bound: profiling aggregates are O(1)
            # per stage name, so they never drop with the event buffer
            p.observe(name, (t1 - t0) * 1e3)
        ev = {"name": name, "t0": t0, "t1": t1, "trace": trace_id,
              "id": span_id, "parent": parent_id,
              "tid": tid if tid is not None else threading.current_thread().name,
              "attrs": attrs or {}}
        if cuda is not None:
            ev["_cuda"] = cuda       # (start, end): see _resolve
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # -- the device's clock --------------------------------------------------

    def _start_events(self, device) -> tuple:
        """(stream, start, end) for a span on the CUDA `device`, with
        `start` recorded on its current stream."""
        import torch

        device = torch.device(device)
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        stream = torch.cuda.current_stream(index)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        return stream, start, end

    def _resolve(self) -> None:
        """Give each recorded span that holds CUDA events its `dev_ms`,
        waiting here for the events to complete."""
        with self._lock:
            pending = [(ev, ev.pop("_cuda")) for ev in self._events
                       if "_cuda" in ev]
        for ev, (start, end) in pending:
            end.synchronize()
            ev["dev_ms"] = start.elapsed_time(end)

    # -- span creation -------------------------------------------------------

    def span(self, name: str, parent=_AMBIENT, **attrs):
        """Context manager for one span.

        parent omitted : nest under the current thread-local span; start a
                         new (sampling-decided) trace if there is none.
        parent=ctx     : explicit cross-thread/cross-wire parent.
        parent=None    : force a new root trace.
        """
        if not self.enabled:
            p = self.profiler
            if p is not None and p.enabled:
                return p.span(name)
            return _NOOP
        stack = self._stack()
        if parent is _AMBIENT:
            top = stack[-1] if stack else None
            if top is None:
                if not self._sample():
                    return _UnsampledSpan(stack)
                tid = self._ids(2)
                return Span(self, stack, name, tid, tid + 1, 0, attrs)
            if not top.sampled:
                return _UnsampledSpan(stack)
            return Span(self, stack, name, top.trace_id, self._ids(),
                        top.span_id, attrs)
        if parent is None:
            if not self._sample():
                return _UnsampledSpan(stack)
            tid = self._ids(2)
            return Span(self, stack, name, tid, tid + 1, 0, attrs)
        if not parent.sampled:
            return _UnsampledSpan(stack)
        return Span(self, stack, name, parent.trace_id, self._ids(),
                    parent.span_id, attrs)

    def child_span(self, name: str, device_clock=None, **attrs):
        """A span ONLY if a sampled span is already open on this thread —
        never starts a new trace. The inner layers (store reads, hops,
        segments) use this so background work (prefetch threads, health
        probes) cannot spawn stray root traces.

        device_clock : the device the span's work runs on; a CUDA device
                       brackets the span with CUDA events (`dev_ms`)."""
        if not self.enabled:
            p = self.profiler
            if p is not None and p.enabled:
                return p.span(name)
            return _NOOP
        stack = self._stack()
        top = stack[-1] if stack else None
        if top is None or not top.sampled:
            return _NOOP
        clock = device_clock if str(device_clock).startswith("cuda") else None
        return Span(self, stack, name, top.trace_id, self._ids(),
                    top.span_id, attrs, clock)

    def current_ctx(self) -> SpanCtx | None:
        """Ctx of the innermost span on this thread (None when untraced)."""
        if not self.enabled:
            return None
        stack = self._stack()
        top = stack[-1] if stack else None
        return top.ctx if top is not None and top.sampled else None

    # -- out-of-band recording (retroactive / pre-allocated spans) -----------

    def sample_request(self) -> SpanCtx | None:
        """Reserve a root ctx for a request whose span will be recorded
        retroactively (the serve queue records `request`/`queue` spans at
        scatter time, when the timestamps are known). Returns None when
        tracing is disabled; an unsampled ctx when sampled out."""
        if not self.enabled:
            return None
        if not self._sample():
            return SpanCtx(0, 0, 0, False)
        tid = self._ids(2)
        return SpanCtx(tid, tid + 1, 0, True)

    def child_ctx(self, parent: SpanCtx | None) -> SpanCtx | None:
        """Pre-allocate a ctx under `parent` (recorded later via
        `record_span(ctx=...)`); None if the parent is absent/unsampled."""
        if parent is None or not parent.sampled or not self.enabled:
            return None
        return SpanCtx(parent.trace_id, self._ids(), parent.span_id, True)

    def record_span(self, name: str, t0: float, t1: float, *,
                    ctx: SpanCtx | None = None, parent: SpanCtx | None = None,
                    tid: str | None = None, **attrs) -> SpanCtx | None:
        """Record a span from already-measured perf_counter timestamps.

        `ctx` uses a pre-allocated identity (sample_request / child_ctx);
        otherwise a fresh span id is minted under `parent`. Returns the
        recorded span's ctx (None if unsampled/disabled)."""
        if not self.enabled:
            return None
        if ctx is not None:
            if not ctx.sampled:
                return None
            trace_id, span_id, parent_id = (ctx.trace_id, ctx.span_id,
                                            ctx.parent_id)
            if parent is not None and parent.sampled:
                parent_id = parent.span_id
        elif parent is not None:
            if not parent.sampled:
                return None
            trace_id, span_id, parent_id = (parent.trace_id, self._ids(),
                                            parent.span_id)
        else:
            trace_id = self._ids(2)
            span_id, parent_id = trace_id + 1, 0
        self._record(name, t0, t1, trace_id, span_id, parent_id, tid, attrs)
        return SpanCtx(trace_id, span_id, parent_id, True)

    # -- export --------------------------------------------------------------

    def spans(self) -> list[dict]:
        """Raw recorded spans (internal schema) — tests and the per-stage
        benchmark aggregate over this. A span that held CUDA events also
        carries `dev_ms`."""
        self._resolve()
        with self._lock:
            return list(self._events)

    def export(self, trace_ids=None) -> dict:
        """Chrome trace-event JSON object (loads in chrome://tracing and
        https://ui.perfetto.dev): complete ('X') events, ts/dur in us
        relative to the tracer epoch.

        `trace_ids` (an iterable of trace ids) restricts the export to
        those traces — the flight recorder uses this to dump only the
        span trees of the requests it captured."""
        with self._lock:
            events = list(self._events)
            epoch = self._epoch
            dropped = self.dropped
        if trace_ids is not None:
            keep = set(trace_ids)
            events = [ev for ev in events if ev["trace"] in keep]
        tids: dict[str, int] = {}
        out = []
        for ev in events:
            tid = tids.setdefault(str(ev["tid"]), len(tids) + 1)
            args = {"trace_id": ev["trace"], "span_id": ev["id"],
                    "parent_id": ev["parent"]}
            args.update(ev["attrs"])
            out.append({"name": ev["name"], "ph": "X", "pid": 1, "tid": tid,
                        "ts": round((ev["t0"] - epoch) * 1e6, 3),
                        "dur": round((ev["t1"] - ev["t0"]) * 1e6, 3),
                        "cat": "repro", "args": args})
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": "repro"}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": 1, "tid": n,
                  "args": {"name": t}} for t, n in sorted(
                      tids.items(), key=lambda kv: kv[1])]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": dropped}}

    def write(self, path: str, trace_ids=None) -> str:
        with open(path, "w") as f:
            json.dump(self.export(trace_ids), f)
        return path


# The process-wide tracer every layer records into. Disabled by default;
# launch/serve.py --trace, scripts, and tests flip it on.
TRACER = Tracer(enabled=False)
