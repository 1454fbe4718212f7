"""Process-wide metrics registry: counters, gauges, bounded histograms.

One `MetricsRegistry` (`REGISTRY`) absorbs every ad-hoc stats surface the
stack grew — the PageCache counters, the serve rollup, the cluster
rollup, the ingest residency bounds — behind a single `snapshot()` that
the exporters (`obs.export`) turn into Prometheus text or JSON.

Two ways in:

  * direct instruments — `REGISTRY.counter("serve_requests_total")` /
    `gauge` / `histogram`; get-or-create by (name, labels), each with its
    own lock so N threads incrementing never lose a count (pinned by the
    concurrency test);
  * collectors — `REGISTRY.register_collector(obj, fn)` holds a WEAK
    reference to `obj` and calls `fn(obj)` at snapshot time. Objects that
    already keep counters under their own locks (PageCache, ClusterRouter,
    MutableSearchService) publish through this with zero hot-path cost;
    a garbage-collected owner silently drops out of the snapshot.

Collector sample form: `(kind, name, labels_dict, value)` where kind is
"counter" or "gauge". Histograms are direct-only (they need `observe`).

Metric naming follows Prometheus conventions (`*_total` for counters,
`*_bytes`/`*_ms` units in the name); docs/observability.md carries the
full name table with the paper-figure mapping.
"""

from __future__ import annotations

import bisect
import itertools
import threading
import weakref

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "DEFAULT_MS_BUCKETS", "next_uid"]

# Latency buckets (ms): two-decade log-ish spread around the regimes the
# repo actually serves (sub-ms kernels to multi-second cold builds).
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)

_uid = itertools.count()


def next_uid() -> str:
    """Small unique label value for per-object metric streams (one per
    PageCache / service / router instance)."""
    return str(next(_uid))


class Counter:
    """Monotonic counter; `inc` is exact under concurrency (own lock)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value; settable and incrementable."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Bounded-bucket histogram (cumulative counts, Prometheus-style).

    `buckets` are inclusive upper bounds; one implicit +Inf bucket tops
    them off, so memory is fixed no matter how many observations land."""

    __slots__ = ("name", "labels", "buckets", "_lock", "_counts", "_sum",
                 "_count")

    def __init__(self, name: str, labels: dict, buckets=DEFAULT_MS_BUCKETS):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.name = name
        self.labels = labels
        self.buckets = b
        self._lock = threading.Lock()
        self._counts = [0] * (len(b) + 1)        # last slot == +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v) -> None:
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, out = 0, []
        for le, c in zip(self.buckets + (float("inf"),), counts):
            cum += c
            out.append((le, cum))
        return {"buckets": out, "sum": s, "count": total}


def _key(kind: str, name: str, labels: dict) -> tuple:
    return (kind, name, tuple(sorted(labels.items())))


class MetricsRegistry:
    """Get-or-create instrument store + weakref collector hub."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}
        self._collectors: list[tuple[weakref.ref, object]] = []

    # -- direct instruments --------------------------------------------------

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, buckets=DEFAULT_MS_BUCKETS,
                  **labels) -> Histogram:
        k = _key("histogram", name, labels)
        with self._lock:
            m = self._metrics.get(k)
            if m is None:
                m = self._metrics[k] = Histogram(name, labels, buckets)
            return m

    def _get(self, kind, cls, name, labels):
        k = _key(kind, name, labels)
        with self._lock:
            m = self._metrics.get(k)
            if m is None:
                m = self._metrics[k] = cls(name, labels)
            return m

    # -- collectors ----------------------------------------------------------

    def register_collector(self, obj, fn) -> None:
        """At snapshot time call `fn(obj)` -> iterable of
        (kind, name, labels, value). Weakly referenced: when `obj` dies its
        series vanish from the snapshot (no unregister bookkeeping)."""
        with self._lock:
            self._collectors.append((weakref.ref(obj), fn))

    # -- snapshot ------------------------------------------------------------

    def snapshot(self) -> dict:
        """One structured view of everything: the registry's instruments
        plus every live collector's samples."""
        with self._lock:
            metrics = list(self._metrics.items())
            collectors = list(self._collectors)
        out = {"counters": [], "gauges": [], "histograms": []}
        for (kind, name, _), m in metrics:
            if kind == "histogram":
                out["histograms"].append(
                    {"name": name, "labels": dict(m.labels),
                     **m.snapshot()})
            else:
                out[kind + "s"].append({"name": name,
                                        "labels": dict(m.labels),
                                        "value": m.value})
        dead = False
        for ref, fn in collectors:
            obj = ref()
            if obj is None:
                dead = True
                continue
            try:
                samples = fn(obj)
            except Exception:            # a dying owner must not take the
                continue                 # whole snapshot with it
            for kind, name, labels, value in samples:
                out[kind + "s"].append({"name": name, "labels": dict(labels),
                                        "value": value})
        if dead:
            with self._lock:
                self._collectors = [(r, f) for r, f in self._collectors
                                    if r() is not None]
        out["counters"].sort(key=lambda s: (s["name"], sorted(
            s["labels"].items())))
        out["gauges"].sort(key=lambda s: (s["name"], sorted(
            s["labels"].items())))
        out["histograms"].sort(key=lambda s: (s["name"], sorted(
            s["labels"].items())))
        return out


# The process-wide registry every layer publishes into.
REGISTRY = MetricsRegistry()
