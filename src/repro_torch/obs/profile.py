"""Continuous per-stage profiler: the fig_obs breakdown, live (obs phase 2).

fig_obs answers "where does a request's time go?" by replaying recorded
trace spans offline. This module answers it continuously, in-process,
with the same zero-cost-when-disabled discipline as `Tracer`:

  * every span close feeds `PROFILER.observe(name, ms)` — either through
    `Tracer._record` (tracing enabled) or through the lightweight
    `_ProfSpan` the tracer hands out on its disabled path (tracing
    disabled, the default), so stage timings flow whether or not trace
    events are being retained;
  * durations aggregate into REGISTRY histograms
    (`profile_stage_ms{stage=...}`) — bounded memory, Prometheus-ready —
    plus internal resettable sums that `profile_report()` turns into the
    batch-size-weighted attribution fig_obs computes from spans:
    queue / traversal / store_read / rerank / dispatch_other, summing to
    the measured e2e latency exactly (queue+exec == e2e by construction;
    the exec residue is `dispatch_other`, never dropped);
  * batch-size weighting is explicit: `Replica._search` wraps the search
    call in `PROFILER.weighted(n_queries)` (a thread-local), so a stage
    shared by a batch of B co-riders counts B times — every rider
    experiences the whole stage — exactly fig_obs's `size/n_req` weight;
  * request-level latencies arrive via `PROFILER.request(queue, exec,
    e2e)` from the serve collector, NOT from spans: the batcher's
    retroactive request/queue/exec spans exist only for sampled traces,
    and the profiler must see every request.

Attribution caveat: with tracing enabled at sample_rate < 1.0, stage
spans are only observed for sampled traces while `request()` sees every
request — the breakdown then under-attributes stages. It is exact when
tracing is off (the production default) or fully sampled.

Overhead budget: the always-on profiler must cost <= 2% QPS on the csd
lane harness (asserted by benchmarks/fig_obs.py before BENCH_obs.json is
written). Disabled, it is one attribute check on the tracer's disabled
path.
"""

from __future__ import annotations

import threading
import time

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry

__all__ = ["Profiler", "PROFILER", "profile_report"]


class _NoopSpan:
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


class _ProfSpan:
    """Times one stage and feeds the profiler on exit. Handed out by the
    tracer's disabled path; mimics the span surface (`sampled`/`ctx`/
    `set`) so call sites need no branching."""

    __slots__ = ("_prof", "_name", "_t0")
    sampled = False
    ctx = None

    def __init__(self, prof: "Profiler", name: str):
        self._prof = prof
        self._name = name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._prof.observe(self._name, (time.perf_counter() - self._t0) * 1e3)
        return False

    def set(self, **attrs):
        pass


class _Weighted:
    """Context manager setting the thread-local batch-size weight."""

    __slots__ = ("_local", "_n", "_prev")

    def __init__(self, local, n):
        self._local = local
        self._n = n
        self._prev = None

    def __enter__(self):
        self._prev = getattr(self._local, "weight", None)
        self._local.weight = self._n
        return self

    def __exit__(self, *exc):
        self._local.weight = self._prev
        return False


def _collect_profiler(prof: "Profiler"):
    """Snapshot-time samples: totals the report is built from, published so
    an external scraper can compute the same attribution."""
    with prof._lock:
        n = prof._req_n
        out = [("counter", "profile_requests_total", {}, n)]
        for name, w in sorted(prof._wsum.items()):
            out.append(("counter", "profile_stage_weighted_ms_total",
                        {"stage": name}, w))
    return out


class Profiler:
    """Process-wide per-stage duration aggregator (one instance: PROFILER).

    Enabled by default — "always-on" is the point; `configure(
    enabled=False)` reduces it to one attribute check per span."""

    def __init__(self, enabled: bool = True,
                 registry: MetricsRegistry = REGISTRY):
        self.enabled = bool(enabled)
        self.registry = registry
        self._lock = threading.Lock()
        self._local = threading.local()
        self._hists: dict[str, object] = {}
        # resettable aggregates behind profile_report(); the REGISTRY
        # histograms stay cumulative (Prometheus counters never reset)
        self._sum: dict[str, float] = {}
        self._count: dict[str, int] = {}
        self._wsum: dict[str, float] = {}
        self._req_n = 0
        self._req_queue = 0.0
        self._req_exec = 0.0
        self._req_e2e = 0.0
        registry.register_collector(self, _collect_profiler)

    # -- configuration -------------------------------------------------------

    def configure(self, enabled: bool | None = None) -> "Profiler":
        if enabled is not None:
            self.enabled = bool(enabled)
        return self

    def reset(self) -> None:
        """Zero the report window (REGISTRY histograms are cumulative and
        stay)."""
        with self._lock:
            self._sum = {}
            self._count = {}
            self._wsum = {}
            self._req_n = 0
            self._req_queue = 0.0
            self._req_exec = 0.0
            self._req_e2e = 0.0

    # -- recording -----------------------------------------------------------

    def span(self, name: str):
        """A timing context for `name` (the tracer's disabled path calls
        this; direct use is fine too)."""
        if not self.enabled:
            return _NOOP
        return _ProfSpan(self, name)

    def weighted(self, n: int) -> _Weighted:
        """Stage observations inside this context count `n` times in the
        weighted attribution (n = the batch's pre-padding request count)."""
        return _Weighted(self._local, int(n))

    def observe(self, name: str, ms: float) -> None:
        """One closed stage span of `ms` milliseconds."""
        h = self._hists.get(name)
        if h is None:
            h = self._hists.setdefault(
                name, self.registry.histogram("profile_stage_ms", stage=name))
        h.observe(ms)
        w = getattr(self._local, "weight", None)
        with self._lock:
            self._sum[name] = self._sum.get(name, 0.0) + ms
            self._count[name] = self._count.get(name, 0) + 1
            if w:
                self._wsum[name] = self._wsum.get(name, 0.0) + ms * w

    def request(self, queue_ms: float, exec_ms: float, e2e_ms: float) -> None:
        """One completed request's latency split (from serve._Collector —
        the batcher's retroactive spans exist only for sampled traces)."""
        with self._lock:
            self._req_n += 1
            self._req_queue += queue_ms
            self._req_exec += exec_ms
            self._req_e2e += e2e_ms

    # -- reporting -----------------------------------------------------------

    def report(self) -> dict:
        """The live per-request stage attribution (fig_obs's breakdown).

        stage_ms sums to e2e_ms exactly: queue + exec == e2e by
        construction, traversal is reported net of its nested store
        reads, and the exec residue (replica wait, batch pack/pad,
        scatter) is `dispatch_other`."""
        with self._lock:
            n = self._req_n
            queue_s, exec_s, e2e_s = (self._req_queue, self._req_exec,
                                      self._req_e2e)
            wsum = dict(self._wsum)
            spans = {name: {"count": self._count[name],
                            "total_ms": round(self._sum[name], 3)}
                     for name in sorted(self._sum)}
        if n == 0:
            return {"requests": 0, "spans": spans}
        queue = queue_s / n
        execm = exec_s / n
        e2e = e2e_s / n
        trav = wsum.get("traversal", 0.0) / n
        store = wsum.get("store-read", 0.0) / n
        rerank = wsum.get("rerank", 0.0) / n
        breakdown = {
            "queue": queue,
            "traversal": trav - store,
            "store_read": store,
            "rerank": rerank,
            "dispatch_other": execm - trav - rerank,
        }
        total = sum(breakdown.values())
        return {
            "requests": n,
            "e2e_ms": round(e2e, 3),
            "stage_ms": {k: round(v, 3) for k, v in breakdown.items()},
            "stage_sum_ms": round(total, 3),
            "sum_matches_e2e": bool(
                abs(total - e2e) < 1e-6 * max(1.0, e2e)),
            "spans": spans,
        }


# The process-wide profiler (attached to TRACER by repro_torch.obs.__init__).
# Enabled by default: continuous profiling is the always-on telemetry tier.
PROFILER = Profiler(enabled=True)


def profile_report(reset: bool = False) -> dict:
    """The global profiler's attribution; `reset=True` starts a fresh
    window afterwards."""
    rep = PROFILER.report()
    if reset:
        PROFILER.reset()
    return rep
