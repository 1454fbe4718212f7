"""Declarative SLOs with multi-window burn-rate breach detection.

The paper's operating point is a latency/recall contract (75.59 QPS at
recall 0.94, §6.2/§6.5); this module makes such contracts first-class:
declare objectives, feed the tracker from the serve path, and breaches
surface as `slo_*` REGISTRY series plus bounded in-process events.

Objective kinds
---------------
  latency    : `objective` fraction of requests must finish within
               `target` ms ("p99 e2e <= 50ms" is objective=0.99,
               target=50). Error budget = 1 - objective.
  error_rate : the failed-request fraction must stay below `target`
               (budget = target; successes arrive via record_latency,
               failures via record_error).
  recall     : `objective` fraction of recall probes (the recall-
               regression fixtures replayed against live traffic) must
               score >= `target`. Budget = 1 - objective.

Breach semantics (the SRE multi-window burn-rate rule)
------------------------------------------------------
Each sample is good/bad; over a sliding window the burn rate is
bad_fraction / error_budget (1.0 = consuming budget exactly as fast as
the objective allows). A breach fires only when BOTH the long window
(`window_s`) and the short window (`window_s * short_frac`) burn at
>= `burn_threshold`, with at least `min_samples` long-window samples:
the long window gives significance, the short window makes the alert
reset quickly once the condition clears (no alerting on stale pain).

Breach EVENTS are edge-triggered (not-breaching -> breaching), appended
to a bounded list and counted in `slo_breaches_total`; the current burn
rates and breach state are gauges, re-set on every `evaluate()`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry

__all__ = ["SLO", "SLOTracker", "default_slos"]

_KINDS = ("latency", "error_rate", "recall")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective (see module docstring for kinds)."""

    name: str
    kind: str
    target: float
    objective: float = 0.99
    window_s: float = 60.0
    short_frac: float = 1.0 / 12.0     # SRE convention: short = long/12
    burn_threshold: float = 2.0
    min_samples: int = 20

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if self.budget() <= 0.0:
            raise ValueError(
                f"SLO {self.name!r} has no error budget: "
                f"objective/target leave nothing to burn")

    def budget(self) -> float:
        """Allowed bad-sample fraction (what burn rate 1.0 consumes)."""
        if self.kind == "error_rate":
            return self.target
        return 1.0 - self.objective

    @property
    def short_window_s(self) -> float:
        return self.window_s * self.short_frac


class _State:
    """Per-SLO sliding window: (monotonic_t, bad) samples + edge state."""

    __slots__ = ("samples", "breaching")

    def __init__(self, max_samples: int):
        self.samples: deque = deque(maxlen=max_samples)
        self.breaching = False


def _collect_slo(tr: "SLOTracker"):
    with tr._lock:
        return [("counter", "slo_samples_total", {"slo": s.name, **tr.labels},
                 tr._seen[s.name]) for s in tr.slos]


class SLOTracker:
    """Feeds samples from the serve path, evaluates burn rates on demand.

    Hot-path cost per request: one lock + one deque append per matching
    SLO. Windows are bounded (`max_samples`) so a tracker that is fed but
    never evaluated cannot grow without bound."""

    def __init__(self, slos, *, clock=time.monotonic, labels=None,
                 registry: MetricsRegistry = REGISTRY,
                 max_samples: int = 65536, max_events: int = 256):
        self.slos: tuple[SLO, ...] = tuple(slos)
        if not self.slos:
            raise ValueError("SLOTracker needs at least one SLO")
        self.labels = dict(labels or {})
        self.clock = clock
        self.registry = registry
        self._lock = threading.Lock()
        self._state = {s.name: _State(max_samples) for s in self.slos}
        # lifetime sample count (stays monotone when the window wraps)
        self._seen = {s.name: 0 for s in self.slos}
        self._events: deque = deque(maxlen=max_events)
        self._m_breaches = {
            s.name: registry.counter("slo_breaches_total",
                                     slo=s.name, **self.labels)
            for s in self.slos}
        registry.register_collector(self, _collect_slo)

    # -- feeding -------------------------------------------------------------

    def _push(self, slo: SLO, bad: bool) -> None:
        self._seen[slo.name] += 1
        self._state[slo.name].samples.append((self.clock(), bad))

    def record_latency(self, e2e_ms: float) -> None:
        """One completed request: a latency sample AND an error-rate
        success sample."""
        with self._lock:
            for s in self.slos:
                if s.kind == "latency":
                    self._push(s, e2e_ms > s.target)
                elif s.kind == "error_rate":
                    self._push(s, False)

    def record_error(self, n: int = 1) -> None:
        """`n` failed requests (dispatch exceptions, shard failures)."""
        with self._lock:
            for s in self.slos:
                if s.kind == "error_rate":
                    for _ in range(int(n)):
                        self._push(s, True)

    def record_recall(self, recall: float) -> None:
        """One recall probe (recall-regression fixture replayed live)."""
        with self._lock:
            for s in self.slos:
                if s.kind == "recall":
                    self._push(s, recall < s.target)

    # -- evaluation ----------------------------------------------------------

    @staticmethod
    def _window(samples, now: float, horizon_s: float):
        n = bad = 0
        cutoff = now - horizon_s
        for (t, b) in samples:
            if t >= cutoff:
                n += 1
                bad += b
        return n, bad

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Prune, compute both windows' burn rates, fire edge-triggered
        breach events, refresh the `slo_*` gauges. Returns one status
        dict per SLO."""
        if now is None:
            now = self.clock()
        out = []
        with self._lock:
            for s in self.slos:
                st = self._state[s.name]
                cutoff = now - s.window_s
                while st.samples and st.samples[0][0] < cutoff:
                    st.samples.popleft()
                n_long, bad_long = self._window(st.samples, now, s.window_s)
                n_short, bad_short = self._window(st.samples, now,
                                                  s.short_window_s)
                budget = s.budget()
                frac_long = bad_long / n_long if n_long else 0.0
                frac_short = bad_short / n_short if n_short else 0.0
                burn_long = frac_long / budget
                burn_short = frac_short / budget
                breaching = (n_long >= s.min_samples
                             and burn_long >= s.burn_threshold
                             and burn_short >= s.burn_threshold)
                if breaching and not st.breaching:
                    self._events.append({
                        "slo": s.name, "kind": s.kind, "at": now,
                        "burn_long": round(burn_long, 3),
                        "burn_short": round(burn_short, 3),
                        "samples": n_long, "bad": bad_long,
                        "labels": dict(self.labels)})
                    self._m_breaches[s.name].inc()
                st.breaching = breaching
                out.append({
                    "slo": s.name, "kind": s.kind, "target": s.target,
                    "objective": s.objective, "window_s": s.window_s,
                    "samples": n_long, "bad": bad_long,
                    "bad_frac": round(frac_long, 6),
                    "burn_long": round(burn_long, 3),
                    "burn_short": round(burn_short, 3),
                    "burn_threshold": s.burn_threshold,
                    "breaching": breaching})
        reg = self.registry
        for row in out:
            lab = {"slo": row["slo"], **self.labels}
            reg.gauge("slo_burn_rate", window="long", **lab).set(
                row["burn_long"])
            reg.gauge("slo_burn_rate", window="short", **lab).set(
                row["burn_short"])
            reg.gauge("slo_breaching", **lab).set(
                1.0 if row["breaching"] else 0.0)
        return out

    def breaches(self) -> list[dict]:
        """Edge-triggered breach events so far (bounded, oldest first)."""
        with self._lock:
            return list(self._events)

    def summary(self, now: float | None = None) -> str:
        """Human-readable drain-time summary (launch/serve.py --slo)."""
        lines = []
        for row in self.evaluate(now):
            state = "BREACH" if row["breaching"] else "ok"
            lines.append(
                f"slo {row['slo']:<14} [{state:>6}] kind={row['kind']} "
                f"target={row['target']} burn={row['burn_long']:.2f}x"
                f"/{row['burn_short']:.2f}x (long/short) "
                f"bad={row['bad']}/{row['samples']}")
        n = len(self.breaches())
        lines.append(f"slo breach events: {n}")
        return "\n".join(lines)


def default_slos(p99_ms: float = 50.0, error_rate: float = 0.01,
                 recall_floor: float | None = None,
                 window_s: float = 60.0) -> list[SLO]:
    """The serve CLI's stock objectives: p99 e2e latency, error rate,
    and (optional) a recall floor matching the recall-regression tests."""
    slos = [
        SLO(name="latency_p99", kind="latency", target=p99_ms,
            objective=0.99, window_s=window_s),
        SLO(name="error_rate", kind="error_rate", target=error_rate,
            window_s=window_s),
    ]
    if recall_floor is not None:
        slos.append(SLO(name="recall_floor", kind="recall",
                        target=recall_floor, objective=0.95,
                        window_s=window_s))
    return slos
