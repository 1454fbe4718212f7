"""repro_torch.obs — the port's copy of the reference's telemetry core.

Four modules, standard library and numpy only, copied from `repro.obs`
with every span and metric name kept, so a snapshot of the port reads as
one of the reference:

  * `TRACER`   — hierarchical trace spans over the request path (search
                 -> traversal -> store-read / hop_superstep -> hop-kernel,
                 rerank), Chrome/Perfetto trace-event JSON; near-zero cost
                 when disabled (the default), sampled when enabled.
  * `REGISTRY` — process-wide counters / gauges / bounded histograms and
                 snapshot-time collectors (the page cache, the csd
                 backend).
  * `PROFILER` — continuous per-stage profiling fed at span close, with
                 tracing on or off; `profile_report()` gives the stage
                 attribution.
  * `latency_summary` — the one percentile helper (p50/p99/p999/mean).

The exporters, SLOs, flight recorder and calibration of the reference's
`repro.obs` are not ported yet (ROADMAP.md).
"""

from repro_torch.obs.metrics import (DEFAULT_MS_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry, REGISTRY)
from repro_torch.obs.profile import PROFILER, Profiler, profile_report
from repro_torch.obs.stats import latency_summary
from repro_torch.obs.trace import TRACER, SpanCtx, Tracer

# The global tracer feeds the global profiler at span close, as the
# reference's package does; private Tracer() instances stay unlinked.
TRACER.profiler = PROFILER

__all__ = [
    "TRACER", "Tracer", "SpanCtx",
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_MS_BUCKETS",
    "PROFILER", "Profiler", "profile_report",
    "latency_summary",
]
