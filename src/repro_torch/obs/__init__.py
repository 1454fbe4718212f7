"""repro_torch.obs — the port's copy of the reference's telemetry spine.

Standard library and numpy only, copied from `repro.obs` with every span,
metric and file-format name kept, so a snapshot of the port reads as one
of the reference:

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
  * `SLOTracker` / `default_slos` — declarative latency / error-rate /
                 recall objectives with multi-window burn-rate breaches.
  * `FlightRecorder` — bounded capture of the N slowest + errored
                 requests, dumpable as Perfetto JSON.
  * `to_prometheus` / `to_json` / `write_snapshot` / `PeriodicExporter`
                 — the snapshot writers (Prometheus text or JSON).
  * `latency_summary` — the one percentile helper (p50/p99/p999/mean).
  * `calibrate` / `compare_terms` — fit the cost model's storage hit rate,
                 bandwidth and per-superstep dispatch overhead from a
                 snapshot and price the measured workload with the
                 card's `launch.roofline.HW`.
"""

from repro_torch.obs.calibrate import (Calibration, calibrate,
                                       compare_terms, load_calibration)
from repro_torch.obs.export import (PeriodicExporter, to_json,
                                    to_prometheus, write_snapshot)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (DEFAULT_MS_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry, REGISTRY)
from repro_torch.obs.profile import PROFILER, Profiler, profile_report
from repro_torch.obs.slo import SLO, SLOTracker, default_slos
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
    "SLO", "SLOTracker", "default_slos",
    "FlightRecorder",
    "latency_summary",
    "to_prometheus", "to_json", "write_snapshot", "PeriodicExporter",
    "Calibration", "calibrate", "load_calibration", "compare_terms",
]
