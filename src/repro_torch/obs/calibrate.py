"""Cost-model calibration: fit HW parameters from measured telemetry (the
reference's `obs/calibrate.py`; `compare_terms` prices with the port's
`launch/roofline.HW`, the card's constants).

`launch/costmodel.py` prices queries from hand-entered `HW` constants
(§6.5's SSD-bandwidth-bound regime: a guessed `ssd_bw`, a guessed cache
hit rate, zero dispatch overhead). After this module, the constants come
from the system itself: point `calibrate()` at a REGISTRY snapshot (the
JSON the `PeriodicExporter` / `write_snapshot` emit) and get back the
parameters the workload actually exhibited —

    cache_hit_rate        store_cache hits / (hits + misses)
    effective_ssd_bw      flash bytes actually read / seconds spent in
                          store-read spans (the continuous profiler's
                          `profile_stage_ms{stage="store-read"}` sum)
    blocks_per_query      demand block accesses per csd query
    dispatch_overhead_s   per-superstep host time NOT inside the hop
                          kernel: (superstep span time - hop-kernel span
                          time) / supersteps — the host<->device sync tax
                          the fused-hop work amortizes
    hops/supersteps/bytes per query, from the csd_* counters

`compare_terms()` then prices the measured workload through the analytic
model twice — once with the HW priors, once with the fitted parameters —
and reports per-term modeled-vs-measured relative error (storage,
fanout, dispatch). `ann_dryrun --calibrated <metrics.json>` surfaces
exactly this table, so capacity planning runs on observed numbers
(ROADMAP item 5).

Requires a snapshot taken while the continuous profiler was on (the
default) and csd traffic flowed; missing inputs yield None fields rather
than errors, and `compare_terms` marks those terms unavailable.
"""

from __future__ import annotations

import dataclasses
import json

__all__ = ["Calibration", "calibrate", "load_calibration", "compare_terms",
           "store_window"]


# -- snapshot accessors ------------------------------------------------------

def _counter_sum(snap: dict, name: str) -> float | None:
    """Sum of a counter over all label sets; None when absent entirely."""
    vals = [s["value"] for s in snap.get("counters", ())
            if s["name"] == name]
    return float(sum(vals)) if vals else None


def _gauge_max(snap: dict, name: str) -> float | None:
    vals = [s["value"] for s in snap.get("gauges", ())
            if s["name"] == name]
    return float(max(vals)) if vals else None


def _hist_totals(snap: dict, name: str, **labels) -> tuple[float, int]:
    """(sum, count) over histograms matching `name` + label subset."""
    tot, n = 0.0, 0
    for h in snap.get("histograms", ()):
        if h["name"] != name:
            continue
        if any(h["labels"].get(k) != v for k, v in labels.items()):
            continue
        tot += h["sum"]
        n += h["count"]
    return tot, n


# -- the fit -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Calibration:
    """Fitted workload/hardware parameters (None = not in the snapshot)."""

    queries: int | None
    cache_hit_rate: float | None
    effective_ssd_bw: float | None       # bytes/s through store-read spans
    blocks_per_query: float | None       # demand block accesses / query
    bytes_per_query: float | None        # flash bytes / query
    hops_per_query: float | None
    supersteps_per_query: float | None
    dispatch_overhead_s: float | None    # host s per superstep, ex-kernel
    store_read_s: float | None           # total wall s inside store reads
    graph_degree: int | None             # csd m0_pad (padded out-degree)
    vector_row_bytes: int | None
    block_size: int | None
    source: dict = dataclasses.field(default_factory=dict)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def calibrate(snapshot: dict) -> Calibration:
    """Fit a `Calibration` from one REGISTRY snapshot (see module doc)."""
    hits = _counter_sum(snapshot, "store_cache_hits_total")
    misses = _counter_sum(snapshot, "store_cache_misses_total")
    flash_bytes = _counter_sum(snapshot, "store_bytes_read_total")
    queries = _counter_sum(snapshot, "csd_queries_total")
    hops = _counter_sum(snapshot, "csd_hops_total")
    steps = _counter_sum(snapshot, "csd_supersteps_total")

    store_ms, store_n = _hist_totals(snapshot, "profile_stage_ms",
                                     stage="store-read")
    # superstep wall time: "hop_superstep" on the fused path, "hop" on the
    # unfused path (there each hop IS one superstep / host sync)
    sup_ms, sup_n = _hist_totals(snapshot, "profile_stage_ms",
                                 stage="hop_superstep")
    hop_ms, hop_n = _hist_totals(snapshot, "profile_stage_ms", stage="hop")
    kern_ms, _ = _hist_totals(snapshot, "profile_stage_ms",
                              stage="hop-kernel")
    sup_ms += hop_ms
    sup_n += hop_n

    demand = (hits + misses) if hits is not None and misses is not None \
        else None
    hit_rate = (hits / demand) if demand else None
    store_read_s = store_ms / 1e3 if store_n else None
    eff_bw = (flash_bytes / store_read_s
              if flash_bytes and store_read_s else None)
    q = int(queries) if queries else None
    dispatch = (max(0.0, sup_ms - kern_ms) / 1e3 / sup_n) if sup_n else None

    return Calibration(
        queries=q,
        cache_hit_rate=hit_rate,
        effective_ssd_bw=eff_bw,
        blocks_per_query=(demand / q) if demand is not None and q else None,
        bytes_per_query=(flash_bytes / q)
        if flash_bytes is not None and q else None,
        hops_per_query=(hops / q) if hops is not None and q else None,
        supersteps_per_query=(steps / q)
        if steps is not None and q else None,
        dispatch_overhead_s=dispatch,
        store_read_s=store_read_s,
        graph_degree=(int(g) if (g := _gauge_max(snapshot,
                                                 "csd_graph_degree")) else None),
        vector_row_bytes=(int(g) if (g := _gauge_max(
            snapshot, "csd_vector_row_bytes")) else None),
        block_size=(int(g) if (g := _gauge_max(snapshot,
                                               "csd_block_size")) else None),
        source={"store_read_spans": store_n, "superstep_spans": sup_n},
    )


def load_calibration(path: str) -> Calibration:
    """Calibrate from a metrics snapshot JSON on disk (the exporter's
    `.json` output)."""
    with open(path) as f:
        return calibrate(json.load(f))


def store_window(before: dict, after: dict, uids) -> dict:
    """One store's series over a window, as a snapshot `calibrate` reads.

    `calibrate` sums counters and takes the gauges' maximum over every
    label set, so a snapshot of a process serving several csd stores
    would fit their mixture without an error. This keeps the counters and
    gauges labelled by one of `uids` (the csd backend's `uid` and its
    page cache's), counters as `after` minus `before`, and the profiler's
    `profile_stage_ms` histograms as `after` minus `before`. Those carry
    no store label: the window must hold this store's traffic alone."""
    uids = set(uids)

    def key(s):
        return s["name"], tuple(sorted(s["labels"].items()))

    def ours(s):
        return bool(uids & set(s["labels"].values()))

    was = {key(s): s["value"] for s in before.get("counters", ())}
    hist = {key(h): h for h in before.get("histograms", ())}
    out = {"counters": [], "gauges": [], "histograms": []}
    for s in after.get("counters", ()):
        if ours(s):
            out["counters"].append(
                {**s, "value": s["value"] - was.get(key(s), 0)})
    out["gauges"] = [dict(s) for s in after.get("gauges", ()) if ours(s)]
    for h in after.get("histograms", ()):
        if h["name"] != "profile_stage_ms":
            continue
        h0 = hist.get(key(h), {"sum": 0.0, "count": 0})
        out["histograms"].append({"name": h["name"],
                                  "labels": dict(h["labels"]),
                                  "sum": h["sum"] - h0["sum"],
                                  "count": h["count"] - h0["count"]})
    return out


# -- modeled vs measured -----------------------------------------------------

def _term(modeled, measured, calibrated=None) -> dict:
    rel = ((modeled - measured) / measured) if measured else None
    out = {"modeled": modeled, "measured": measured,
           "rel_error": round(rel, 4) if rel is not None else None}
    if calibrated is not None:
        crel = ((calibrated - measured) / measured) if measured else None
        out["calibrated"] = calibrated
        out["calibrated_rel_error"] = (round(crel, 4)
                                       if crel is not None else None)
    return out


def compare_terms(cal: Calibration, hw=None) -> dict:
    """Per-term modeled-vs-measured error on the measured workload.

    storage  : seconds/query in flash reads — HW-prior model vs the
               profiler's store-read time, plus the calibrated model
               (measured hit rate + effective bandwidth).
    fanout   : demand block accesses/query — the analytic
               hops x degree x row/block estimate vs the cache's count.
    dispatch : host seconds/superstep — the model's prior is 0 (it only
               prices flash); measured is the fitted per-superstep
               overhead, which `dispatch_cost` can now price.
    """
    from repro_torch.launch.costmodel import dispatch_cost, storage_cost
    from repro_torch.launch.roofline import HW
    hw = hw or HW()
    terms: dict[str, dict] = {}

    q = cal.queries or 0
    if q and cal.blocks_per_query and cal.block_size and cal.store_read_s:
        measured_s = cal.store_read_s / q
        prior = storage_cost(cal.blocks_per_query, cal.block_size,
                             cache_hit_rate=0.0, ssd_bw=hw.ssd_bw)
        fitted = storage_cost(cal.blocks_per_query, cal.block_size,
                              cache_hit_rate=cal.cache_hit_rate or 0.0,
                              ssd_bw=cal.effective_ssd_bw or hw.ssd_bw)
        terms["storage"] = _term(prior.storage_s, measured_s,
                                 fitted.storage_s)
        terms["storage"]["unit"] = "s/query"
    else:
        terms["storage"] = {"unavailable": True}

    if (cal.hops_per_query and cal.graph_degree and cal.vector_row_bytes
            and cal.block_size and cal.blocks_per_query):
        modeled_bpq = (cal.hops_per_query * cal.graph_degree
                       * cal.vector_row_bytes / cal.block_size)
        terms["fanout"] = _term(round(modeled_bpq, 3),
                                round(cal.blocks_per_query, 3),
                                round(cal.blocks_per_query, 3))
        terms["fanout"]["unit"] = "blocks/query"
    else:
        terms["fanout"] = {"unavailable": True}

    if cal.dispatch_overhead_s is not None:
        dc = dispatch_cost(cal.supersteps_per_query or 0.0,
                           cal.dispatch_overhead_s)
        # the prior model prices dispatch at zero — the whole point of
        # this term is to surface how much that omission costs
        terms["dispatch"] = _term(0.0, cal.dispatch_overhead_s,
                                  cal.dispatch_overhead_s)
        terms["dispatch"]["unit"] = "s/superstep"
        terms["dispatch"]["dispatch_s_per_query"] = round(dc.dispatch_s, 9)
    else:
        terms["dispatch"] = {"unavailable": True}

    return terms
