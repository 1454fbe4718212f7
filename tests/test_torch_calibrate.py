"""The port's cost-model calibration (`repro_torch.obs.calibrate`) against
the reference's (`repro.obs.calibrate`), on the CPU.

  * The reference's synthetic snapshot (hand-picked numbers with known
    answers, `tests/test_calibrate.py`), the empty snapshot, unfused hop
    spans and the load round trip give `Calibration.asdict()` and
    `compare_terms` equal to the reference's, bit for bit, at the
    default `ssd_bw` and at another one.
  * `store_window` keeps one store's series of a window: its backend's
    and page cache's counters as differences, their gauges, and the
    profiler's stage histograms as differences.
  * A live csd search of the port with PROFILER on, windowed to its
    store, passes the reference's live bar (the csd_* series equal the
    backend's own counters; storage, fanout and dispatch all fitted; the
    calibrated storage term within 2x of measured), and the reference's
    `calibrate` reads the port's snapshot as the port's does.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.launch.roofline import HW as RefHW
from repro.obs import calibrate as ref_calibrate
from repro.obs import compare_terms as ref_compare_terms
from repro.obs import load_calibration as ref_load
from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.data import VectorDataset
from repro_torch.launch.roofline import HW
from repro_torch.obs import (PROFILER, REGISTRY, Calibration, calibrate,
                             compare_terms, load_calibration)
from repro_torch.obs.calibrate import store_window

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)


def synthetic_snapshot():
    """The reference's synthetic snapshot (`tests/test_calibrate.py`):
    100 queries, 80% hit rate, 1000 demand accesses, 200 misses x 4096B
    from flash in 0.8s of store-read time, 500 hops over 125 supersteps
    with 2ms/superstep of host overhead on top of 1ms/superstep of kernel
    time."""
    return {
        "counters": [
            {"name": "store_cache_hits_total", "labels": {}, "value": 800},
            {"name": "store_cache_misses_total", "labels": {}, "value": 200},
            {"name": "store_bytes_read_total", "labels": {},
             "value": 200 * 4096},
            {"name": "csd_queries_total", "labels": {}, "value": 100},
            {"name": "csd_hops_total", "labels": {}, "value": 500},
            {"name": "csd_supersteps_total", "labels": {}, "value": 125},
        ],
        "gauges": [
            {"name": "csd_graph_degree", "labels": {}, "value": 24},
            {"name": "csd_vector_row_bytes", "labels": {}, "value": 512},
            {"name": "csd_block_size", "labels": {}, "value": 4096},
        ],
        "histograms": [
            {"name": "profile_stage_ms", "labels": {"stage": "store-read"},
             "buckets": [], "sum": 800.0, "count": 400},
            {"name": "profile_stage_ms",
             "labels": {"stage": "hop_superstep"},
             "buckets": [], "sum": 375.0, "count": 125},
            {"name": "profile_stage_ms", "labels": {"stage": "hop-kernel"},
             "buckets": [], "sum": 125.0, "count": 125},
        ],
    }


def unfused_snapshot():
    snap = synthetic_snapshot()
    for h in snap["histograms"]:
        if h["labels"].get("stage") == "hop_superstep":
            h["labels"]["stage"] = "hop"
    return snap


def empty_snapshot():
    return {"counters": [], "gauges": [], "histograms": []}


def _same_as_reference(snap, ssd_bw=None):
    """Port and reference fits and term tables of `snap`, held equal."""
    cal, ref = calibrate(copy.deepcopy(snap)), ref_calibrate(snap)
    assert isinstance(cal, Calibration)
    assert cal.asdict() == ref.asdict()
    hw, rhw = ((HW(), RefHW()) if ssd_bw is None
               else (HW(ssd_bw=ssd_bw), RefHW(ssd_bw=ssd_bw)))
    terms = compare_terms(cal, hw=hw)
    assert terms == ref_compare_terms(ref, hw=rhw)
    if ssd_bw is None:
        assert compare_terms(cal) == ref_compare_terms(ref)
    return cal, terms


@pytest.mark.parametrize("ssd_bw", [None, 1.25e9])
@pytest.mark.parametrize("make", [synthetic_snapshot, unfused_snapshot,
                                  empty_snapshot])
def test_fit_and_terms_equal_reference(make, ssd_bw):
    _same_as_reference(make(), ssd_bw)


def test_synthetic_known_answers():
    """The reference's known answers, read off the port."""
    cal, terms = _same_as_reference(synthetic_snapshot())
    assert cal.queries == 100
    assert cal.cache_hit_rate == pytest.approx(0.8)
    assert cal.effective_ssd_bw == pytest.approx(200 * 4096 / 0.8)
    assert cal.dispatch_overhead_s == pytest.approx(0.002)
    assert cal.source == {"store_read_spans": 400, "superstep_spans": 125}
    assert terms["storage"]["calibrated"] == pytest.approx(0.008)
    assert terms["fanout"]["modeled"] == pytest.approx(15.0)
    assert terms["dispatch"]["dispatch_s_per_query"] == pytest.approx(0.0025)
    assert calibrate(unfused_snapshot()).dispatch_overhead_s == \
        pytest.approx(0.002)
    empty = compare_terms(calibrate(empty_snapshot()))
    assert empty == {t: {"unavailable": True}
                     for t in ("storage", "fanout", "dispatch")}
    assert json.dumps(calibrate(empty_snapshot()).asdict())


def test_load_calibration_roundtrip(tmp_path):
    path = str(tmp_path / "metrics.json")
    with open(path, "w") as f:
        json.dump(synthetic_snapshot(), f)
    cal = load_calibration(path)
    assert cal.asdict() == ref_load(path).asdict()
    assert cal.queries == 100 and cal.block_size == 4096


def test_store_window_keeps_one_store():
    """Two stores' series and a process-wide counter: the window holds
    store "a"'s counters and gauges only, counters and stage histograms
    as differences."""
    def snap(scale):
        out = {"counters": [], "gauges": [], "histograms": []}
        for uid, key in (("a", "backend"), ("b", "backend")):
            out["counters"].append({"name": "csd_queries_total",
                                    "labels": {key: uid},
                                    "value": 10 * scale})
            out["gauges"].append({"name": "csd_block_size",
                                  "labels": {key: uid},
                                  "value": 4096 if uid == "a" else 512})
        out["counters"].append({"name": "store_cache_hits_total",
                                "labels": {"cache": "ca"},
                                "value": 3 * scale})
        out["counters"].append({"name": "api_queries_total",
                                "labels": {"backend": "csd"},
                                "value": 99 * scale})
        out["histograms"].append({"name": "profile_stage_ms",
                                  "labels": {"stage": "store-read"},
                                  "buckets": [], "sum": 2.5 * scale,
                                  "count": 4 * scale})
        out["histograms"].append({"name": "serve_e2e_ms", "labels": {},
                                  "buckets": [], "sum": 1.0, "count": 1})
        return out

    w = store_window(snap(1), snap(3), ["a", "ca"])
    assert w["counters"] == [
        {"name": "csd_queries_total", "labels": {"backend": "a"},
         "value": 20},
        {"name": "store_cache_hits_total", "labels": {"cache": "ca"},
         "value": 6}]
    assert w["gauges"] == [{"name": "csd_block_size",
                            "labels": {"backend": "a"}, "value": 4096}]
    assert w["histograms"] == [{"name": "profile_stage_ms",
                                "labels": {"stage": "store-read"},
                                "sum": 5.0, "count": 8}]
    # a series new in the window counts from zero
    assert store_window(empty_snapshot(), snap(1), ["a"])["counters"][0][
        "value"] == 10


@pytest.fixture(scope="module")
def csd_store(tmp_path_factory):
    ds = VectorDataset(1000, 32, 12, seed=3)
    v, q = np.rint(ds.vectors()), np.rint(np.clip(ds.queries(32), 0, 255))
    return v, q, tmp_path_factory.mktemp("calibrate-csd")


@pytest.mark.parametrize("hops", [1, 4])
def test_live_csd_calibration(csd_store, hops):
    """Real csd traffic of the port, windowed to its store: the reference's
    live bar, and the reference's fit of the same snapshot."""
    v, q, tmp = csd_store
    spec = IndexSpec(backend="csd", num_partitions=2,
                     hnsw=HNSWConfig(M=8, ef_construction=40),
                     storage_path=str(tmp / f"store-h{hops}"),
                     cache_bytes=64 * 1024, fused_hops=hops, prefetch=False)
    svc = SearchService.build(v, spec, device="cpu")
    be = svc.backend
    uids = (be.uid, be.reader.cache.uid)
    was = PROFILER.enabled
    PROFILER.configure(enabled=True)
    try:
        before = REGISTRY.snapshot()
        q0 = (be._queries, be._hops, be._dist_calcs, be._supersteps)
        for _ in range(3):
            svc.search(SearchRequest(queries=q, k=10, ef=40))
        snap = store_window(before, REGISTRY.snapshot(), uids)
    finally:
        PROFILER.configure(enabled=was)

    csd = {c["name"]: c["value"] for c in snap["counters"]
           if c["labels"].get("backend") == be.uid}
    assert csd["csd_queries_total"] == be._queries - q0[0] == 3 * len(q)
    assert csd["csd_hops_total"] == be._hops - q0[1] > 0
    assert csd["search_dist_calcs_total"] == be._dist_calcs - q0[2] > 0
    assert csd["csd_supersteps_total"] == be._supersteps - q0[3] > 0
    gauges = {g["name"]: g["value"] for g in snap["gauges"]
              if g["labels"].get("backend") == be.uid}
    assert gauges["csd_graph_degree"] > 0
    assert gauges["csd_vector_row_bytes"] == 128 * 4   # lane-padded rows
    assert gauges["csd_block_size"] == spec.block_size

    cal = calibrate(snap)
    assert cal.queries == 3 * len(q)
    assert cal.effective_ssd_bw and cal.blocks_per_query
    terms = compare_terms(cal)
    available = [k for k, t in terms.items() if not t.get("unavailable")]
    assert set(available) >= {"storage", "fanout", "dispatch"}
    st = terms["storage"]
    ratio = st["calibrated"] / st["measured"]
    assert 0.5 <= ratio <= 2.0, \
        f"calibrated storage off by {ratio:.2f}x: {st}"
    # the port's snapshot reads as the reference's: the reference fits
    # the same parameters from it
    assert ref_calibrate(json.loads(json.dumps(snap))).asdict() == \
        cal.asdict()
    assert ref_compare_terms(ref_calibrate(snap)) == terms
    assert dataclasses.asdict(cal)["source"]["superstep_spans"] > 0
    be.reader.close()
