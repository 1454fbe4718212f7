"""One run of one cell: set-up, the measured window, the comparison.

Everything particular to a cell is data that this module finds by name:

  BENCHMARK.json              the cell (its configuration and traffic)
                              and the metrics it reports
  bench/configs/<name>.json   the configuration: rows, the index spec
  bench/traffic/<name>.json   the traffic mix: a closed loop of batched
                              requests over a query pool
  bench/workloads/<name>.json the cell's comparison: the limit of each
                              number `compare.judge` gives that it holds
  bench/metrics/<name>.py     one reader a metric: `read(run) -> value`,
                              or None where it finds nothing to read

The window drives `SearchService.search(SearchRequest(...))` of the
port, one request in flight: request i serves slice i % R of the query
pool, and is timed from the moment it is sent until its ids and
distances are on the host. The window closes when the first request ends
after `seconds` have passed. Set-up ends with `warmup_requests`
requests. With `trace`, every request asks for its statistics (the
program's `QueryStats` counters, which the run's record hands to the
metric readers under `counters`, so that a reader of a counter needs no
change here), and once
the window has closed `profiled_requests` more run under torch.profiler
recording the device, then `named_requests` recording the host's ops too
(`devtrace.py`); the per-layer metrics are read. Without it, the
end-to-end ones. The profiled stretches come last because a profiled process
stays slower afterwards (on the card, about a fifth for the rest of the
run), which would bend the window's host-clock metrics.

After the window the service is freed and the plain reference
(`reference/exact.py`) computes the exact top-k of the whole pool;
`compare.judge` holds every served answer to it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from bench import compare, devtrace, generator
from bench.reference import exact
from repro_torch.api import IndexSpec, SearchRequest, SearchService

__all__ = ["Cell", "load_cell", "run", "build_service", "log"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict          # number -> limit (compare.NUMBERS)
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bm = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bm["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bm["configs"] if c["name"] == w["config"])

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name=name, chips=int(w["chips"]),
                config=_load(root / cfg["file"]),
                traffic=_load(root / "bench" / "traffic"
                              / f"{w['traffic']}.json"),
                checks=_load(root / "bench" / "workloads"
                             / f"{name}.json")["checks"],
                end_to_end=[m for m in bm["end_to_end"] if reports(m)],
                per_layer=[m for m in bm["per_layer"] if reports(m)])


def reader(metric: str, root: Path = ROOT):
    """The `read` function of bench/metrics/<metric>.py."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def build_service(base: np.ndarray, config: dict, device):
    """The system under test: the port's service over `base`."""
    return SearchService.build(base, IndexSpec.from_json(config["spec"]),
                               device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Window:
    """The closed loop: one request in flight, answers kept for the
    comparison."""

    def __init__(self, svc, requests, device):
        self.svc, self.requests, self.device = svc, requests, device
        self.answers, self.latencies, self.queries = [], [], []
        self.failed = 0
        self.calcs = torch.zeros((), dtype=torch.int64, device=device)
        self.calc_queries = 0

    def one(self, i: int) -> None:
        r = i % len(self.requests)
        req = self.requests[r]
        t = time.perf_counter()
        try:
            resp = self.svc.search(req)
            ids = resp.ids.cpu()
            dists = resp.dists.cpu()
        except Exception:   # a failed request counts, and the loop goes on
            self.failed += 1
            if self.failed == 1:
                log("a request failed:\n" + traceback.format_exc())
            return
        self.latencies.append(time.perf_counter() - t)
        self.queries.append(len(req.queries))
        self.answers.append((r, ids.numpy(), dists.numpy()))
        stats = getattr(resp, "stats", None)
        if stats is not None and stats.dist_calcs is not None:
            self.calcs += stats.dist_calcs.sum(dtype=torch.int64)
            self.calc_queries += len(req.queries)


def _profiled(win: _Window, n: int, start: int, host_ops: bool):
    """Requests start .. start+n-1 under torch.profiler: (the profiler,
    the stretch's seconds on the host clock). The trace is read after the
    window: reading it takes seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.append(ProfilerActivity.CPU)
    _sync(win.device)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for i in range(start, start + n):
            with record_function(devtrace.RANGE):
                win.one(i)
        _sync(win.device)
        seconds = time.perf_counter() - t
    return prof, seconds


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, build=build_service) -> dict:
    """One run; returns the result line's object (checks last)."""
    cfg, tr = cell.config, cell.traffic
    if tr["loop"] != "closed" or int(tr["in_flight"]) != 1:
        raise ValueError(f"traffic {tr}: only a closed loop with one "
                         f"request in flight is generated")
    t = time.perf_counter()
    base = generator.base_rows(int(cfg["rows"]), seed)
    pool = generator.query_pool(int(cfg["rows"]), int(tr["pool_requests"]),
                                int(tr["queries_per_request"]), seed)
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    svc = build(base, cfg, device)
    t_build = time.perf_counter() - t
    # the request's fields that the traffic sets (ef: graph backends only)
    fields = {f: tr[f] for f in ("k", "ef", "rerank") if f in tr}
    requests = [SearchRequest(np.ascontiguousarray(q), with_stats=trace,
                              **fields) for q in pool]
    win = _Window(svc, requests, device)
    t = time.perf_counter()
    for i in range(int(tr["warmup_requests"])):   # the traffic's one shape
        win.one(i)
    _sync(device)
    t_warm = time.perf_counter() - t
    warm_failed = win.failed
    win = _Window(svc, requests, device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: inputs {t_gen:.3f}, build {t_build:.3f}, "
        f"warm-up {t_warm:.3f} ({tr['warmup_requests']} requests)")

    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while time.perf_counter() < deadline:
        win.one(i)
        i += 1
    t1 = time.perf_counter()
    n_window = len(win.latencies)
    lat = np.asarray(win.latencies or [np.nan]) * 1e3
    log(f"window {t1 - t0:.3f} s: {n_window} requests, "
        f"{sum(win.queries)} queries, {win.failed} failed; ms min "
        f"{lat.min():.3f} median {np.median(lat):.3f} max {lat.max():.3f}")
    profs = []
    if trace:     # the device alone, then the host's ops too
        for key, host_ops in (("profiled_requests", False),
                              ("named_requests", True)):
            profs.append(_profiled(win, int(tr[key]), i, host_ops))
            i += int(tr[key])
    _sync(device)
    calcs = int(win.calcs.item())
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    trace_out = None
    if trace:
        t = time.perf_counter()
        (dev_prof, dev_s), (host_prof, _) = profs
        busy = devtrace.device_busy(dev_prof.events())
        if busy is not None:
            served = win.queries[n_window:n_window + int(
                tr["profiled_requests"])]
            trace_out = {**busy, "window_s": dev_s,
                         "requests": len(served), "queries": sum(served),
                         "idle_gaps": devtrace.idle_gaps(host_prof.events())}
        del profs, dev_prof, host_prof
        log(f"trace read in {time.perf_counter() - t:.3f} s")

    del svc, win.svc, requests
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    k = int(tr["k"])
    flat = pool.reshape(-1, pool.shape[-1])
    gt_i, gt_d = exact.exact_topk(base, flat, k, device)
    shape = (pool.shape[0], pool.shape[1], k)
    numbers = compare.judge(
        win.answers, pool, gt_i.reshape(shape), gt_d.reshape(shape),
        lambda q, ids: exact.exact_dists(base, q, ids, device))
    log(f"reference and comparison {time.perf_counter() - t:.3f} s over "
        f"{numbers['queries']} served queries")
    ok, checks = compare.verdict(numbers, cell.checks)
    attempted = len(win.latencies) + win.failed
    ok = ok and win.failed == 0 and warm_failed == 0 and attempted > 0

    record = {
        "config": cfg, "traffic": tr, "setup_s": setup_s,
        "window": {"seconds": t1 - t0,
                   "latencies_s": win.latencies[:n_window],
                   "queries": sum(win.queries[:n_window])},
        "numbers": numbers,
        "trace": trace_out,
        "counters": {"dist_calcs": calcs, "queries": win.calc_queries},
    }
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else torch.device(device).type,
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok), "attempted": attempted,
           "failed": win.failed, "metrics": metrics, "device": dev}
    if trace:
        if trace_out is None:
            raise RuntimeError("the traced stretch holds no device record")
        dev["busy_s"] = trace_out["busy_s"]
        dev["window_s"] = trace_out["window_s"]
        out["breakdown"] = {"device_ops": trace_out["device_ops"],
                            "idle_gaps": trace_out["idle_gaps"]}
    out["checks"] = checks
    return out
