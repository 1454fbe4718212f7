"""ANN serving CLI over repro_torch.api / repro_torch.serve.

Two request paths, one flag apart, as the reference's:

  sync (default)       : `serve_loop` — fixed-stride batches straight into
                         `SearchService.search`; reports QPS and
                         per-batch latency.
  async (--serve-async): the repro_torch.serve subsystem — per-query
                         submission through the dynamic batcher and the
                         replica pool (the paper's host feeding 4
                         SmartSSDs, Fig. 10); prints the ServeStats rollup
                         (QPS, queueing vs execution latency, batch sizes,
                         per-replica counters).

The index runs on the card unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 \\
      --partitions 4 --batch 64 --num-batches 50 --backend partitioned \\
      --serve-async --replicas 4 --max-batch 64 --max-wait-ms 2

`--backend csd` serves out of core from a block store at `--storage` (a
new temporary directory when it is not given); async csd replicas each
open their own page cache over it. `--backend distributed` shards the
partitions over the default mesh (every card over `model`; one slot on
the CPU). With `--shards N` the index is built as a `repro_torch.cluster`
scatter-gather cluster instead of one service (`--shard-replicas R` for
per-shard failover sets); either request path fronts the router
unchanged.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.data import VectorDataset


def serve_loop(service, queries, batch: int, k: int, ef: int,
               rerank: bool = False, log=print):
    """Stream `queries` through in fixed batches; returns (ids, stats).

    Each batch's latency ends when its ids are on the host, which waits
    for the device."""
    lat = []
    n = 0
    ids_all = []
    t_start = time.perf_counter()
    for i in range(0, len(queries) - batch + 1, batch):
        q = queries[i: i + batch]
        t0 = time.perf_counter()
        resp = service.search(SearchRequest(queries=q, k=k, ef=ef,
                                            rerank=rerank))
        ids_all.append(resp.ids.cpu().numpy())
        lat.append(time.perf_counter() - t0)
        n += batch
    wall = time.perf_counter() - t_start
    lat_ms = np.array(lat) * 1e3
    stats = {
        "qps": n / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "batches": len(lat),
    }
    log(f"[serve] {n} queries  {stats['qps']:.1f} QPS  "
        f"p50 {stats['p50_ms']:.1f}ms  p99 {stats['p99_ms']:.1f}ms")
    return np.concatenate(ids_all) if ids_all else np.zeros((0, k)), stats


def serve_async(service, queries, *, k: int, ef: int, rerank: bool = False,
                replicas: int = 2, max_batch: int = 64,
                max_wait_ms: float = 2.0, slo=None,
                flight_out: str | None = None, log=print):
    """Per-query submission through repro_torch.serve; returns (ids, stats
    dict).

    Queries are submitted one by one — the dynamic batcher, not the caller,
    decides the device batch shapes. `slo` attaches an SLOTracker (breach
    summary printed at drain); `flight_out` writes the slow-query flight
    recorder's Perfetto dump there after drain.
    """
    from repro_torch.serve import SearchServer

    with SearchServer(service, replicas=replicas, max_batch=max_batch,
                      max_wait_ms=max_wait_ms, slo=slo) as srv:
        futs = srv.submit_many(queries, k=k, ef=ef, rerank=rerank)
        results = [f.result() for f in futs]
        srv.drain()
        roll = srv.stats()
        if srv.slo is not None:
            for line in srv.slo.summary().splitlines():
                log(f"[serve-async] {line}")
        if flight_out:
            log(f"[serve-async] flight  -> {srv.debug_dump(flight_out)}")
    log(f"[serve-async] {roll.summary()}")
    for r in roll.replicas:
        extra = ("" if "block_reads" not in r else
                 f"  block_reads={r['block_reads']} "
                 f"hit_rate={r['cache_hit_rate']:.2f}")
        log(f"[serve-async]   replica {r['replica']}: {r['queries']} queries "
            f"in {r['batches']} batches, busy {r['busy_s']:.2f}s{extra}")
    ids = np.stack([r.ids for r in results])
    stats = {
        "qps": roll.qps,
        "p50_ms": roll.e2e_ms["p50"],
        "p99_ms": roll.e2e_ms["p99"],
        "queue_p50_ms": roll.queue_ms["p50"],
        "exec_p50_ms": roll.exec_ms["p50"],
        "batches": int(sum(roll.batch_sizes.values())),
        "mean_batch": roll.mean_batch,
        "replicas": roll.replicas,
    }
    return ids, stats


def build_service(args, ds: VectorDataset) -> SearchService:
    storage = args.storage
    if args.backend == "csd" and not storage:
        storage = tempfile.mkdtemp(prefix="repro-serve-csd-")
        print(f"[serve] --storage not given; csd block store at {storage}")
    spec = IndexSpec(metric=args.metric, backend=args.backend,
                     num_partitions=args.partitions,
                     hnsw=HNSWConfig(M=args.M),
                     keep_vectors=args.rerank and args.backend != "csd",
                     storage_path=storage)
    if args.shards > 1:
        from repro_torch.cluster import build_cluster
        print(f"[serve] building {args.shards}-shard {spec.backend} cluster "
              f"(x{args.shard_replicas} replicas, "
              f"{args.partitions} partitions/shard, metric={spec.metric}) "
              f"over {args.n} vectors on {args.device or 'cuda'} ...")
        t0 = time.perf_counter()
        router = build_cluster(ds.vectors(), spec, args.shards,
                               replicas=args.shard_replicas, path=storage,
                               device=args.device)
        print(f"[serve] build {time.perf_counter()-t0:.1f}s")
        return router
    print(f"[serve] building {spec.backend} index "
          f"({args.partitions} partitions, metric={spec.metric}) over "
          f"{args.n} vectors on {args.device or 'cuda'} ...")
    t0 = time.perf_counter()
    service = SearchService.build(ds.vectors(), spec, device=args.device)
    print(f"[serve] build {time.perf_counter()-t0:.1f}s")
    return service


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64,
                    help="sync stride / async submission window size")
    ap.add_argument("--num-batches", type=int, default=20)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef", type=int, default=40)
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--metric", default="l2",
                    choices=["l2", "ip", "cosine"])
    ap.add_argument("--backend", default="partitioned",
                    choices=["exact", "hnsw", "partitioned", "distributed",
                             "csd"])
    ap.add_argument("--rerank", action="store_true")
    ap.add_argument("--serve-async", action="store_true",
                    help="serve through repro_torch.serve (queue + dynamic "
                         "batcher + replica pool) instead of the sync loop")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--shards", type=int, default=1,
                    help="shard the index across N cluster workers "
                         "(repro_torch.cluster scatter-gather router)")
    ap.add_argument("--shard-replicas", type=int, default=1,
                    help="replicas per shard (failover set)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="dynamic batcher flush size (default: --batch)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--storage", default=None,
                    help="csd block-store directory (default: a tempdir)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the index lives (default: cuda; raises "
                         "when no CUDA device is visible)")
    ap.add_argument("--trace", action="store_true",
                    help="record hierarchical trace spans over the whole "
                         "request path (repro_torch.obs)")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="per-request trace sampling rate in [0, 1]")
    ap.add_argument("--trace-out", default=None,
                    help="write Chrome/Perfetto trace-event JSON here "
                         "(implies --trace)")
    ap.add_argument("--metrics-out", default=None,
                    help="write a metrics snapshot here (.json -> JSON, "
                         "else Prometheus text exposition)")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="with --metrics-out: re-emit the file every N "
                         "seconds while serving (0 = once, at the end)")
    ap.add_argument("--slo", action="store_true",
                    help="track the stock SLOs (p99 e2e latency, error "
                         "rate) and print a breach summary at drain "
                         "(async path only)")
    ap.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="latency SLO: 99%% of requests under this many ms")
    ap.add_argument("--slo-error-rate", type=float, default=0.01,
                    help="error-rate SLO: failed-request budget fraction")
    ap.add_argument("--flight-out", default=None,
                    help="write the slow-query flight recorder's Perfetto "
                         "JSON dump here at drain (async path only)")
    args = ap.parse_args(argv)

    from repro_torch.obs import PeriodicExporter, TRACER, write_snapshot
    if args.trace or args.trace_out:
        TRACER.configure(enabled=True, sample_rate=args.trace_sample)

    slo_tracker = None
    if args.slo:
        from repro_torch.obs import SLOTracker, default_slos
        slo_tracker = SLOTracker(default_slos(
            p99_ms=args.slo_p99_ms, error_rate=args.slo_error_rate))
    if (args.slo or args.flight_out) and not args.serve_async:
        print("[serve] note: --slo/--flight-out need the async serve path; "
              "pass --serve-async (ignored on the sync loop)")

    ds = VectorDataset(args.n, args.dim)
    service = build_service(args, ds)
    queries = ds.queries(args.batch * args.num_batches)

    exporter = None
    if args.metrics_out and args.metrics_interval > 0:
        exporter = PeriodicExporter(
            args.metrics_out, args.metrics_interval,
            tracer=TRACER if (args.trace or args.trace_out) else None,
            trace_path=args.trace_out).start()
    try:
        if args.serve_async:
            _, stats = serve_async(
                service, queries, k=args.k, ef=args.ef, rerank=args.rerank,
                replicas=args.replicas,
                max_batch=args.max_batch or args.batch,
                max_wait_ms=args.max_wait_ms, slo=slo_tracker,
                flight_out=args.flight_out)
        else:
            _, stats = serve_loop(service, queries, args.batch, args.k,
                                  args.ef, rerank=args.rerank)
    finally:
        if exporter is not None:
            exporter.stop()                  # final complete snapshot
        elif args.metrics_out:
            print(f"[serve] metrics -> {write_snapshot(args.metrics_out)}")
        if args.trace_out:
            print(f"[serve] trace   -> {TRACER.write(args.trace_out)}")
    return stats


if __name__ == "__main__":
    main()
