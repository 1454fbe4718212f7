"""ANN serving CLI over repro_torch.api: the synchronous request path.

`serve_loop` streams fixed-stride batches straight into
`SearchService.search` and reports QPS and per-batch latency. The index
runs on the card unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 \\
      --partitions 4 --batch 64 --num-batches 50 --backend partitioned

`--backend csd` serves out of core from a block store at `--storage` (a
new temporary directory when it is not given). The reference's async
(dynamic batcher + replica pool), cluster, tracing and SLO flags belong to
later slices of the port and are not accepted yet.
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
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num-batches", type=int, default=20)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef", type=int, default=40)
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--metric", default="l2",
                    choices=["l2", "ip", "cosine"])
    ap.add_argument("--backend", default="partitioned",
                    choices=["exact", "hnsw", "partitioned", "csd"])
    ap.add_argument("--rerank", action="store_true")
    ap.add_argument("--storage", default=None,
                    help="csd block-store directory (default: a tempdir)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the index lives (default: cuda; raises "
                         "when no CUDA device is visible)")
    args = ap.parse_args(argv)

    ds = VectorDataset(args.n, args.dim)
    service = build_service(args, ds)
    queries = ds.queries(args.batch * args.num_batches)
    _, stats = serve_loop(service, queries, args.batch, args.k, args.ef,
                          rerank=args.rerank)
    return stats


if __name__ == "__main__":
    main()
