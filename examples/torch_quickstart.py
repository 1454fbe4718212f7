"""Quickstart for the port's `repro_torch.api` search service.

The whole public surface is three objects:

  IndexSpec     — what to build: metric (l2 / ip / cosine), backend
                  (exact / hnsw / partitioned / distributed / csd),
                  partition count, HNSW knobs, vector dtype
                  (float32 / uint8 / int8 / pq)
  SearchRequest — one batched call: k, ef, rerank, with_stats
  SearchService — build/load once, search many times, versioned save()

This script builds the paper's two-stage partitioned engine (§4.1) at its
SIFT1B operating point (K=10, ef=40) on the card (or `--device cpu`),
verifies recall against the exact ground truth, repeats the exercise
under the cosine metric, and finally rebuilds the index quantized to
uint8 — the precision the paper's billion-scale result runs at.

  PYTHONPATH=src python examples/torch_quickstart.py [--n 5000 --dim 128] \\
      [--device cpu]

(--n/--dim shrink the dataset; the README's tiny-data command is
`--n 2000 --dim 64 --partitions 2`.)
"""

import argparse

import numpy as np

from repro_torch.api import (IndexSpec, SearchRequest, SearchService,
                             exact_topk_np)
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.data import VectorDataset


def recall_at_k(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    return float(np.mean(
        [len(set(ids[b]) & set(gt[b])) / k for b in range(len(gt))]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    # 1) a SIFT-like dataset (clustered features)
    ds = VectorDataset(n=args.n, dim=args.dim, n_clusters=32, seed=0)
    vectors = ds.vectors()
    queries = ds.queries(32)

    # 2) build the two-stage partitioned engine (paper §4.1): P sub-graphs,
    #    each independently searchable / independently placeable in HBM.
    spec = IndexSpec(backend="partitioned", num_partitions=args.partitions,
                     hnsw=HNSWConfig(M=16, ef_construction=100),
                     keep_vectors=True)
    svc = SearchService.build(vectors, spec, device=dev)

    # 3) search (stage 1 per-partition + stage 2 merge) at the paper's
    #    SIFT1B operating point: K=10, ef=40. rerank=True folds the paper's
    #    host-side stage-2 brute force into one batched device call.
    resp = svc.search(SearchRequest(queries=queries, k=10, ef=40,
                                    rerank=True, with_stats=True))
    ids = resp.ids.cpu().numpy()

    # 4) verify against the exact ground truth (paper Fig. 9 baseline).
    gt = exact_topk_np("l2", vectors, queries, 10)
    r = recall_at_k(ids, gt, 10)
    reads = float(resp.stats.dist_calcs.float().mean())
    print(f"l2     recall@10 (ef=40, {args.partitions} partitions): {r:.3f}  "
          f"(~{reads:.0f} vector reads/query of {len(vectors)})")
    assert r >= 0.9

    # 5) same engine, cosine metric: the registry normalizes the data and
    #    the queries at the edge; the graph kernels minimize 1 - cos.
    svc_cos = SearchService.build(
        vectors, IndexSpec(metric="cosine", backend="partitioned",
                           num_partitions=args.partitions,
                           hnsw=HNSWConfig(M=16, ef_construction=100)),
        device=dev)
    ids_cos = svc_cos.search(
        SearchRequest(queries=queries, k=10, ef=40)).ids.cpu().numpy()
    gt_cos = exact_topk_np("cosine", vectors, queries, 10)
    r_cos = recall_at_k(ids_cos, gt_cos, 10)
    print(f"cosine recall@10 (ef=40, {args.partitions} partitions): "
          f"{r_cos:.3f}")
    assert r_cos >= 0.9

    # 6) the paper's SIFT1B precision: uint8 vectors. The service fits a
    #    symmetric scalar quantizer (scale/zero-point land in the index
    #    manifest), stores 1-byte codes everywhere, traverses in integer
    #    code space, and keeps stage-2 rerank in float32 over dequantized
    #    rows.
    svc_u8 = SearchService.build(
        vectors, IndexSpec(backend="partitioned", dtype="uint8",
                           num_partitions=args.partitions,
                           hnsw=HNSWConfig(M=16, ef_construction=100),
                           keep_vectors=True),
        device=dev)
    ids_u8 = svc_u8.search(
        SearchRequest(queries=queries, k=10, ef=40, rerank=True)).ids.cpu(
        ).numpy()
    r_u8 = recall_at_k(ids_u8, gt, 10)
    print(f"uint8  recall@10 (ef=40, {args.partitions} partitions): "
          f"{r_u8:.3f}  (scale={svc_u8.spec.qscale:.4g}, "
          f"zero_point={svc_u8.spec.qzero}, 1 byte/dim)")
    assert r_u8 >= 0.85

    print(f"first query -> ids {ids[0][:5]} "
          f"dists {resp.dists[0, :5].cpu().numpy().round(1)}")
    print("OK")


if __name__ == "__main__":
    main()
