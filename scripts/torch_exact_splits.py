#!/usr/bin/env python3
"""Time the exact 8-bit scan's kernel route on one NVIDIA card: the row
splits of `csrc/l2topk_q_tc.cu` at the benchmark's shape, and one exact
request split between its spans.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_exact_splits.py [--seed N]

Over `bench/generator.py`'s 1,000,000 x 128 uint8 rows and a request of
10,000 queries of seed N, k = 10:

(a) `qdist.l2topk_q_tc_cuda` with the split count forced to each of
    `SPLITS` and as `l2topk.splits_for` chooses; device ms by CUDA events
    (median of 5), each answer bitwise equal to one split's;
(b) the exact uint8 service (`SearchService`, the benchmark's
    configuration), 10 requests with the port's TRACER on, each ended by
    copying its ids and distances to the host: medians of the host ms of
    the request, `search`, `encode`, `upload`, `scan`, and of the scan's
    device ms (`dev_ms`).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
N, BQ, K = 1_000_000, 10_000, 10
SPLITS = (1, 2, 4, 5, 10, 21, 95)


def median_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end))
    return sorted(runs)[reps // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_exact_splits.py: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import generator
    from repro_torch.api import IndexSpec, SearchRequest, SearchService
    from repro_torch.kernels import l2topk, qdist
    from repro_torch.obs import TRACER

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    base = generator.base_rows(N, args.seed)
    queries = generator.query_pool(N, 1, BQ, args.seed)[0]
    x = torch.from_numpy(base).to(dev)
    q = torch.from_numpy(queries).to(dev)
    xsq = qdist.sqnorms(x)

    # (a) the splits
    rule = l2topk.splits_for(BQ, N, K, qdist._TC_CTAS)
    chosen = qdist.splits_for
    want = None
    try:
        for s in sorted(set(SPLITS) | {rule}):
            qdist.splits_for = lambda *a, s=s: s
            got = qdist.l2topk_q_tc_cuda(q, x, xsq, k=K)
            want = got if want is None else want
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ms = median_ms(lambda: qdist.l2topk_q_tc_cuda(q, x, xsq, k=K))
            groups = -(-BQ // 64)
            waves = -(-groups * s // qdist._TC_CTAS)
            print(f"(a) S = {s:3d}{' (the rule)' if s == rule else ''}: "
                  f"{groups * s} CTAs, {waves} waves, {waves / s:.4f} CTA "
                  f"lengths of S = 1; device {ms:.4f} ms; bitwise equal to "
                  f"S = 1: {same}")
            if not same:
                return 1
    finally:
        qdist.splits_for = chosen
    del x, q, xsq

    # (b) one exact request, by span
    t = time.perf_counter()
    svc = SearchService.build(base, IndexSpec(backend="exact",
                                              dtype="uint8"), device=dev)
    print(f"(b) build {time.perf_counter() - t:.3f} s")
    req = SearchRequest(queries.astype(np.float32), k=K)
    for _ in range(2):
        svc.search(req).ids.cpu()
    TRACER.configure(enabled=True, sample_rate=1.0)
    rows = []
    try:
        for _ in range(10):
            TRACER.clear()
            t = time.perf_counter()
            resp = svc.search(req)
            resp.ids.cpu(), resp.dists.cpu()
            total = (time.perf_counter() - t) * 1e3
            by = {ev["name"]: ev for ev in TRACER.spans()}
            row = {n: (ev["t1"] - ev["t0"]) * 1e3 for n, ev in by.items()}
            row["request"], row["scan_dev"] = total, by["scan"]["dev_ms"]
            rows.append(row)
        attrs = by["scan"]["attrs"], by["upload"]["attrs"]
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()
    med = {n: float(np.median([r[n] for r in rows])) for n in rows[0]}
    print(f"(b) scan {attrs[0]}, upload {attrs[1]}; medians of 10, ms: "
          + ", ".join(f"{n} {v:.3f}" for n, v in med.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
