#!/usr/bin/env python3
"""Sweep the PyTorch port's FP32-FMA fused exact scan (`l2topk`'s
`csrc/l2topk.cu`) over its row splits and k on one NVIDIA card, and split
its device time between its two launches.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_scan_sweep.py

Over 1,000,000 x 128 integer-valued float32 rows and 256 queries (seeded),
it calls `csrc/l2topk.cu` through its C entry with the split count forced
to 32, 64 and 128 at k = 1, 10 and 64, then as its wrapper
(`l2topk_fma_cuda`) chooses, and prints each device time (CUDA events,
median of 5). Then `l2dist` at the same shapes, and a `torch.profiler`
split of one wrapper call between the per-split pass and the merge. The
FMA kernel's split rule in `kernels/l2topk.py` is read off this sweep.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
N, D, BQ, SEED = 1_000_000, 128, 256, 0


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
    if not torch.cuda.is_available():
        print("torch_scan_sweep.py: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, l2dist as ld, l2topk as lt

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randint(0, 256, (N, D), generator=g, device=dev).float()
    q = torch.randint(0, 256, (BQ, D), generator=g, device=dev).float()
    xsq, qsq = ld.sqnorms(x), ld.sqnorms(q)
    lib = _build.load("l2topk", lt._SIGNATURES)
    for line in _build.BUILD_LOG.get("l2topk", "").splitlines():
        if "registers" in line:
            print("[ptxas]", line.strip())
    stream = torch.cuda.current_stream(dev).cuda_stream

    def forced(k: int, splits: int):
        part_d = torch.empty((BQ, splits, k), device=dev)
        part_i = torch.empty((BQ, splits, k), dtype=torch.int32, device=dev)
        out_d = torch.empty((BQ, k), device=dev)
        out_i = torch.empty((BQ, k), dtype=torch.int32, device=dev)

        def call():
            err = lib.repro_l2topk(
                q.data_ptr(), x.data_ptr(), qsq.data_ptr(), xsq.data_ptr(),
                part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                out_i.data_ptr(), dev.index or 0, BQ, N, D, 0, 1, 1, k,
                splits, 1.0, stream)
            if err:
                raise RuntimeError(f"l2topk launch failed: CUDA error {err}")
        return call

    for k in (1, 10, 64):
        for splits in (32, 64, 128):
            print(f"l2topk {BQ} x {N} x {D}, k={k}, splits={splits}: "
                  f"{median_ms(forced(k, splits)):.3f} ms", flush=True)
        wrapper = median_ms(lambda: lt.l2topk_fma_cuda(q, x, xsq, k=k))
        print(f"l2topk {BQ} x {N} x {D}, k={k}, the wrapper's splits: "
              f"{wrapper:.3f} ms", flush=True)
    print(f"l2dist {BQ} x {N} x {D}: "
          f"{median_ms(lambda: ld.l2dist_cuda(q, x, xsq)):.3f} ms")
    lt.l2topk_fma_cuda(q, x, xsq, k=10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lt.l2topk_fma_cuda(q, x, xsq, k=10)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            print(f"[profile] k=10 {ev.key[:70]}: {ev.count} calls, "
                  f"{ev.device_time_total / ev.count:.1f} us a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
