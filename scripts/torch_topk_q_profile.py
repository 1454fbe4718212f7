#!/usr/bin/env python3
"""Split the device time of the PyTorch port's fused scans on the tensor
cores between their roles, on one NVIDIA card: `l2topk_q` over 8-bit
codes (`csrc/l2topk_q_tc.cu`) and `l2topk` over float32 rows
(`csrc/l2topk_tc.cu`, 3 x TF32).

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_topk_q_profile.py

Over 1,000,000 x 128 rows and 256 queries of seeded integers in 0..255
(uint8 codes for `l2topk_q_tc`, the same values as float32 for
`l2topk_tc`), it builds each kernel and three variants of its source with
nvcc:

- "no products": the MMA warpgroups issue no `wgmma`, so every distance
  is qsq + xsq and the selection runs on rows in the same random order;
- "no selection": the selection warps release each distance tile
  untouched, so the kernel runs the TMA ring, the products and the
  distance epilogue;
- "pipeline only": the MMA warpgroups skip the products and the epilogue
  too, so only the ring and the barriers run.

It times the four at k = 1, 10 and 64 (CUDA events, median of 5; the
four in turns, twice), so the differences split the kernel's time:
selection = kernel - no selection, products and epilogue = no selection -
pipeline only, and the products alone = kernel - no products. The
variants' answers are meaningless: only their times are read. The last
line is a JSON object of every time in ms.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
N, D, BQ, SEED = 1_000_000, 128, 256, 0

# the lines the variants stub, as they stand in both kernels' sources
SELECT = "    mbar_wait(dfull + 8 * db, (it / kDistBufs) & 1);\n"
MMA = "      mbar_wait(full + 8 * st, (i / kStages) & 1);\n"
SKIP_SELECT = SELECT + (
    "    if (SKIP_SELECT) {\n      __syncwarp();\n"
    "      if (lane == 0) mbar_arrive(dempty + 8 * db);\n      continue;\n"
    "    }\n")
SKIP_MMA = MMA + (
    "      if (SKIP_MMA) {\n        __syncwarp();\n"
    "        if (lane == 0) mbar_arrive(empty + 8 * st);\n"
    "        const int db = i % kDistBufs;\n"
    "        mbar_wait(dempty + 8 * db, ((i / kDistBufs) & 1) ^ 1);\n"
    "        named_sync(1 + wg, 128);\n"
    "        if (tid == 0) mbar_arrive(dfull + 8 * db);\n        continue;\n"
    "      }\n")
# the products' calls, as they stand in l2topk_tc.cu and l2topk_q_tc.cu
PRODUCTS = ("wgmma_tf32(acc, ", "wgmma_i8<T>(acc, ")
# name -> (SKIP_SELECT, SKIP_MMA, SKIP_PRODUCTS)
VARIANTS = {"kernel": (0, 0, 0), "no products": (0, 0, 1),
            "no selection": (1, 0, 0), "pipeline only": (1, 1, 0)}


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


def build_variants(_build, kernels) -> dict:
    """(kernel, variant) -> the C source's stem, built from a copy of
    csrc/ in the build directory."""
    csrc = _build.BUILD_DIR / "profile_csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, csrc)
    stems = {}
    for kernel in kernels:
        src = (_build.CSRC / f"{kernel}.cu").read_text()
        if SELECT not in src or MMA not in src or not any(
                p in src for p in PRODUCTS):
            raise RuntimeError(f"csrc/{kernel}.cu changed: update the lines "
                               f"this script stubs")
        body = src.replace(SELECT, SKIP_SELECT).replace(MMA, SKIP_MMA)
        for p in PRODUCTS:
            body = body.replace(p, "if (!SKIP_PRODUCTS) " + p)
        for i, (name, flags) in enumerate(VARIANTS.items()):
            stems[kernel, name] = f"{kernel}_v{i}"
            (csrc / f"{kernel}_v{i}.cu").write_text("".join(
                f"#define {flag} {v}\n" for flag, v in zip(
                    ("SKIP_SELECT", "SKIP_MMA", "SKIP_PRODUCTS"), flags))
                + body)
    _build.CSRC = csrc
    _build.build_all(tuple(stems.values()))
    return stems


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_topk_q_profile.py: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, l2dist as ld, l2topk as lt
    from repro_torch.kernels import qdist as qd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    kernels = ("l2topk_q_tc", "l2topk_tc")
    stems = build_variants(_build, kernels)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randint(0, 256, (N, D), generator=g, device=dev).to(torch.uint8)
    q = torch.randint(0, 256, (BQ, D), generator=g, device=dev).to(torch.uint8)
    xsq = ld.sqnorms(x)
    xf, qf = x.float(), q.float()
    calls = {"l2topk_q_tc": lambda k: qd.l2topk_q_tc_cuda(q, x, xsq, k=k),
             "l2topk_tc": lambda k: lt.l2topk_tc_cuda(qf, xf, xsq, k=k)}
    rows = {"l2topk_q_tc": "uint8 codes", "l2topk_tc": "float32 rows"}
    load = _build.load

    def timed(kernel: str, name: str, k: int) -> float:
        # the wrapper loads its library through _build.load by name
        _build.load = lambda _, sig: load(stems[kernel, name], sig)
        try:
            return median_ms(lambda: calls[kernel](k))
        finally:
            _build.load = load

    out = {}
    for kernel in kernels:
        for k in (1, 10, 64):
            runs = {name: [] for name in VARIANTS}
            for order in (list(VARIANTS), list(VARIANTS)[::-1]):
                for name in order:
                    runs[name].append(timed(kernel, name, k))
            t = {name: sum(r) / len(r) for name, r in runs.items()}
            out[f"{kernel} k={k}"] = t
            print(f"{kernel} k={k}: kernel {t['kernel']:.4f} ms, no "
                  f"products {t['no products']:.4f} ms, no selection "
                  f"{t['no selection']:.4f} ms, pipeline only "
                  f"{t['pipeline only']:.4f} ms -> selection "
                  f"{t['kernel'] - t['no selection']:.4f} ms, products and "
                  f"epilogue {t['no selection'] - t['pipeline only']:.4f} ms, "
                  f"products {t['kernel'] - t['no products']:.4f} ms "
                  f"({BQ} x {N} x {D} {rows[kernel]})", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
