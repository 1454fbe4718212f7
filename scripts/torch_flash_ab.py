#!/usr/bin/env python3
"""The tensor-core flash kernel of this checkout against another
checkout's (`csrc/flash_attention_tc.cu`), in turns, on the shapes both
take: G = 1 (one KV head a query head), causal, from position 0.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_flash_ab.py --against DIR [--rounds 10]

DIR is the other checkout's root (for example its parent commit, from
`git archive`, unpacked under build/). Its source is built with the same
nvcc flags into build/flash_ab/ and called through its own C interface:
the one before the masks were added (q, k, v, o, device, BH, T, S, hd,
causal, scale_log2, stream), or this checkout's. Each round times both
kernels by CUDA events over `--calls` launches, in the order A B B A,
after one warm-up each; the outputs must be bitwise equal. Prints each
shape's per-call medians over the rounds, their ratio and the spread
(the quartiles of each side's rounds), beside the card's name and power
limit; writes chiprun_out/flash_ab.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((128, 2048, 192), (320, 2048, 128), (256, 2048, 64))


def build_other(root: Path) -> ctypes.CDLL:
    """nvcc the other checkout's flash_attention_tc.cu into build/flash_ab."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = root / "src" / "repro_torch" / "kernels" / "csrc" / \
        "flash_attention_tc.cu"
    out = ROOT / "build" / "flash_ab" / "other_flash_attention_tc.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def other_caller(lib, masked: bool):
    """fn(q, k, v) -> out through the other build's C interface: with the
    mask's arguments (`masked`, this checkout's) or without them (the one
    before grouped heads and masks)."""
    fn = lib.repro_flash_attention_tc
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.restype = ctypes.c_int
    fn.argtypes = [P] * 4 + [I] * (10 if masked else 6) + [ctypes.c_float, P]

    def call(q, k, v):
        bh, t, hd = q.shape
        out = torch.empty_like(q)
        scale = float(np.float32(math.log2(math.e) / math.sqrt(hd)))
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                q.device.index or 0, bh]
        if masked:
            args += [k.shape[0], t, k.shape[1], hd, 1, 0, 0, 0]
        else:
            args += [t, k.shape[1], hd, 1]
        err = fn(*args, scale, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other flash kernel failed: {err}")
        return out

    return call


def events_ms(fn, calls: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_ab.py: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import attention

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = build_other(args.against.resolve())
    other_src = (args.against.resolve() / "src/repro_torch/kernels/csrc/"
                 "flash_attention_tc.cu").read_text()
    other = other_caller(lib, "int BKV" in other_src)
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for bh, t, hd in SHAPES:
        q, k, v = (torch.randn((bh, t, hd), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        sides = {"against": lambda: other(q, k, v),
                 "this": lambda: attention.flash_attention_tc_cuda(q, k, v)}
        a, b = sides["against"](), sides["this"]()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            d = float((a.float() - b.float()).abs().max())
            raise RuntimeError(f"[{bh}, {t}, {hd}]: the two kernels differ, "
                               f"max {d}")
        ms = {"against": [], "this": []}
        for r in range(args.rounds):
            order = ("against", "this", "this", "against") if r % 2 == 0 \
                else ("this", "against", "against", "this")
            for side in order:
                ms[side].append(events_ms(sides[side], args.calls))
        med = {s: float(np.median(x)) for s, x in ms.items()}
        iqr = {s: [float(np.percentile(x, 25)), float(np.percentile(x, 75))]
               for s, x in ms.items()}
        results[f"{bh}x{t}x{hd}"] = {"median_ms": med, "quartiles_ms": iqr,
                                     "ratio": med["this"] / med["against"]}
        print(f"[{bh}, {t}, {hd}] bf16 causal, G = 1: this checkout "
              f"{med['this']:.4f} ms (quartiles {iqr['this'][0]:.4f}-"
              f"{iqr['this'][1]:.4f}), against {med['against']:.4f} ms "
              f"({iqr['against'][0]:.4f}-{iqr['against'][1]:.4f}); ratio "
              f"{med['this'] / med['against']:.3f}; outputs bitwise equal",
              flush=True)
        del q, k, v, a, b
    out = ROOT / "chiprun_out" / "flash_ab.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
