#!/usr/bin/env python3
"""Time the PyTorch port's PQ partitioned path in two checkouts in turns,
on one NVIDIA card: this one and another (such as an unpacked parent
commit), on one index.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_pq_path_ab.py --against DIR [--rounds 4]

It builds chip_smoke.py's pq partitioned index once (32,768 integer-valued
128-d rows, P = 4, HNSW M = 16, ef_construction = 100, pq_m = 16, integer
codebooks; the numpy graph build takes a few minutes), saves it, then
serves it in one process per turn, in the order against, this, this,
against, then this, against, against, this (`--rounds` such rounds in
all). Each turn loads the index with its own checkout's package, serves
one untimed batch and twice 8 batches of 256 through its `serve_loop`
(ef = 40, k = 10, rerank off), splits one batch five times by its
chip_smoke.py's `pq_split` (LUT build, upper-layer descent, hop-stepped
layer 0, host clock; the median kept) and counts the torch operators one
search calls (torch.profiler, CPU activity). Both must return the same
ids. It prints each side's median and range; the last line is a JSON
object with every turn's numbers, in ms.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve(tree: str, index: str) -> dict:
    """One turn, in its own process: the index served by `tree`'s port."""
    sys.path[:0] = [str(Path(tree) / "src"), tree]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.api import SearchRequest, SearchService
    from repro_torch.launch.serve import serve_loop

    cs.log = lambda m: None
    svc = SearchService.load(index, device="cuda")
    _, queries = cs.main_data(cs.N_MAIN, cs.N_QUERIES)
    q0 = queries[:cs.BATCH]
    svc.search(SearchRequest(q0, k=10, ef=40)).ids.cpu()
    p50 = []
    for _ in range(2):
        ids, st = serve_loop(svc, queries, cs.BATCH, 10, 40,
                             log=lambda m: None)
        p50.append(st["p50_ms"])
    splits = [cs.pq_split(svc, q0) for _ in range(5)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        svc.search(SearchRequest(q0, k=10, ef=40)).ids.cpu()
    torch.cuda.synchronize()
    return {"p50_ms": float(np.mean(p50)),
            **{key: float(np.median([sp[key] for sp in splits]))
               for key in ("lut_ms", "upper_ms", "layer0_ms")},
            "ops": sum(e.count for e in prof.key_averages()),
            "ids_sum": int(np.asarray(ids, np.int64).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--serve", nargs=2, metavar=("TREE", "INDEX"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.serve:
        print(json.dumps(serve(*args.serve)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_pq_path_ab.py: needs a CUDA device", file=sys.stderr)
        return 2
    if not args.against:
        ap.error("--against DIR is required")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = {"against": str(Path(args.against).resolve()),
             "this": str(ROOT)}
    turns = {"against": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        index = str(Path(tmp) / "pq")
        secs = cs.build_worker(cs.partitioned_spec(dtype="pq", pq_m=cs.PQ_M),
                               index, cs.N_MAIN, "cuda")
        print(f"pq partitioned index built in {secs:.1f}s", flush=True)
        for r in range(args.rounds):
            order = ("against", "this", "this", "against")
            for name in order if r % 2 == 0 else order[::-1]:
                out = subprocess.run(
                    [sys.executable, __file__, "--serve", trees[name], index],
                    capture_output=True, text=True, check=True)
                got = json.loads(out.stdout.strip().splitlines()[-1])
                turns[name].append(got)
                print(f"{name}: p50 {got['p50_ms']:.3f} ms; one batch "
                      f"(median of 5): LUT {got['lut_ms']:.3f}, upper "
                      f"{got['upper_ms']:.3f}, hop-stepped layer 0 "
                      f"{got['layer0_ms']:.3f} ms; {got['ops']} torch "
                      f"operators a search", flush=True)
    sums = {t["ids_sum"] for runs in turns.values() for t in runs}
    if len(sums) != 1:
        raise RuntimeError(f"the two checkouts returned different ids: {sums}")
    for key in ("p50_ms", "layer0_ms", "upper_ms"):
        med = {n: sorted(t[key] for t in r)[len(r) // 2]
               for n, r in turns.items()}
        rng = {n: (min(t[key] for t in r), max(t[key] for t in r))
               for n, r in turns.items()}
        print(f"{key}: against median {med['against']:.3f} (range "
              f"{rng['against'][0]:.3f}-{rng['against'][1]:.3f}), this "
              f"median {med['this']:.3f} ({rng['this'][0]:.3f}-"
              f"{rng['this'][1]:.3f}): {med['this'] / med['against'] - 1:+.2%}")
    print(json.dumps(turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
