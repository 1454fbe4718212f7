"""The control of the comparison, and the readings its limits are set from.

The control is the plain reference put in the program's place and
computed one precision below the configuration's 8-bit rows: rows and
queries rounded to 4-bit codes (`reference.exact.quantized_topk`), the
exact top-k in code space, distances rescaled to real space. The
comparison has to find it not correct.

    python3 bench/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 5] [--workers 4] [--out F]

runs the harness once a seed (no measured metrics are taken from these
runs) for the program on `--seeds` and for the control on
`--control-seeds`, `--workers` processes at once, and prints one JSON
line a run with the numbers compared (`compare.NUMBERS`, all of them,
whatever the cell's limits); `--out` also writes them there. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

__all__ = ["ControlService", "build_control", "main"]

BITS = 4    # one precision below the configurations' 8-bit rows


class _Response:
    def __init__(self, ids, dists):
        self.ids, self.dists, self.stats = ids, dists, None


class ControlService:
    """`search(SearchRequest)` answered by the 4-bit reference."""

    def __init__(self, base, device):
        self.base, self.device = base, device

    def search(self, request):
        import torch

        from bench.reference.exact import quantized_topk

        ids, d = quantized_topk(self.base, request.queries, request.k,
                                self.device, bits=BITS)
        return _Response(torch.as_tensor(ids.astype("int32")),
                         torch.as_tensor(d))


def build_control(base, config, device):
    return ControlService(base, device)


def _one(job):
    workload, seed, seconds, control = job
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench import compare, harness

    cell = harness.load_cell(workload)
    cell.checks = {n: float("inf") for n in compare.NUMBERS}
    t = time.perf_counter()
    out = harness.run(cell, seed, seconds, False, "cuda", t,
                      build=build_control if control else
                      harness.build_service)
    return {"workload": workload, "seed": seed,
            "side": "control" if control else "program",
            "numbers": {n: c["value"] for n, c in out["checks"].items()},
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": {n: m["value"] for n, m in out["metrics"].items()}}


def main(argv=None) -> int:
    import multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    jobs = ([(args.workload, s, args.seconds, False) for s in seeds]
            + [(args.workload, s, args.seconds, True) for s in cseeds])
    ctx = mp.get_context("spawn")
    rows = []
    with ctx.Pool(args.workers) as pool:
        for row in pool.imap_unordered(_one, jobs):
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
