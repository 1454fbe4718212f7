#!/usr/bin/env python3
"""Split the device time of the PyTorch port's fused PQ scan
(`csrc/pq_topk_smem.cu`, `pq_topk`) between its parts, on one NVIDIA
card, beside `csrc/qdist.cu`'s pq_topk on the same inputs.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_pq_topk_profile.py [--against DIR]

Over 256 queries' integer tables in [0, 8) and 32,768 and 1,000,000
seeded uint8 code rows of M = 16 with 16 +inf padding rows (chip_smoke.py's
`pq_wide_inputs`), it builds the kernel and three variants of its source
(and of `csrc/pq_stage.cuh`, which holds the lookup) with nvcc:

- "insert each row": the selection of the kernel's first version, which
  inserted each passing distance into its list at once (a ballot, a
  shift of shuffles, the k-th's refresh), instead of buffering the
  passing distances and merging them by rank;
- "no selection": no distance passes the filter (the sums still run, and
  are compared), so the lists stay empty;
- "pipeline only": no selection, and each subspace adds its code byte's
  bits (read as a float) instead of a table entry, so only the tables'
  load, the TMA ring of code tiles, the byte extraction, the float adds
  and the (empty) merges run.

With `--against DIR` (the root of another checkout, such as an unpacked
parent commit) it also builds that checkout's `pq_topk_smem.cu` with its
own headers, and times it in the same turns as "against".

It times the four and qdist.cu's kernel at k = 1, 10 and 64 by device
time (torch.profiler: the durations of a call's kernels, both passes;
in turns, forward then backward), so the differences split the kernel:
selection = kernel - no selection, lookups = no selection - pipeline
only. The variants' answers are meaningless: only their times are read.
The kernel itself (and "against") is first held bitwise to the plain
version. The last line is a JSON object of every time in ms.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ROWS, SEED = (32_768, 1_000_000), 0

# the lines the variants change, as they stand in csrc/pq_topk_smem.cu
# (FILTER, BUFFER) and csrc/pq_stage.cuh (LOOKUP)
FILTER = "      const bool in = topk::before(d, id, kd, ki);\n"
LOOKUP = "lq[(m * 256 + c) * kQ]"
HEADER = '#include "pq_stage.cuh"'
BUFFER = """      if (in)
        buf[qi * kBuffered + held + __popc(pass & my_lanes & below)] =
            make_int2(__float_as_int(d), id);
      held += __popc(pass & my_lanes);
      // a buffer without room for another step's rows: merge them all
      if (__any_sync(kFull, held > kBuffered - kRows)) merge_all();
"""
INSERT = """#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        unsigned int mq = pass & (kQueryLanes << q);
        if (mq == 0u) continue;
        while (mq) {
          const int l = __ffs(mq) - 1;
          mq &= mq - 1;
          const float dl = __shfl_sync(kFull, d, l);
          const int il = __shfl_sync(kFull, id, l);
          float a;
          int b;
          lists[q].at(K - 1, a, b);
          if (topk::before(dl, il, a, b)) lists[q].insert(dl, il, lane);
        }
        float a;
        int b;
        lists[q].at(K - 1, a, b);
        if (q == qi) { kd = a; ki = b; }
      }
"""
# name -> (insert each row, no selection, no lookups)
VARIANTS = {"kernel": (0, 0, 0), "insert each row": (1, 0, 0),
            "no selection": (0, 1, 0), "pipeline only": (0, 1, 1)}


def build_variants(_build, against) -> tuple[dict, dict]:
    """variant -> the C source's stem, and stem -> its source directory:
    the variants built from a copy of csrc/ in the build directory,
    "against" from a copy of that checkout's csrc/."""
    csrc = _build.BUILD_DIR / "profile_pq_csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, csrc)
    src = (_build.CSRC / "pq_topk_smem.cu").read_text()
    head = (_build.CSRC / "pq_stage.cuh").read_text()
    if (FILTER not in src or BUFFER not in src or HEADER not in src
            or LOOKUP not in head):
        raise RuntimeError("csrc/pq_topk_smem.cu or csrc/pq_stage.cuh "
                           "changed: update the lines this script replaces")
    stems = {}
    for i, (name, (insert, no_select, no_lookup)) in enumerate(
            VARIANTS.items()):
        body = src
        if insert:
            body = body.replace(BUFFER, INSERT)
        if no_select:   # d stays live: the tables' sums are never negative
            body = body.replace(FILTER, "      const bool in = d < -1.f;\n")
        if no_lookup:
            # the code's bits as a float: no conversion, whose quarter
            # rate would time itself instead of the pipeline
            (csrc / f"pq_stage_v{i}.cuh").write_text(
                head.replace(LOOKUP, "__int_as_float(c)"))
            body = body.replace(HEADER, f'#include "pq_stage_v{i}.cuh"')
        stems[name] = f"pq_topk_smem_v{i}"
        (csrc / f"{stems[name]}.cu").write_text(body)
    dirs = dict.fromkeys(stems.values(), csrc)
    _build.CSRC = csrc
    _build.build_all(tuple(stems.values()))
    if against is not None:
        other = _build.BUILD_DIR / "profile_pq_csrc_against"
        shutil.rmtree(other, ignore_errors=True)
        other.mkdir(parents=True)
        theirs = Path(against) / "src" / "repro_torch" / "kernels" / "csrc"
        for f in theirs.glob("*.cuh"):
            shutil.copy(f, other)
        shutil.copy(theirs / "pq_topk_smem.cu",
                    other / "pq_topk_smem_against.cu")
        stems["against"] = "pq_topk_smem_against"
        dirs["pq_topk_smem_against"] = other
        _build.CSRC = other
        _build.build_all(("pq_topk_smem_against",))
    return stems, dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None,
                    help="root of another checkout whose pq_topk_smem.cu "
                         "to time beside this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_pq_topk_profile.py: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import qdist as qd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.load("qdist", qd._SIGNATURES)      # before CSRC moves to the copy
    stems, dirs = build_variants(_build, args.against)
    load = _build.load

    def run(name: str, fn):
        # the wrapper loads its library through _build.load by name, from
        # the directory the library was built from
        if name in stems:
            _build.CSRC = dirs[stems[name]]
            _build.load = lambda _, sig: load(stems[name], sig)
        try:
            return fn()
        finally:
            _build.load = load

    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for n_rows in ROWS:
        ints, codes, xpad = cs.pq_wide_inputs(n_rows, g)
        for k in (1, 10, 64):
            calls = {name: (lambda k=k: qd.pq_topk_smem_cuda(ints, codes, xpad,
                                                             k=k))
                     for name in stems}
            calls["qdist.cu"] = lambda k=k: qd.pq_topk_v1_cuda(ints, codes,
                                                               xpad, k=k)
            want = qd.pq_topk_ref(ints, codes, xpad, k=k)
            for name in ("kernel", "against"):
                if name not in stems:
                    continue
                got = run(name, calls[name])
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise RuntimeError(f"pq_topk_smem.cu ({name}) != plain "
                                       f"at {n_rows} rows, k={k}")
            runs = {name: [] for name in calls}
            for order in (list(calls), list(calls)[::-1]):
                for name in order:
                    runs[name].append(run(name, lambda: cs.device_ms(
                        calls[name], reps=10)))
            t = {name: sum(r) / len(r) for name, r in runs.items()}
            out[f"{n_rows} k={k}"] = t
            print(f"256 x {n_rows} x M=16, k={k}: kernel {t['kernel']:.4f} "
                  f"ms, insert each row {t['insert each row']:.4f} ms, no "
                  f"selection {t['no selection']:.4f} ms, pipeline only "
                  f"{t['pipeline only']:.4f} ms, qdist.cu "
                  f"{t['qdist.cu']:.4f} ms"
                  + (f", against {t['against']:.4f} ms (kernel "
                     f"{t['kernel'] / t['against'] - 1:+.2%})"
                     if "against" in t else "")
                  + " -> selection "
                  f"{t['kernel'] - t['no selection']:.4f} ms, lookups "
                  f"{t['no selection'] - t['pipeline only']:.4f} ms",
                  flush=True)
        del ints, codes, xpad
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
