#!/usr/bin/env python3
"""Split the device time of the PyTorch port's PQ ADC matrix kernel
(`csrc/pq_adc_smem.cu`, `pq_adc`) between its parts, on one NVIDIA card,
beside `csrc/qdist.cu`'s pq_adc on the same inputs.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_pq_adc_profile.py

Over 256 queries' integer tables in [0, 8) and 32,768 and 1,000,000
seeded uint8 code rows of M = 16 with 16 +inf padding rows (chip_smoke.py's
`pq_wide_inputs`), it builds the kernel and four variants of its source
(and of `csrc/pq_stage.cuh`, which holds the lookup) with nvcc:

- "PRMT bytes": each code byte extracted by one PRMT (`__byte_perm`)
  instead of a shift and a mask;
- "no stores": the distances are staged and read back but not written
  to the matrix (every sum is >= 0, so the guard `< -1` never holds);
- "no bank conflicts": each row slot of a step reads its table entry at
  the code with its low bits replaced by the slot's index, so the 32 / kQ
  rows of a lookup instruction fall on distinct bank groups (one
  wavefront a lookup instead of 2.10 on random codes);
- "pipeline only": each subspace adds its code byte's bits (read as a
  float) instead of a table entry: the tables' load, the TMA ring of code
  tiles, the byte extraction, the float adds, the staging and the stores.

It times the five and qdist.cu's kernel by device time (torch.profiler;
in turns, forward then backward), so the differences split the kernel:
stores = kernel - no stores, bank conflicts = kernel - no bank
conflicts, lookups = kernel - pipeline only. The variants' answers are
meaningless: only their times are read. The kernel itself is first held
bitwise to the plain version. The last line is a JSON object of every
time in ms.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ROWS, SEED = (32_768, 1_000_000), 0

# the lines the variants change, as they stand in csrc/pq_stage.cuh
# (EXTRACT, LOOKUP) and csrc/pq_adc_smem.cu (STORE)
EXTRACT = "(w[h] >> (8 * b)) & 0xffu"
LOOKUP = "lq[(m * 256 + c) * kQ]"
STORE = "if (q < n_queries) o[q * bx] = stage[q * kPitch + lane];"
HEADER = '#include "pq_stage.cuh"'
VARIANTS = {
    "kernel": {},
    "PRMT bytes": {EXTRACT: "__byte_perm(w[h], 0u, 0x4440u + b)"},
    "no stores": {STORE: "if (q < n_queries && stage[q * kPitch + lane] "
                         "< -1.f) o[q * bx] = stage[q * kPitch + lane];"},
    # a step's row slot (lane / kQ) replaces the code's low bits
    "no bank conflicts": {LOOKUP: "lq[(m * 256 + ((c & ~(32 / kQ - 1)) | "
                                  "((threadIdx.x & 31) / kQ))) * kQ]"},
    # the code's bits as a float: no conversion, whose quarter rate would
    # time itself instead of the pipeline
    "pipeline only": {LOOKUP: "__int_as_float(c)"},
}


def build_variants(_build) -> dict:
    """variant -> the C source's stem, built from a copy of csrc/ in the
    build directory."""
    csrc = _build.BUILD_DIR / "profile_pq_adc_csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, csrc)
    src = (_build.CSRC / "pq_adc_smem.cu").read_text()
    head = (_build.CSRC / "pq_stage.cuh").read_text()
    if (STORE not in src or HEADER not in src
            or any(line not in head for line in (EXTRACT, LOOKUP))):
        raise RuntimeError("csrc/pq_adc_smem.cu or csrc/pq_stage.cuh "
                           "changed: update the lines this script replaces")
    stems = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        body, hbody = src, head
        for old, new in edits.items():
            body, hbody = body.replace(old, new), hbody.replace(old, new)
        stems[name] = f"pq_adc_smem_v{i}"
        (csrc / f"pq_stage_v{i}.cuh").write_text(hbody)
        (csrc / f"{stems[name]}.cu").write_text(
            body.replace(HEADER, f'#include "pq_stage_v{i}.cuh"'))
    _build.CSRC = csrc
    _build.build_all(tuple(stems.values()))
    return stems


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pq_adc_profile.py: needs a CUDA device", file=sys.stderr)
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
    stems = build_variants(_build)
    for name, stem in stems.items():
        regs = [line.strip() for line in _build.BUILD_LOG[stem].splitlines()
                if "registers" in line]
        print(f"[build] {name}: {'; '.join(regs)}")
    load = _build.load

    def run(name: str, fn):
        # the wrapper loads its library through _build.load by name
        if name in stems:
            _build.load = lambda _, sig: load(stems[name], sig)
        try:
            return fn()
        finally:
            _build.load = load

    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for n_rows in ROWS:
        ints, codes, xpad = cs.pq_wide_inputs(n_rows, g)
        calls = {name: (lambda: qd.pq_adc_smem_cuda(ints, codes, xpad))
                 for name in VARIANTS}
        calls["qdist.cu"] = lambda: qd.pq_adc_v1_cuda(ints, codes, xpad)
        want = qd.pq_adc_ref(ints, codes, xpad)
        for name in ("kernel", "PRMT bytes"):
            if not torch.equal(run(name, calls[name]), want):
                raise RuntimeError(f"pq_adc_smem.cu ({name}) != plain at "
                                   f"{n_rows} rows")
        del want
        runs = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                runs[name].append(run(name, lambda: cs.device_ms(
                    calls[name], reps=10)))
        t = {name: sum(r) / len(r) for name, r in runs.items()}
        out[str(n_rows)] = t
        print(f"256 x {n_rows} x M=16: kernel {t['kernel']:.4f} ms, "
              f"PRMT bytes {t['PRMT bytes']:.4f} ms, no stores "
              f"{t['no stores']:.4f} ms, no bank conflicts "
              f"{t['no bank conflicts']:.4f} ms, pipeline only "
              f"{t['pipeline only']:.4f} ms, qdist.cu {t['qdist.cu']:.4f} "
              f"ms -> stores {t['kernel'] - t['no stores']:.4f} ms, bank "
              f"conflicts {t['kernel'] - t['no bank conflicts']:.4f} ms, "
              f"lookups {t['kernel'] - t['pipeline only']:.4f} ms",
              flush=True)
        del ints, codes, xpad
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
