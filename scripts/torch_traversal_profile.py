#!/usr/bin/env python3
"""Split the device time of a superstep of the PyTorch port's layer-0
traversal kernel (`csrc/traversal_async.cu`) between its stages, and
measure the card's dependent-load latency floor, on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_traversal_profile.py

It builds a seeded synthetic graph at the main path's shapes (P = 4
partitions of 8,192 integer-valued 128-d rows, M0_pad = 32 neighbours of
random degree 16..32, 256 queries: L = 1,024 lanes; C = 72, EF = 40, H =
4), runs the kernel from random entry points to the end and records the
input state of every superstep, for float32 rows and their uint8 / int8
codes. Then it builds the kernel and three variants of its source with
nvcc:

- "no visited test": every valid neighbour is active (no test-and-set),
  so a hop also gathers the rows it has seen;
- "rows not gathered": no bulk copies; the distances read whatever the
  staging tile holds;
- "no merge": the next head is still found and its list loaded, but the
  lists are neither merged nor swapped, so every lane stays live for H
  hops;

and replays every recorded superstep through each of them and through
`csrc/traversal.cu` (the kernels in turns, twice, in opposite orders),
timing the kernels' device time with torch.profiler. The variants'
answers are meaningless: only their times are read. The kernel and
traversal.cu are also timed the same way at both bitmap placements, on
one partition of 65,536 rows (shared memory) and of 1,000,000 rows
(global memory) with 256 lanes, chip_smoke.py's kernel-phase shapes.

The pointer chase: 32 chains a CTA over L = 1,024 CTAs, each step one
dependent 4-byte load through a random cycle of 128-byte lines, over a
16 MiB table (the main path's float32 rows; L2-resident) and a 512 MiB
one (the 1M-row table; device memory). A launch of 0, 2H and 64 steps
gives the launch's own time, the floor of a superstep whose hops each
wait for two dependent loads (the neighbour list, then the rows), and
the latency of one load (the slope). The last line is a JSON object of
every time in ms.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
P, N, D, M0, B = 4, 8192, 128, 32, 256
C, EF, H, MAX_HOPS, SEED, REPS = 72, 40, 4, 176, 0, 3

# the lines the variants stub, as they stand in csrc/traversal_async.cu
VISIT = "        act = (atomicOr(vis + (nid >> 5), bit) & bit) == 0u;\n"
COPY = ("        hopper::mbar_expect_tx(bar, row_bytes);\n"
        "        hopper::bulk_load(hopper::smem_u32(rows + tid * row_bytes),\n"
        "                          vec + static_cast<long long>(nid) * D, "
        "row_bytes,\n                          bar);\n")
MERGE_BATCH = "        const int pf = rank + count_less_equal(fd, EF, d);\n"
MERGE_BATCH_END = "        if (pc < C) { ncd[pc] = d; nci[pc] = id; }\n"
MERGE_OLD = ("      // old entry i of both lists moves up by the batch entries "
             "below it\n")
MERGE_OLD_END = ("        if (i < EF && i + nf < EF) { nfd[i + nf] = f; "
                 "nfi[i + nf] = fi[i]; }\n      }\n")
SWAP = "    cur = nx;\n"
VARIANTS = {"kernel": (0, 0, 0), "no visited test": (1, 0, 0),
            "rows not gathered": (0, 1, 0), "no merge": (0, 0, 1)}

CHASE = r"""
#include <cuda_runtime.h>
__global__ void chase_kernel(const int* __restrict__ next, int* out,
                             int lines, int steps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int i = static_cast<int>((static_cast<long long>(t) * 2654435761ll) %
                           lines) * 32;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  out[t] = i;
}
extern "C" int repro_chase(const void* next, void* out, int lines, int ctas,
                           int threads, int steps, void* stream) {
  chase_kernel<<<ctas, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), static_cast<int*>(out), lines, steps);
  return static_cast<int>(cudaGetLastError());
}
"""


def stub(src: str) -> str:
    """The source with #if SKIP_* around the stubbed lines."""
    for line in (VISIT, COPY, MERGE_BATCH, MERGE_BATCH_END, MERGE_OLD,
                 MERGE_OLD_END, SWAP):
        if line not in src:
            raise RuntimeError("csrc/traversal_async.cu changed: update the "
                               f"lines this script stubs ({line.strip()!r})")
    src = src.replace(VISIT, "#if SKIP_VISITED\n        act = true;\n#else\n"
                      + VISIT + "#endif\n")
    src = src.replace(COPY, "#if SKIP_ROWS\n        hopper::mbar_arrive(bar);"
                      "\n#else\n" + COPY + "#endif\n")
    src = src.replace(MERGE_BATCH, "#if !SKIP_MERGE\n" + MERGE_BATCH)
    src = src.replace(MERGE_BATCH_END, MERGE_BATCH_END + "#endif\n")
    src = src.replace(MERGE_OLD, "#if !SKIP_MERGE\n" + MERGE_OLD)
    src = src.replace(MERGE_OLD_END, MERGE_OLD_END + "#endif\n")
    return src.replace(SWAP, "#if !SKIP_MERGE\n" + SWAP + "#endif\n")


def build(_build) -> dict:
    """name -> the C source's stem, built from a copy of csrc/ in the
    build directory (the variants and the pointer chase)."""
    body = stub((_build.CSRC / "traversal_async.cu").read_text())
    csrc = _build.BUILD_DIR / "profile_traversal_csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cu*"):
        shutil.copy(f, csrc)
    stems = {"traversal.cu": "traversal", "chase": "chase"}
    for i, (name, (vis, rows, merge)) in enumerate(VARIANTS.items()):
        stems[name] = f"traversal_async_v{i}"
        (csrc / f"{stems[name]}.cu").write_text(
            f"#define SKIP_VISITED {vis}\n#define SKIP_ROWS {rows}\n"
            f"#define SKIP_MERGE {merge}\n" + body)
    (csrc / "chase.cu").write_text(CHASE)
    _build.CSRC = csrc
    _build.build_all(tuple(stems.values()))
    return stems


def device_ms(make, calls: int, name: str, tries: int = 5) -> float:
    """Device ms a call of the kernels named *name* that make()() launches
    `calls` times (torch.profiler; a trace that lost kernel records is
    taken again, up to `tries` times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn = make()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if len(us) == calls:
            return sum(us) / 1e3 / calls
        print(f"the profiler saw {len(us)} {name} kernels of {calls}; "
              f"taking the trace again", flush=True)
    raise RuntimeError(f"no complete trace of {calls} {name} kernels")


def graph(dev, g, p: int = P, n: int = N):
    """[p, n, D] integer-valued rows, sqnorms, de-duplicated neighbour
    rows of random degree, and B queries."""
    vec = torch.randint(0, 256, (p, n, D), generator=g, device=dev,
                        dtype=torch.int32).float()
    sq = (vec * vec).sum(-1)
    nbr = torch.randint(0, n, (p * n, M0), generator=g, device=dev,
                        dtype=torch.int32)
    srt, order = torch.sort(nbr, dim=1, stable=True)
    dup = torch.zeros_like(nbr, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    nbr = torch.empty_like(nbr).scatter_(1, order, torch.where(dup, -1, srt))
    degree = torch.randint(M0 // 2, M0 + 1, (p * n, 1), generator=g,
                           device=dev)
    nbr[torch.arange(M0, device=dev)[None, :] >= degree] = -1
    q = torch.randint(0, 256, (B, D), generator=g, device=dev,
                      dtype=torch.int32).float()
    return vec, sq, nbr.view(p, n, M0).contiguous(), q


def initial_state(vec, sq, q, g):
    from repro_torch.kernels.traversal import metric_distance

    dev = vec.device
    p, n, _ = vec.shape
    L = p * B
    lane = torch.arange(L, device=dev)
    part, qrow = lane // B, lane % B
    ep = torch.randint(0, n, (L,), generator=g, device=dev,
                       dtype=torch.int32)
    qf = q.float()
    ep_d = metric_distance("l2", (vec[part, ep.long()].float()
                                  * qf[qrow]).sum(-1),
                           sq[part, ep.long()], (qf * qf).sum(-1)[qrow])
    vis = torch.zeros((L, (n + 31) // 32), dtype=torch.int32, device=dev)
    vis.scatter_add_(1, (ep >> 5).long()[:, None],
                     (torch.ones_like(ep) << (ep & 31))[:, None])
    cand_d = torch.full((L, C), float("inf"), device=dev)
    cand_i = torch.full((L, C), -1, dtype=torch.int32, device=dev)
    fin_d = torch.full((L, EF), float("inf"), device=dev)
    fin_i = torch.full((L, EF), -1, dtype=torch.int32, device=dev)
    cand_d[:, 0], cand_i[:, 0], fin_d[:, 0], fin_i[:, 0] = ep_d, ep, ep_d, ep
    z = torch.zeros(L, dtype=torch.int32, device=dev)
    return [cand_d, cand_i, fin_d, fin_i, vis, z, z.clone()]


def split(tr, _build, stems, tables, q, g, names=(*VARIANTS,
                                                 "traversal.cu")) -> dict:
    """Record the supersteps of one search with the kernel, then time
    `names` (variants and traversal.cu) replaying them."""
    vec, sq, nbr = tables
    qsq = (q * q).sum(-1)
    state = initial_state(vec, sq, q, g)
    kw = dict(fused_hops=H, max_hops=MAX_HOPS, metric="l2")
    states = []
    while bool(((state[0][:, 0] < state[2][:, -1])
                & (state[5] < MAX_HOPS)).any()):
        states.append([t.clone() for t in state])
        tr.fused_traversal_async_cuda(vec, sq, nbr, q, qsq, *state, **kw)
    load = _build.load

    def replay(name):
        if name == "traversal.cu":
            fn = tr.fused_traversal_ldg_cuda
        else:
            # the wrapper loads its library through _build.load by name
            _build.load = lambda _, sig: load(stems[name], sig)
            fn = tr.fused_traversal_async_cuda

        def make():
            works = [[t.clone() for t in st] for _ in range(REPS)
                     for st in states]
            return lambda: [fn(vec, sq, nbr, q, qsq, *w, **kw) for w in works]

        try:
            return device_ms(make, REPS * len(states), "traversal")
        finally:
            _build.load = load

    names = list(names)
    runs = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            runs[name].append(replay(name))
    out = {name: sum(r) / len(r) for name, r in runs.items()}
    out["supersteps"] = len(states)
    return out


def chase(_build, dev) -> dict:
    import ctypes

    lib = _build.load("chase", {"repro_chase": (
        ctypes.c_int, [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])})
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    L, T = P * B, 32
    out = torch.empty(L * T, dtype=torch.int32, device=dev)
    res = {}
    for label, mib in (("L2 (16 MiB)", 16), ("device memory (512 MiB)", 512)):
        lines = mib * 2 ** 20 // 128
        perm = torch.randperm(lines, generator=g, device=dev).int()
        nxt = torch.zeros(lines * 32, dtype=torch.int32, device=dev)
        # one random cycle through every line
        nxt[perm.long() * 32] = torch.roll(perm, -1) * 32
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(steps):
            err = lib.repro_chase(nxt.data_ptr(), out.data_ptr(), lines, L,
                                  T, steps, stream)
            if err:
                raise RuntimeError(f"chase launch failed: CUDA error {err}")

        t = {}
        for steps in (0, 2 * H, 64):
            t[steps] = device_ms(
                lambda: lambda: [run(steps) for _ in range(20)], 20, "chase")
        lat = (t[64] - t[0]) / 64
        res[label] = {"launch_ms": t[0], f"floor_{2 * H}_loads_ms": t[2 * H],
                      "64_loads_ms": t[64], "load_latency_ns": lat * 1e6}
        print(f"pointer chase, {label}: a launch of {L} x {T} chains "
              f"{t[0]:.4f} ms with no load, {t[2 * H]:.4f} ms with {2 * H} "
              f"dependent loads (H = {H} hops x 2), {t[64]:.4f} ms with 64; "
              f"{lat * 1e6:.1f} ns a load", flush=True)
        del nxt, perm
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_traversal_profile.py: needs a CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, traversal as tr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    stems = build(_build)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    vec, sq, nbr, q = graph(dev, g)
    out = {"card": smi}
    for dtype in ("float32", "uint8", "int8"):
        if dtype == "float32":
            rows, qq = vec, q
        elif dtype == "uint8":
            rows, qq = vec.to(torch.uint8), q
        else:
            rows = (vec - 128).clamp(-127, 127).to(torch.int8)
            qq = (q - 128).clamp(-127, 127)
        rsq = (rows.float() ** 2).sum(-1)
        t = split(tr, _build, stems, (rows.contiguous(), rsq, nbr),
                  qq.contiguous(), g)
        out[dtype] = t
        k = t["kernel"]
        print(f"{dtype}: {t['supersteps']} supersteps; device ms a "
              f"superstep: kernel {k:.4f}, no visited test "
              f"{t['no visited test']:.4f} ({k - t['no visited test']:+.4f})"
              f", rows not gathered {t['rows not gathered']:.4f} "
              f"({k - t['rows not gathered']:+.4f}), no merge "
              f"{t['no merge']:.4f} ({k - t['no merge']:+.4f}); traversal.cu "
              f"{t['traversal.cu']:.4f} ({t['traversal.cu'] / k:.2f}x)",
              flush=True)
    # both bitmap placements at the kernel phase of chip_smoke.py's shapes:
    # one partition, 256 lanes
    for n in (65_536, 1_000_000):
        vec, sq, nbr, q = graph(dev, g, 1, n)
        t = split(tr, _build, stems, (vec, sq, nbr), q, g,
                  ("kernel", "traversal.cu"))
        place = tr.traversal_route(vec.dtype, D, M0, C, EF, n)[1]
        out[f"float32 {n} rows"] = {**t, "bitmap": place}
        print(f"float32, one partition of {n} rows, {B} lanes, {place} "
              f"bitmap: {t['supersteps']} supersteps; device ms a "
              f"superstep: kernel {t['kernel']:.4f}, traversal.cu "
              f"{t['traversal.cu']:.4f} "
              f"({t['traversal.cu'] / t['kernel']:.2f}x)", flush=True)
        del vec, sq, nbr
    out["chase"] = chase(_build, dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
