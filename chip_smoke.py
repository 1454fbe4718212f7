#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

  1. card    — name and power limit from nvidia-smi; TF32 off.
  2. build   — nvcc builds every kernel under src/repro_torch/kernels/csrc
               for sm_90a (one nvcc per source, all started together).
  3. kernel  — the fused layer-0 traversal kernel against its plain PyTorch
               version on the card, at SIFT1M's table size: a seeded
               synthetic graph of 1,000,000 integer-valued 128-d rows, 256
               lanes, C=72, EF=40, max_hops=176, l2/ip/cosine at H in
               {1, 4}, supersteps run to the end; every state tensor must
               be bitwise equal after every superstep.
  4. main    — the port's main path through its public entry points:
               SearchService.build(partitioned, P=4, M=16,
               ef_construction=100, fused_hops=4) over 32,768 integer-valued
               128-d vectors on the card, then `serve_loop` over 8 batches
               of 256 queries (k=10, ef=40) with rerank off and on, the
               traversal launch counter reset just before and read just
               after. Checks: recall@10 >= 0.95 against the exact backend
               on the card, launches > 0, fused_hops=1 bitwise equal to
               fused_hops=4, and a CPU copy (saved, then loaded with
               device="cpu") bitwise equal to the card on one batch.
  5. timing  — the kernel and its plain version at the main path's shapes,
               replayed from the beam states of one main-path batch; the
               bound is the bytes those supersteps must move over the
               card's 3.35 TB/s.

The line before the last is {"kernels": [...]} with each kernel's
launches on the main path, error, times and bound; the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the repository's
sources beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
DEVICE = "cuda"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def events_ms(fn) -> float:
    """Device time of fn() in ms (CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version at SIFT1M's table size
# ---------------------------------------------------------------------------


def synthetic_graph(n_rows: int, dim: int, m0: int, seed: int):
    """Integer-valued rows, +inf sqnorm pads, de-duplicated neighbor rows
    of random degree (duplicates -> -1, first occurrence kept)."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    n_valid = n_rows - 16                                  # 16 pad rows
    vec = torch.randint(0, 256, (1, n_rows, dim), generator=g, device=dev,
                        dtype=torch.int32).float()
    vec[0, n_valid:] = 0
    sq = (vec * vec).sum(-1)
    sq[0, n_valid:] = float("inf")
    nbr = torch.randint(0, n_valid, (n_rows, m0), generator=g, device=dev,
                        dtype=torch.int32)
    srt, order = torch.sort(nbr, dim=1, stable=True)
    dup = torch.zeros_like(nbr, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    nbr = torch.empty_like(nbr).scatter_(1, order, torch.where(dup, -1, srt))
    degree = torch.randint(m0 // 2, m0 + 1, (n_rows, 1), generator=g,
                           device=dev)
    nbr[torch.arange(m0, device=dev)[None, :] >= degree] = -1
    nbr[n_valid:] = -1
    return vec, sq, nbr[None].contiguous(), g


def initial_state(vec, sq, queries, qsq, metric, C, EF, g):
    from repro_torch.core.search import bitmap_words
    from repro_torch.kernels.traversal import metric_distance

    dev = vec.device
    L = queries.shape[0]
    n_valid = int(torch.isfinite(sq[0]).sum())
    ep = torch.randint(0, n_valid, (L,), generator=g, device=dev,
                       dtype=torch.int32)
    ep_d = metric_distance(metric, (vec[0, ep.long()] * queries).sum(-1),
                           sq[0, ep.long()], qsq)
    vis = torch.zeros((L, bitmap_words(vec.shape[1])), dtype=torch.int32,
                      device=dev)
    vis.scatter_add_(1, (ep >> 5).long()[:, None],
                     (torch.ones_like(ep) << (ep & 31))[:, None])
    cand_d = torch.full((L, C), float("inf"), device=dev)
    cand_i = torch.full((L, C), -1, dtype=torch.int32, device=dev)
    fin_d = torch.full((L, EF), float("inf"), device=dev)
    fin_i = torch.full((L, EF), -1, dtype=torch.int32, device=dev)
    cand_d[:, 0], cand_i[:, 0], fin_d[:, 0], fin_i[:, 0] = ep_d, ep, ep_d, ep
    zeros = torch.zeros(L, dtype=torch.int32, device=dev)
    return [cand_d, cand_i, fin_d, fin_i, vis, zeros, zeros.clone()]


def live_any(state, max_hops: int) -> bool:
    cand_d, _, fin_d, _, _, hops, _ = state
    return bool(((cand_d[:, 0] < fin_d[:, -1]) & (hops < max_hops)).any())


def kernel_phase(n_rows: int, seed: int) -> dict:
    from repro_torch.kernels import traversal as tr

    B, D, M0, C, EF, MAX_HOPS = 256, 128, 32, 72, 40, 176
    t0 = time.perf_counter()
    vec, sq, nbr, g = synthetic_graph(n_rows, D, M0, seed)
    queries = torch.randint(0, 256, (B, D), generator=g, device=DEVICE,
                            dtype=torch.int32).float()
    qsq = (queries * queries).sum(-1)
    torch.cuda.synchronize()
    log(f"[kernel] synthetic graph: {n_rows} rows x {D} d "
        f"({vec.numel() * 4 / 2**20:.0f} MiB), M0_pad={M0}, "
        f"{time.perf_counter() - t0:.1f}s")
    worst = 0.0
    for metric in ("l2", "ip", "cosine"):
        for H in (1, 4):
            init = initial_state(vec, sq, queries, qsq, metric, C, EF,
                                 g)
            sk = [t.clone() for t in init]
            sr = [t.clone() for t in init]
            steps, k_ms, r_ms = 0, 0.0, 0.0
            while live_any(sk, MAX_HOPS) or live_any(sr, MAX_HOPS):
                k_ms += events_ms(lambda: tr.fused_traversal_cuda(
                    vec, sq, nbr, queries, qsq, *sk, fused_hops=H,
                    max_hops=MAX_HOPS, metric=metric))
                r_ms += events_ms(lambda: tr.fused_traversal_ref(
                    vec, sq, nbr, queries, qsq, *sr, fused_hops=H,
                    max_hops=MAX_HOPS, metric=metric))
                steps += 1
                for name, a, b in zip(("cand_d", "cand_i", "fin_d", "fin_i",
                                       "visited", "hops", "calcs"), sk, sr):
                    check(torch.equal(a, b),
                          f"kernel != plain: {name} after superstep {steps} "
                          f"({metric}, H={H})")
            fin = torch.isfinite(sr[2])
            worst = max(worst, float((sk[2][fin] - sr[2][fin]).abs().max()))
            log(f"[kernel] {metric:6s} H={H}: bitwise equal over {steps} "
                f"supersteps ({steps} kernel launches); hops mean {sk[5].float().mean():.1f} "
                f"(max {int(sk[5].max())}), calcs mean "
                f"{sk[6].float().mean():.1f}; kernel "
                f"{k_ms / steps:.4f} ms/superstep, plain "
                f"{r_ms / steps:.4f} ms/superstep")
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def recall_at(ids: np.ndarray, gt: np.ndarray) -> float:
    hit = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    return hit / gt.size


def main_phase(n: int, n_queries: int, batch: int) -> dict:
    import dataclasses

    from repro_torch.api import IndexSpec, SearchRequest, SearchService
    from repro_torch.core.hnsw_graph import HNSWConfig
    from repro_torch.data import VectorDataset
    from repro_torch.kernels import traversal as tr
    from repro_torch.launch.serve import serve_loop

    ds = VectorDataset(n, 128)
    data = np.rint(ds.vectors()).astype(np.float32)
    queries = np.rint(np.clip(ds.queries(n_queries), 0, 255)).astype(
        np.float32)
    spec = IndexSpec(backend="partitioned", num_partitions=4,
                     hnsw=HNSWConfig(M=16, ef_construction=100),
                     keep_vectors=True, fused_hops=4)
    t0 = time.perf_counter()
    svc = SearchService.build(data, spec, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[main] build: {n} x 128 vectors, P=4, M=16, ef_construction=100 "
        f"-> {build_s:.1f}s (host graph build + upload)")

    exact = SearchService.build(data, IndexSpec(backend="exact"),
                                device=DEVICE)
    gt = np.concatenate([
        exact.search(SearchRequest(queries[i:i + batch], k=10)).ids.cpu()
        .numpy() for i in range(0, n_queries, batch)])

    n_batches = n_queries // batch
    tr.LAUNCHES = 0
    for rerank in (False, True):
        before = tr.LAUNCHES
        ids, st = serve_loop(svc, queries, batch, 10, 40, rerank=rerank,
                             log=lambda m: log(f"[main] rerank={rerank} {m}"))
        launches = tr.LAUNCHES - before
        rec = recall_at(ids, gt)
        log(f"[main] rerank={rerank}: recall@10 {rec:.4f}, QPS "
            f"{st['qps']:.1f}, p50 {st['p50_ms']:.3f} ms, p99 "
            f"{st['p99_ms']:.3f} ms per {batch}-query batch, traversal "
            f"launches {launches} ({launches / n_batches:.2f} per batch)")
        check(rec >= 0.95, f"recall@10 {rec:.4f} < 0.95 (rerank={rerank})")
    main_launches = tr.LAUNCHES
    check(main_launches > 0, "the main path launched no traversal kernel")

    # hops per batch and the fused_hops=1 == fused_hops=4 contract
    def answer(h, q):
        be = svc.backend
        old = be.spec
        be.spec = dataclasses.replace(old, fused_hops=h)
        try:
            r = svc.search(SearchRequest(q, k=10, ef=40, with_stats=True))
            return [t.cpu() for t in (r.ids, r.dists, r.stats.hops,
                                      r.stats.dist_calcs)]
        finally:
            be.spec = old

    hops = []
    for i in range(0, n_queries, batch):
        a4, a1 = answer(4, queries[i:i + batch]), answer(1, queries[i:i + batch])
        for name, x, y in zip(("ids", "dists", "hops", "dist_calcs"), a4, a1):
            check(torch.equal(x, y), f"fused_hops=1 != 4: {name}, batch "
                                     f"{i // batch}")
        hops.append(int(a4[2].sum()))
    log(f"[main] fused_hops=1 == fused_hops=4 bitwise on {n_queries} "
        f"queries; layer-0 hops per batch (summed over partitions) mean "
        f"{np.mean(hops):.0f}")

    # the CPU copy: save, load with device="cpu", one batch bitwise
    with tempfile.TemporaryDirectory() as tmp:
        svc.save(tmp)
        cpu = SearchService.load(tmp, device="cpu")
    q0 = queries[:batch]
    for rerank in (False, True):
        rc = cpu.search(SearchRequest(q0, k=10, ef=40, rerank=rerank,
                                      with_stats=True))
        rg = svc.search(SearchRequest(q0, k=10, ef=40, rerank=rerank,
                                      with_stats=True))
        for name in ("ids", "dists"):
            check(torch.equal(getattr(rc, name), getattr(rg, name).cpu()),
                  f"CPU != card: {name} (rerank={rerank})")
        check(torch.equal(rc.stats.hops, rg.stats.hops.cpu())
              and torch.equal(rc.stats.dist_calcs, rg.stats.dist_calcs.cpu()),
              f"CPU != card: stats (rerank={rerank})")
    log(f"[main] CPU copy (save -> load device='cpu') bitwise equal to the "
        f"card on one {batch}-query batch, rerank off and on")
    return {"launches": main_launches, "svc": svc, "queries": q0}


# ---------------------------------------------------------------------------
# phase 5: kernel timing at the main path's shapes
# ---------------------------------------------------------------------------


def timing_phase(svc, queries, reps: int = 5) -> dict:
    """Replay the layer-0 supersteps of one main-path batch: record each
    superstep's input state, then time the kernel and the plain version
    from those states (device time, CUDA events, median of `reps`)."""
    from repro_torch.core import search as cs
    from repro_torch.kernels import traversal as tr

    db = svc.backend.pdb.db
    P, _, d_pad = db.vectors.shape
    p = svc.backend.params(10, 40).resolve(db.l0_nbrs.shape[-1])
    q = cs.prepare_queries(queries, d_pad, db.vectors.device)
    B = q.shape[0]
    lane = torch.arange(P * B, device=q.device)
    qsq = (q * q).sum(-1)
    # host clock around each stage of one batch (each ends synchronized)
    split = {}
    for _ in range(3):                     # the last of 3 repeats is kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ep, ep_d, _ = cs._greedy_upper(db, lane // B, q[lane % B],
                                       qsq[lane % B], p)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cs._search_layer0(db, q, qsq, ep, ep_d, p)
        torch.cuda.synchronize()
        split = {"upper_ms": (t1 - t0) * 1e3,
                 "layer0_ms": (time.perf_counter() - t1) * 1e3}
    # the layer-0 loop's initial state, then record supersteps as they run
    states = []
    orig = cs.fused_layer0

    def recorder(*args, **kw):
        states.append([t.clone() for t in args[5:]])
        return orig(*args, **kw)

    cs.fused_layer0 = recorder
    try:
        cs._search_layer0(db, q, qsq, ep, ep_d, p)
    finally:
        cs.fused_layer0 = orig
    H = max(p.fused_hops, 1)
    args = (db.vectors, db.sqnorms, db.l0_nbrs, q, qsq)
    kw = dict(fused_hops=H, max_hops=p.max_hops, metric=p.metric)

    def time_fn(fn):
        """Median device ms per superstep, and each superstep's output."""
        per_step, outs = [], []
        for st in states:
            runs = []
            for _ in range(reps):
                work = [t.clone() for t in st]
                torch.cuda.synchronize()
                runs.append(events_ms(lambda: fn(*args, *work, **kw)))
            per_step.append(sorted(runs)[len(runs) // 2])
            outs.append(work)
        return per_step, outs

    launches_before = tr.LAUNCHES
    k_ms, k_out = time_fn(tr.fused_traversal_cuda)
    r_ms, r_out = time_fn(tr.fused_traversal_ref)
    tr.LAUNCHES = launches_before          # timing launches do not count
    for i, (a, b) in enumerate(zip(k_out, r_out)):
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"kernel != plain at the main path's shapes, superstep {i}")
    # bytes each superstep must move, from this batch's own data
    D, M0 = d_pad, db.l0_nbrs.shape[-1]
    C, EF = p.cand_size, p.ef
    L = P * B
    bytes_ = flops = 0
    for st, nxt in zip(states, r_out):
        dh = int((nxt[5] - st[5]).sum())
        dc = int((nxt[6] - st[6]).sum())
        bytes_ += (dh * 2 * 4 * M0          # neighbor rows + visited words
                   + dc * (4 * D + 4)       # active rows + their sqnorms
                   + L * (C + EF) * 8 * 2   # beam state in and out
                   + B * (4 * D + 4))       # queries
        flops += dc * 2 * D
    steps = len(states)
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3 / steps
    out = {"steps": steps, "ms": sum(k_ms) / steps, "plain_ms": sum(r_ms) / steps,
           "bound_ms": bound_ms, "bytes_per_step": bytes_ / steps,
           "lanes": L, "H": H, **split}
    log(f"[timing] main-path shapes: L={L} lanes (P={P} x B={B}), "
        f"N_pad={db.vectors.shape[1]}, D_pad={D}, M0_pad={M0}, C={C}, "
        f"EF={EF}, H={H}: {steps} supersteps; kernel {out['ms']:.4f} ms, "
        f"plain {out['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms "
        f"({out['bytes_per_step'] / 1e6:.3f} MB) per superstep")
    log(f"[timing] one {B}-query batch, host clock: upper-layer descent "
        f"{split['upper_ms']:.3f} ms, layer-0 loop {split['layer0_ms']:.3f} "
        f"ms ({steps} supersteps, kernel {sum(k_ms):.3f} ms of it)")
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernel,main",
                    help="comma list of kernel,main (card and build "
                         "always run)")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke test needs a CUDA device", file=sys.stderr)
        return 2
    t_all = time.perf_counter()

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] nvcc sm_90a: {', '.join(p.name for p in libs.values())} "
        f"in {time.perf_counter() - t0:.1f}s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line.strip()}")

    phases = set(args.phases.split(","))
    kern = {"max_abs_err": None}
    if "kernel" in phases:
        kern = kernel_phase(1_000_000, seed=0)
    main_out = timing = None
    if "main" in phases:
        main_out = main_phase(32768, 2048, 256)
        timing = timing_phase(main_out["svc"], main_out["queries"])

    row = {
        "name": "fused_traversal",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/traversal.cu",
        "replaces": "src/repro/kernels/traversal.py:234",
        "launches": main_out["launches"] if main_out else 0,
        "max_abs_err": kern["max_abs_err"],
        "ms": timing["ms"] if timing else None,
        "plain_ms": timing["plain_ms"] if timing else None,
        "bound_ms": timing["bound_ms"] if timing else None,
        "bound_by": "bytes",
        "library_ms": None,
    }
    log(f"[done] {time.perf_counter() - t_all:.1f}s")
    print(smi)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
