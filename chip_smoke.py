#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

  1. card    — name and power limit from nvidia-smi; TF32 off.
  2. build   — nvcc builds every kernel under src/repro_torch/kernels/csrc
               for sm_90a (one nvcc per source, all started together).
               Then three worker processes start building the quantized
               indexes of phase 6 (uint8, int8 and pq partitioned, each
               through SearchService.build on the card, then saved), while
               phases 3 and 4's build run; a fourth builds the index
               phase 6d's compaction must equal, and then the four shards
               of phase 6e's cluster and the single index its
               build_cluster check must equal (six workers in all); phase
               4 waits for them (and stops the workers) before it serves,
               so no build competes with a timed batch.
  3. kernel  — every kernel against its plain PyTorch version on the card
               at SIFT1M's table size, 1,000,000 rows: both layer-0
               traversal kernels (traversal_async.cu, through the
               dispatching wrapper, and traversal.cu) on a seeded synthetic
               graph of integer-valued 128-d float32 rows (l2/ip/cosine)
               and of its uint8 and int8 code rows (l2), at H in {1, 4},
               256 lanes, C=72, EF=40, max_hops=176, supersteps run to the
               end, every state tensor bitwise equal after every superstep;
               the same on a second graph of N_SHARED = 65,536 rows, so
               traversal_async.cu runs with its visited bitmap in global
               memory (1M rows) and in shared memory (65,536); its shared-
               memory count against the Python mirror and its CTAs an SM
               at the main path's shapes (>= 8); and both pq_adc kernels
               (pq_adc_smem.cu and qdist.cu's) and both pq_topk kernels
               (pq_topk_smem.cu and qdist.cu's; M=16, 256 queries, k = 1,
               10 and 64) over 1,000,000 seeded uint8 code rows with
               float-valued and integer-valued tables in [0, 8)
               (tie-heavy), with and without +inf padding rows, bitwise
               equal; then pq_adc through its dispatching wrapper at
               ragged Bq and Bx, a short tile and M = 16 / 32 / 64 (both
               kernels), M = 8 and unaligned codes (qdist.cu), each on the
               kernel the launch counters show it took.
  4. main    — the port's float32 main path through its public entry
               points: SearchService.build(partitioned, P=4, M=16,
               ef_construction=100, fused_hops=4) over 32,768
               integer-valued 128-d vectors on the card, then `serve_loop`
               over 8 batches of 256 queries (k=10, ef=40) with rerank off
               and on, each after one untimed batch (the timed loop starts
               on a warm service), both traversal launch counters reset
               just before and read just after. Checks: recall@10 >= 0.95
               against the exact backend on the card, traversal_async.cu
               launches > 0 and traversal.cu launches == 0,
               fused_hops=1 bitwise equal to fused_hops=4, and a CPU copy
               (saved, then loaded with device="cpu") bitwise equal to the
               card on one batch.
  5. timing  — both traversal kernels and the plain version at the main
               path's shapes, replayed from the beam states of one
               main-path batch, each bitwise equal to the plain version;
               the kernels' device time by torch.profiler, in turns
               (async, ldg, ldg, async), and each call's time with CUDA
               events around it; the bound is the bytes those supersteps
               must move over the card's 3.35 TB/s.
  6. quant   — the quantized paths over the same vectors and queries,
               each index loaded onto the card from its worker's save:
               uint8 and int8 partitioned (P=4, fused_hops=4) through
               `serve_loop`, rerank off and on — uint8 ids equal to the
               float32 service's (byte data with max 255 quantizes to
               itself), recall@10 gates, traversal_async.cu launches > 0
               and traversal.cu launches == 0,
               fused_hops=1 == 4 on every batch, a CPU copy bitwise equal
               on one batch; pq (pq_m=16, codebooks fitted by the port's
               PQQuantizer.fit and rounded to integers, so every LUT entry
               is an exact integer): the exact backend through the pq_topk
               kernels (pq_topk_smem.cu launches > 0, qdist.cu's pq_topk
               launches == 0), its ids equal to a host numpy ADC top-10
               on one batch, its p50 per batch read again with ops.pq_topk
               sent to each kernel in turns (the same ids); partitioned with rerank off and on,
               its rerank-off ids against the exact ADC scan's (overlap
               gate), rerank on no worse than off; recall@10 against the
               float32 exact backend is printed (PQ at 16 bytes a row
               cannot resolve this data's neighbors: see PERF.md); a CPU
               copy of each backend bitwise equal on one batch. Then the 8-bit
               traversal and the PQ kernels are timed at these paths'
               shapes against their plain versions and bounds (the PQ
               kernels by device time, both pq_topk kernels in turns and
               both pq_adc kernels in turns, CUDA events around a call
               printed beside; the bound the largest of bytes, float adds
               and shared-memory lookups), and both pq_topk and both
               pq_adc kernels by device time at the kernel phase's
               1,000,000 rows on its integer tables with padding rows.
  6b. csd    — the out-of-core csd backend over the four partitioned
               indexes of phases 4 and 6 (float32, uint8, int8, pq with
               its float32 rerank rows), each written by
               CSDBackend.from_partitioned to a block store of 4,096-byte
               blocks on the machine's disk (no new graph build), then
               served from it with a page cache of at most 1/8 of the
               store and the prefetcher on: one untimed batch, then
               CSD_BATCHES batches of 256 through `serve_loop`, rerank off
               and on. Checks: ids, dists, hops and dist_calcs bitwise
               equal to the partitioned service on the card at fused_hops
               1 and 4 (rerank on at 4 too), block reads > 0, peak cache
               bytes within the cache, fewer supersteps at fused_hops 4
               than at 1, a CPU copy (saved, then loaded with
               device="cpu") bitwise equal on one batch. Prints store and
               cache bytes, QPS and p50 / p99, block reads and bytes read
               a query, the cache hit rate, supersteps a batch, one
               batch's host time by the port's TRACER spans (store-read,
               hop_superstep, hop-kernel, rerank) and the device's busy
               time (torch.profiler) beside the batch's p50. Each store's
               own series (its backend's and page cache's uid, and the
               profiler's stage histograms) over its timed rerank-off
               batches are kept for the cost phase.
  cost     — the port's cost model (`launch/roofline.py`,
               `costmodel.py`, `ann_dryrun.py`, `obs/calibrate.py`)
               against the card, right after 6b, from its four stores'
               traffic (no new build, no new index): (a) the card is an
               H100 with its memory within 10 % of HW.hbm_bytes and 132
               SMs, and a 4 GiB device-to-device copy (median of 5, CUDA
               events) reads and writes at a share of HW.hbm_bw in [0.5,
               1.05]; (b) for each csd dtype, `calibrate` and
               `compare_terms` over the store's 6b window: the fitted hit
               rate, effective storage bandwidth, blocks and supersteps a
               query and dispatch overhead, each term's modeled, measured
               and calibrated values, beside hop-kernel's and the
               device's busy ms a superstep; checks: storage, fanout and
               dispatch all fitted, the storage term's calibrated /
               measured in [0.5, 2], csd_queries_total = the queries
               served; (c) `python -m repro_torch.launch.ann_dryrun
               --calibrated` on the float32 window as a subprocess: its
               last line JSON with fits_hbm true and
               calibrated_qps_per_device, and phase 4's rerank-off QPS
               as a share of its memory-bound bound; (d) the dry-run's
               working-set formula at phase 4's batch beside the rise of
               max_memory_allocated over one batch (printed, no gate).

  6c. serve  — the async serving layer (repro_torch.serve) over phase 4's
               float32 partitioned service: SearchServer with max_wait_ms
               = 2, each of the 2,048 queries its own request (k=10,
               ef=40), rerank off and on, swept over replicas {1, 2, 4} x
               max_batch {64, 256} (one stream a replica on the card), the
               traversal launch counters reset just before the sweep and
               read just after; then one profiled run a replica count
               (max_batch 256) for the device's idle share (torch.profiler
               busy time, the union of the streams' kernels, against the
               wall clock); then phase 6b's float32 csd store behind 4
               replicas, each opening its own page cache of 1/8 of the
               store, over 1,024 queries; then one traced run with the
               stock SLOs and the flight recorder. Checks: ids and dists
               bitwise equal to the direct 256-query batches on every
               run (their ids are phase 4's serve_loop ids; csd: phase
               6b's serve_loop ids, and the partitioned service's dists),
               traversal_async.cu launches > 0 and traversal.cu == 0 over
               the sweep, every csd replica reads blocks, the trace file
               (as --trace-out writes it) parses and nests request > exec
               and batch > dispatch > search, the metrics snapshot holds
               the serve_replica_* and slo_* series, the SLO status and
               the flight dump are read back. Prints each run's QPS, e2e /
               queue / exec p50 and p99, mean batch, per-replica busy
               seconds, and the idle shares.
  6d. ingest — the mutable index (repro_torch.ingest) on the card:
               MutableSearchService(partitioned, P=4, fused_hops=4, M=16,
               ef_construction=100, keep_vectors, seal_threshold=2,048)
               behind a 2-replica SearchServer; the first N_INGEST =
               8,192 of phase 4's vectors streamed in 16 inserts of 512
               through SearchServer.insert, every 10th row of each
               insert deleted once it is sealed (10 %), a 256-query batch
               served rerank off and on after every insert; then
               flush_index and compact_index. Checks: no deleted gid in
               any result, before and after compaction; after compaction,
               ids and dists bitwise equal to SearchService.build over the
               surviving rows on the card (built by a worker process
               beside phase 4's build) on all 2,048 queries, rerank off
               and on; recall@10 >= 0.95 against the exact backend over
               the survivors; a CPU copy (manifest v2 save, load
               device="cpu") bitwise equal to the card on one batch;
               traversal_async.cu launches > 0 and traversal.cu == 0.
               Prints insert rows/s, seal and compaction seconds, search
               p50 before and after compaction, and resident bytes.
  6e. cluster — the sharded cluster (repro_torch.cluster) and the
               distributed backend over phase 4's rows. Phase 4's own
               answers and serve_loops run first. (a) CLUSTER_SHARDS = 4
               shards of one partition each, cut from phase 4's saved
               state (partition i, ids made shard-local; by the seed
               schedule a shard build over those rows gives the same
               graph), each loaded on the card with CLUSTER_REPLICAS = 2
               replicas (`_clone_service`: on one card they share it)
               behind a ClusterRouter: `serve_loop` over all 2,048
               queries, rerank off and on, ids and dists bitwise equal to
               phase 4's service; QPS and p50 beside phase 4's direct
               serve_loop run in the same phase; one profiled loop each
               for the device's idle share and the host side thread by
               thread; then every batch submitted at once from 4 threads
               with replica 0 of every shard killed once the first is in
               flight: every result unchanged, failovers > 0, no shard
               query lost or duplicated, the health monitor marking the
               dead replicas down and, revived, up. build_cluster itself
               on the card at CLUSTER_SMALL = 4,096 rows, 2 shards x 2
               replicas (the seed schedule): ids, dists, hops and
               dist_calcs bitwise equal to a single P=2 index over the
               same rows (a worker's build), rerank off and on. (b) phase
               4's saved state as a `distributed` index (`from_state`, no
               build) on the default mesh (every card over `model`) and a
               (2, 2) ("data", "model") mesh of cuda:0 slots: ids, dists
               and dist_calcs bitwise equal to phase 4's service on every
               batch, rerank off and on, a doubled batch's halves
               identical, QPS and p50 printed, the (2, 2) mesh's loop
               profiled. The launch counters are set to 0 just before the
               router's serve_loops and each mesh's, and read just after:
               traversal_async.cu > 0 and traversal.cu == 0 in each of
               the three, and traversal.cu == 0 over the phase.

  7. scan    — the exact-scan kernels through the public `kernels.ops` API,
               SIFT1M's size: 1,000,000 integer-valued 128-d float32 rows
               (the main paths' data distribution), their uint8 codes
               (scale 1.0: the bytes themselves) and int8 codes (scale
               255/127), 2,048 queries (codes for the 8-bit tables) in
               batches of 256, k=10. Every batch goes through ops.l2topk,
               ops.l2topk_q on both code tables, ops.l2dist and
               ops.l2dist_q, the launch counters reset just before and read
               just after: all four must launch their tensor-core kernels
               (l2topk_tc.cu, l2topk_q_tc.cu, l2dist_tc.cu,
               l2dist_q_tc.cu) and their FMA routes never. Checks: l2topk
               ids and dists bitwise equal to core/bruteforce.py's
               bruteforce_topk on every batch; uint8 l2topk_q equal to
               l2topk; int8 l2topk_q (out_scale = (255/127)^2) bitwise
               equal to its plain version; l2dist / l2dist_q at the top-k
               ids equal the top-k dists. Then both routes of every
               kernel against its plain version at 256 x 1M, with and
               without 16 xsq=+inf pad rows: bitwise on the integer rows
               and codes (l2dist on l2, ip and cosine; l2topk and l2topk_q
               at k = 1, 10 and 64; l2dist_q on uint8 and int8 codes; the
               l2topk_q FMA route given code-valued float32 queries),
               within SCAN_TOL on unit-norm rows (cosine) and Gaussian
               rows (l2dist on l2 and ip, l2topk); ragged shapes (Bq = 3,
               Bx = 70,000, D = 128 / 48 on the tensor cores, l2topk also
               Bx = 70,001; D = 200, and Bx = 70,001 for the matrices, on
               the FMA kernels) through the dispatching wrappers, each on
               the counter its route names; and each timed (median of 5)
               beside its plain version, a library yardstick (torch.addmm,
               then torch.topk for the fused scans; timed only) and its
               bound, the two routes of each kernel on the same inputs.
  8. lm      — the LM substrate, last, after torch.cuda.empty_cache():
               deepseek-v2-lite-16b at full width and depth (27 layers, d
               2048, 16 MLA heads, 64 experts top-6, vocab 102,400; 15.7 B
               parameters, bf16) with the router through the topk kernel,
               built on the card from torch.Generator("cuda").manual_seed(0)
               by `init_params`. B=8 seeded prompts of T=2,048 tokens,
               `prefill_step` into a 2,080-position MLA cache, then 32
               greedy `decode_step`s, the topk and flash_attention launch
               counters reset just before and read just after. Checks: (a)
               both topk kernels (select_k_short.cu, select_k.cu) bitwise
               equal to the plain version on the router's own [16,384, 64]
               rows (k=6) and on [4,096, 64] rows with ties, NaN, +/-inf
               and -0.0 beside +0.0 (k = 1, 6, 64; the plain version on
               the CPU), select_k.cu also at [256, 1M] (k=10) with ties
               and +inf; (b) the flash kernels within FLASH_TOL
               of their plain version: the bf16 tensor-core kernel at
               [128, 2048, 192] causal and at ragged bf16 shapes (T and S
               not multiples of 64 or 128, S != T without the mask, hd =
               24 and 256, T = 1), the FP32-FMA kernel at bf16 hd = 100
               and at unaligned float32 shapes, causal and full, each case
               on the kernel the wrapper picks for it; (c) prefill(256)
               then decode(256..258) against a prefill over 259 tokens
               (B=2) and (d) the same prefill with ops.topk /
               ops.flash_attention swapped for their plain versions, both
               with the capacity raised so that no token is dropped: bf16
               RMS |d logits| within LM_TOL_BF16 x RMS |logit| and the
               greedy token equal on LM_GREEDY_SHARE of the rows (set
               from scripts/torch_lm_gates.py); then (c) and (d) again in
               float32 at full width, depth 1 + 2, within the reference's
               2e-3 with every greedy token equal; (e) 26 short-row topk
               and 27 tensor-core flash launches a prefill (0 of
               select_k.cu and of the FMA flash kernel), 26 short-row
               topk a decode step. Prints
               prefill ms and tokens/s, decode p50 / p99 ms a step and
               tokens/s, peak memory, a torch.profiler split of one
               prefill and one decode step, and each kernel beside its
               plain version, a library call (torch.topk,
               scaled_dot_product_attention; timed only) and its bound,
               the FMA flash kernel at the path's shape beside the
               tensor-core one, both topk kernels by device time at
               [16,384, 64] and [8, 64] beside the device time of one
               trivial kernel (a launch floor).

Each serving path prints QPS and p50/p99 per 256-query batch. The line
before the last is {"kernels": [...]} with each kernel's launches on its
path, error, times and bound; the last line is {"ok": true, "device":
{...}}. Without CUDA, or without the repository's sources beside this
file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# The card's peak rates (NVIDIA's H100 SXM data sheet) have one home, the
# port's `launch/roofline.HW`. Alone in its directory this file finds no
# port: the rates stay None and main() refuses to run.
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.launch.roofline import HW
except ImportError:
    HW = None
_PEAK = HW() if HW else None
HBM_BYTES_PER_S = _PEAK and _PEAK.hbm_bw        # device memory
FP32_FLOPS = _PEAK and _PEAK.fp32_flops         # float32 outside the TCs
TF32_FLOPS = _PEAK and _PEAK.tf32_flops         # dense TF32 tensor cores
INT8_OPS = _PEAK and _PEAK.int8_ops             # dense int8 tensor cores
BF16_FLOPS = _PEAK and _PEAK.peak_flops         # dense bf16 tensor cores
# shared-memory lookups a second: a floor for the PQ kernels
SMEM_LOOKUPS_PER_S = _PEAK and _PEAK.smem_lookups
DEVICE = "cuda"
N_MAIN, N_QUERIES, BATCH, PQ_M = 32768, 2048, 256, 16
# the csd phase: block bytes, the page cache at most 1 / CSD_CACHE_SHARE
# of its store, timed batches of each serving loop
CSD_BLOCK, CSD_CACHE_SHARE, CSD_BATCHES = 4096, 8, 4
# the serve phase: the sweep's replica counts and batcher sizes, the
# batcher's wait, and the csd run's replicas (each on its own page cache)
# and queries
SERVE_REPLICAS, SERVE_MAX_BATCH, SERVE_WAIT_MS = (1, 2, 4), (64, 256), 2.0
SERVE_CSD_REPLICAS, SERVE_CSD_QUERIES = 4, 1024
# the ingest phase: rows streamed in inserts of INGEST_STEP, the seal
# threshold, every INGEST_DEL-th row of each insert deleted once sealed
N_INGEST, INGEST_STEP, INGEST_SEAL, INGEST_DEL = 8192, 512, 2048, 10
# the cluster phase: shards (one partition each, so phase 4's index),
# replicas a shard, and build_cluster's own check at (rows, shards)
CLUSTER_SHARDS, CLUSTER_REPLICAS, CLUSTER_SMALL = 4, 2, (4096, 2)
# the kernel phase's second synthetic graph: 65,536 rows, a 2,048-word
# visited bitmap a lane, the widest traversal_async.cu keeps in shared memory
N_SHARED = 65536
# least share of the exact ADC scan's top-10 the PQ graph search must find
PQ_OVERLAP_GATE = 0.90
HNSW_M, HNSW_EFC, P_MAIN = 16, 100, 4
# the scan phase: SIFT1M's size; float data is held to the plain versions
# within SCAN_TOL * (|q|^2 + |x|^2) (sums in another order; see
# tests/test_torch_scan.py)
N_SCAN, SCAN_K, SCAN_TOL = 1_000_000, 10, 1e-5
# the lm phase: deepseek-v2-lite-16b, B prompts of T tokens, a cache of S
# positions, greedy decode steps; the router's k; (c)'s prompt length
LM_ARCH, LM_B, LM_T, LM_S, LM_STEPS = "deepseek_v2_lite_16b", 8, 2048, 2080, 32
LM_TOPK, LM_C_T, LM_TOPK_WIDE = 6, 256, (256, 1_000_000)
# flash kernel against its plain version: |d| <= rel x max(|got|, |want|)
# + abs; float32 sums in another order, bf16 one rounding of the same
# float32 value (one bf16 spacing)
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-6)}
# (c) decode against prefill and (d) plain versions against the kernels.
# bf16 at full depth (bf16_gate): RMS |d logits| <= LM_TOL_BF16 x RMS
# |logit|, the greedy token equal on LM_GREEDY_SHARE of the rows, and a
# differing one only where the row's difference can explain it.
# scripts/torch_lm_gates.py read both checks on model seeds 0-7 (PERF.md
# §6): the RMS ratio 0.046-0.114 without a fault, 0.259-1.27 with one (a
# non-causal flash kernel; decode one position early), where the max
# |d| over max |logit| overlapped (0.066-0.261 against 0.260-1.32) and
# the greedy share separated nothing (3 of 8 rows at least without a
# fault, up to 7 of 8 with one). float32 at depth 1 + LM_F32_PERIODS,
# where the same checks differ by 1e-5: the reference's own 2e-3
# (tests/test_models.py), every greedy token equal.
LM_TOL_BF16, LM_GREEDY_SHARE, LM_TOL_F32, LM_F32_PERIODS = 0.18, 0.25, 2e-3, 2


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


def median_ms(fn, reps: int = 5) -> float:
    """Median device ms of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    runs = sorted(events_ms(fn) for _ in range(reps))
    return runs[len(runs) // 2]


def bound(bytes_: float, ops: float, peak: float):
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    tb, to = bytes_ / HBM_BYTES_PER_S, ops / peak
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def pq_bound(bytes_: float, adds: float, lookups: float):
    """(bound ms, bound_by, what): the largest of the bytes over the memory
    rate, the float adds over FP32's rate and the shared-memory table
    lookups over SMEM_LOOKUPS_PER_S. Lookups and adds are both operations
    ("operations"); `what` names the one that bounds."""
    times = {"bytes": bytes_ / HBM_BYTES_PER_S, "adds": adds / FP32_FLOPS,
             "lookups": lookups / SMEM_LOOKUPS_PER_S}
    what = max(times, key=times.get)
    return (times[what] * 1e3, "bytes" if what == "bytes" else "operations",
            what)


def in_turns(fns: dict, reps: int = 20) -> dict:
    """device_ms of each of two calls in turns (a, b, b, a), averaged: the
    two kernels meet the same clocks."""
    (na, fa), (nb, fb) = fns.items()
    a1, b1, b2, a2 = (device_ms(f, reps) for f in (fa, fb, fb, fa))
    return {na: (a1 + a2) / 2, nb: (b1 + b2) / 2}


def main_data(n: int, n_queries: int):
    """The main paths' integer-valued 128-d vectors and queries (0..255)."""
    from repro_torch.data import VectorDataset

    ds = VectorDataset(n, 128)
    data = np.rint(ds.vectors()).astype(np.float32)
    queries = np.rint(np.clip(ds.queries(n_queries), 0, 255)).astype(
        np.float32)
    return data, queries


def partitioned_spec(**kw):
    from repro_torch.api import IndexSpec
    from repro_torch.core.hnsw_graph import HNSWConfig

    kw = {"num_partitions": P_MAIN, **kw}
    return IndexSpec(backend="partitioned",
                     hnsw=HNSWConfig(M=HNSW_M, ef_construction=HNSW_EFC),
                     keep_vectors=True, fused_hops=4, **kw)


def build_worker(spec, path: str, n: int, device: str) -> float:
    """Worker process: build one quantized partitioned index through
    SearchService.build on `device` and save it to `path`; returns the
    build's seconds. For pq, the codebooks are fitted by the port's
    PQQuantizer.fit, rounded to integers and passed in on the spec."""
    import dataclasses

    from repro_torch.api import SearchService
    from repro_torch.optim import PQQuantizer

    data, _ = main_data(n, 0)
    if spec.dtype == "pq":
        fit = PQQuantizer.fit(data, spec.pq_m, seed=0)
        spec = dataclasses.replace(
            spec, pq_codebooks=np.rint(fit.codebooks).tolist())
    t0 = time.perf_counter()
    svc = SearchService.build(data, spec, device=device)
    seconds = time.perf_counter() - t0
    svc.save(path)
    return seconds


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at SIFT1M's table size
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


def code_table(vec, sq, queries, dtype: str):
    """8-bit code rows of the synthetic float rows: uint8 as they are,
    int8 shifted by -128 (signed codes); code sqnorms with the +inf pads."""
    if dtype == "uint8":
        codes, qc = vec.to(torch.uint8), queries
    else:
        codes = (vec - 128).clamp(-127, 127).to(torch.int8)
        qc = (queries - 128).clamp(-127, 127)
    cf = codes.float()
    csq = torch.where(torch.isinf(sq), sq, (cf * cf).sum(-1))
    return codes.contiguous(), csq, qc.contiguous(), (qc * qc).sum(-1)


def initial_state(vec, sq, queries, qsq, metric, C, EF, g):
    from repro_torch.core.search import bitmap_words
    from repro_torch.kernels.traversal import metric_distance

    dev = vec.device
    L = queries.shape[0]
    n_valid = int(torch.isfinite(sq[0]).sum())
    ep = torch.randint(0, n_valid, (L,), generator=g, device=dev,
                       dtype=torch.int32)
    ep_d = metric_distance(metric, (vec[0, ep.long()].float() * queries).sum(-1),
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


def run_supersteps(tables, queries, qsq, metric, H, g, what: str) -> dict:
    """Both traversal kernels and the plain version from one initial state
    to the end, bitwise after every superstep: traversal_async.cu through
    the dispatching fused_traversal_cuda (its route checked and its launches
    counted) and traversal.cu. Returns each kernel's max |fin_d|
    difference (0)."""
    from repro_torch.kernels import traversal as tr

    C, EF, MAX_HOPS = 72, 40, 176
    vec, sq, nbr = tables
    route = tr.traversal_route(vec.dtype, vec.shape[2], nbr.shape[2], C, EF,
                               vec.shape[1])
    check(route[0] == "async", f"{what}: the route gives {route}")
    init = initial_state(vec, sq, queries, qsq, metric, C, EF, g)
    sa = [t.clone() for t in init]
    sl = [t.clone() for t in init]
    sr = [t.clone() for t in init]
    kw = dict(fused_hops=H, max_hops=MAX_HOPS, metric=metric)
    steps, a_ms, l_ms, r_ms = 0, 0.0, 0.0, 0.0
    a0, l0 = tr.ASYNC_LAUNCHES, tr.LAUNCHES
    while live_any(sa, MAX_HOPS) or live_any(sr, MAX_HOPS):
        # the kernels in turns: the first call after the checks reads slower
        for kernel in ("ldg", "async")[::1 - 2 * (steps % 2)]:
            if kernel == "async":
                a_ms += events_ms(lambda: tr.fused_traversal_cuda(
                    vec, sq, nbr, queries, qsq, *sa, **kw))
            else:
                l_ms += events_ms(lambda: tr.fused_traversal_ldg_cuda(
                    vec, sq, nbr, queries, qsq, *sl, **kw))
        r_ms += events_ms(lambda: tr.fused_traversal_ref(
            vec, sq, nbr, queries, qsq, *sr, **kw))
        steps += 1
        for name, a, b, c in zip(("cand_d", "cand_i", "fin_d", "fin_i",
                                  "visited", "hops", "calcs"), sa, sl, sr):
            check(torch.equal(a, c),
                  f"traversal_async.cu != plain: {name} after superstep "
                  f"{steps} ({what}, {route[1]} bitmap, {metric}, H={H})")
            check(torch.equal(b, c),
                  f"traversal.cu != plain: {name} after superstep {steps} "
                  f"({what}, {metric}, H={H})")
    check((tr.ASYNC_LAUNCHES - a0, tr.LAUNCHES - l0) == (steps, steps),
          f"{what}: launches counted on the wrong kernel")
    fin = torch.isfinite(sr[2])
    log(f"[kernel] {what} {metric:6s} H={H}, {route[1]} bitmap: both kernels "
        f"bitwise equal to the plain version over {steps} supersteps; hops "
        f"mean {sa[5].float().mean():.1f} (max {int(sa[5].max())}), calcs "
        f"mean {sa[6].float().mean():.1f}; traversal_async {a_ms / steps:.4f}"
        f", traversal.cu {l_ms / steps:.4f}, plain {r_ms / steps:.4f} "
        f"ms/superstep (a call, host time included)")
    return {"async": float((sa[2][fin] - sr[2][fin]).abs().max()),
            "ldg": float((sl[2][fin] - sr[2][fin]).abs().max())}


def traversal_checks(n_rows: int, seed: int) -> dict:
    """Both traversal kernels against the plain version on a synthetic
    graph of `n_rows` rows: float32 rows under l2 / ip / cosine and their
    uint8 / int8 codes under l2, at H = 1 and 4. Returns the worst
    difference by (kernel, dtype), and the graph's generator."""
    B, D, M0 = 256, 128, 32
    t0 = time.perf_counter()
    vec, sq, nbr, g = synthetic_graph(n_rows, D, M0, seed)
    queries = torch.randint(0, 256, (B, D), generator=g, device=DEVICE,
                            dtype=torch.int32).float()
    qsq = (queries * queries).sum(-1)
    torch.cuda.synchronize()
    log(f"[kernel] synthetic graph: {n_rows} rows x {D} d "
        f"({vec.numel() * 4 / 2**20:.0f} MiB), M0_pad={M0}, bitmap "
        f"{(n_rows + 31) // 32} words a lane, "
        f"{time.perf_counter() - t0:.1f}s")
    worst = {}

    def keep(dtype, errs):
        for k, e in errs.items():
            worst[(k, dtype)] = max(worst.get((k, dtype), 0.0), e)

    for metric in ("l2", "ip", "cosine"):
        for H in (1, 4):
            keep("float32", run_supersteps((vec, sq, nbr), queries, qsq,
                                           metric, H, g, "float32"))
    for dtype in ("uint8", "int8"):
        codes, csq, qc, qcsq = code_table(vec, sq, queries, dtype)
        for H in (1, 4):
            keep(dtype, run_supersteps((codes, csq, nbr), qc, qcsq, "l2", H,
                                       g, dtype))
        del codes, csq
    del vec, sq, nbr
    torch.cuda.empty_cache()
    return worst, g


def async_layout_check() -> None:
    """The Python mirror of traversal_async.cu's shared memory against the
    kernel's own count, and its residency at the main path's shapes."""
    from repro_torch.kernels import traversal as tr

    for dt in (torch.float32, torch.uint8, torch.int8):
        for shape in ((128, 32, 72, 40, 256), (128, 32, 72, 40, 0),
                      (128, 32, 72, 40, 2048)):
            check(tr.async_smem_bytes(dt, *shape)
                  == tr.async_smem_bytes_cuda(dt, *shape),
                  f"async_smem_bytes != the kernel's count at {dt}, {shape}")
        blocks = {n: tr.async_blocks_per_sm(dt, 128, 32, 72, 40, n)
                  for n in (8192, 1_000_000)}
        check(min(blocks.values()) >= 8, f"traversal_async.cu {dt}: "
                                         f"{blocks} CTAs an SM, expected 8")
        log(f"[kernel] traversal_async {dt}: "
            f"{tr.async_smem_bytes(dt, 128, 32, 72, 40, 256)} bytes of "
            f"shared memory a CTA at the main path's shapes (W = 256 in "
            f"shared memory), {blocks[8192]} CTAs an SM; "
            f"{tr.async_smem_bytes(dt, 128, 32, 72, 40, 0)} bytes and "
            f"{blocks[1_000_000]} CTAs an SM with the bitmap in global "
            f"memory")


def pq_adc_ragged_check(g) -> None:
    """Both pq_adc kernels bitwise equal to the plain version off the main
    shapes, and the route each shape takes by the launch counters: ragged
    Bq (not a multiple of 128 / M) and Bx (not a multiple of 32 or 4), a
    short tile, M = 16 / 32 / 64 with pad rows to pq_adc_smem.cu; M = 8
    and unaligned codes to qdist.cu."""
    from repro_torch.kernels import qdist as qd

    for bq, bx, m, offset in ((9, 2083, 16, 0), (3, 31, 16, 0),
                              (17, 4100, 32, 0), (5, 70001, 64, 0),
                              (9, 2083, 8, 0), (9, 2083, 16, 1)):
        luts = torch.floor(torch.rand((bq, m, 256), generator=g,
                                      device=DEVICE) * 8)
        buf = torch.randint(0, 256, (bx * m + 16,), generator=g,
                            device=DEVICE, dtype=torch.int32).to(torch.uint8)
        codes = buf[offset:offset + bx * m].view(bx, m)
        xpad = torch.zeros(bx, device=DEVICE)
        xpad[bx - bx // 5:] = float("inf")
        want = qd.pq_adc_ref(luts, codes, xpad)
        smem = qd.pq_adc_route(luts, codes, xpad)
        check(smem == (m in qd.SMEM_M and offset == 0),
              f"pq_adc_route({bq} x {bx} x M={m}, offset {offset}) = {smem}")
        before = qd.ADC_SMEM_LAUNCHES, qd.ADC_LAUNCHES
        got = qd.pq_adc_cuda(luts, codes, xpad)
        check(torch.equal(got, want), f"pq_adc != plain at {bq} x {bx} x "
                                      f"M={m}, offset {offset}")
        check((qd.ADC_SMEM_LAUNCHES - before[0], qd.ADC_LAUNCHES - before[1])
              == ((1, 0) if smem else (0, 1)),
              f"pq_adc at {bq} x {bx} x M={m} took the wrong kernel")
        fns = ((qd.pq_adc_smem_cuda, qd.pq_adc_v1_cuda) if smem
               else (qd.pq_adc_v1_cuda,))
        for fn in fns:
            check(torch.equal(fn(luts, codes, xpad), want),
                  f"{fn.__name__} != plain at {bq} x {bx} x M={m}")
        log(f"[kernel] pq_adc {bq} x {bx} x M={m}"
            f"{', codes at a 1-byte offset' if offset else ''}: "
            f"{'pq_adc_smem.cu and qdist.cu' if smem else 'qdist.cu'} "
            f"bitwise equal to the plain version; the wrapper took "
            f"{'pq_adc_smem.cu' if smem else 'qdist.cu'}")


def pq_kernel_check(n_rows: int, g) -> dict:
    """Both pq_adc kernels and both pq_topk kernels against their plain
    versions at n_rows x M=16, 256 queries, bitwise: float tables and
    integer tables in [0, 8) (ties), with and without 16 +inf padding
    rows, k = 1, 10, 64; then pq_adc off the main shapes."""
    from repro_torch.kernels import qdist as qd

    B = 256
    luts = torch.rand((B, PQ_M, 256), generator=g, device=DEVICE) * 50
    ints, codes, xpad = pq_wide_inputs(n_rows, g)
    check(qd.pq_topk_route(ints, codes, xpad, 10),
          "the 1M-row PQ shape does not take pq_topk_smem.cu")
    check(qd.pq_adc_route(ints, codes, xpad),
          "the 1M-row PQ shape does not take pq_adc_smem.cu")
    worst = {"pq_adc": 0.0, "pq_adc_v1": 0.0, "pq_topk": 0.0,
             "pq_topk_v1": 0.0}
    for xp in (None, xpad):
        for name, tab in (("float", luts), ("integer [0, 8)", ints)):
            want = qd.pq_adc_ref(tab, codes, xp)
            fin = torch.isfinite(want)
            for key, fn in (("pq_adc", qd.pq_adc_smem_cuda),
                            ("pq_adc_v1", qd.pq_adc_v1_cuda)):
                got = fn(tab, codes, xp)
                check(torch.equal(got, want),
                      f"{key} != plain ({name} tables, xpad="
                      f"{xp is not None})")
                worst[key] = max(worst[key],
                                 float((got[fin] - want[fin]).abs().max()))
                del got
            if xp is not None:
                check(bool(torch.isinf(want[:, n_rows - 16:]).all()),
                      "pq_adc: a pad row is finite")
            log(f"[kernel] pq_adc {B} x {n_rows} x M={PQ_M}, {name} tables "
                f"(xpad={xp is not None}): pq_adc_smem.cu and qdist.cu "
                f"bitwise equal to the plain version")
            del want, fin
        torch.cuda.empty_cache()
        for name, tab in (("float", luts), ("integer [0, 8)", ints)):
            wv64, wi64 = qd.pq_topk_ref(tab, codes, xp, k=64)
            for k in (1, 10, 64):
                wv, wi = wv64[:, :k], wi64[:, :k]
                for key, fn in (("pq_topk", qd.pq_topk_smem_cuda),
                                ("pq_topk_v1", qd.pq_topk_v1_cuda)):
                    gv, gi = fn(tab, codes, xp, k=k)
                    check(torch.equal(gv, wv) and torch.equal(gi, wi),
                          f"{key} != plain ({name} tables, k={k}, "
                          f"xpad={xp is not None})")
                    if xp is not None:
                        check(int(gi.max()) < n_rows - 16,
                              f"{key} returned a pad row")
                    worst[key] = max(worst[key], float((gv - wv).abs().max()))
            log(f"[kernel] pq_topk {B} x {n_rows} x M={PQ_M}, {name} tables "
                f"(xpad={xp is not None}): pq_topk_smem.cu and qdist.cu "
                f"bitwise equal to the plain version (ids and dists) at k = "
                f"1, 10, 64")
            del wv64, wi64
    torch.cuda.empty_cache()
    pq_adc_ragged_check(g)
    return worst


def pq_wide_inputs(n_rows: int, g):
    """256 queries' integer tables in [0, 8) (ties), n_rows seeded uint8
    code rows of M=16, an xpad with 16 +inf padding rows."""
    ints = torch.floor(torch.rand((256, PQ_M, 256), generator=g,
                                  device=DEVICE) * 8)
    codes = torch.randint(0, 256, (n_rows, PQ_M), generator=g, device=DEVICE,
                          dtype=torch.int32).to(torch.uint8)
    xpad = torch.zeros(n_rows, device=DEVICE)
    xpad[n_rows - 16:] = float("inf")
    return ints, codes, xpad


def pq_wide_timing(n_rows: int, seed: int) -> dict:
    """Both pq_topk kernels at 256 x n_rows x M=16, k=10, and both pq_adc
    kernels, on pq_wide_inputs (the kernel phase's tie-heavy check),
    device time in turns. Runs after the traversal timings, which take the
    run's first profiler traces."""
    from repro_torch.kernels import qdist as qd

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    ints, codes, xpad = pq_wide_inputs(n_rows, g)
    t = in_turns({"smem": lambda: qd.pq_topk_smem_cuda(ints, codes, xpad, k=10),
                  "v1": lambda: qd.pq_topk_v1_cuda(ints, codes, xpad, k=10)},
                 reps=5)
    lookups = 256 * n_rows * PQ_M
    t["bound_ms"], _, what = pq_bound(256 * PQ_M * 1024 + codes.numel()
                                      + n_rows * 4 + 256 * 10 * 8, lookups,
                                      lookups)
    log(f"[timing] pq_topk 256 x {n_rows} x M={PQ_M}, k=10, integer tables, "
        f"16 pad rows, device time (torch.profiler, in turns): "
        f"pq_topk_smem.cu {t['smem']:.4f} ms, qdist.cu {t['v1']:.4f} ms "
        f"({t['v1'] / t['smem']:.2f}x); bound {t['bound_ms']:.4f} ms ({what})")
    a = in_turns({"adc_smem": lambda: qd.pq_adc_smem_cuda(ints, codes, xpad),
                  "adc_v1": lambda: qd.pq_adc_v1_cuda(ints, codes, xpad)},
                 reps=5)
    t.update(a)
    t["adc_bound_ms"], _, what = pq_bound(256 * PQ_M * 1024 + codes.numel()
                                          + n_rows * 4 + 256 * n_rows * 4,
                                          lookups, lookups)
    log(f"[timing] pq_adc 256 x {n_rows} x M={PQ_M}, integer tables, 16 pad "
        f"rows, device time (torch.profiler, in turns): pq_adc_smem.cu "
        f"{t['adc_smem']:.4f} ms, qdist.cu {t['adc_v1']:.4f} ms "
        f"({t['adc_v1'] / t['adc_smem']:.2f}x); bound "
        f"{t['adc_bound_ms']:.4f} ms ({what})")
    del ints, codes, xpad
    torch.cuda.empty_cache()
    return t


def kernel_phase(n_rows: int, seed: int) -> dict:
    """Both traversal kernels at both bitmap placements of traversal_async.cu
    (`n_rows` rows: global memory; N_SHARED rows: shared memory), then
    pq_adc / pq_topk."""
    async_layout_check()
    worst, g = traversal_checks(n_rows, seed)
    for key, e in traversal_checks(N_SHARED, seed + 1)[0].items():
        worst[key] = max(worst[key], e)
    worst.update(pq_kernel_check(n_rows, g))
    return worst


# ---------------------------------------------------------------------------
# phase 4: the float32 main path
# ---------------------------------------------------------------------------


def recall_at(ids: np.ndarray, gt: np.ndarray) -> float:
    hit = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    return hit / gt.size


def answer(svc, q, h=None, rerank=False, stats=False):
    """One search with stats, on the host: ids, dists, hops, dist_calcs
    (and the QueryStats if `stats`); `h` overrides fused_hops."""
    import dataclasses

    from repro_torch.api import SearchRequest

    be = svc.backend                   # None for a cluster router
    old = be and be.spec
    if h is not None:
        be.spec = dataclasses.replace(old, fused_hops=h)
    try:
        r = svc.search(SearchRequest(q, k=10, ef=40, rerank=rerank,
                                     with_stats=True))
        got = [None if t is None else t.cpu()
               for t in (r.ids, r.dists, r.stats.hops, r.stats.dist_calcs)]
        return (got, r.stats) if stats else got
    finally:
        if be is not None:
            be.spec = old


def serve_paths(svc, queries, gt, what: str, gate: dict):
    """serve_loop rerank off and on, each after one untimed batch, with
    recall@10 against `gt`; `gate` maps rerank -> the least recall, if
    any. Returns ids and serve_loop's stats, each per rerank."""
    from repro_torch.launch.serve import serve_loop

    from repro_torch.api import SearchRequest

    n_batches = len(queries) // BATCH
    ids_by, stats_by = {}, {}
    for rerank in (False, True):
        # one untimed batch first: the timed loop starts on a warm service
        svc.search(SearchRequest(queries[:BATCH], k=10, ef=40,
                                 rerank=rerank)).ids.cpu()
        ids, st = serve_loop(svc, queries, BATCH, 10, 40, rerank=rerank,
                             log=lambda m: log(f"[{what}] rerank={rerank} {m}"))
        rec = recall_at(ids, gt)
        log(f"[{what}] rerank={rerank}: recall@10 {rec:.4f}, QPS "
            f"{st['qps']:.1f}, p50 {st['p50_ms']:.3f} ms, p99 "
            f"{st['p99_ms']:.3f} ms per {BATCH}-query batch "
            f"({n_batches} batches)")
        if rerank in gate:
            check(rec >= gate[rerank], f"{what}: recall@10 {rec:.4f} < "
                                       f"{gate[rerank]} (rerank={rerank})")
        ids_by[rerank], stats_by[rerank] = ids, st
    return ids_by, stats_by


def check_fused_hops(svc, queries, what: str) -> None:
    hops = []
    for i in range(0, len(queries), BATCH):
        a4, a1 = answer(svc, queries[i:i + BATCH], 4), answer(
            svc, queries[i:i + BATCH], 1)
        for name, x, y in zip(("ids", "dists", "hops", "dist_calcs"), a4, a1):
            check(torch.equal(x, y), f"{what}: fused_hops=1 != 4: {name}, "
                                     f"batch {i // BATCH}")
        hops.append(int(a4[2].sum()))
    log(f"[{what}] fused_hops=1 == fused_hops=4 bitwise on {len(queries)} "
        f"queries; layer-0 hops per batch (summed over partitions) mean "
        f"{np.mean(hops):.0f}")


def check_cpu_copy(svc, cpu, q0, what: str, reranks=(False, True)) -> None:
    """The card's and a CPU copy's answers to one batch, bitwise: ids and
    dists, and hops and dist_calcs where the backend counts them; rerank
    as `reranks` lists it (the exact backend has none)."""
    graph = svc.backend.uses_graph
    reranks = reranks if graph else (False,)
    for rerank in reranks:
        rc, rg = answer(cpu, q0, rerank=rerank), answer(svc, q0, rerank=rerank)
        for name, x, y in zip(("ids", "dists", "hops", "dist_calcs"), rc, rg):
            if x is None and y is None:
                continue
            check(x is not None and y is not None and torch.equal(x, y),
                  f"{what}: CPU != card: {name} (rerank={rerank})")
    log(f"[{what}] CPU copy (save -> load device='cpu') bitwise equal to the "
        f"card on one {len(q0)}-query batch, rerank "
        f"{' and '.join('on' if r else 'off' for r in reranks)}")


# pq_adc's launches summed over the paths' serving runs, by kernel row name
ADC_ON_PATHS = {"pq_adc": 0, "pq_adc_v1": 0}


def reset_adc_counts() -> None:
    from repro_torch.kernels import qdist as qd

    qd.ADC_SMEM_LAUNCHES = qd.ADC_LAUNCHES = 0


def take_adc_counts(what: str) -> None:
    """pq_adc's launches in a path's run (counters set to 0 just before
    it), added to ADC_ON_PATHS: no path of either package calls pq_adc (the
    exact PQ backend takes the fused pq_topk), so both must be 0."""
    from repro_torch.kernels import qdist as qd

    got = {"pq_adc": qd.ADC_SMEM_LAUNCHES, "pq_adc_v1": qd.ADC_LAUNCHES}
    for name, n in got.items():
        ADC_ON_PATHS[name] += n
    log(f"[{what}] pq_adc launches: pq_adc_smem.cu {got['pq_adc']}, "
        f"qdist.cu {got['pq_adc_v1']}")
    check(got == {"pq_adc": 0, "pq_adc_v1": 0},
          f"the {what} path launched pq_adc {got}")


def check_traversal_launches(what: str, n_batches: int) -> int:
    """The traversal launches of a path's serving run (counters set to 0
    just before it): traversal_async.cu launched, traversal.cu never."""
    from repro_torch.kernels import traversal as tr

    launches, ldg = tr.ASYNC_LAUNCHES, tr.LAUNCHES
    # serve_paths serves n_batches + 1 (a warm-up) for each rerank setting
    log(f"[{what}] traversal launches: traversal_async.cu {launches} "
        f"({launches / (2 * (n_batches + 1)):.2f} per batch), traversal.cu "
        f"{ldg}")
    check(launches > 0, f"the {what} path launched no traversal_async.cu")
    check(ldg == 0, f"the {what} path launched traversal.cu {ldg} times")
    return launches


def main_phase(svc, data, queries) -> dict:
    from repro_torch.api import IndexSpec, SearchRequest, SearchService
    from repro_torch.kernels import traversal as tr

    exact = SearchService.build(data, IndexSpec(backend="exact"),
                                device=DEVICE)
    gt = np.concatenate([
        exact.search(SearchRequest(queries[i:i + BATCH], k=10)).ids.cpu()
        .numpy() for i in range(0, len(queries), BATCH)])
    n_batches = len(queries) // BATCH
    tr.ASYNC_LAUNCHES = tr.LAUNCHES = 0
    reset_adc_counts()
    ids_by, st = serve_paths(svc, queries, gt, "main",
                             {False: 0.95, True: 0.95})
    launches = check_traversal_launches("main", n_batches)
    check_fused_hops(svc, queries, "main")
    with tempfile.TemporaryDirectory() as tmp:
        svc.save(tmp)
        cpu = SearchService.load(tmp, device="cpu")
    check_cpu_copy(svc, cpu, queries[:BATCH], "main")
    take_adc_counts("main")
    return {"launches": launches, "gt": gt, "ids": ids_by,
            "qps": st[False]["qps"]}


# ---------------------------------------------------------------------------
# phase 5: traversal timing at a main path's shapes
# ---------------------------------------------------------------------------


def timing_phase(svc, queries, what: str, reps: int = 5) -> dict:
    """Replay the layer-0 supersteps of one batch of `svc`'s main path:
    record each superstep's input state, then run both traversal kernels
    and the plain version from those states, bitwise, and time them: the
    kernels' device time by torch.profiler, in turns, and every call with
    CUDA events around it (median of `reps`). `queries` are in the index's
    space (codes for uint8/int8)."""
    from repro_torch.core import search as cs
    from repro_torch.kernels import traversal as tr

    db = svc.backend.pdb.db
    P, _, d_pad = db.vectors.shape
    p = svc.backend.params(10, 40).resolve(db.l0_nbrs.shape[-1])
    q = cs.prepare_queries(queries, d_pad, db.vectors.device)
    B = q.shape[0]
    lane = torch.arange(P * B, device=q.device)
    part = lane // B
    qsq = (q * q).sum(-1)
    dist = cs._lane_distance_fn(db, part, q[lane % B], qsq[lane % B],
                                p.metric)
    # host clock around each stage of one batch (each ends synchronized)
    split = {}
    for _ in range(3):                     # the last of 3 repeats is kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ep, ep_d, _ = cs._greedy_upper(db, part, dist, p)
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

    def call_ms(fn):
        """Median ms of a call per superstep (CUDA events around it, so the
        wrapper's host time counts), and each superstep's output."""
        per_step, outs = [], []
        for st in states:
            runs = []
            for _ in range(reps):
                work = [t.clone() for t in st]
                torch.cuda.synchronize()
                runs.append(events_ms(lambda: fn(*args, *work, **kw)))
            per_step.append(sorted(runs)[len(runs) // 2])
            outs.append(work)
        return sum(per_step) / len(per_step), outs

    def kernel_ms(fn):
        """Device ms a superstep of fn's kernel: torch.profiler's durations
        of the kernels named *traversal* over `reps` replays of every
        recorded superstep (their state copies made before, not timed)."""
        def replay():
            works = [[t.clone() for t in st] for _ in range(reps)
                     for st in states]
            torch.cuda.synchronize()
            return lambda: [fn(*args, *w, **kw) for w in works]

        return profiled_ms(replay, reps * len(states), "traversal", what)

    route = tr.traversal_route(db.vectors.dtype, d_pad, db.l0_nbrs.shape[-1],
                               p.cand_size, p.ef, db.vectors.shape[1])
    check(route == ("async", "shared"), f"{what}: the route gives {route}")
    kernels = {"async": tr.fused_traversal_async_cuda,
               "ldg": tr.fused_traversal_ldg_cuda}
    calls, outs = {}, {}
    for name, fn in (*kernels.items(), ("plain", tr.fused_traversal_ref)):
        calls[name], outs[name] = call_ms(fn)
    r_out = outs["plain"]
    for name in kernels:
        for i, (a, b) in enumerate(zip(outs[name], r_out)):
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{what}: {name} kernel != plain at the path's shapes, "
                  f"superstep {i}")
    # device time, the two kernels in turns within this call
    dev = {name: [] for name in kernels}
    for name in ("async", "ldg", "ldg", "async"):
        dev[name].append(kernel_ms(kernels[name]))
    dev = {name: sum(v) / len(v) for name, v in dev.items()}
    # bytes each superstep must move, from this batch's own data
    D, M0 = d_pad, db.l0_nbrs.shape[-1]
    row_bytes = D * db.vectors.element_size()
    C, EF = p.cand_size, p.ef
    L = P * B
    bytes_ = flops = 0
    for st, nxt in zip(states, r_out):
        dh = int((nxt[5] - st[5]).sum())
        dc = int((nxt[6] - st[6]).sum())
        bytes_ += (dh * 2 * 4 * M0          # neighbor rows + visited words
                   + dc * (row_bytes + 4)   # active rows + their sqnorms
                   + L * (C + EF) * 8 * 2   # beam state in and out
                   + B * (4 * D + 4))       # queries
        flops += dc * 2 * D
    steps = len(states)
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3 / steps
    out = {"steps": steps, "ms": dev["async"], "call_ms": calls["async"],
           "ldg_ms": dev["ldg"], "ldg_call_ms": calls["ldg"],
           "plain_ms": calls["plain"], "bound_ms": bound_ms,
           "bytes_per_step": bytes_ / steps, "lanes": L, "H": H, **split}
    log(f"[timing] {what} shapes: L={L} lanes (P={P} x B={B}), "
        f"N_pad={db.vectors.shape[1]}, D_pad={D} ({db.vectors.dtype}), "
        f"M0_pad={M0}, C={C}, EF={EF}, H={H}: {steps} supersteps, both "
        f"kernels bitwise equal to the plain version; per superstep, device "
        f"time (profiler, in turns): traversal_async {dev['async']:.4f} ms, "
        f"traversal.cu {dev['ldg']:.4f} ms ({dev['ldg'] / dev['async']:.2f}x)"
        f"; a call (CUDA events, host time included): traversal_async "
        f"{calls['async']:.4f} ms, traversal.cu {calls['ldg']:.4f} ms, plain "
        f"{calls['plain']:.4f} ms; bound {bound_ms:.5f} ms "
        f"({out['bytes_per_step'] / 1e6:.3f} MB)")
    log(f"[timing] {what}: one {B}-query batch, host clock: upper-layer "
        f"descent {split['upper_ms']:.3f} ms, layer-0 loop "
        f"{split['layer0_ms']:.3f} ms ({steps} supersteps, traversal_async "
        f"device time {steps * dev['async']:.3f} ms of it)")
    return out


# ---------------------------------------------------------------------------
# phase 6: the quantized paths
# ---------------------------------------------------------------------------


def scalar_phase(path: str, dtype: str, queries, main_out) -> dict:
    """A uint8 / int8 partitioned index loaded onto the card from its
    worker's save: serving, the uint8 == float32 check, fused_hops, the CPU
    copy, and its traversal timing."""
    from repro_torch.api import SearchService
    from repro_torch.kernels import traversal as tr

    svc = SearchService.load(path, device=DEVICE)
    quant = svc.quantizer
    log(f"[{dtype}] loaded: scale {quant.scale!r}, zero-point "
        f"{quant.zero_point}, rows {tuple(svc.backend.pdb.db.vectors.shape)} "
        f"{svc.backend.pdb.db.vectors.dtype}")
    # byte data with max 255 quantizes to itself only for uint8
    exact_bytes = dtype == "uint8" and quant.scale == 1.0 \
        and quant.zero_point == 0
    gate = {False: 0.95, True: 0.95} if dtype == "uint8" else {True: 0.90}
    tr.ASYNC_LAUNCHES = tr.LAUNCHES = 0
    reset_adc_counts()
    ids_by, _ = serve_paths(svc, queries, main_out["gt"], dtype, gate)
    launches = check_traversal_launches(dtype, len(queries) // BATCH)
    if dtype == "uint8":
        if exact_bytes:
            for rerank in (False, True):
                check(np.array_equal(ids_by[rerank], main_out["ids"][rerank]),
                      f"uint8 ids != float32 ids (rerank={rerank})")
            log("[uint8] ids equal to the float32 service's on all "
                f"{len(queries)} queries, rerank off and on")
        else:
            log("[uint8] the data's max is not 255: uint8 is gated on "
                "recall only")
    check_fused_hops(svc, queries, dtype)
    # int8's decoded rows are not integers (scale 255/127): the rerank's
    # float sums may differ between the card and the CPU in the last ulp
    cpu = SearchService.load(path, device="cpu")
    check_cpu_copy(svc, cpu, queries[:BATCH], dtype,
                   (False, True) if exact_bytes else (False,))
    take_adc_counts(dtype)
    timing = timing_phase(svc, quant.encode_f32(queries[:BATCH]), dtype)
    return {"launches": launches, "timing": timing}


def pq_split(svc, q) -> dict:
    """Host clock around the stages of one PQ partitioned batch (each ends
    synchronized): LUT build, upper-layer descent, hop-stepped layer 0."""
    from repro_torch.core import search as cs
    from repro_torch.optim import build_pq_lut

    db = svc.backend.pdb.db
    P = db.vectors.shape[0]
    p = svc.backend.params(10, 40).resolve(db.l0_nbrs.shape[-1])
    qt = torch.as_tensor(q, device=DEVICE)
    B = qt.shape[0]
    lane = torch.arange(P * B, device=DEVICE)
    part = lane // B
    out = {}
    for _ in range(3):                     # the last of 3 repeats is kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lut = build_pq_lut(qt, svc.backend.codebooks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dist = cs._lane_distance_fn(db, part, lut=lut[lane % B])
        ep, ep_d, _ = cs._greedy_upper(db, part, dist, p)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, _, hops, _ = cs._search_layer0_pq(db, part, dist, ep, ep_d, p)
        torch.cuda.synchronize()
        out = {"lut_ms": (t1 - t0) * 1e3, "upper_ms": (t2 - t1) * 1e3,
               "layer0_ms": (time.perf_counter() - t2) * 1e3,
               "layer0_iterations": int(hops.max())}
    log(f"[pq] one {B}-query partitioned batch, host clock: LUT build "
        f"{out['lut_ms']:.3f} ms, upper-layer descent {out['upper_ms']:.3f} "
        f"ms, hop-stepped layer 0 {out['layer0_ms']:.3f} ms "
        f"({out['layer0_iterations']} hop iterations, plain torch ops)")
    return out


def pq_timing(exact, q, reps: int = 5) -> dict:
    """Both pq_topk kernels and both pq_adc kernels against their plain
    versions at the exact PQ path's shapes (one batch's LUTs over the
    whole code table): device time by torch.profiler (each pair in turns),
    CUDA events around a call (the wrapper's host work included) beside."""
    from repro_torch.kernels import qdist as qd
    from repro_torch.optim import build_pq_lut

    be = exact.backend
    qt = torch.as_tensor(q, device=DEVICE)
    t0 = time.perf_counter()
    luts = build_pq_lut(qt, be.codebooks)
    torch.cuda.synchronize()
    lut_host_ms = (time.perf_counter() - t0) * 1e3
    codes = be.codes
    (bq, m, _), bx, k = luts.shape, codes.shape[0], 10
    check(qd.pq_topk_route(luts, codes, None, k),
          "the exact PQ path's shapes do not take pq_topk_smem.cu")
    check(qd.pq_adc_route(luts, codes, None),
          "the exact PQ path's shapes do not take pq_adc_smem.cu")
    kern = {"pq_topk": lambda: qd.pq_topk_smem_cuda(luts, codes, k=k),
            "pq_topk_v1": lambda: qd.pq_topk_v1_cuda(luts, codes, k=k),
            "pq_adc": lambda: qd.pq_adc_smem_cuda(luts, codes),
            "pq_adc_v1": lambda: qd.pq_adc_v1_cuda(luts, codes)}
    plain = {"pq_topk": lambda: qd.pq_topk_ref(luts, codes, k=k),
             "pq_adc": lambda: qd.pq_adc_ref(luts, codes)}
    plain["pq_topk_v1"] = plain["pq_topk"]
    plain["pq_adc_v1"] = plain["pq_adc"]
    dev_ms = in_turns({n: kern[n] for n in ("pq_topk", "pq_topk_v1")})
    dev_ms.update(in_turns({n: kern[n] for n in ("pq_adc", "pq_adc_v1")}))
    out = {}
    for name in ("pq_topk", "pq_topk_v1", "pq_adc", "pq_adc_v1"):
        adc = name.startswith("pq_adc")
        got, want = kern[name](), plain[name]()
        same = (torch.equal(got, want) if adc else
                all(torch.equal(a, b) for a, b in zip(got, want)))
        check(same, f"{name} != plain at the exact PQ path's shapes")
        out_bytes = bq * bx * 4 if adc else bq * k * 8
        bytes_ = luts.numel() * 4 + codes.numel() + out_bytes
        adds = lookups = bq * bx * m
        bound_ms, bound_by, what = pq_bound(bytes_, adds, lookups)
        out[name] = {"ms": dev_ms[name], "events_ms": median_ms(kern[name], reps),
                     "plain_ms": median_ms(plain[name], reps),
                     "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"[timing] {name} at the exact PQ path's shapes ({bq} queries x "
            f"{bx} rows x M={m}): kernel {out[name]['ms']:.4f} ms device "
            f"(torch.profiler; {out[name]['events_ms']:.4f} ms by CUDA "
            f"events around a call), plain {out[name]['plain_ms']:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({what}: {lookups / 1e6:.1f}M "
            f"shared-memory lookups {lookups / SMEM_LOOKUPS_PER_S * 1e3:.5f} "
            f"ms, {adds / 1e6:.1f}M fp32 adds {adds / FP32_FLOPS * 1e3:.5f} "
            f"ms, {bytes_ / 1e6:.3f} MB {bytes_ / HBM_BYTES_PER_S * 1e3:.5f} "
            f"ms)")
    for name, new in (("pq_topk", "pq_topk_smem.cu"),
                      ("pq_adc", "pq_adc_smem.cu")):
        log(f"[timing] {name} at the exact PQ path's shapes: {new} "
            f"{out[name]['ms']:.4f} ms against qdist.cu's "
            f"{out[name + '_v1']['ms']:.4f} ms device time, in turns "
            f"({out[name + '_v1']['ms'] / out[name]['ms']:.2f}x)")
    log(f"[timing] exact PQ batch: LUT build {lut_host_ms:.3f} ms (host "
        f"clock), pq_topk {out['pq_topk']['ms']:.4f} ms (device)")
    out["wide"] = pq_wide_timing(1_000_000, seed=2)
    return out


def adc_topk_np(codes, codebooks, q, k: int = 10):
    """The exact ADC top-k on the host in numpy, independent of the port:
    with integer codebooks and queries every table entry and sum is an
    exact integer, so any summation order gives the same distances, and
    the stable argsort gives the lower row first among ties."""
    m, _, dsub = codebooks.shape
    adc = np.zeros((len(q), len(codes)), np.float32)
    for mi in range(m):
        sub = q[:, mi * dsub:(mi + 1) * dsub]
        lut = ((sub[:, None, :] - codebooks[mi][None]) ** 2).sum(-1)
        adc += lut[:, codes[:, mi]]
    return np.argsort(adc, axis=1, kind="stable")[:, :k]


def pq_route_p50(exact, queries, ids, p50_main: float) -> dict:
    """The exact PQ batch's p50 on each pq_topk kernel within this run:
    the main loop's (pq_topk_smem.cu), then with ops.pq_topk sent to
    qdist.cu's kernel twice and to pq_topk_smem.cu again (in turns), the
    same ids every time."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import qdist as qd
    from repro_torch.launch.serve import serve_loop

    p50 = {"smem": [p50_main], "v1": []}
    for route in ("v1", "v1", "smem"):
        ops.pq_topk_cuda = (qd.pq_topk_v1_cuda if route == "v1"
                            else qd.pq_topk_smem_cuda)
        try:
            got, st = serve_loop(exact, queries, BATCH, 10, 40,
                                 log=lambda m: None)
        finally:
            ops.pq_topk_cuda = qd.pq_topk_cuda
        check(np.array_equal(got, ids), f"pq exact ids differ on {route}")
        p50[route].append(st["p50_ms"])
    log(f"[pq-exact] p50 per {BATCH}-query batch by pq_topk kernel, in turns "
        f"(smem, v1, v1, smem): pq_topk_smem.cu {p50['smem'][0]:.3f} / "
        f"{p50['smem'][1]:.3f} ms, qdist.cu {p50['v1'][0]:.3f} / "
        f"{p50['v1'][1]:.3f} ms (host clock, ids equal)")
    return p50


def pq_phase(path: str, data, queries, gt) -> dict:
    from repro_torch.api import IndexSpec, SearchRequest, SearchService
    from repro_torch.kernels import qdist as qd

    spq = SearchService.load(path, device=DEVICE)
    cbs = np.asarray(spq.spec.pq_codebooks, np.float32)
    check(np.array_equal(cbs, np.rint(cbs)), "pq codebooks are not integers")
    log(f"[pq] loaded: pq_m={spq.spec.pq_m}, integer codebooks, code rows "
        f"{tuple(spq.backend.pdb.db.vectors.shape)}")
    t0 = time.perf_counter()
    exact = SearchService.build(
        data, IndexSpec(backend="exact", dtype="pq", pq_m=PQ_M,
                        pq_codebooks=spq.spec.pq_codebooks), device=DEVICE)
    torch.cuda.synchronize()
    log(f"[pq] exact backend build (encode {len(data)} rows): "
        f"{time.perf_counter() - t0:.1f}s")
    from repro_torch.launch.serve import serve_loop

    # one untimed batch first, as serve_paths does
    exact.search(SearchRequest(queries[:BATCH], k=10, ef=40)).ids.cpu()
    qd.TOPK_LAUNCHES = qd.TOPK_SMEM_LAUNCHES = 0
    reset_adc_counts()
    ids, st = serve_loop(exact, queries, BATCH, 10, 40,
                         log=lambda m: log(f"[pq-exact] {m}"))
    launches, v1 = qd.TOPK_SMEM_LAUNCHES, qd.TOPK_LAUNCHES
    log(f"[pq-exact] recall@10 {recall_at(ids, gt):.4f} against the float32 "
        f"exact backend, QPS {st['qps']:.1f}, p50 {st['p50_ms']:.3f} ms, p99 "
        f"{st['p99_ms']:.3f} ms per {BATCH}-query batch; pq_topk launches "
        f"{launches} (pq_topk_smem.cu; qdist.cu's {v1})")
    check(launches > 0 and v1 == 0,
          f"the exact PQ path launched pq_topk_smem.cu {launches} times and "
          f"qdist.cu's pq_topk {v1} times (expected > 0 and 0)")
    p50 = pq_route_p50(exact, queries, ids, st["p50_ms"])
    q0 = queries[:BATCH]
    check(np.array_equal(ids[:BATCH], adc_topk_np(exact.backend.raw, cbs, q0)),
          "pq exact ids != the host numpy ADC top-10")
    rec_err = float(np.mean(((data - spq.quantizer.decode(exact.backend.raw))
                             ** 2).sum(1)))
    log(f"[pq-exact] ids equal to a host numpy ADC top-10 on one batch; "
        f"mean squared reconstruction error {rec_err:.1f} a row")
    by, _ = serve_paths(spq, queries, gt, "pq", {})
    overlap = recall_at(by[False], ids)
    rec = {r: recall_at(by[r], gt) for r in (False, True)}
    log(f"[pq] partitioned rerank off against the exact ADC scan: top-10 "
        f"overlap {overlap:.4f}")
    check(overlap >= PQ_OVERLAP_GATE, f"pq partitioned finds {overlap:.4f} "
                                      f"of the exact ADC top-10 (< "
                                      f"{PQ_OVERLAP_GATE})")
    check(rec[True] >= rec[False], "pq rerank lowered recall@10")
    check_cpu_copy(spq, SearchService.load(path, device="cpu"), q0, "pq")
    with tempfile.TemporaryDirectory() as tmp:
        exact.save(tmp)
        exact_cpu = SearchService.load(tmp, device="cpu")
    check_cpu_copy(exact, exact_cpu, q0, "pq-exact")
    # the pq paths end here: pq_timing launches pq_adc only to compare it
    take_adc_counts("pq")
    split = pq_split(spq, q0)
    timing = pq_timing(exact, q0)
    return {"launches": launches, "timing": timing, "split": split,
            "p50_ms": p50}


# ---------------------------------------------------------------------------
# phase 6b: the out-of-core csd backend
# ---------------------------------------------------------------------------


def csd_split(svc, q) -> dict:
    """Host ms of one rerank-on csd batch by the port's own TRACER spans
    (each summed over its occurrences): the whole search, the per-partition
    traversals, the block store's reads (`store-read`: the page cache's
    block gets), the supersteps on the device (their submission:
    `hop-kernel`) and stage-2 rerank. Beside them, "read_rows": the whole
    StoreReader.read_rows calls of the search's own thread (the block
    gets, and the addressing and row cuts around them), by a timer put
    around the reader's method for this batch only."""
    from repro_torch.api import SearchRequest
    from repro_torch.obs import TRACER

    reader = svc.backend.reader
    read_rows, me, spent = reader.read_rows, threading.get_ident(), []

    def timed(*args, **kwargs):
        if threading.get_ident() != me:     # the prefetcher's thread
            return read_rows(*args, **kwargs)
        t0 = time.perf_counter()
        try:
            return read_rows(*args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)

    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    reader.read_rows = timed
    try:
        svc.search(SearchRequest(q, k=10, ef=40, rerank=True)).ids.cpu()
        spans = TRACER.spans()
    finally:
        del reader.read_rows
        TRACER.configure(enabled=False)
        TRACER.clear()
    out = {n: sum(ev["t1"] - ev["t0"] for ev in spans if ev["name"] == n)
           * 1e3 for n in ("search", "traversal", "store-read",
                           "hop_superstep", "hop-kernel", "rerank")}
    out["read_rows"] = sum(spent) * 1e3
    return out


def csd_phase(tmp: str, parts: dict, queries) -> dict:
    """Each partitioned index of phases 4 and 6 (dtype -> service on the
    card) re-served out of core: CSDBackend.from_partitioned writes its
    block store (CSD_BLOCK-byte blocks; pq with its float32
    `rerank_vectors`) under `tmp`, and the service reopens it with a page
    cache of at most 1 / CSD_CACHE_SHARE of the store and the prefetcher
    on. One untimed batch, then CSD_BATCHES timed ones through serve_loop,
    rerank off and on. Checks: ids, dists, hops and dist_calcs bitwise
    equal to the partitioned service on the card at fused_hops 1 and 4
    (and rerank on at 4), block reads > 0, peak cache bytes within the
    cache, fewer supersteps at fused_hops 4 than at 1, and a CPU copy
    bitwise equal to the card on one batch."""
    import dataclasses
    import os

    from repro_torch.api import SearchRequest, SearchService
    from repro_torch.launch.serve import serve_loop
    from repro_torch.obs import REGISTRY
    from repro_torch.obs.calibrate import store_window
    from repro_torch.store import CSDBackend

    q0 = queries[:BATCH]
    out = {}
    for dt, part in parts.items():
        what = f"csd-{dt}"
        t0 = time.perf_counter()
        path = str(Path(tmp) / what)
        spec = dataclasses.replace(part.spec, backend="csd",
                                   keep_vectors=False, storage_path=path,
                                   block_size=CSD_BLOCK, prefetch=True)
        CSDBackend.from_partitioned(
            part.backend.pdb, spec, device=DEVICE,
            raw=part.backend.raw if dt == "pq" else None).reader.close()
        store = os.path.getsize(Path(path) / "blocks.bin")
        cache = max(CSD_BLOCK,
                    store // CSD_CACHE_SHARE // CSD_BLOCK * CSD_BLOCK)
        spec = dataclasses.replace(spec, cache_bytes=cache)
        svc = SearchService(spec, CSDBackend.from_state(spec, {}, DEVICE))
        log(f"[{what}] block store {store} bytes ({store // CSD_BLOCK} "
            f"blocks of {CSD_BLOCK}), written in "
            f"{time.perf_counter() - t0:.1f}s; page cache {cache} bytes "
            f"(1/{store / cache:.2f} of the store), prefetch on")
        lat, served = {}, {}
        reset_adc_counts()
        # the cost phase's calibration window: this store's series over
        # the timed rerank-off batches (the profiler is on by default)
        uids = (svc.backend.uid, svc.backend.reader.cache.uid)
        for rerank in (False, True):
            svc.search(SearchRequest(q0, k=10, ef=40, rerank=rerank)).ids.cpu()
            before = REGISTRY.snapshot()
            served[rerank], st = serve_loop(svc, queries[:BATCH * CSD_BATCHES], BATCH, 10,
                               40, rerank=rerank,
                               log=lambda m: log(f"[{what}] rerank={rerank} "
                                                 f"{m}"))
            if not rerank:
                window = store_window(before, REGISTRY.snapshot(), uids)
            lat[rerank] = st
            log(f"[{what}] rerank={rerank}: QPS {st['qps']:.1f}, p50 "
                f"{st['p50_ms']:.3f} ms, p99 {st['p99_ms']:.3f} ms per "
                f"{BATCH}-query batch ({st['batches']} batches)")
        stats = {}
        for h, rerank in ((1, False), (4, False), (4, True)):
            got, stats[h, rerank] = answer(svc, q0, h, rerank, stats=True)
            for name, x, y in zip(("ids", "dists", "hops", "dist_calcs"),
                                  got, answer(part, q0, h, rerank)):
                check(torch.equal(x, y), f"{what} != partitioned: {name} "
                                         f"(fused_hops={h}, rerank={rerank})")
        s1, s4 = stats[1, False], stats[4, False]
        pc = svc.backend.reader.cache
        check(s1.block_reads > 0 and s4.block_reads > 0,
              f"{what}: no block reads")
        check(pc.peak_bytes <= pc.capacity_bytes == cache,
              f"{what}: peak cache bytes {pc.peak_bytes} > {cache}")
        check(s4.supersteps < s1.supersteps,
              f"{what}: {s4.supersteps} supersteps at fused_hops=4, "
              f"{s1.supersteps} at 1")
        log(f"[{what}] bitwise equal to the partitioned service on the card "
            f"(ids, dists, hops, dist_calcs) at fused_hops 1 and 4, rerank "
            f"off, and at 4 with rerank; peak cache {pc.peak_bytes} of "
            f"{cache} bytes")
        for h, s in ((1, s1), (4, s4)):
            log(f"[{what}] fused_hops={h}, one {BATCH}-query batch: "
                f"{s.block_reads / BATCH:.1f} block reads and "
                f"{s.bytes_read / BATCH:.0f} bytes a query, cache hit rate "
                f"{s.cache_hit_rate:.4f}, {s.supersteps} supersteps a batch "
                f"(summed over {part.spec.num_partitions} partitions)")
        split = csd_split(svc, q0)
        log(f"[{what}] one rerank-on batch by TRACER span, host ms: search "
            f"{split['search']:.1f}, traversal {split['traversal']:.1f}, "
            f"store-read {split['store-read']:.1f}, hop_superstep "
            f"{split['hop_superstep']:.1f} (hop-kernel submission "
            f"{split['hop-kernel']:.1f}), rerank {split['rerank']:.1f}; "
            f"whole read_rows calls {split['read_rows']:.1f} (store-read "
            f"and the addressing and row cuts around it); the rest of "
            f"search outside read_rows and hop_superstep "
            f"{split['search'] - split['read_rows'] - split['hop_superstep']:.1f}")
        busy = device_ms(lambda: svc.search(SearchRequest(
            q0, k=10, ef=40)).ids.cpu(), reps=1)
        log(f"[{what}] device busy {busy:.3f} ms of a rerank-off batch "
            f"(torch.profiler, kernels and copies): idle share "
            f"{1 - busy / lat[False]['p50_ms']:.3f} of its p50")
        with tempfile.TemporaryDirectory() as idx:
            svc.save(idx)
            cpu = SearchService.load(idx, device="cpu")
        # int8's decoded rows are not integers (scale 255/127): the
        # rerank's float sums may differ between the card and the CPU
        check_cpu_copy(svc, cpu, q0, what,
                       (False,) if dt == "int8" else (False, True))
        take_adc_counts(what)
        cpu.backend.reader.close()
        svc.backend.reader.close()
        out[dt] = {"store_bytes": store, "cache_bytes": cache,
                   "spec": spec, "ids": served, "window": window,
                   "serve": lat, "split": split, "busy_ms": busy,
                   "stats": {h: {f: getattr(s, f) for f in (
                       "block_reads", "bytes_read", "cache_hit_rate",
                       "supersteps")} for h, s in ((1, s1), (4, s4))}}
        log(f"[{what}] phase {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# the cost phase: the port's cost model against the card and 6b's traffic
# ---------------------------------------------------------------------------

COPY_BYTES = 4 << 30             # (a)'s device-to-device copy, 4 GiB


def hbm_copy_share() -> float:
    """(a) The card against the roofline's HW: an H100, its memory within
    10 % of HW.hbm_bytes, 132 SMs (the count inside HW.smem_lookups), and
    a COPY_BYTES device-to-device copy's bandwidth (bytes read plus bytes
    written over the median of 5 CUDA-event timings) as a share of
    HW.hbm_bw, which must lie in [0.5, 1.05]."""
    props = torch.cuda.get_device_properties(0)
    check("H100" in props.name, f"cost: the card is {props.name}")
    check(abs(props.total_memory - _PEAK.hbm_bytes) <= 0.1 * _PEAK.hbm_bytes,
          f"cost: {props.total_memory} bytes of device memory against "
          f"HW.hbm_bytes {_PEAK.hbm_bytes:.0f}")
    check(props.multi_processor_count == 132,
          f"cost: {props.multi_processor_count} SMs, HW.smem_lookups "
          f"counts 132")
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    dst = torch.empty_like(src)
    ms = median_ms(lambda: dst.copy_(src))
    del src, dst
    share = 2 * COPY_BYTES / (ms / 1e3) / _PEAK.hbm_bw
    log(f"[cost] (a) {props.name}: {props.total_memory} bytes "
        f"({props.total_memory / _PEAK.hbm_bytes:.4f} of HW.hbm_bytes), "
        f"{props.multi_processor_count} SMs; a {COPY_BYTES}-byte copy "
        f"{ms:.4f} ms (median of 5): {2 * COPY_BYTES / ms / 1e9:.4f} TB/s "
        f"read + written, {share:.4f} of HW.hbm_bw "
        f"({_PEAK.hbm_bw / 1e12:.2f} TB/s)")
    check(0.5 <= share <= 1.05, f"cost: the copy reads {share:.4f} of "
                                f"HW.hbm_bw, outside [0.5, 1.05]")
    return share


def calibrate_store(dt: str, o: dict) -> dict:
    """(b) One csd store's calibration from its 6b window (its own series
    over the timed rerank-off batches): the fitted parameters and each
    term's modeled, measured and calibrated values. Checks the reference's
    live bar (`tests/test_calibrate.py`): storage, fanout and dispatch
    all fitted, the storage term's calibrated / measured in [0.5, 2], and
    csd_queries_total equal to the queries served."""
    from repro_torch.obs import calibrate, compare_terms

    what, snap = f"csd-{dt}", o["window"]
    cal, n = calibrate(snap), BATCH * CSD_BATCHES
    terms = compare_terms(cal)
    queries = sum(c["value"] for c in snap["counters"]
                  if c["name"] == "csd_queries_total")
    check(queries == n, f"cost: {what} csd_queries_total {queries}, "
                        f"{n} served")
    missing = [t for t, v in terms.items() if v.get("unavailable")]
    check(not missing, f"cost: {what} terms unavailable: {missing}")
    st = terms["storage"]
    ratio = st["calibrated"] / st["measured"]
    check(0.5 <= ratio <= 2.0, f"cost: {what} storage calibrated / "
                               f"measured {ratio:.4f} outside [0.5, 2]")
    kern = [h for h in snap["histograms"]
            if h["labels"].get("stage") == "hop-kernel"]
    kern_ms = sum(h["sum"] for h in kern) / max(1, sum(h["count"]
                                                      for h in kern))
    steps = o["stats"][4]["supersteps"]
    busy = o["busy_ms"] / steps
    log(f"[cost] (b) {what}: {n} queries, cache_hit_rate "
        f"{cal.cache_hit_rate:.4f}, effective_ssd_bw "
        f"{cal.effective_ssd_bw / 1e9:.4f} GB/s, blocks_per_query "
        f"{cal.blocks_per_query:.2f}, supersteps_per_query "
        f"{cal.supersteps_per_query:.4f}, dispatch_overhead_s "
        f"{cal.dispatch_overhead_s:.3e} a superstep; beside it hop-kernel "
        f"(the submission) {kern_ms:.4f} ms and the device busy "
        f"{busy:.4f} ms a superstep ({o['busy_ms']:.3f} ms over {steps} "
        f"supersteps of one batch, 6b)")
    for name, t in terms.items():
        log(f"[cost] (b) {what} {name}: modeled {t['modeled']}, measured "
            f"{t['measured']}, calibrated {t['calibrated']} {t['unit']} "
            f"(rel. error {t['rel_error']}, calibrated "
            f"{t['calibrated_rel_error']})")
    return {"fitted": cal.asdict(), "terms": terms, "storage_ratio": ratio,
            "hop_kernel_ms": kern_ms, "busy_ms_step": busy}


def dryrun_check(metrics: str, main_qps: float) -> dict:
    """(c) `python -m repro_torch.launch.ann_dryrun --calibrated METRICS`
    as a subprocess: its last line parses as JSON with fits_hbm true and
    calibrated_qps_per_device present; phase 4's measured QPS is printed
    as a share of its memory-bound bound."""
    import os

    path = os.pathsep.join(filter(None, (str(ROOT / "src"),
                                         os.environ.get("PYTHONPATH"))))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.ann_dryrun",
         "--calibrated", metrics], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=path), timeout=300)
    check(out.returncode == 0, f"cost: ann_dryrun exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    work = rec["calibration"].get("measured_workload", {})
    check(rec["fits_hbm"] is True, f"cost: ann_dryrun: resident "
                                   f"{rec['resident_bytes']} B past HBM")
    check("calibrated_qps_per_device" in work,
          "cost: ann_dryrun gave no calibrated_qps_per_device")
    bound = rec["modeled_worstcase_qps_per_chip"]
    log(f"[cost] (c) ann_dryrun --calibrated (csd-float32): "
        f"db_bytes_per_device {rec['db_bytes_per_device']}, resident_bytes "
        f"{rec['resident_bytes']}, fits_hbm {rec['fits_hbm']}, gather "
        f"{rec['collectives']['gather']:.0f} B a batch of 4,096; "
        f"calibrated_qps_per_device {work['calibrated_qps_per_device']}; "
        f"modeled_worstcase_qps_per_chip {bound} against phase 4's "
        f"{main_qps:.1f} QPS: {main_qps / bound:.4f} of it")
    return {"record": rec, "main_share": main_qps / bound}


def working_set_check(svc, queries) -> dict:
    """(d) ann_dryrun's working-set formula at phase 4's batch (BATCH
    queries x P_MAIN partitions, its n_pad) beside the rise of
    max_memory_allocated over one batch. Not a gate: the search's own
    intermediates are not in the model."""
    from repro_torch.api import SearchRequest
    from repro_torch.core.search import SearchParams
    from repro_torch.launch.ann_dryrun import batch_working_set

    db = svc.backend.pdb.db
    parts, n_pad = db.vectors.shape[:2]
    p = SearchParams(ef=40, k=10).resolve(db.l0_nbrs.shape[-1])
    model = batch_working_set(parts * BATCH, n_pad, p.cand_size, p.ef)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    svc.search(SearchRequest(queries[:BATCH], k=10, ef=40)).ids.cpu()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    log(f"[cost] (d) working set of one {BATCH}-query batch, P={parts}, "
        f"n_pad {n_pad}: modeled {model} bytes, max_memory_allocated rose "
        f"{rise} bytes: {model / rise:.4f} of it")
    return {"model": model, "rise": rise}


def cost_phase(csd_out: dict, svc, main_qps: float, queries,
               tmp: str) -> dict:
    t0 = time.perf_counter()
    share = hbm_copy_share()
    cal = {dt: calibrate_store(dt, o) for dt, o in csd_out.items()}
    metrics = Path(tmp) / "cost-csd-float32.json"
    metrics.write_text(json.dumps(csd_out["float32"]["window"]))
    dry = dryrun_check(str(metrics), main_qps)
    ws = working_set_check(svc, queries)
    log(f"[cost] phase {time.perf_counter() - t0:.1f}s")
    return {"copy_share": share, "calibration": cal, "dryrun": dry,
            "working_set": ws}


# ---------------------------------------------------------------------------
# phase 6c: the async serving layer (repro_torch.serve)
# ---------------------------------------------------------------------------


def direct_results(svc, queries, rerank: bool):
    """ids and dists of `svc.search` over `queries` in BATCH-query
    batches, on the host (what serve_loop serves)."""
    from repro_torch.api import SearchRequest

    ids, dists = [], []
    for i in range(0, len(queries), BATCH):
        r = svc.search(SearchRequest(queries[i:i + BATCH], k=10, ef=40,
                                     rerank=rerank))
        ids.append(r.ids.cpu().numpy())
        dists.append(r.dists.cpu().numpy())
    return np.concatenate(ids), np.concatenate(dists)


def busy_union_ms(events) -> float:
    """ms in which at least one CUDA kernel or copy ran: the union of the
    profiler's device intervals (replicas' streams may overlap)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for t0, t1 in spans:
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy / 1e3


def serve_async_run(svc, queries, replicas: int, max_batch: int,
                    rerank: bool, profile: bool = False, **kw) -> dict:
    """One SearchServer run: every query submitted as its own request;
    returns the ids and dists on the host, the ServeStats rollup and the
    wall seconds, and, if `profile`, the device's busy ms over the run
    (torch.profiler)."""
    from repro_torch.serve import SearchServer

    prof = None
    ctx = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
        ctx = prof
    torch.cuda.synchronize()
    with ctx:
        t0 = time.perf_counter()
        with SearchServer(svc, replicas=replicas, max_batch=max_batch,
                          max_wait_ms=SERVE_WAIT_MS, **kw) as srv:
            res = [f.result() for f in srv.submit_many(
                queries, k=10, ef=40, rerank=rerank)]
            roll = srv.stats()
        wall = time.perf_counter() - t0
    out = {"ids": np.stack([r.ids for r in res]),
           "dists": np.stack([r.dists for r in res]), "stats": roll,
           "wall_s": wall}
    if prof is not None:
        out["busy_ms"] = busy_union_ms(prof.events())
        out["idle"] = 1 - out["busy_ms"] / (wall * 1e3)
    return out


def log_serve(what: str, run: dict) -> None:
    st = run["stats"]
    busy = ", ".join(f"{r['busy_s']:.3f}" for r in st.replicas)
    log(f"[{what}] {st.completed} queries, QPS {st.qps:.1f}; e2e p50 / p99 "
        f"{st.e2e_ms['p50']:.3f} / {st.e2e_ms['p99']:.3f} ms, queue "
        f"{st.queue_ms['p50']:.3f} / {st.queue_ms['p99']:.3f}, exec "
        f"{st.exec_ms['p50']:.3f} / {st.exec_ms['p99']:.3f}; mean batch "
        f"{st.mean_batch:.1f} ({sum(st.batch_sizes.values())} batches); "
        f"replica busy s [{busy}]"
        + (f"; device busy {run['busy_ms']:.3f} ms of {run['wall_s'] * 1e3:.3f}"
           f" (idle share {run['idle']:.3f}, torch.profiler)"
           if "busy_ms" in run else ""))


def check_same(what: str, run: dict, ids, dists) -> None:
    check(np.array_equal(run["ids"], ids), f"{what}: async ids != direct")
    check(np.array_equal(run["dists"], dists),
          f"{what}: async dists != direct")


def check_trace_file(path: str) -> None:
    """The Perfetto JSON parses, and nests request > exec and batch >
    dispatch > search (each span's parent, by the exported ids)."""
    with open(path) as f:
        doc = json.load(f)
    evs = [ev for ev in doc["traceEvents"] if ev.get("ph") == "X"]
    name_of = {ev["args"]["span_id"]: ev["name"] for ev in evs}
    parents = {}
    for ev in evs:
        parents.setdefault(ev["name"], set()).add(
            name_of.get(ev["args"]["parent_id"]))
    for child, parent in (("exec", "request"), ("dispatch", "batch"),
                          ("search", "dispatch")):
        check(parents.get(child) == {parent},
              f"trace: {child} spans' parents are {parents.get(child)}, "
              f"not {{{parent!r}}}")
    log(f"[serve] trace {path}: {len(evs)} spans, request > exec and batch "
        f"> dispatch > search nested")


def serve_obs_run(svc, queries, tmp: str) -> None:
    """One traced run with the stock SLOs and the flight recorder: the
    trace file as `--trace-out` writes it, a metrics snapshot taken while
    the server lives (`--metrics-out`), the flight dump (`--flight-out`);
    each read back."""
    from repro_torch.obs import (TRACER, SLOTracker, default_slos,
                                 write_snapshot)
    from repro_torch.serve import SearchServer

    paths = {n: str(Path(tmp) / n) for n in (
        "trace.json", "metrics.json", "flight.json")}
    slo = SLOTracker(default_slos(p99_ms=50.0, error_rate=0.01))
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    try:
        with SearchServer(svc, replicas=2, max_batch=64,
                          max_wait_ms=SERVE_WAIT_MS, slo=slo) as srv:
            for f in srv.submit_many(queries, k=10, ef=40):
                f.result()
            status = srv.slo_status()      # sets the slo_* gauges
            write_snapshot(paths["metrics.json"])
            srv.debug_dump(paths["flight.json"])
        TRACER.write(paths["trace.json"])
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()
    check_trace_file(paths["trace.json"])
    with open(paths["metrics.json"]) as f:
        snap = json.load(f)
    names = {s["name"] for kind in ("counters", "gauges", "histograms")
             for s in snap[kind]}
    want = {"serve_replica_batches_total", "serve_replica_queries_total",
            "serve_replica_busy_seconds_total", "serve_replica_inflight",
            "serve_requests_total", "serve_e2e_ms", "slo_samples_total",
            "slo_burn_rate"}
    check(want <= names, f"metrics snapshot lacks {sorted(want - names)}")
    with open(paths["flight.json"]) as f:
        flight = json.load(f)["otherData"]["flight"]
    check(flight["captured_total"] > 0 and flight["slowest"],
          "flight recorder dump captured nothing")
    check(len(status) == 2 and all("burn_long" in s for s in status),
          f"SLO status {status}")
    log(f"[serve] metrics snapshot {len(names)} series names (the "
        f"serve_replica_* ones included), flight dump {len(flight['slowest'])}"
        f" slowest (max {flight['slowest'][0]['e2e_ms']} ms), SLOs: "
        + "; ".join(f"{s['slo']} burn {s['burn_long']:.2f}x "
                    f"{'BREACH' if s['breaching'] else 'ok'}"
                    for s in status))


def serve_phase(svc, queries, main_out, csd_store, tmp: str) -> dict:
    """Phase 4's float32 partitioned service through SearchServer: every
    query its own request, the sweep SERVE_REPLICAS x SERVE_MAX_BATCH,
    rerank off and on, ids and dists bitwise equal to the direct batches
    (whose ids are phase 4's serve_loop ids); traversal_async.cu launched
    and traversal.cu never over the sweep; the device's idle share over
    one run at each replica count (torch.profiler). Then phase 6b's
    float32 csd store behind SERVE_CSD_REPLICAS replicas, each on its own
    page cache, over SERVE_CSD_QUERIES queries: ids equal to 6b's
    serve_loop ids, dists to the partitioned service's (6b holds csd =
    partitioned bitwise), and every replica reads blocks. Last, one traced
    run with the SLOs and the flight recorder (serve_obs_run)."""
    from repro_torch.api import SearchService
    from repro_torch.kernels import traversal as tr
    from repro_torch.serve import SearchServer
    from repro_torch.store import CSDBackend

    t_phase = time.perf_counter()
    direct = {}
    for rerank in (False, True):
        direct[rerank] = direct_results(svc, queries, rerank)
        check(np.array_equal(direct[rerank][0], main_out["ids"][rerank]),
              f"serve: direct ids != phase 4's serve_loop ids "
              f"(rerank={rerank})")
    out = {"runs": {}}
    tr.ASYNC_LAUNCHES = tr.LAUNCHES = 0
    for replicas in SERVE_REPLICAS:
        for max_batch in SERVE_MAX_BATCH:
            for rerank in (False, True):
                what = (f"serve r={replicas} b={max_batch} "
                        f"rerank={'on' if rerank else 'off'}")
                run = serve_async_run(svc, queries, replicas, max_batch,
                                      rerank)
                check_same(what, run, *direct[rerank])
                log_serve(what, run)
                out["runs"][replicas, max_batch, rerank] = run["stats"]
    launches, ldg = tr.ASYNC_LAUNCHES, tr.LAUNCHES
    log(f"[serve] traversal launches over the sweep: traversal_async.cu "
        f"{launches}, traversal.cu {ldg}")
    check(launches > 0, "the serve sweep launched no traversal_async.cu")
    check(ldg == 0, f"the serve sweep launched traversal.cu {ldg} times")
    out["launches"] = launches
    # device idle share, one profiled run a replica count (not in the
    # launch count above: the kernels line counts the sweep); the
    # profiler slows the host, so the busy ms is also set against the wall
    # of the same configuration's unprofiled run
    out["idle"] = {}
    for replicas in SERVE_REPLICAS:
        what = f"serve profiled r={replicas} b={SERVE_MAX_BATCH[-1]}"
        run = serve_async_run(svc, queries, replicas, SERVE_MAX_BATCH[-1],
                              False, profile=True)
        check_same(what, run, *direct[False])
        log_serve(what, run)
        plain = out["runs"][replicas, SERVE_MAX_BATCH[-1], False].wall_s
        log(f"[{what}] device busy {run['busy_ms']:.3f} ms against the "
            f"unprofiled run's {plain * 1e3:.3f} ms: idle share "
            f"{1 - run['busy_ms'] / (plain * 1e3):.3f}")
        out["idle"][replicas] = (run["busy_ms"], run["wall_s"], run["idle"],
                                 plain)
    # csd: one block store, SERVE_CSD_REPLICAS page caches
    spec = csd_store["spec"]
    csd = SearchService(spec, CSDBackend.from_state(spec, {}, DEVICE))
    nq = SERVE_CSD_QUERIES
    what = f"serve csd r={SERVE_CSD_REPLICAS} b={BATCH}"
    t0 = time.perf_counter()
    with SearchServer(csd, replicas=SERVE_CSD_REPLICAS, max_batch=BATCH,
                      max_wait_ms=SERVE_WAIT_MS) as srv:
        res = [f.result() for f in srv.submit_many(queries[:nq], k=10,
                                                   ef=40)]
        roll = srv.stats()
        readers = {id(r.service.backend.reader) for r in srv.pool.replicas}
    run = {"ids": np.stack([r.ids for r in res]),
           "dists": np.stack([r.dists for r in res]), "stats": roll,
           "wall_s": time.perf_counter() - t0}
    check(np.array_equal(run["ids"], csd_store["ids"][False]),
          f"{what}: ids != phase 6b's serve_loop ids")
    check(np.array_equal(run["dists"], direct[False][1][:nq]),
          f"{what}: dists != the partitioned service's")
    check(len(readers) == SERVE_CSD_REPLICAS,
          f"{what}: {len(readers)} StoreReaders for {SERVE_CSD_REPLICAS} "
          f"replicas")
    for r in roll.replicas:
        check(r.get("block_reads", 0) > 0,
              f"{what}: replica {r['replica']} read no block")
        check(r["queries"] > 0, f"{what}: replica {r['replica']} idle")
    log_serve(what, run)
    log(f"[{what}] per replica (own page cache of {spec.cache_bytes} "
        f"bytes): " + "; ".join(
            f"r{r['replica']} {r['queries']} queries, {r['block_reads']} "
            f"block reads, hit rate {r['cache_hit_rate']:.4f}"
            for r in roll.replicas))
    csd.backend.reader.close()
    out["csd"] = roll
    serve_obs_run(svc, queries[:4 * 64], tmp)
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 6d: the mutable index (repro_torch.ingest) on the card
# ---------------------------------------------------------------------------


def ingest_plan(n: int):
    """The ingest phase's pinned script: inserts of INGEST_STEP rows (gids
    0.. in insert order), each one's every INGEST_DEL-th row deleted once
    it is sealed (4 inserts later, or after the last insert). Returns
    (delete lists by the insert after which they run, the survivors)."""
    steps = n // INGEST_STEP
    per_seal = INGEST_SEAL // INGEST_STEP
    dele = {i: [] for i in range(steps)}
    for j in range(steps):
        gids = j * INGEST_STEP + np.arange(0, INGEST_STEP, INGEST_DEL)
        dele[min(j + per_seal, steps - 1)].append(gids)
    dele = {i: np.concatenate(g) for i, g in dele.items() if g}
    dead = np.concatenate(list(dele.values()))
    return dele, np.setdiff1d(np.arange(n), dead)


def rebuild_worker(path: str, n: int, device: str) -> float:
    """Worker process: SearchService.build over the ingest phase's
    survivors (what its compaction must equal) on `device`, saved to
    `path`; returns the build's seconds."""
    from repro_torch.api import SearchService

    data, _ = main_data(N_MAIN, 0)
    _, alive = ingest_plan(n)
    t0 = time.perf_counter()
    svc = SearchService.build(data[alive], partitioned_spec(), device=device)
    seconds = time.perf_counter() - t0
    svc.save(path)
    return seconds


def ingest_phase(data, queries, rebuild_path: str) -> dict:
    """The mutable index on the card, served through SearchServer while it
    grows: N_INGEST rows in inserts of INGEST_STEP, a seal every
    INGEST_SEAL rows, the ingest_plan deletes, 256-query batches rerank
    off and on between inserts, then flush_index and compact_index."""
    from repro_torch.api import (IndexSpec, MutableSearchService,
                                 SearchRequest, SearchService)
    from repro_torch.kernels import traversal as tr
    from repro_torch.serve import SearchServer

    t_phase = time.perf_counter()
    dele, alive = ingest_plan(N_INGEST)
    svc = MutableSearchService(partitioned_spec(), seal_threshold=INGEST_SEAL,
                               device=DEVICE)
    seal_s = []
    seal = svc._seal_locked

    def timed_seal():              # the seals that made a segment
        n, t0 = len(svc._segments), time.perf_counter()
        seal()
        if len(svc._segments) > n:
            seal_s.append(time.perf_counter() - t0)

    svc._seal_locked = timed_seal
    tr.ASYNC_LAUNCHES = tr.LAUNCHES = 0
    dead = np.zeros(0, np.int64)
    served = 0

    def serve(srv, step: int, label: str) -> None:
        nonlocal served
        q = queries[(step % (len(queries) // BATCH)) * BATCH:][:BATCH]
        for rerank in (False, True):
            for f in srv.submit_many(q, k=10, ef=40, rerank=rerank):
                ids = f.result().ids
                check(not np.isin(ids, dead).any(),
                      f"ingest: a deleted gid surfaced ({label}, "
                      f"rerank={rerank})")
                served += 1

    def p50_search() -> float:
        lat = []
        for i in range(0, len(queries), BATCH):
            t0 = time.perf_counter()
            svc.search(SearchRequest(queries[i:i + BATCH], k=10,
                                     ef=40)).ids.cpu()
            lat.append((time.perf_counter() - t0) * 1e3)
        return float(np.percentile(lat, 50))

    insert_s = 0.0
    with SearchServer(svc, replicas=2, max_batch=BATCH,
                      max_wait_ms=SERVE_WAIT_MS) as srv:
        for i in range(N_INGEST // INGEST_STEP):
            t0 = time.perf_counter()
            gids = srv.insert(data[i * INGEST_STEP:(i + 1) * INGEST_STEP])
            insert_s += time.perf_counter() - t0
            check(np.array_equal(gids, i * INGEST_STEP
                                 + np.arange(INGEST_STEP)),
                  f"ingest: insert {i} returned gids {gids[:3]}...")
            if i in dele:
                check(srv.delete(dele[i]) == len(dele[i]),
                      f"ingest: delete after insert {i}")
                dead = np.concatenate([dead, dele[i]])
            serve(srv, i, f"after insert {i}")
        srv.flush_index()
        segments = svc.num_segments
        p50_before = p50_search()
        t0 = time.perf_counter()
        summary = srv.compact_index()
        compact_s = time.perf_counter() - t0
        check(svc.num_segments == 1, f"ingest: {svc.num_segments} segments "
                                     f"after compaction")
        serve(srv, 0, "after compaction")
        p50_after = p50_search()
    launches, ldg = tr.ASYNC_LAUNCHES, tr.LAUNCHES
    check(launches > 0, "the ingest path launched no traversal_async.cu")
    check(ldg == 0, f"the ingest path launched traversal.cu {ldg} times")
    check(svc.size == len(alive), f"ingest: {svc.size} live rows, "
                                  f"{len(alive)} expected")
    rows_s = N_INGEST / insert_s
    log(f"[ingest] {N_INGEST} rows in {N_INGEST // INGEST_STEP} inserts: "
        f"{insert_s:.1f}s, {rows_s:.1f} rows/s (the numpy graph builder's "
        f"insert_point and {len(seal_s)} seals of {INGEST_SEAL} rows, "
        f"{sum(seal_s):.2f}s: " + ", ".join(f"{s:.2f}" for s in seal_s)
        + f"); {len(dead)} deleted; {segments} segments before compaction")
    log(f"[ingest] compaction {compact_s:.1f}s ({summary}); search p50 "
        f"(rerank off, {BATCH}-query batch) {p50_before:.3f} ms over "
        f"{segments} segments, {p50_after:.3f} ms after; resident "
        f"{svc.resident_bytes()} bytes now, peak {svc.peak_resident_bytes}"
        f" (host memtable and builder tables; no csd caches here)")
    log(f"[ingest] {served} served requests after every insert and after "
        f"compaction, rerank off and on: no deleted gid surfaced; "
        f"traversal launches: traversal_async.cu {launches}, traversal.cu "
        f"{ldg}")
    # compaction == a from-scratch build over the survivors (a worker
    # built it on the card beside phase 4's build)
    fresh = SearchService.load(rebuild_path, device=DEVICE)
    exact = SearchService.build(data[alive], IndexSpec(backend="exact"),
                                device=DEVICE)
    got_all = []
    for rerank in (False, True):
        for i in range(0, len(queries), BATCH):
            q = queries[i:i + BATCH]
            got = svc.search(SearchRequest(q, k=10, ef=40, rerank=rerank))
            want = fresh.search(SearchRequest(q, k=10, ef=40, rerank=rerank))
            wi = want.ids.cpu().numpy()
            gi = got.ids.numpy()
            check(np.array_equal(gi, np.where(wi >= 0,
                                              alive[np.maximum(wi, 0)], -1)),
                  f"ingest: compacted ids != rebuild (rerank={rerank}, "
                  f"batch {i // BATCH})")
            check(np.array_equal(got.dists.numpy(),
                                 want.dists.cpu().numpy()),
                  f"ingest: compacted dists != rebuild (rerank={rerank}, "
                  f"batch {i // BATCH})")
            check(not np.isin(gi, dead).any(),
                  "ingest: a deleted gid surfaced after compaction")
            if not rerank:
                got_all.append(gi)
    gt = np.concatenate([
        alive[exact.search(SearchRequest(queries[i:i + BATCH],
                                         k=10)).ids.cpu().numpy()]
        for i in range(0, len(queries), BATCH)])
    rec = recall_at(np.concatenate(got_all), gt)
    log(f"[ingest] after compaction: ids and dists bitwise equal to "
        f"SearchService.build over the {len(alive)} survivors on the card, "
        f"rerank off and on; recall@10 {rec:.4f} against the exact backend "
        f"over the survivors")
    check(rec >= 0.95, f"ingest: recall@10 {rec:.4f} < 0.95")
    with tempfile.TemporaryDirectory() as idx:
        svc.save(idx)
        cpu = MutableSearchService.load(idx, device="cpu")
    q0 = queries[:BATCH]
    for rerank in (False, True):
        a = svc.search(SearchRequest(q0, k=10, ef=40, rerank=rerank))
        b = cpu.search(SearchRequest(q0, k=10, ef=40, rerank=rerank))
        check(torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists),
              f"ingest: CPU copy != card (rerank={rerank})")
    log(f"[ingest] CPU copy (v2 save -> load device='cpu') bitwise equal to "
        f"the card on one {BATCH}-query batch, rerank off and on; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    svc.close()
    return {"launches": launches, "rows_s": rows_s, "seal_s": seal_s,
            "compact_s": compact_s, "p50": (p50_before, p50_after),
            "recall": rec, "resident": (svc.resident_bytes(),
                                        svc.peak_resident_bytes)}


# ---------------------------------------------------------------------------
# phase 6e: the sharded cluster and the distributed backend
# ---------------------------------------------------------------------------


def cluster_spec():
    """The cluster's base spec: phase 4's with P_MAIN / CLUSTER_SHARDS
    partitions a shard, so CLUSTER_SHARDS shards are phase 4's index."""
    return partitioned_spec(num_partitions=P_MAIN // CLUSTER_SHARDS)


def small_single_worker(path: str, device: str) -> float:
    """Worker process: the single index build_cluster's check at
    CLUSTER_SMALL must equal (P = its shard count over its rows)."""
    from repro_torch.api import SearchService

    data, _ = main_data(N_MAIN, 0)
    n, shards = CLUSTER_SMALL
    t0 = time.perf_counter()
    svc = SearchService.build(data[:n], partitioned_spec(
        num_partitions=shards), device=device)
    seconds = time.perf_counter() - t0
    svc.save(path)
    return seconds


def same_answers(got, want) -> bool:
    """`answer`s equal: ids, dists, and hops / dist_calcs where both count
    them; ids by value (a router's are int64 global ids)."""
    return all(x is None or y is None or np.array_equal(x.numpy(), y.numpy())
               for x, y in zip(got, want))


def loop_stats(svc, queries, rerank: bool, what: str) -> dict:
    """serve_loop after one untimed batch; returns its ids and stats."""
    from repro_torch.api import SearchRequest
    from repro_torch.launch.serve import serve_loop

    svc.search(SearchRequest(queries[:BATCH], k=10, ef=40,
                             rerank=rerank)).ids.cpu()
    ids, st = serve_loop(svc, queries, BATCH, 10, 40, rerank=rerank,
                         log=lambda m: log(f"[{what}] rerank={rerank} {m}"))
    st["ids"] = ids
    return st


def counted(fn, what: str, seen: dict):
    """fn() with the traversal launch counters set to 0 just before and
    read just after: traversal_async.cu must have launched and
    traversal.cu not. `seen["ldg"]` adds up traversal.cu's launches since
    the previous reset, so the phase's total stays checked. Returns (fn's
    result, traversal_async.cu's launches)."""
    from repro_torch.kernels import traversal as tr

    seen["ldg"] += tr.LAUNCHES
    tr.ASYNC_LAUNCHES = tr.LAUNCHES = 0
    out = fn()
    launches, ldg = tr.ASYNC_LAUNCHES, tr.LAUNCHES
    log(f"[cluster] {what}: traversal_async.cu {launches} launches, "
        f"traversal.cu {ldg}")
    check(launches > 0, f"{what} launched no traversal_async.cu")
    check(ldg == 0, f"{what} launched traversal.cu {ldg} times")
    return out, launches


def saved_leaves(svc, tmp: str) -> dict:
    """Phase 4's index saved and read back as {leaf path: array}."""
    from repro_torch.api import read_step_leaves
    from repro_torch.checkpoint import latest_step

    path = str(Path(tmp) / "main-index")
    svc.save(path)
    return read_step_leaves(path, latest_step(path))


def shard_leaves(leaves: dict, i: int, lo: int, hi: int) -> dict:
    """Shard i's state cut from phase 4's: its contiguous block of
    partitions from every db leaf, global ids made shard-local, and rows
    [lo, hi) of the raw vectors. By the seed schedule a shard built over
    those rows holds the same graphs (build_cluster's check and the CPU
    tests hold that)."""
    q = P_MAIN // CLUSTER_SHARDS
    out = {"meta/num_partitions": np.int32(q), "meta/dim": leaves["meta/dim"],
           "vectors/raw": np.asarray(leaves["vectors/raw"])[lo:hi]}
    for k, v in leaves.items():
        if k.startswith("db/"):
            out[k] = np.asarray(v)[i * q:(i + 1) * q]
    g = out["db/gids"]
    check(np.array_equal(np.sort(g[g >= 0]), np.arange(lo, hi)),
          f"cluster: phase 4's partitions {i * q}..{(i + 1) * q - 1} do not "
          f"hold rows {lo}..{hi - 1}")
    out["db/gids"] = np.where(g >= 0, g - lo, g).astype(g.dtype)
    return out


def cluster_router(leaves: dict, tmp: str):
    """Phase 6e's router: CLUSTER_SHARDS shards cut from phase 4's saved
    state and loaded on the card, with CLUSTER_REPLICAS replicas through
    serve's `_clone_service` (on one card they share it), behind a
    ClusterRouter publishing cluster.json."""
    from repro_torch.api import SearchService
    from repro_torch.api.backends import PartitionedBackend
    from repro_torch.cluster import (ClusterRouter, ShardClient, ShardWorker,
                                     shard_bounds, shard_spec)
    from repro_torch.serve.dispatch import _clone_service

    bounds = shard_bounds(N_MAIN, CLUSTER_SHARDS)
    clients = []
    for i in range(CLUSTER_SHARDS):
        name = f"shard-{i:03d}"
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        spec = shard_spec(cluster_spec(), i)
        primary = SearchService(spec, PartitionedBackend.from_state(
            spec, shard_leaves(leaves, i, lo, hi), DEVICE))
        gids = np.arange(lo, hi)
        workers = [ShardWorker(name, primary, gids)]
        for r in range(1, CLUSTER_REPLICAS):
            svc, owns = _clone_service(primary, r)
            workers.append(ShardWorker(name, svc, gids, rid=r,
                                       owns_backend=owns))
        clients.append(ShardClient(name, workers))
    return ClusterRouter(cluster_spec(), clients,
                         path=str(Path(tmp) / "cluster"), device=DEVICE)


# CUDA runtime calls by kind, for the host side of a profiled loop
HOST_KINDS = (("sync", ("Synchronize",)), ("copy", ("cudaMemcpy",)),
              ("alloc", ("cudaMalloc", "cudaFree", "cudaHostAlloc")),
              ("event", ("cudaEvent", "cudaStreamWaitEvent")),
              ("launch", ("LaunchKernel",)))


def host_split(trace: dict) -> list:
    """The host side of a profiled run from its chrome trace, thread by
    thread (the trace's id; the profiler names CUDA runtime calls' threads
    by an id of its own, not the OS's): its span (first to last profiled
    call), ms inside profiled calls, of which ms in each HOST_KINDS kind
    of CUDA runtime call, its kernel launches, and the rest of the span
    ("outside": Python, torch's dispatch, waits for the interpreter lock
    and idle waits for work, which the profiler cannot tell apart). The
    profiler records torch ops only on the thread that started it, and
    CUDA runtime calls on every thread. Threads by busiest first."""
    by = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in (
                "cpu_op", "cuda_runtime", "cuda_driver"):
            by.setdefault(int(e["tid"]), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e.get("name", "")))
    out = []
    for tid, evs in by.items():
        evs.sort()
        inside, end = 0.0, None
        for t0, t1, _ in evs:
            if end is None or t0 > end:
                inside += t1 - t0
                end = t1
            elif t1 > end:
                inside += t1 - end
                end = t1
        span = max(t1 for _, t1, _ in evs) - evs[0][0]
        row = {"thread": tid, "span": span / 1e3, "inside": inside / 1e3,
               "outside": (span - inside) / 1e3,
               "launches": sum("LaunchKernel" in n for _, _, n in evs)}
        for kind, keys in HOST_KINDS:
            row[kind] = sum(t1 - t0 for t0, t1, n in evs
                            if any(k in n for k in keys)) / 1e3
        out.append(row)
    return sorted(out, key=lambda r: -r["inside"])


def thread_clocks() -> dict:
    """{OS thread id: ms on a CPU (user + system, /proc's clock ticks)} of
    this process's live threads. A thread waiting for the interpreter
    lock, an event or a future is asleep, and gathers none."""
    import os

    tick = 1e3 / os.sysconf("SC_CLK_TCK")
    out = {}
    for d in Path("/proc/self/task").iterdir():
        try:
            f = (d / "stat").read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[int(d.name)] = (int(f[11]) + int(f[12])) * tick
    return out


def profiled_loop(svc, queries, what: str) -> dict:
    """One rerank-off serve_loop under torch.profiler: device busy ms,
    wall ms, idle share; the host side (logged): the process's CPU ms
    over all its threads (those that ended in the loop too) and its
    context switches, each live thread's CPU ms, and the trace's
    per-thread split of the profiled calls (`host_split`)."""
    import resource

    from torch.profiler import ProfilerActivity

    from repro_torch.launch.serve import serve_loop

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        # read before the profiler stops: its trace processing runs on
        # this thread
        c0, cpu0 = thread_clocks(), time.process_time()
        sw0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        serve_loop(svc, queries, BATCH, 10, 40, log=lambda m: None)
        wall = (time.perf_counter() - t0) * 1e3
        cpu, c1 = (time.process_time() - cpu0) * 1e3, thread_clocks()
        sw1 = resource.getrusage(resource.RUSAGE_SELF)
    switches = (sw1.ru_nvcsw - sw0.ru_nvcsw, sw1.ru_nivcsw - sw0.ru_nivcsw)
    names = {t.native_id: t.name for t in threading.enumerate()}
    busy = busy_union_ms(prof.events())
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(str(Path(d) / "trace.json"))
        trace = json.loads((Path(d) / "trace.json").read_text())
    threads = host_split(trace)
    log(f"[cluster] {what}, profiled serve_loop, rerank off "
        f"(torch.profiler): device busy {busy:.3f} ms of {wall:.3f} (idle "
        f"share {1 - busy / wall:.3f}); process CPU {cpu:.3f} ms over all "
        f"threads ({cpu / wall:.3f} cores); context switches "
        f"{switches[0]} voluntary, {switches[1]} involuntary")
    clocks = sorted(((tid, names.get(tid, "(not Python's)"),
                      run - c0.get(tid, 0)) for tid, run in c1.items()),
                    key=lambda x: -x[2])
    for tid, name, run in clocks[:12]:
        if run > 0:
            log(f"[cluster] {what} thread {tid} {name}: on a CPU "
                f"{run:.3f} ms")
    for r in threads[:12]:
        log(f"[cluster] {what} traced thread {r['thread']}: "
            f"span {r['span']:.3f} ms, inside profiled calls "
            f"{r['inside']:.3f} (sync {r['sync']:.3f}, copy {r['copy']:.3f}, "
            f"alloc {r['alloc']:.3f}, event {r['event']:.3f}, launch "
            f"{r['launch']:.3f} for {r['launches']} launches), outside "
            f"{r['outside']:.3f}")
    return {"busy": busy, "wall": wall, "idle": 1 - busy / wall,
            "cpu": cpu, "switches": switches, "clocks": clocks,
            "threads": threads}


def cluster_failover(router, queries, direct) -> int:
    """Every batch submitted at once from CLUSTER_SHARDS threads, one
    replica of every shard killed once the first batch is in flight:
    every result equal to the direct batches. Then the health monitor
    marks the dead replicas down and, revived, up. Returns the
    failovers."""
    from repro_torch.api import SearchRequest
    from repro_torch.cluster import HealthMonitor

    before = sum(c.failovers for c in router.shards)
    served = sum(r.queries for c in router.shards for r in c.replicas)
    with concurrent.futures.ThreadPoolExecutor(CLUSTER_SHARDS) as ex:
        futs = [ex.submit(router.search, SearchRequest(
            queries[i:i + BATCH], k=10, ef=40))
            for i in range(0, len(queries), BATCH)]
        for c in router.shards:
            c.replicas[0].kill()
        got = [f.result() for f in futs]
    ids = np.concatenate([r.ids.numpy() for r in got])
    dists = np.concatenate([r.dists.numpy() for r in got])
    check(np.array_equal(ids, direct[0]) and np.array_equal(dists, direct[1]),
          "cluster: results changed when one replica of each shard died")
    failovers = sum(c.failovers for c in router.shards) - before
    now = sum(r.queries for c in router.shards for r in c.replicas)
    check(now - served == CLUSTER_SHARDS * len(queries),
          f"cluster: {now - served} shard queries served for "
          f"{CLUSTER_SHARDS} x {len(queries)} (lost or duplicated)")
    check(failovers > 0, "cluster: no failover with a replica of every "
                         "shard dead")
    mon = HealthMonitor(router, interval_s=60.0, timeout_s=600.0)
    down = mon.probe_now()
    check(all(f == [False] + [True] * (CLUSTER_REPLICAS - 1)
              for f in down.values()), f"health after the kill: {down}")
    for c in router.shards:
        c.replicas[0].revive()
    up = mon.probe_now()
    check(all(all(f) for f in up.values()), f"health after revival: {up}")
    log(f"[cluster] {len(got)} batches in flight, replica 0 of every shard "
        f"killed: ids and dists unchanged, {failovers} failovers, "
        f"{now - served} shard queries (none lost or duplicated); the "
        f"health monitor marked the {CLUSTER_SHARDS} dead replicas down "
        f"and, revived, up")
    return failovers


def small_cluster_check(data, queries, path: str) -> None:
    """build_cluster itself on the card at CLUSTER_SMALL (rows, shards), 2
    replicas: bitwise the worker-built single index over the same rows
    (P = shards), rerank off and on, on one batch."""
    from repro_torch.api import SearchService
    from repro_torch.cluster import build_cluster

    n, shards = CLUSTER_SMALL
    t0 = time.perf_counter()
    router = build_cluster(data[:n], partitioned_spec(num_partitions=1),
                           shards, replicas=2, device=DEVICE)
    seconds = time.perf_counter() - t0
    single = SearchService.load(path, device=DEVICE)
    try:
        q0 = queries[:BATCH]
        for rerank in (False, True):
            check(same_answers(answer(router, q0, rerank=rerank),
                               answer(single, q0, rerank=rerank)),
                  f"cluster: build_cluster at {n} rows != a single index "
                  f"(rerank={rerank})")
    finally:
        router.close()
    log(f"[cluster] build_cluster({n} rows, {shards} shards x 2 replicas) on "
        f"the card in {seconds:.1f}s: ids, dists, hops and dist_calcs "
        f"bitwise equal to SearchService.build(P={shards}) over the same "
        f"rows on one {BATCH}-query batch, rerank off and on")


def distributed_check(svc, queries, leaves: dict, seen: dict) -> dict:
    """Phase 4's saved state as a distributed index (`from_state`, no new
    build) on the default mesh (every card over `model`) and on a (2, 2)
    ("data", "model") mesh of cuda:0 slots: every batch's ids, dists and
    dist_calcs bitwise equal to phase 4's service, rerank off and on; the
    halves of a doubled batch identical. Phase 4's answers are taken
    first; each mesh's serve_loops run in a counted window of their own.
    Returns each mesh's loop stats and launches, and the (2, 2) mesh's
    profiled loop."""
    import dataclasses

    from repro_torch.api import SearchService
    from repro_torch.api.backends import DistributedBackend
    from repro_torch.launch.mesh import make_mesh

    spec = dataclasses.replace(svc.spec, backend="distributed")
    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    want = {r: [answer(svc, q, rerank=r) for q in batches]
            for r in (False, True)}
    out = {}
    for what, mesh in (("default", None), ("2x2", make_mesh(
            (2, 2), ("data", "model"), devices=f"{DEVICE}:0"))):
        dist = SearchService(spec, DistributedBackend.from_state(
            spec, leaves, DEVICE, mesh=mesh))
        label = f"distributed {what} mesh {dist.backend.mesh.shape}"
        runs, launches = counted(
            lambda: {r: loop_stats(dist, queries, r, f"cluster {label}")
                     for r in (False, True)},
            f"{label} serve_loops", seen)
        for rerank in (False, True):
            for i, q in enumerate(batches):
                check(same_answers(answer(dist, q, rerank=rerank),
                                   want[rerank][i]),
                      f"{label}: != phase 4's service (rerank={rerank}, "
                      f"batch {i})")
            a = answer(dist, np.concatenate([batches[0]] * 2),
                       rerank=rerank)
            check(all(x is None or torch.equal(x[:BATCH], x[BATCH:])
                      for x in a),
                  f"{label}: the doubled batch's halves differ "
                  f"(rerank={rerank})")
        out[what] = {"runs": runs, "launches": launches}
        if what == "2x2":
            out[what]["profile"] = profiled_loop(dist, queries, label)
        log(f"[cluster] {label}: ids, dists and dist_calcs bitwise equal to "
            f"phase 4's service on all {len(queries)} queries, rerank off "
            f"and on; a doubled batch's halves identical")
    return out


def cluster_phase(svc, data, queries, small_path, tmp: str) -> dict:
    """(a) CLUSTER_SHARDS shards cut from phase 4's saved state x
    CLUSTER_REPLICAS replicas behind a ClusterRouter: serve_loop ids and
    dists bitwise equal to phase 4's service, rerank off and on; failover
    under load; the device idle share and the host split; build_cluster
    itself at CLUSTER_SMALL. (b) the distributed backend on two meshes.
    Phase 4's own answers and loops run first; the router's and each
    mesh's serve_loops run in counted windows of their own."""
    from repro_torch.kernels import traversal as tr

    t_phase = time.perf_counter()
    direct = {r: direct_results(svc, queries, r) for r in (False, True)}
    base = {r: loop_stats(svc, queries, r, "cluster phase 4 direct")
            for r in (False, True)}
    prof_d = profiled_loop(svc, queries, "phase 4's direct service")
    leaves = saved_leaves(svc, tmp)
    seen = {"ldg": 0}
    tr.LAUNCHES = 0
    router = cluster_router(leaves, tmp)
    try:
        runs, launches = counted(
            lambda: {r: loop_stats(router, queries, r, "cluster router")
                     for r in (False, True)},
            "the router's serve_loops", seen)
        for rerank in (False, True):
            st = runs[rerank]
            got = direct_results(router, queries, rerank)
            check(np.array_equal(st["ids"], direct[rerank][0])
                  and np.array_equal(got[0], direct[rerank][0])
                  and np.array_equal(got[1], direct[rerank][1]),
                  f"cluster: ids / dists != phase 4's service "
                  f"(rerank={rerank})")
            b = base[rerank]
            log(f"[cluster] {CLUSTER_SHARDS} shards x {CLUSTER_REPLICAS} "
                f"replicas, rerank={rerank}: ids and dists bitwise equal to "
                f"phase 4's service on {len(queries)} queries; QPS "
                f"{st['qps']:.1f}, p50 {st['p50_ms']:.3f} ms, p99 "
                f"{st['p99_ms']:.3f} ms against phase 4's direct "
                f"serve_loop {b['qps']:.1f} QPS, p50 {b['p50_ms']:.3f} ms")
        prof = profiled_loop(router, queries, "router")
        failovers = cluster_failover(router, queries, direct[False])
        topo = router.topology()
        check(topo.n_shards == CLUSTER_SHARDS and topo.version >= 1,
              f"cluster: topology {topo}")
    finally:
        router.close()
    small_cluster_check(data, queries, small_path)
    dist = distributed_check(svc, queries, leaves, seen)
    ldg = seen["ldg"] + tr.LAUNCHES
    per_path = {"router": launches,
                **{f"mesh {k}": v["launches"] for k, v in dist.items()}}
    log(f"[cluster] traversal_async.cu launches in the counted windows: "
        f"{per_path}; traversal.cu over the whole phase {ldg}; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    check(ldg == 0, f"the cluster phase launched traversal.cu {ldg} times")
    return {"launches": sum(per_path.values()), "per_path": per_path,
            "runs": runs, "base": base, "profile": prof,
            "profile_direct": prof_d, "failovers": failovers, "dist": dist}


# ---------------------------------------------------------------------------
# phase 7: the exact-scan kernels
# ---------------------------------------------------------------------------


def scan_tables(dev):
    """The scan phase's rows and queries: float32, and the uint8 / int8
    codes of the port's VectorQuantizer (code rows, code queries,
    out_scale), each with its rows' sums of squares."""
    from repro_torch.kernels.l2dist import sqnorms
    from repro_torch.optim import VectorQuantizer

    data, queries = main_data(N_SCAN, N_QUERIES)
    tabs = {"float32": (torch.from_numpy(data).to(dev),
                        torch.from_numpy(queries).to(dev), None)}
    for dt in ("uint8", "int8"):
        quant = VectorQuantizer.fit(data, dt)
        if dt == "uint8":
            check(quant.scale == 1.0 and quant.zero_point == 0,
                  "the scan rows are not bytes with max 255")
        tabs[dt] = (torch.from_numpy(quant.encode(data)).to(dev),
                    torch.from_numpy(quant.encode(queries)).to(dev),
                    quant.dist_scale)
    return {dt: (x, q, scale, sqnorms(x)) for dt, (x, q, scale) in tabs.items()}


def scan_counts() -> dict:
    """The exact-scan launch counters, by kernel row name."""
    from repro_torch.kernels import l2dist as ld, l2topk as lt
    from repro_torch.kernels import qdist as qd

    return {"l2dist": ld.TC_LAUNCHES, "l2dist_fma": ld.LAUNCHES,
            "l2topk": lt.TC_LAUNCHES, "l2topk_fma": lt.LAUNCHES,
            "l2dist_q": qd.L2DIST_Q_TC_LAUNCHES,
            "l2dist_q_fma": qd.L2DIST_Q_LAUNCHES,
            "l2topk_q": qd.L2TOPK_Q_TC_LAUNCHES,
            "l2topk_q_fma": qd.L2TOPK_Q_LAUNCHES}


def reset_scan_counts() -> None:
    from repro_torch.kernels import l2dist as ld, l2topk as lt
    from repro_torch.kernels import qdist as qd

    ld.TC_LAUNCHES = ld.LAUNCHES = lt.TC_LAUNCHES = lt.LAUNCHES = 0
    qd.L2DIST_Q_TC_LAUNCHES = qd.L2DIST_Q_LAUNCHES = 0
    qd.L2TOPK_Q_TC_LAUNCHES = qd.L2TOPK_Q_LAUNCHES = 0


def scan_path(tabs) -> dict:
    """The 8 batches through ops.l2topk, ops.l2topk_q (uint8, int8 code
    queries), ops.l2dist and ops.l2dist_q, counters reset before and read
    after."""
    from repro_torch.kernels import ops

    x, q, _, xsq = tabs["float32"]
    u8, qu8, _, u8sq = tabs["uint8"]
    i8, qi8, s8, i8sq = tabs["int8"]
    out = {"float32": [], "uint8": [], "int8": [], "batch_ms": []}
    reset_scan_counts()
    for b in range(0, N_QUERIES, BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        top = ops.l2topk(q[b:b + BATCH], x, xsq, k=SCAN_K)
        torch.cuda.synchronize()
        out["batch_ms"].append((time.perf_counter() - t0) * 1e3)
        out["float32"].append(top)
        out["uint8"].append(ops.l2topk_q(qu8[b:b + BATCH], u8, u8sq, k=SCAN_K))
        out["int8"].append(ops.l2topk_q(qi8[b:b + BATCH], i8, i8sq, k=SCAN_K,
                                        out_scale=s8))
        dv, di = top
        for what, full in (("l2dist", ops.l2dist(q[b:b + BATCH], x)),
                           ("l2dist_q", ops.l2dist_q(qu8[b:b + BATCH], u8))):
            check(torch.equal(full.gather(1, di.long()), dv)
                  and torch.equal(full.min(1).values, dv[:, 0]),
                  f"ops.{what} disagrees with ops.l2topk, batch {b // BATCH}")
            del full
    out["launches"] = scan_counts()
    return out


def same(got, want) -> bool:
    if isinstance(got, tuple):
        return all(torch.equal(a, b) for a, b in zip(got, want))
    return torch.equal(got, want)


def max_err(got, want) -> float:
    """Largest |kernel - plain| over finite entries of a matrix or of a
    top-k's distances."""
    a, b = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
    fin = torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def scan_kernel_checks(tabs, g) -> dict:
    """Both routes of every exact-scan kernel against its plain version at
    256 x 1M: bitwise on the integer rows and codes, with and without 16
    pad rows (l2topk and l2topk_q at k = 1, 10 and 64); within SCAN_TOL on
    unit-norm rows (cosine) and Gaussian rows (l2dist on l2 and ip,
    l2topk); and the ragged shapes each route takes or leaves by shape.
    Returns each kernel row's largest |kernel - plain|."""
    from repro_torch.kernels import l2dist as ld, l2topk as lt
    from repro_torch.kernels import qdist as qd

    x, q, _, xsq = tabs["float32"]
    q = q[:BATCH]
    pad = xsq.clone()
    pad[N_SCAN - 16:] = float("inf")
    err = dict.fromkeys(scan_counts(), 0.0)

    def held(name, tag, got, want):
        check(same(got, want), f"{name} != plain ({tag})")
        if isinstance(got, tuple) and "pads=True" in tag:
            check(int(got[1].max()) < N_SCAN - 16, f"{name} returned a pad row")
        err[name] = max(err[name], max_err(got, want))
        log(f"[scan] {name} {tag}: bitwise equal to its plain version")

    for xs in (None, pad):
        tag = f"{BATCH} x {N_SCAN} x 128, l2 (xsq pads={xs is not None})"
        want = ld.l2dist_ref(q, x, xs)
        held("l2dist", tag, ld.l2dist_tc_cuda(q, x, xs), want)
        held("l2dist_fma", tag, ld.l2dist_fma_cuda(q, x, xs), want)
        del want
        for k in (1, SCAN_K, 64):
            tag = (f"{BATCH} x {N_SCAN} x 128, float32 (xsq pads="
                   f"{xs is not None}), k={k}")
            want = lt.l2topk_ref(q, x, xs, k=k)
            held("l2topk", tag, lt.l2topk_tc_cuda(q, x, xs, k=k), want)
            held("l2topk_fma", tag, lt.l2topk_fma_cuda(q, x, xs, k=k), want)
            del want
    for metric in ("ip", "cosine"):
        want = ld.l2dist_ref(q, x, metric=metric)
        held("l2dist", f"{BATCH} x {N_SCAN} x 128, {metric}",
             ld.l2dist_tc_cuda(q, x, metric=metric), want)
        held("l2dist_fma", f"{BATCH} x {N_SCAN} x 128, {metric}",
             ld.l2dist_fma_cuda(q, x, metric=metric), want)
        del want
    for dt in ("uint8", "int8"):
        c, qc, scale, csq = tabs[dt]
        qc = qc[:BATCH]
        cpad = torch.where(torch.isinf(pad), pad, csq)
        for xs in (None, cpad):
            tag = f"{BATCH} x {N_SCAN} x 128, {dt} (xsq pads={xs is not None})"
            want = qd.l2dist_q_ref(qc, c, xs, out_scale=scale)
            held("l2dist_q", tag, qd.l2dist_q_tc_cuda(qc, c, xs,
                                                      out_scale=scale), want)
            held("l2dist_q_fma", tag, qd.l2dist_q_fma_cuda(
                qc, c, xs, out_scale=scale), want)
            del want
            for k in (1, SCAN_K, 64):
                want = qd.l2topk_q_ref(qc, c, xs, k=k, out_scale=scale)
                held("l2topk_q", f"{tag}, k={k}",
                     qd.l2topk_q_tc_cuda(qc, c, xs, k=k, out_scale=scale), want)
                # the FMA route takes the same queries as code-valued floats
                held("l2topk_q_fma", f"{tag}, k={k}",
                     qd.l2topk_q_fma_cuda(qc.float(), c, xs, k=k,
                                          out_scale=scale), want)
                del want
    scan_ragged_checks(tabs, err)
    # float data: unit-norm rows for cosine, Gaussian rows for l2 and ip
    gx = torch.randn((N_SCAN, 128), generator=g, device=DEVICE)
    gq = torch.randn((BATCH, 128), generator=g, device=DEVICE)
    for what, xs, qs, metric in (
            ("unit-norm", gx / gx.norm(dim=1, keepdim=True),
             gq / gq.norm(dim=1, keepdim=True), "cosine"),
            ("Gaussian", gx, gq, "ip"), ("Gaussian", gx, gq, "l2")):
        tol = SCAN_TOL * (ld.sqnorms(qs)[:, None] + ld.sqnorms(xs)[None, :])
        want = ld.l2dist_ref(qs, xs, metric=metric)
        for name, fn in (("l2dist", ld.l2dist_tc_cuda),
                         ("l2dist_fma", ld.l2dist_fma_cuda)):
            got = fn(qs, xs, metric=metric)
            d = (got - want).abs()
            check(bool((d <= tol).all()),
                  f"{name} ({metric}, {what} rows) beyond the tolerance")
            err[name] = max(err[name], float(d.max()))
            log(f"[scan] {name} {metric} on {what} rows: within {SCAN_TOL} x "
                f"(|q|^2 + |x|^2) of its plain version (largest share of it "
                f"{float((d / tol).max()) * SCAN_TOL:.3e})")
            del got, d
        del want
        if metric != "l2":
            continue
        wv, wi = lt.l2topk_ref(qs, xs, k=SCAN_K + 1)
        row_tol = tol.max(1).values[:, None]
        # ids may differ only where the k-th and (k+1)-th are within tol
        clear = (wv[:, SCAN_K] - wv[:, SCAN_K - 1]) > 2 * row_tol[:, 0]
        for name, fn in (("l2topk", lt.l2topk_tc_cuda),
                         ("l2topk_fma", lt.l2topk_fma_cuda)):
            gv, gi = fn(qs, xs, k=SCAN_K)
            check(bool(((gv - wv[:, :SCAN_K]).abs() <= row_tol).all()),
                  f"{name} on {what} rows beyond the tolerance")
            same_ids = (torch.sort(gi, 1).values
                        == torch.sort(wi[:, :SCAN_K], 1).values).all(1)
            check(bool(same_ids[clear].all()),
                  f"{name} on {what} rows: other ids away from a near-tie")
            err[name] = max(err[name],
                            float((gv - wv[:, :SCAN_K]).abs().max()))
            log(f"[scan] {name} on {what} rows: dists within the tolerance, "
                f"ids equal on {int(same_ids.sum())}/{BATCH} queries "
                f"({int(clear.sum())} clear of a near-tie)")
        del tol
    del gx, gq
    torch.cuda.empty_cache()
    return err


def scan_ragged_checks(tabs, err) -> None:
    """The dispatching wrappers at shapes off the main path's: Bq = 3 and
    Bx = 70,000 (not a multiple of 64) at D = 128 and 48, which the
    tensor-core kernels take (l2topk also Bx = 70,001: it stores no
    [Bq, Bx] matrix), and D = 200 and, for l2dist and l2dist_q, Bx =
    70,001, which they leave to the FMA kernels; bitwise against the plain
    versions, and each launch on the counter its route names."""
    from repro_torch.kernels import l2dist as ld, l2topk as lt
    from repro_torch.kernels import qdist as qd

    def cut(t, n, d):
        """t's first n rows at width d (columns repeated past 128)."""
        return (t[:n, :d] if d <= 128 else
                torch.cat([t[:n], t[:n, :d - 128]], 1)).contiguous()

    def held(name, what, calls):
        """calls() runs one route: a list of (kernel, plain) results."""
        before = scan_counts()
        pairs = calls()
        for got, want in pairs:
            check(same(got, want), f"{what} != plain")
            err[name] = max(err[name], max_err(got, want))
        n = len(pairs)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in scan_counts().items() if
                 v != before[k]}
        check(moved == {name: n}, f"{what} launched {moved}, expected "
                                  f"{{{name!r}: {n}}}")
        log(f"[scan] {what}: bitwise equal to its plain version, on {name}")

    x, q, _, _ = tabs["float32"]
    for name, bx, d in (("l2dist", 70_000, 128), ("l2dist", 70_000, 48),
                        ("l2dist_fma", 70_000, 200),
                        ("l2dist_fma", 70_001, 128)):
        xs, qs = cut(x, bx, d), cut(q, 3, d)
        held(name, f"l2dist_cuda 3 x {bx} x {d}, l2 and ip",
             lambda: [(ld.l2dist_cuda(qs, xs, metric=m),
                       ld.l2dist_ref(qs, xs, metric=m)) for m in ("l2", "ip")])
    for name, bx, d in (("l2topk", 70_000, 128), ("l2topk", 70_000, 48),
                        ("l2topk", 70_001, 128), ("l2topk_fma", 70_000, 200)):
        xs, qs = cut(x, bx, d), cut(q, 3, d)
        held(name, f"l2topk_cuda 3 x {bx} x {d}, k = 1, {SCAN_K}, 64",
             lambda: [(lt.l2topk_cuda(qs, xs, k=k), lt.l2topk_ref(qs, xs, k=k))
                      for k in (1, SCAN_K, 64)])
    for dt in ("uint8", "int8"):
        c, qc, scale, _ = tabs[dt]
        for name, bx, d in (("l2topk_q", 70_000, 128),
                            ("l2topk_q", 70_000, 48),
                            ("l2topk_q_fma", 70_000, 200)):
            cs, qs = cut(c, bx, d), cut(qc, 3, d)
            held(name, f"l2topk_q_cuda 3 x {bx} x {d}, {dt} codes, k = 1, "
                       f"{SCAN_K}, 64",
                 lambda: [(qd.l2topk_q_cuda(qs, cs, k=k, out_scale=scale),
                           qd.l2topk_q_ref(qs, cs, k=k, out_scale=scale))
                          for k in (1, SCAN_K, 64)])
        for name, bx, d in (("l2dist_q", 70_000, 128),
                            ("l2dist_q", 70_000, 48),
                            ("l2dist_q_fma", 70_001, 128),
                            ("l2dist_q_fma", 70_000, 200)):
            cs, qs = cut(c, bx, d), cut(qc, 3, d)
            held(name, f"l2dist_q_cuda 3 x {bx} x {d}, {dt} codes",
                 lambda: [(qd.l2dist_q_cuda(qs, cs, out_scale=scale),
                           qd.l2dist_q_ref(qs, cs, out_scale=scale))])


def scan_timing(tabs, reps: int = 5) -> dict:
    """Each kernel, its plain version and its library yardstick (one
    torch.addmm, then torch.topk for the fused scans; codes cast to float32
    before timing) at 256 x 1M x 128, ms as the median of `reps` by CUDA
    events around a call, and each kernel's device ms by torch.profiler
    (`device_ms`: the wrapper's host time left out); the tensor-core and
    FMA routes of each kernel on the same inputs, in the same call, and
    compared by device ms. Bounds at the units each kernel uses: FP32
    FMAs, TF32 (3 products) or int8 tensor cores."""
    from repro_torch.kernels import l2dist as ld, l2topk as lt
    from repro_torch.kernels import qdist as qd

    out = {}
    for dt in ("float32", "uint8", "int8"):
        x, q, _, xsq = tabs[dt]
        q = q[:BATCH]
        qf, xf = q.float(), x.float()
        qsq = ld.sqnorms(qf)
        bq, (bx, d) = q.shape[0], x.shape
        ops_ = 2.0 * bq * bx * d
        in_bytes = q.numel() * q.element_size() + x.numel() * x.element_size() \
            + bx * 4
        dist_lib = (lambda xf=xf, qf=qf, qsq=qsq, xsq=xsq: torch.addmm(
            qsq[:, None] + xsq[None, :], qf, xf.T, alpha=-2))
        topk_lib = (lambda lib=dist_lib: torch.topk(lib(), SCAN_K, dim=1,
                                                    largest=False))
        dist_out, topk_out = bq * bx * 4, bq * SCAN_K * 8
        if dt == "float32":
            rows = (("l2dist", lambda: ld.l2dist_tc_cuda(q, x, xsq),
                     lambda: ld.l2dist_ref(q, x, xsq), dist_lib, dist_out,
                     3 * ops_, TF32_FLOPS),
                    ("l2dist_fma", lambda: ld.l2dist_fma_cuda(q, x, xsq),
                     lambda: ld.l2dist_ref(q, x, xsq), dist_lib, dist_out,
                     ops_, FP32_FLOPS),
                    ("l2topk", lambda: lt.l2topk_tc_cuda(q, x, xsq, k=SCAN_K),
                     lambda: lt.l2topk_ref(q, x, xsq, k=SCAN_K), topk_lib,
                     topk_out, 3 * ops_, TF32_FLOPS),
                    ("l2topk_fma", lambda: lt.l2topk_fma_cuda(q, x, xsq,
                                                              k=SCAN_K),
                     lambda: lt.l2topk_ref(q, x, xsq, k=SCAN_K), topk_lib,
                     topk_out, ops_, FP32_FLOPS))
        elif dt == "uint8":
            rows = (("l2dist_q", lambda: qd.l2dist_q_tc_cuda(q, x, xsq),
                     lambda: qd.l2dist_q_ref(q, x, xsq), dist_lib, dist_out,
                     ops_, INT8_OPS),
                    ("l2dist_q_fma", lambda: qd.l2dist_q_fma_cuda(q, x, xsq),
                     lambda: qd.l2dist_q_ref(q, x, xsq), dist_lib, dist_out,
                     ops_, INT8_OPS),
                    ("l2topk_q", lambda: qd.l2topk_q_tc_cuda(q, x, xsq,
                                                             k=SCAN_K),
                     lambda: qd.l2topk_q_ref(q, x, xsq, k=SCAN_K), topk_lib,
                     topk_out, ops_, INT8_OPS),
                    ("l2topk_q_fma", lambda: qd.l2topk_q_fma_cuda(
                        qf, x, xsq, k=SCAN_K),
                     lambda: qd.l2topk_q_ref(q, x, xsq, k=SCAN_K), topk_lib,
                     topk_out, ops_, INT8_OPS))
        else:
            rows = (("l2dist_q_int8", lambda: qd.l2dist_q_tc_cuda(q, x, xsq),
                     lambda: qd.l2dist_q_ref(q, x, xsq), dist_lib, dist_out,
                     ops_, INT8_OPS),
                    ("l2topk_q_int8", lambda: qd.l2topk_q_tc_cuda(
                q, x, xsq, k=SCAN_K),
                     lambda: qd.l2topk_q_ref(q, x, xsq, k=SCAN_K), topk_lib,
                     topk_out, ops_, INT8_OPS),
                    ("l2topk_q_fma_int8", lambda: qd.l2topk_q_fma_cuda(
                        qf, x, xsq, k=SCAN_K),
                     lambda: qd.l2topk_q_ref(q, x, xsq, k=SCAN_K), topk_lib,
                     topk_out, ops_, INT8_OPS))
        for name, kf, pf, lf, ob, n_ops, peak in rows:
            b_ms, b_by = bound(in_bytes + ob, n_ops, peak)
            t = {"ms": median_ms(kf, reps), "device_ms": device_ms(kf),
                 "plain_ms": median_ms(pf, reps),
                 "library_ms": median_ms(lf, reps), "bound_ms": b_ms,
                 "bound_by": b_by}
            out[name] = t
            unit = "GFLOP" if dt == "float32" else "GOP"
            log(f"[scan] timing {name} ({dt} rows, {bq} x {bx} x {d}"
                f"{f', k={SCAN_K}' if 'topk' in name else ''}): kernel "
                f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}), plain "
                f"{t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
                f"{(in_bytes + ob) / 1e6:.1f} MB, {n_ops / 1e9:.1f} {unit} at "
                f"{peak / 1e12:.0f} T/s)")
            torch.cuda.empty_cache()
        del xf, qf
    for fast, slow in (("l2topk", "l2topk_fma"), ("l2dist", "l2dist_fma"),
                       ("l2dist_q", "l2dist_q_fma"),
                       ("l2topk_q", "l2topk_q_fma"),
                       ("l2topk_q_int8", "l2topk_q_fma_int8")):
        log(f"[scan] {fast} (tensor cores) device {out[fast]['device_ms']:.4f}"
            f" ms against the FMA route's {out[slow]['device_ms']:.4f} ms: "
            f"{out[slow]['device_ms'] / out[fast]['device_ms']:.2f}x (events "
            f"{out[fast]['ms']:.4f} / {out[slow]['ms']:.4f} ms); library "
            f"{out[fast]['library_ms']:.4f} ms")
    return out


def scan_phase(seed: int) -> dict:
    from repro_torch.core.bruteforce import bruteforce_topk
    from repro_torch.kernels import qdist as qd

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    tabs = scan_tables(dev)
    torch.cuda.synchronize()
    log(f"[scan] tables: {N_SCAN} x 128 float32 ({N_SCAN * 128 * 4 / 2**20:.0f}"
        f" MiB), uint8 and int8 codes (int8 out_scale "
        f"{tabs['int8'][2]!r}), {N_QUERIES} queries, "
        f"{time.perf_counter() - t0:.1f}s")
    path = scan_path(tabs)
    launches = path["launches"]
    log(f"[scan] ops over {N_QUERIES // BATCH} batches of {BATCH}: launches "
        f"{launches}; ops.l2topk host clock per batch, median "
        f"{np.median(path['batch_ms']):.3f} ms, max "
        f"{max(path['batch_ms']):.3f} ms")
    n_batches = N_QUERIES // BATCH
    check(launches == {"l2dist": n_batches, "l2dist_fma": 0,
                       "l2topk": n_batches, "l2topk_fma": 0,
                       "l2dist_q": n_batches, "l2dist_q_fma": 0,
                       "l2topk_q": 2 * n_batches, "l2topk_q_fma": 0},
          f"the scan path's launches {launches}: expected every launch on "
          f"the tensor-core kernels, none on their FMA routes")
    x, q, _, xsq = tabs["float32"]
    i8, qi8, s8, i8sq = tabs["int8"]
    for i, b in enumerate(range(0, N_QUERIES, BATCH)):
        fv, fi = path["float32"][i]
        ids, dists = bruteforce_topk(x, xsq, q[b:b + BATCH], k=SCAN_K,
                                     chunk=40_000)
        check(torch.equal(fi, ids) and torch.equal(fv, dists),
              f"ops.l2topk != bruteforce_topk, batch {i}")
        check(same(path["uint8"][i], path["float32"][i]),
              f"uint8 ops.l2topk_q != float32 ops.l2topk, batch {i}")
        check(same(path["int8"][i], qd.l2topk_q_ref(
            qi8[b:b + BATCH], i8, i8sq, k=SCAN_K, out_scale=s8)),
              f"int8 ops.l2topk_q != its plain version, batch {i}")
    log(f"[scan] on all {N_QUERIES} queries: ops.l2topk ids and dists bitwise "
        f"equal to bruteforce_topk; uint8 ops.l2topk_q equal to ops.l2topk; "
        f"int8 ops.l2topk_q bitwise equal to its plain version")
    del path
    torch.cuda.empty_cache()
    err = scan_kernel_checks(tabs, g)
    timing = scan_timing(tabs)
    return {name: {"launches": launches[name], "err": err[name],
                   "timing": timing[name]} for name in launches}


# ---------------------------------------------------------------------------
# phase 8: the LM substrate, DeepSeek-V2-Lite at full width and depth
# ---------------------------------------------------------------------------


def lm_config(**moe):
    """deepseek-v2-lite-16b as the port's registry gives it, the router
    through the topk kernel (the reference's own `router_use_kernel`)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_use_kernel=True, **moe))


@contextlib.contextmanager
def swapped_ops(topk_fn=None, flash_fn=None):
    """ops.topk / ops.flash_attention replaced while the block runs (the
    model modules call them through `ops`)."""
    from repro_torch.kernels import ops

    saved = ops.topk, ops.flash_attention
    ops.topk = topk_fn or saved[0]
    ops.flash_attention = flash_fn or saved[1]
    try:
        yield
    finally:
        ops.topk, ops.flash_attention = saved


def profile_split(fn) -> dict:
    """Device ms of one call of fn by torch.profiler: the flash and router
    kernels by name, the expert einsums and the decode attention by their
    `record_function` ranges, the rest by difference; and the wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ranges = ("moe.experts", "mla.decode_attention")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in ranges]
    ms = lambda es: sum(e.time_range.elapsed_us() for e in es) / 1e3  # noqa: E731
    out = {"wall_ms": wall, "device_ms": ms(kern),
           "attention_ms": ms(e for e in kern   # either flash kernel
                              if "flash_attention" in e.name),
           "router_ms": ms(e for e in kern   # either topk kernel
                           if "select_k" in e.name)}
    for name in ranges:
        out[name] = sum(e.device_time_total for e in events
                        if e.name == name and e.device_type == DeviceType.CPU
                        ) / 1e3
    out["rest_ms"] = (out["device_ms"] - out["attention_ms"]
                      - out["router_ms"] - out["moe.experts"]
                      - out["mla.decode_attention"])
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    out["top"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out["kernels"] = len(kern)
    return out


def device_ms(fn, reps: int = 20, traces: int = 3, tries: int = 6) -> float:
    """Device ms of one fn() call by torch.profiler: the durations of every
    kernel it launches, summed over `reps` calls after a warm-up and
    divided by reps. Unlike CUDA events around a call, host time between
    launches does not count, so a call whose host side outlasts its
    kernels is timed by its kernels.

    Late in a long process the profiler drops some or all device records
    of one trace in two or three, and keeps the next one whole. So
    `traces` traces are taken, and the one with the most records is kept
    if it has some and a multiple of `reps` (fn launches the same kernels
    each call); else more are taken, up to `tries` in all. If none is
    whole, fn is timed by CUDA events around the `reps` calls (host time
    included), and the log says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best: list = []
    for n in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        best = max(best, us, key=len)
        if n >= traces and best and len(best) % reps == 0:
            return sum(best) / 1e3 / reps
    ms = events_ms(lambda: [fn() for _ in range(reps)]) / reps
    log(f"[timing] device_ms: no whole trace in {tries} (at most "
        f"{len(best)} device records over {reps} calls); timed by CUDA "
        f"events around the {reps} calls instead (host time included): "
        f"{ms:.4f} ms a call")
    return ms


def profiled_ms(make, calls: int, name: str, what: str,
                tries: int = 5) -> float:
    """Device ms a call of the kernels named *name*: torch.profiler's
    durations over one run of make()(), which launches them `calls` times.
    A trace that lost kernel records is taken again (torch.profiler now and
    then reports a few of the launches), up to `tries` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        run = make()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if len(us) == calls:
            return sum(us) / 1e3 / calls
        log(f"[timing] {what}: the profiler saw {len(us)} {name} kernels of "
            f"{calls}; taking the trace again")
    raise RuntimeError(f"chip_smoke check failed: {what}: no complete "
                       f"trace of {calls} {name} kernels in {tries} tries")


def log_split(what: str, s: dict) -> None:
    log(f"[lm] split of {what} (torch.profiler, device ms): flash attention "
        f"kernel {s['attention_ms']:.3f}, decode attention (plain torch) "
        f"{s['mla.decode_attention']:.3f}, router topk kernel "
        f"{s['router_ms']:.3f}, expert einsums {s['moe.experts']:.3f}, rest "
        f"{s['rest_ms']:.3f}; device busy {s['device_ms']:.3f} of "
        f"{s['wall_ms']:.3f} wall (idle share "
        f"{1 - s['device_ms'] / s['wall_ms']:.3f}), {s['kernels']} kernels")
    log(f"[lm]   kernels with the most device time: " + "; ".join(
        f"{name[:70]} {us / 1e3:.3f} ms" for name, us in s["top"]))


def lm_topk_checks(router_neg, g) -> dict:
    """(a) both topk kernels bitwise equal to the plain version: on the
    router's own [B*T, E] rows (k=6), and on [4,096, E] rows with ties,
    NaN, +/-inf and -0.0 beside +0.0 (k = 1, 6, 64; the plain version on
    the CPU, whose sort ties the zeros); select_k.cu also at LM_TOPK_WIDE
    ([256, 1M]), k=10, with ties and +inf (the short-row kernel refuses
    it). Returns each kernel's largest |kernel - plain| over finite
    values (0)."""
    from repro_torch.kernels import topk

    e = router_neg.shape[1]
    odd = torch.round(torch.randn((4096, e), generator=g, device=DEVICE)
                      * 4) / 4                          # many ties
    pick = torch.randint(0, 8, odd.shape, generator=g, device=DEVICE)
    for code, val in ((1, float("nan")), (2, float("inf")),
                      (3, -float("inf")), (4, 0.0), (5, -0.0)):
        odd[pick == code] = val
    odd[7] = float("nan")
    odd[9] = -0.0
    cases = [("router rows", router_neg, (LM_TOPK,), False),
             ("ties, NaN, +/-inf, signed zeros", odd, (1, LM_TOPK, 64), True)]
    big = torch.round(torch.randn(LM_TOPK_WIDE, generator=g,
                                  device=DEVICE) * 16) / 16     # many ties
    big[:, 7::11] = float("inf")
    big[3] = float("inf")
    big[5, 1000:] = float("inf")
    cases.append(("ties and +inf", big, (10,), False))
    worst = {"topk": 0.0, "topk_stream": 0.0}
    for what, x, ks, on_cpu in cases:
        routes = (("topk_stream", topk.topk_stream_cuda),)
        if topk.takes_short_rows(x.shape[1], max(ks)):
            routes = (("topk", topk.topk_short_cuda),) + routes
        for kk in ks:
            want = topk.topk_ref(x.cpu() if on_cpu else x, kk)
            for key, fn in routes:
                got = [t.to(want[0].device) for t in fn(x, kk)]
                check(torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1])
                      and torch.equal(torch.signbit(got[0]),
                                      torch.signbit(want[0])),
                      f"{key} kernel != plain on {what}, k={kk}")
                fin = torch.isfinite(want[0])
                worst[key] = max(worst[key], float(
                    (got[0][fin] - want[0][fin]).abs().max()))
            log(f"[lm] (a) topk {list(x.shape)}, k={kk}, {what}: "
                f"{' and '.join(k for k, _ in routes)} values (signs "
                f"included) and ids bitwise equal to the plain version "
                f"({int((want[1] < 0).sum())} unfilled slots, (+inf, -1) "
                f"in both)")
    del big, odd
    return worst


def lm_flash_checks(path_shape, g) -> dict:
    """(b) the flash kernels within FLASH_TOL of their plain version, each
    case on the kernel `flash_attention_cuda` picks for it: the tensor-core
    kernel at MLA prefill's [B*H, T, qk_nope + qk_rope] bf16 causal and at
    ragged bf16 shapes (T and S not multiples of the 64-key tile or the
    128-row block, S != T without the mask, hd = 24 and 256, T = 1); the
    FP32-FMA kernel at bf16 hd = 100 (not a multiple of 8) and at
    unaligned float32 shapes, causal and full. Returns the largest
    |kernel - plain| of each: the tensor-core kernel's at the path's
    shape, the FMA kernel's over its cases."""
    from repro_torch.kernels import attention

    bh, t, hd = path_shape
    bf = torch.bfloat16
    cases = [((bh, t, t, hd), bf, True, "tc"),
             ((6, 1000, 1000, 192), bf, True, "tc"),
             ((6, 777, 1000, 192), bf, False, "tc"),
             ((6, 333, 200, 24), bf, True, "tc"),
             ((4, 300, 300, 256), bf, True, "tc"),
             ((16, 1, 1, 192), bf, True, "tc"),
             ((16, 1, 500, 192), bf, False, "tc"),
             ((4, 500, 500, 100), bf, True, "fma"),
             ((6, 1000, 1000, 100), torch.float32, True, "fma"),
             ((6, 1000, 777, 100), torch.float32, False, "fma"),
             ((5, 333, 333, 192), torch.float32, True, "fma"),
             ((3, 129, 200, 17), torch.float32, False, "fma")]
    err = {"tc": 0.0, "fma": 0.0}
    for n, ((bh, t, s, hd), dtype, causal, kernel) in enumerate(cases):
        q, k, v = (torch.randn((bh, m, hd), generator=g, device=DEVICE).to(
            dtype) for m in (t, s, s))
        before = attention.TC_LAUNCHES, attention.FMA_LAUNCHES
        got = attention.flash_attention_cuda(q, k, v, causal=causal).float()
        took = "tc" if attention.TC_LAUNCHES > before[0] else "fma"
        check(took == kernel and attention.FMA_LAUNCHES - before[1]
              + attention.TC_LAUNCHES - before[0] == 1,
              f"flash_attention at {[bh, t, s, hd]} {dtype} took the {took} "
              f"kernel, expected {kernel}")
        want = attention.flash_attention_ref(q, k, v, causal=causal).float()
        rel, absol = FLASH_TOL[dtype]
        tol = rel * torch.maximum(got.abs(), want.abs()) + absol
        d = float((got - want).abs().max())
        check(bool(((got - want).abs() <= tol).all()),
              f"flash_attention {kernel} kernel beyond the tolerance at "
              f"{[bh, t, s, hd]} {dtype} causal={causal}: max {d}")
        if n == 0 or kernel == "fma":
            err[kernel] = max(err[kernel], d)
        log(f"[lm] (b) flash_attention, {kernel} kernel, [{bh}, {t}, {hd}] "
            f"x S={s} {dtype}, causal={causal}: within {rel:g} x |out| + "
            f"{absol:g} of its plain version (max |d| {d:.3g})")
        del q, k, v, got, want, tol
    return err


def lm_timing(router_neg, path_shape, g, reps: int = 5) -> dict:
    """Each kernel, its plain version and a library call at the path's
    shapes (device ms, median of `reps`), and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import attention, topk

    out = {}
    b, e = router_neg.shape
    dec = router_neg[:LM_B].contiguous()                # a decode step's rows
    routes = {"topk": topk.topk_short_cuda, "topk_stream": topk.topk_stream_cuda}
    # the router's calls are microseconds of device work: time them by
    # their kernels (device_ms), both kernels in turns; CUDA events around
    # a call would time the host's wrapper, printed beside for that reason
    dev_ms = in_turns({n: (lambda f=f: f(router_neg, LM_TOPK))
                       for n, f in routes.items()})
    dec_ms = in_turns({n: (lambda f=f: f(dec, LM_TOPK))
                       for n, f in routes.items()})
    lib = {"plain_ms": device_ms(lambda: topk.topk_ref(router_neg, LM_TOPK)),
           "library_ms": device_ms(lambda: torch.topk(
               router_neg, LM_TOPK, dim=1, largest=False))}
    one = torch.zeros(1, device=DEVICE)
    floor_ms = device_ms(lambda: one.add_(1))          # one trivial kernel
    nbytes = b * e * 4 + b * LM_TOPK * 8
    bound_ms, bound_by = bound(nbytes, b * e, FP32_FLOPS)
    dec_bytes = LM_B * e * 4 + LM_B * LM_TOPK * 8
    for name, fn in routes.items():
        out[name] = dict(lib, ms=dev_ms[name], decode_ms=dec_ms[name],
                         events_ms=median_ms(lambda: fn(router_neg, LM_TOPK),
                                             reps),
                         bound_ms=bound_ms, bound_by=bound_by,
                         decode_bound_ms=dec_bytes / HBM_BYTES_PER_S * 1e3,
                         launch_floor_ms=floor_ms)
    events = median_ms(lambda: torch.topk(router_neg, LM_TOPK, dim=1,
                                          largest=False), reps)
    log(f"[lm] timing topk [{b}, {e}], k={LM_TOPK} (the router's rows), "
        f"device time of its kernels (in turns): select_k_short.cu "
        f"{dev_ms['topk']:.4f} ms, select_k.cu {dev_ms['topk_stream']:.4f} "
        f"ms ({dev_ms['topk_stream'] / dev_ms['topk']:.2f}x), plain "
        f"{lib['plain_ms']:.4f} ms, library (torch.topk) "
        f"{lib['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
        f"{nbytes / 1e6:.2f} MB); CUDA events around one call (host wrapper "
        f"included): select_k_short.cu {out['topk']['events_ms']:.4f}, "
        f"select_k.cu {out['topk_stream']['events_ms']:.4f}, torch.topk "
        f"{events:.4f} ms")
    log(f"[lm] timing topk [{LM_B}, {e}], k={LM_TOPK} (a decode step's "
        f"rows, one CTA), device time (in turns): select_k_short.cu "
        f"{dec_ms['topk']:.4f} ms, select_k.cu {dec_ms['topk_stream']:.4f} "
        f"ms; bound {dec_bytes / HBM_BYTES_PER_S * 1e3:.7f} ms (bytes: "
        f"{dec_bytes} B); launch floor (device time of one trivial kernel, "
        f"a 1-element add_) {floor_ms:.4f} ms")
    bh, T, hd = path_shape
    q, k, v = (torch.randn((bh, T, hd), generator=g, device=DEVICE).to(
        torch.bfloat16) for _ in range(3))
    q4, k4, v4 = (x.view(LM_B, bh // LM_B, T, hd) for x in (q, k, v))
    t = {"ms": median_ms(lambda: attention.flash_attention_tc_cuda(q, k, v),
                         reps),
         "plain_ms": median_ms(lambda: attention.flash_attention_ref(q, k, v),
                               reps),
         "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
             q4, k4, v4, is_causal=True), reps)}
    # the FP32-FMA kernel on the same inputs (it takes the other shapes)
    fma = dict(t, ms=median_ms(
        lambda: attention.flash_attention_fma_cuda(q, k, v), reps))
    # q.k^T and P.V over the causal pairs, 2 hd operations a pair each.
    # The bound prices both at the bf16 tensor cores: products of bf16
    # inputs are exact in a float32 accumulator, and P, which the function
    # keeps in float32, splits exactly into three bf16 pieces (8 + 8 + 8
    # mantissa bits), so P.V costs three bf16 products
    qk = pv = 2.0 * bh * hd * T * (T + 1) / 2
    nbytes = 4 * bh * T * hd * 2
    t["bound_ms"], t["bound_by"] = bound(nbytes, qk + 3 * pv, BF16_FLOPS)
    fma["bound_ms"], fma["bound_by"] = t["bound_ms"], t["bound_by"]
    out["flash_attention"], out["flash_attention_fma"] = t, fma
    log(f"[lm] timing flash_attention [{bh}, {T}, {hd}] bf16 causal (one MLA "
        f"prefill layer): tensor-core kernel {t['ms']:.4f} ms, FP32-FMA "
        f"kernel {fma['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library (scaled_dot_product_attention) {t['library_ms']:.4f} ms, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {qk / 1e9:.1f} "
        f"GFLOP q.k^T + 3 x {pv / 1e9:.1f} GFLOP P.V at the bf16 tensor "
        f"cores' 989 TFLOP/s; {(qk + pv) / FP32_FLOPS * 1e3:.4f} ms for "
        f"{(qk + pv) / 1e9:.1f} GFLOP at FP32 67 TFLOP/s outside them; "
        f"{nbytes / 1e6:.0f} MB {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return out


def lm_invariant(model, cfg, toks) -> list:
    """The reference's invariant (tests/test_models.py): prefill(T) then
    decode(T..T+2) against a prefill over T+3 tokens at those positions;
    returns the (got, want) logits pairs [B, V] of the four positions."""
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.models.transformer import (
        compute_logits,
        forward,
        init_cache,
    )

    b, n = toks.shape
    t = n - 3
    with torch.no_grad():
        hidden, _, _ = forward(model, cfg, toks, mode="prefill")
        full = compute_logits(model, cfg, hidden)
    cache = init_cache(cfg, b, n, dtype=cfg.param_dtype, device=DEVICE)
    got, cache = prefill_step(model, {"inputs": toks[:, :t]}, cache, cfg)
    pairs = [(got[:, 0], full[:, t - 1])]
    for pos in range(t, n):
        got, cache = decode_step(model, toks[:, pos:pos + 1], cache, pos, cfg)
        pairs.append((got[:, 0], full[:, pos]))
    return pairs


def logit_gap(pairs, V: int) -> dict:
    """(got, want) logits pairs [B, V]: the max |d| and max |want|, the
    RMS of d over the RMS of want, the rows whose greedy token is equal
    (`same` of `n`), and (wanted top-2 margin, row max |d|) of each row
    whose greedy token differs."""
    pairs = [(a[:, :V], b[:, :V]) for a, b in pairs]
    d2 = sum(float((a - b).double().square().sum()) for a, b in pairs)
    w2 = sum(float(b.double().square().sum()) for _, b in pairs)
    gap = {"err": max(float((a - b).abs().max()) for a, b in pairs),
           "scale": max(float(b.abs().max()) for _, b in pairs),
           "rms": (d2 / w2) ** 0.5, "same": 0, "n": 0, "flips": []}
    for a, b in pairs:
        eq = a.argmax(-1) == b.argmax(-1)
        gap["same"] += int(eq.sum())
        gap["n"] += a.shape[0]
        top2 = b.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        row_err = (a - b).abs().amax(-1)
        gap["flips"] += [(float(m), float(r)) for m, r, e in
                         zip(margin, row_err, eq) if not e]
    return gap


def bf16_gate(gap: dict) -> bool:
    """The bf16 gate: RMS |d| within LM_TOL_BF16 x RMS |logit|, the greedy
    token equal on LM_GREEDY_SHARE of the rows, and a row's greedy token
    differing only where the wanted top-2 margin is within twice that
    row's max |d|, where the difference itself can swap the two."""
    return (gap["rms"] <= LM_TOL_BF16
            and gap["same"] >= LM_GREEDY_SHARE * gap["n"]
            and all(m <= 2 * r for m, r in gap["flips"]))


def compare_logits(what: str, pairs, V: int, tol) -> dict:
    """Log and gate (got, want) logits pairs [B, V]: bf16 (`tol` None) by
    `bf16_gate`; float32 |d| <= tol + tol |want| and every greedy token
    equal. Returns the `logit_gap`."""
    gap = logit_gap(pairs, V)
    pairs = [(a[:, :V], b[:, :V]) for a, b in pairs]
    log(f"[lm] {what}: max |d logits| {gap['err']:.6f} (max |logit| "
        f"{gap['scale']:.3f}; ratio {gap['err'] / gap['scale']:.4f}), RMS "
        f"|d| / RMS |logit| {gap['rms']:.4f}, greedy token equal on "
        f"{gap['same']}/{gap['n']}"
        + (f"; (top-2 margin, row max |d|) where it differs: "
           + ", ".join(f"({m:.4f}, {r:.4f})" for m, r in gap["flips"])
           if gap["flips"] else ""))
    if tol is None:
        check(bf16_gate(gap), f"{what}: beyond {LM_TOL_BF16} x RMS |logit|, "
              f"greedy tokens equal on {gap['same']}/{gap['n']} (at least "
              f"{LM_GREEDY_SHARE} wanted), or a differing greedy token "
              f"where its margin exceeds twice the row's difference: "
              f"{gap['flips']}")
    else:
        ok = all(bool(((a - b).abs() <= tol + tol * b.abs()).all())
                 for a, b in pairs)
        check(ok and gap["same"] == gap["n"], f"{what}: beyond {tol} or "
              f"greedy tokens equal on {gap['same']}/{gap['n']} only")
    return gap


def no_drop_config(cfg):
    """cfg with the MoE capacity raised so that no token is dropped: two
    runs that group or route tokens differently then differ by the tokens'
    own values, not by which tokens a full expert turns away."""
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def prefill_last(model, cfg, prompts, **swap):
    """The last position's logits [B, V] of a prefill over `prompts` (no
    cache) with ops swapped as `swapped_ops` takes them."""
    from repro_torch.models.model import prefill_step

    with swapped_ops(**swap):
        return prefill_step(model, {"inputs": prompts}, None, cfg)[0][:, 0]


def lm_bf16_pairs(model, cfg, prompts, **swap) -> dict:
    """The logits pairs of (c) and (d) at full depth in bf16, both with the
    capacity raised so that no token is dropped (a prefill over T and one
    over T+3 group tokens differently, and the kernels' and the plain
    versions' router near-ties move tokens between experts): (c)
    prefill(LM_C_T) + decode x3 against prefill(LM_C_T + 3), B=2; (d) the
    main prefill with the plain topk and flash_attention against the
    kernels. `swap` (ops as `swapped_ops` takes them) replaces the plain
    versions in (d) and runs the whole of (c), to put a fault in."""
    from repro_torch.kernels.attention import flash_attention_ref
    from repro_torch.kernels.topk import topk_ref

    cfg = no_drop_config(cfg)
    with swapped_ops(**swap):
        c = lm_invariant(model, cfg, prompts[:2, :LM_C_T + 3])
    d = [(prefill_last(model, cfg, prompts, **(swap or {
        "topk_fn": topk_ref, "flash_fn": flash_attention_ref})),
          prefill_last(model, cfg, prompts))]
    return {f"(c) bf16, full depth: prefill({LM_C_T}) + decode x3 against "
            f"prefill({LM_C_T + 3}), B=2, no drops": c,
            f"(d) bf16, full depth: the {prompts.shape[0]} x "
            f"{prompts.shape[1]} prefill with the plain topk and "
            f"flash_attention against the kernels, no drops": d}


def lm_f32_checks(prompts, g) -> None:
    """(c) and (d) again in float32 at full width and depth 1 + LM_F32_PERIODS
    (the prefix layer and the first MoE periods), where rounding cannot
    hide a fault: both held to the reference's own 2e-3."""
    import dataclasses

    from repro_torch.kernels.attention import flash_attention_ref
    from repro_torch.kernels.topk import topk_ref
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(lm_config(), num_periods=LM_F32_PERIODS,
                              param_dtype=torch.float32)
    model = init_params(cfg, device=DEVICE, generator=g)
    toks = prompts[:2, :LM_C_T + 3]
    no_drop = no_drop_config(cfg)
    compare_logits(f"(c) float32, depth 1+{LM_F32_PERIODS}: prefill("
                   f"{LM_C_T}) + decode x3 against prefill({LM_C_T + 3}), "
                   f"B=2, no drops", lm_invariant(model, no_drop, toks),
                   cfg.vocab_size, LM_TOL_F32)
    plain = prefill_last(model, cfg, toks[:, :LM_C_T], topk_fn=topk_ref,
                         flash_fn=flash_attention_ref)
    compare_logits(f"(d) float32, depth 1+{LM_F32_PERIODS}: prefill({LM_C_T}"
                   f") with the plain topk and flash_attention against the "
                   f"kernels", [(plain, prefill_last(model, cfg,
                                                     toks[:, :LM_C_T]))],
                   cfg.vocab_size, LM_TOL_F32)
    del model


def lm_phase(seed: int) -> dict:
    from repro_torch.kernels import attention, topk
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.models.transformer import init_cache, init_params

    dev = torch.device(DEVICE)
    cfg = lm_config()
    V = cfg.vocab_size
    n_moe = sum(s.ffn == "moe" for s in cfg.all_specs())
    n_attn = cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = init_params(cfg, device=dev, generator=g)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} MLA heads, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}, {n_params / 1e9:.3f} B parameters "
        f"({n_params * 2 / 1e9:.2f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    prompts = torch.randint(0, V, (LM_B, LM_T), generator=g, device=dev)
    cache = init_cache(cfg, LM_B, LM_S, dtype=cfg.param_dtype, device=dev)
    t0 = time.perf_counter()
    warm, cache = prefill_step(model, {"inputs": prompts}, cache, cfg)
    decode_step(model, warm[:, -1, :V].argmax(-1)[:, None], cache, LM_T, cfg)
    torch.cuda.synchronize()
    log(f"[lm] warm-up prefill and decode step (library loads, cuBLAS "
        f"set-up; the main path writes the same positions again): "
        f"{time.perf_counter() - t0:.2f}s")

    # the main path: prefill, then greedy decode steps, counters around it
    torch.cuda.reset_peak_memory_stats()
    topk.SHORT_LAUNCHES = topk.LAUNCHES = 0
    attention.TC_LAUNCHES = attention.FMA_LAUNCHES = 0
    t0 = time.perf_counter()
    logits, cache = prefill_step(model, {"inputs": prompts}, cache, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    per_prefill = (topk.SHORT_LAUNCHES, topk.LAUNCHES, attention.TC_LAUNCHES,
                   attention.FMA_LAUNCHES)
    tok = logits[:, -1, :V].argmax(-1)[:, None]
    first_tok = tok.clone()
    steps, gen, per_step = [], [tok], set()
    for i in range(LM_STEPS):
        before = topk.SHORT_LAUNCHES, topk.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = decode_step(model, tok, cache, LM_T + i, cfg)
        tok = out[:, -1, :V].argmax(-1)[:, None]
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        gen.append(tok)
        per_step.add((topk.SHORT_LAUNCHES - before[0],
                      topk.LAUNCHES - before[1]))
    launches = {"topk": topk.SHORT_LAUNCHES, "topk_stream": topk.LAUNCHES,
                "flash_attention": attention.TC_LAUNCHES,
                "flash_attention_fma": attention.FMA_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    # (e) the path went through both kernels, once a layer: every router
    # launch through the short-row topk kernel and every flash launch
    # through the tensor-core kernel
    check(per_prefill == (n_moe, 0, n_attn, 0),
          f"(e) a prefill launched (topk short-row, topk select_k.cu, flash "
          f"tensor-core, flash FMA) {per_prefill}, expected ({n_moe}, 0, "
          f"{n_attn}, 0)")
    check(per_step == {(n_moe, 0)},
          f"(e) a decode step launched (topk short-row, topk select_k.cu) "
          f"{sorted(per_step)}, expected ({n_moe}, 0) every step")
    check(launches == {"topk": n_moe * (1 + LM_STEPS), "topk_stream": 0,
                       "flash_attention": n_attn, "flash_attention_fma": 0},
          f"(e) launches over prefill and {LM_STEPS} decode steps {launches}")
    gen = torch.cat(gen, 1)
    check(logits.shape == (LM_B, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(out).all())
          and bool(((gen >= 0) & (gen < V)).all()),
          "prefill / decode logits not finite or of the wrong shape")
    st = np.array(steps)
    log(f"[lm] prefill {LM_B} x {LM_T} tokens: {prefill_ms:.2f} ms "
        f"({LM_B * LM_T / prefill_ms * 1e3:.1f} tokens/s); launches "
        f"topk {per_prefill[0]} (short rows; select_k.cu {per_prefill[1]}), "
        f"flash_attention {per_prefill[2]} (tensor cores; FP32-FMA kernel "
        f"{per_prefill[3]})")
    log(f"[lm] decode {LM_STEPS} greedy steps of {LM_B} at positions "
        f"{LM_T}..{LM_T + LM_STEPS - 1} (cache {LM_S}): p50 "
        f"{np.percentile(st, 50):.3f} ms, p99 {np.percentile(st, 99):.3f} ms "
        f"a step, {LM_B / np.percentile(st, 50) * 1e3:.1f} tokens/s at p50; "
        f"launches {launches} in all (topk {n_moe} a step)")
    log(f"[lm] peak memory {peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}; "
        f"logits finite, greedy tokens of row 0: {gen[0, :8].tolist()}")

    # the split of one prefill and one decode step; the router's rows
    rows = []

    def recording_topk(x, k):
        if not rows:
            rows.append(x.clone())
        return topk.topk_cuda(x, k)

    with swapped_ops(topk_fn=recording_topk):
        s_pre = profile_split(
            lambda: prefill_step(model, {"inputs": prompts}, cache, cfg))
    log_split(f"one prefill ({LM_B} x {LM_T})", s_pre)
    s_dec = profile_split(
        lambda: decode_step(model, first_tok, cache, LM_T, cfg))
    log_split(f"one decode step (B={LM_B})", s_dec)
    check(s_pre["attention_ms"] > 0 and s_pre["router_ms"] > 0
          and s_dec["router_ms"] > 0,
          "the profiler saw no flash or topk kernel on the device")

    path_shape = (LM_B * cfg.n_heads, LM_T, cfg.mla.qk_nope + cfg.mla.qk_rope)
    err_topk = lm_topk_checks(rows[0], g)
    err_flash = lm_flash_checks(path_shape, g)
    timing = lm_timing(rows[0], path_shape, g)
    del rows
    torch.cuda.empty_cache()
    # (c) and (d) in bf16, the capacity raised so that no token is dropped
    for what, pairs in lm_bf16_pairs(model, cfg, prompts).items():
        compare_logits(what, pairs, V, None)
    del model, cache
    torch.cuda.empty_cache()
    lm_f32_checks(prompts, g)
    torch.cuda.empty_cache()
    return {"topk": {"launches": launches["topk"], "err": err_topk["topk"],
                     "timing": timing["topk"]},
            "topk_stream": {"launches": launches["topk_stream"],
                            "err": err_topk["topk_stream"],
                            "timing": timing["topk_stream"]},
            "flash_attention": {"launches": launches["flash_attention"],
                                "err": err_flash["tc"],
                                "timing": timing["flash_attention"]},
            "flash_attention_fma": {
                "launches": launches["flash_attention_fma"],
                "err": err_flash["fma"],
                "timing": timing["flash_attention_fma"]}}


# ---------------------------------------------------------------------------


def kernel_row(name, source, replaces, launches, err, timing, bound_by):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": timing and timing["ms"],
            "plain_ms": timing and timing["plain_ms"],
            "bound_ms": timing and timing["bound_ms"], "bound_by": bound_by,
            "library_ms": timing and timing.get("library_ms")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="kernel,main,quant,csd,cost,serve,ingest,"
                            "cluster,scan,lm",
                    help="comma list of kernel,main,quant,csd,cost,serve,"
                         "ingest,cluster,scan,lm (card and build always "
                         "run; serve and cost need csd, csd needs quant, "
                         "quant, ingest and cluster need main)")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke test needs a CUDA device", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    phases = set(args.phases.split(","))
    if phases & {"serve", "cost"}:
        phases.add("csd")
    if "csd" in phases:
        phases.add("quant")
    if phases & {"quant", "ingest", "cluster"}:
        phases.add("main")

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
    from repro_torch.api import SearchService
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] nvcc sm_90a: {', '.join(p.name for p in libs.values())} "
        f"in {time.perf_counter() - t0:.1f}s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line.strip()}")

    kern = {}
    main_out = timing = quant = scan = served = ingest = clustered = None
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ProcessPoolExecutor(
                max_workers=6,
                mp_context=multiprocessing.get_context("spawn")) as pool:
        paths = {dt: str(Path(tmp) / dt) for dt in ("uint8", "int8", "pq")}
        # the workers see sys.path (so repro_torch) through spawn's
        # preparation data
        builds = ({dt: pool.submit(build_worker,
                                   partitioned_spec(dtype=dt, pq_m=PQ_M),
                                   path, N_MAIN, DEVICE)
                   for dt, path in paths.items()} if "quant" in phases else {})
        # the ingest phase's reference: a build over its survivors
        rebuild_path = str(Path(tmp) / "ingest-rebuild")
        if "ingest" in phases:
            builds["ingest survivors"] = pool.submit(
                rebuild_worker, rebuild_path, N_INGEST, DEVICE)
        # the single index build_cluster's own check must equal
        small_path = str(Path(tmp) / "cluster-small-single")
        if "cluster" in phases:
            builds["cluster check's single"] = pool.submit(
                small_single_worker, small_path, DEVICE)
        # 3. kernel
        if "kernel" in phases:
            kern = kernel_phase(1_000_000, seed=0)
        # 4. main
        if "main" in phases:
            data, queries = main_data(N_MAIN, N_QUERIES)
            t0 = time.perf_counter()
            svc = SearchService.build(data, partitioned_spec(), device=DEVICE)
            torch.cuda.synchronize()
            log(f"[main] build: {N_MAIN} x 128 vectors, P={P_MAIN}, "
                f"M={HNSW_M}, ef_construction={HNSW_EFC} -> "
                f"{time.perf_counter() - t0:.1f}s (host graph build + upload"
                f"{', beside the quantized builds' if builds else ''})")
            t0 = time.perf_counter()
            for dt, fut in builds.items():
                log(f"[build] {dt}: SearchService.build {fut.result():.1f}s "
                    f"in its worker (saved)")
            if builds:
                # no build competes with a timed batch: the workers exit
                pool.shutdown(wait=True)
            if builds:
                log(f"[build] waited {time.perf_counter() - t0:.1f}s for the "
                    f"workers' builds")
            main_out = main_phase(svc, data, queries)
            # 5. timing
            timing = timing_phase(svc, queries[:BATCH], "main")
            # 6. quant
            if "quant" in phases:
                quant = {dt: scalar_phase(paths[dt], dt, queries, main_out)
                         for dt in ("uint8", "int8")}
                quant["pq"] = pq_phase(paths["pq"], data, queries,
                                       main_out["gt"])
            # 6b. csd, over the same four indexes
            if "csd" in phases:
                parts = {"float32": svc}
                for dt in ("uint8", "int8", "pq"):
                    parts[dt] = SearchService.load(paths[dt], device=DEVICE)
                csd_out = csd_phase(tmp, parts, queries)
                del parts
            # the cost model against the card, from 6b's windows
            if "cost" in phases:
                cost_phase(csd_out, svc, main_out["qps"], queries, tmp)
            # 6c. serve, through SearchServer
            if "serve" in phases:
                served = serve_phase(svc, queries, main_out,
                                     csd_out["float32"], tmp)
            # 6d. ingest, the mutable index served while it grows
            if "ingest" in phases:
                ingest = ingest_phase(data, queries, rebuild_path)
            # 6e. cluster and distributed, over the same rows
            if "cluster" in phases:
                clustered = cluster_phase(svc, data, queries, small_path,
                                          tmp)
    # 7. scan
    if "scan" in phases:
        torch.cuda.empty_cache()
        scan = scan_phase(seed=1)
    # 8. lm
    lm = None
    if "lm" in phases:
        torch.cuda.empty_cache()
        lm = lm_phase(seed=0)

    csrc = "src/repro_torch/kernels/csrc/"
    trav = "src/repro/kernels/traversal.py:234"
    qsrc = csrc + "qdist.cu"
    rows = []
    for dt in ("float32", "uint8", "int8"):
        path = main_out if dt == "float32" else quant and quant[dt]
        t = path and (timing if dt == "float32" else path["timing"])
        sfx = "" if dt == "float32" else f"_{dt}"
        launches = path["launches"] if path else 0
        if dt == "float32":   # the serve, ingest and cluster phases too
            launches += sum(x["launches"] for x in (served, ingest, clustered)
                            if x)
        rows.append(kernel_row(f"fused_traversal_async{sfx}",
                               csrc + "traversal_async.cu", trav, launches,
                               kern.get(("async", dt)), t, "bytes"))
        # the paths launch traversal.cu no time (check_traversal_launches)
        rows.append(kernel_row(
            f"fused_traversal{sfx}", csrc + "traversal.cu", trav, 0,
            kern.get(("ldg", dt)),
            t and {"ms": t["ldg_ms"], "plain_ms": t["plain_ms"],
                   "bound_ms": t["bound_ms"]}, "bytes"))
    pq = quant["pq"] if quant else None
    for name, source, replaces in (
            ("pq_topk", csrc + "pq_topk_smem.cu",
             "src/repro/kernels/qdist.py:310"),
            ("pq_topk_v1", qsrc, "src/repro/kernels/qdist.py:310"),
            ("pq_adc", csrc + "pq_adc_smem.cu",
             "src/repro/kernels/qdist.py:240"),
            ("pq_adc_v1", qsrc, "src/repro/kernels/qdist.py:240")):
        t = pq and pq["timing"][name]
        # the exact PQ path launches only pq_topk_smem.cu (pq_phase checks
        # 0 launches of qdist.cu's pq_topk); pq_adc's are the counts of
        # the main, quant and csd paths' runs (take_adc_counts checks 0)
        launches = (pq["launches"] if pq and name == "pq_topk"
                    else ADC_ON_PATHS.get(name, 0))
        rows.append(kernel_row(name, source, replaces, launches,
                               kern.get(name), t,
                               t["bound_by"] if t else "operations"))
    for name, source, replaces in (
            ("l2topk", "l2topk_tc.cu", "src/repro/kernels/l2topk.py:65"),
            ("l2topk_fma", "l2topk.cu", "src/repro/kernels/l2topk.py:65"),
            ("l2dist", "l2dist_tc.cu", "src/repro/kernels/l2dist.py:57"),
            ("l2dist_fma", "l2dist.cu", "src/repro/kernels/l2dist.py:57"),
            ("l2dist_q", "l2dist_q_tc.cu", "src/repro/kernels/qdist.py:77"),
            ("l2dist_q_fma", "l2dist.cu", "src/repro/kernels/qdist.py:77"),
            ("l2topk_q", "l2topk_q_tc.cu", "src/repro/kernels/qdist.py:158"),
            ("l2topk_q_fma", "l2topk.cu", "src/repro/kernels/qdist.py:158")):
        sc = scan[name] if scan else None
        t = sc and sc["timing"]
        rows.append(kernel_row(name, csrc + source, replaces,
                               sc["launches"] if sc else 0, sc and sc["err"],
                               t, t["bound_by"] if t else "operations"))
    for name, source, replaces, bound_by in (
            ("topk", "select_k_short.cu", "src/repro/kernels/topk.py:78",
             "bytes"),
            ("topk_stream", "select_k.cu", "src/repro/kernels/topk.py:78",
             "bytes"),
            ("flash_attention", "flash_attention_tc.cu",
             "src/repro/kernels/attention.py:79", "operations"),
            ("flash_attention_fma", "flash_attention.cu",
             "src/repro/kernels/attention.py:79", "operations")):
        r = lm[name] if lm else None
        t = r and r["timing"]
        rows.append(kernel_row(name, csrc + source, replaces,
                               r["launches"] if r else 0, r and r["err"], t,
                               t["bound_by"] if t else bound_by))
    log(f"[done] {time.perf_counter() - t_all:.1f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
