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
               Last, the exact uint8 service over the same rows with the
               port's TRACER on (`exact_spans`): one request of 256
               queries records search > encode, upload, scan, scan's work
               counts equal the backend's, its CUDA event pair gives its
               device ms, and under torch.profiler the spans are host
               ranges; prints each span's host ms and the scan's device
               ms.
  7b. graph_build — the batched graph build (`core/batch_build.py`) on the
               benchmark's uint8 rows (`bench/generator.py`), M=16,
               ef_construction=100, P=4: the card build of 4 x 8,192 rows
               equal byte for byte, every table, to the CPU build of the
               same rows (a worker process, beside the rest); at 4 x
               16,384 rows, 10,000 queries, ef 40, the card-built graph's
               recall@10 within 0.005 of build_hnsw's (four worker
               processes, one a partition), both searched on the card and
               held to `bench/reference/exact.py`; the graph cell's
               configuration, 1M rows through SearchService.build
               (`partitioned-batched`, uint8), in <= 60 s, its recall at
               the cell's request; and its spans (`graph_spans`): build >
               one insert a batch (rows summing to the index's, each with
               dev_ms), search > encode, descend, layer0, merge with their
               attrs against the backend (the descent on its kernel route:
               0 syncs, 1 launch), layer0's dev_ms, and the spans as
               torch.profiler ranges.
  7c. descent — the upper-layer descent kernel (csrc/descent.cu) against
               its plain version (`greedy_descent_ref`, lockstep torch ops)
               bitwise in cur, cur_d and calcs: on small lattice graphs
               (tie-heavy; 8-wide upper rows at D_pad 128, 24-wide at 256)
               for float32 / uint8 / int8 rows under l2 / ip / cosine, and
               on the graph cell's 1M-row, 4-partition uint8 graph at its
               40,000 lanes (uint8 and int8 rows under l2, float32 rows of
               the same values under l2 / ip / cosine), one launch each;
               one request of the cell through the service on the kernel
               route (1 launch) and with the torch-op descent swapped in,
               ids, distances and stats bitwise; the kernel's device time
               at the cell's shapes beside the plain version's and its
               floors (the bytes it reads once; its lanes' chains of
               dependent loads at an L2 hit's latency), and the request's
               host ms on both routes. The serving paths of phases 4-6e
               and 12 count descent.cu in windows of their own
               (`descent_window`): one launch a descent on the card, one
               descent a request (a shard's or a mesh slot's part of one),
               and exactly one a request on the main and quant paths.
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

  9. dense   — the GQA attention layer, after the lm phase's model is
               freed: bf16 random weights drawn on the card from the seed.
               (a) qwen3-14b at full width and depth (40 layers, d 5,120,
               GQA 40:8, hd 128, qk_norm; 14.8 B parameters): B=8 prompts
               of T=2,048 tokens, `prefill_step` into a 2,080-position
               cache, 32 greedy `decode_step`s, the flash launch counters
               set to 0 just before and read just after: 40 tensor-core
               flash launches a prefill, 0 FMA, none a decode step;
               finite logits; (c) prefill(256) + decode x3 against
               prefill(259) and (d) the prefill with the plain
               flash_attention against the kernel, in bf16 at full depth
               under the architecture's BF16_GATES, then in float32 at
               full width and depth 2 within 2e-3 with every greedy token
               equal. (b) h2o-danube3-4b at full width and depth (GQA 32:8,
               hd 120, window 4,096): B=2 prompts of 8,192 tokens (every
               row past 4,096 cut by the window), its 4,096-slot ring
               buffer, 32 decode steps from 8,192 (the ring wraps), 24
               tensor-core launches a prefill; (c) across the window
               (prefill(8,192) + decode x3 against prefill(8,195)), (d),
               and both in float32 at depth 2. (c) musicgen-large as
               configured (48 layers, MHA, int8 KV cache, embedded inputs,
               four heads): [8, 2,048, 2,048] embeddings, 32 decode steps
               on the int8 cache, 48 tensor-core launches a prefill,
               logits [8, 1, 4, 2,048] finite, the largest difference
               from the same run on the exact cache printed, the
               dequantization's device time in a step; in float32 at depth
               2 the int8-cache decode within the reference's bar (0.05 x
               max |logit| + 0.1) and (c), (d) within 2e-3. (d) width
               checks in float32 at full width, B=2, T=512, three decode
               steps, (c) and (d) within 2e-3: paligemma-3b at depth 2
               (hd 256, MQA 8:1, prefix 256; (d) also at prefixes 0 and
               512), granite-3-8b and minitron-8b at depth 2, dbrx-132b at
               depth 1 (its router through the topk kernel). Then the
               flash kernels against their plain version at these paths'
               shapes (and a case whose every row sees no key: zeros),
               and the tensor-core kernel timed at qwen3's, danube's and
               musicgen's prefill shapes beside the FMA kernel, the plain
               version, scaled_dot_product_attention with enable_gqa
               (timed only) and its bound; danube's also without its
               window.
  10. ssm    — the recurrent layers (models/ssm.py: Mamba-1, mLSTM,
               sLSTM, each a Python loop over time of torch ops with a
               float32 state), last, after the dense phase's models are
               freed; bf16 random weights drawn on the card from the seed.
               (a) jamba-v0.1-52b at full width (d 4,096, GQA 32:8, hd
               128, Mamba di 8,192, d_state 16, dt_rank 256, 16 experts
               top-2 of d_ff 14,336, vocab 65,536) and 2 of its 4 periods
               (16 layers, 26.0 B parameters, 52.1 GB; all 4 do not fit
               one card), its router through the topk kernel: B=8 prompts
               of T=2,048, `prefill_step` into a 2,080-position cache, 32
               greedy `decode_step`s, the launch counters set to 0 just
               before and read just after: a prefill launches the
               tensor-core flash kernel once a period and select_k_short.cu
               4 times a period, a decode step select_k_short.cu 4 times a
               period and no flash kernel, 0 of the FMA flash and of
               select_k.cu; finite logits; both kernels against their
               plain versions on the inputs a prefill and a decode step
               give them (flash at q [256, 2,048, 128] over k, v [64,
               2,048, 128] within FLASH_TOL; the router's [16,384, 16] and
               [8, 16] rows, k = 2, bitwise); (c) prefill(256) + decode x3
               against prefill(259), every router choice frozen to
               prefill(259)'s, and (d) the 8 x 2,048 prefill (2 rows at a
               time) with the plain flash_attention and topk against the
               kernels, both with no token dropped, under jamba's
               BF16_GATES; then one period in float32 at full width, B=2,
               T=512, (c) and (d) within 2e-3 with every greedy token
               equal. (b) xlstm-350m as configured (24 blocks, mLSTM:sLSTM
               7:1, d 1,024, mLSTM dh 512, tied head; 0.48 B): B=8 x
               T=2,048, 32 decode steps, finite logits, no kernel launch;
               (c) in bf16 under its gate; in float32 at full width, one
               mLSTM and one sLSTM layer alone, then the whole model: (c)
               and the card's logits against the port's on the CPU (the
               same weights, B=2, T=16, prefill and two decode steps), the
               layers within 2e-3, the whole model within XLSTM_F32_TOL
               (its read-out amplifies rounding). Prints prefill
               ms and tokens/s, decode p50 / p99, peak memory, and a
               torch.profiler split of one prefill (8 x 128) and one
               decode step: the recurrent scans (their device ms and
               kernels launched), flash attention, the decode attention,
               the router kernel, the expert einsums, the rest, and the
               idle share.
  11. train  — the training path (models/model.py train_step: forward,
               chunked-vocab loss, backward, AdamW), last, after the ssm
               phase's models are freed: deepseek-v2-lite-16b at full
               width (d 2,048, 16 MLA heads at hd 192, 64 routed experts
               + 2 shared, top-6, vocab 102,400), its router through the
               topk kernel, cut to the dense prefix layer + 2 MoE periods
               (3 of 27 layers, 1.67 B parameters; a whole train state of
               15.7 B does not fit one card), bf16 parameters drawn on
               the card from the seed. (a) the differentiable flash op's
               output (the kernel: tensor cores in bf16, FMA in float32)
               within FLASH_TOL of flash_attention_ref on the same inputs,
               and its gradients (a plain recompute a query block at a
               time) against torch.autograd.grad
               through flash_attention_ref over the whole sequence: MLA's
               [16, 4,096, 192] causal, qwen3's q [40, 4,096, 128] over 8
               KV heads, danube's 4,096 window at T = 5,120, paligemma's
               256-key prefix (q [8, 4,096, 256] over one KV head), each
               in float32 and bf16 within TRAIN_GRAD_TOL, and the op's
               backward alone at MLA's shape (device ms, a call's ms with
               host work, a backward kernel's bound); (b) one float32
               forward and backward at full width and this depth (B=1,
               T=512), the kernels against their plain versions
               (swapped_ops): loss and every gradient within 2e-3;
               (c) B=2 x T=4,096 (configs/shapes.py's train_4k length),
               grad_accum 2 (two microbatches into the float32
               accumulator): one warm-up step, then 5 timed steps (to
               torch.cuda.synchronize()) with the flash and topk launch
               counters set to 0 just before and read just after
               (tensor-core flash and select_k_short.cu > 0); p50 / p99
               step ms, tokens/s, peak GiB, the loss finite, grad_norm
               finite and > 0, every weight matrix changed; then one
               profiled step: device ms of the forward, the attention
               backward (the recompute), the rest of the backward and the
               optimizer, and the idle share (1 - device ms / the
               unprofiled p50); (d) three steps run twice
               from the same generator give bitwise-equal parameters, m
               and v; (e) a TrainLoop on DeepSeek's REDUCED config in
               bf16 runs 8 steps and dies at step 5; resumed, its
               parameters equal an uninterrupted run's bitwise, and the
               GC keeps `keep` steps.
  12. tools  — the LM dry run and sharding tools and the last two
               examples, last, after the train phase's model is freed.
               What needs no card of its own starts after phase 3,
               beside phase 4's index build, and is done before phase 4
               serves: (a)'s sweep and the quickstart as subprocesses,
               (c)'s CPU run in a worker of the build pool.
               (a) `python -m repro_torch.launch.dryrun --arch all --shape
               all --mesh both` as a subprocess: 80 records (10
               architectures x 4 shapes x the (16, 16) and (2, 16, 16)
               production meshes), none in error, the skipped cells
               exactly those `shape_runnable` refuses; the largest
               per-device argument bytes and every cell past 80 GB logged;
               then `report` over the file into the log and `reterm` over
               a copy, which must change no record's analytic fields.
               (b) for deepseek-v2-lite-16b (MLA cache, MoE), qwen3-14b
               (GQA k / v) and xlstm-350m (the mLSTM / sLSTM state):
               `lower_cell` on a one-slot mesh of this card at phase 8's
               decode cell (B=8, a 2,080-position cache, full width and
               depth), then the same parameters, cache, tokens and pos
               allocated on the card uninitialised (torch.empty): its
               argument_bytes must equal the tensors' nbytes, and the rise
               of memory_allocated must lie within the caching allocator's
               rounding of them (alloc_bounds); each freed before the
               next. (c) examples/torch_knn_lm_decode.py's `run` on the
               card and on the CPU with the same weights (the REDUCED
               granite-3-8b, float32, drawn on the CPU from the seed),
               the traversal and flash launch counters set to 0 just
               before the card's run and read just after
               (traversal_async.cu and flash_attention.cu > 0,
               traversal.cu and the tensor-core flash kernel 0): each
               step's LM log-probabilities within 2e-3, retrieved ids
               overlapping >= 0.9, decoded tokens equal wherever the
               mixed distribution's top-2 margin exceeds 1e-3; and
               `examples/torch_quickstart.py --n 2000 --dim 64
               --partitions 2` on the card as a subprocess: exit 0, its
               three recall lines and OK.

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
# the exact services' request over the scan rows: the benchmark's 10,000
# queries, 157 groups of 64 past the card's 132 CTAs, so 5 splits by the
# waves (kernels/l2topk.py splits_for)
EXACT_QUERIES, EXACT_SPLITS = 10_000, 5
# the graph phase: the card build held byte for byte to the CPU build at
# GRAPH_SAME rows a partition, its recall at ef GRAPH_EF to build_hnsw's
# graph's at GRAPH_RECALL rows a partition (within GRAPH_RECALL_TOL), and
# the graph cell's configuration at GRAPH_ROWS rows, GRAPH_QUERIES queries
GRAPH_SAME, GRAPH_RECALL, GRAPH_RECALL_TOL = 8192, 16384, 0.005
GRAPH_ROWS, GRAPH_QUERIES, GRAPH_EF = 1_000_000, 10_000, 40
# the descent phase: the upper-layer hop budget (SearchParams' default),
# its small lattice graphs (partitions, rows a partition, dim, M) and their
# queries
DESCENT_HOPS = 32
DESCENT_SMALL = ((3, 400, 6, 4), (2, 400, 200, 20))
DESCENT_SMALL_QUERIES = 64
# a dependent load that hits L2, where the upper layers' rows stay: the
# pointer chase of scripts/torch_traversal_profile.py over 16 MiB, H100 SXM
L2_LOAD_S = 250.1e-9
# the graph cell's configuration and limits, as bench/run.py reads them
GRAPH_CONFIG = ROOT / "bench" / "configs" / "bigann-u8-hnsw-p4.json"
GRAPH_LIMITS = ROOT / "bench" / "workloads" / "hnsw-u8-q10k.json"
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
# the dense phase: qwen3-14b's main path at full width and depth (B prompts
# of T tokens, a cache of S positions, greedy decode steps), h2o-danube3-4b
# across its 4,096 window (B prompts of T = twice the window, decode steps
# past it), musicgen-large on its int8 cache (B x T embeddings); float32
# checks at full width and depth DENSE_F32_DEPTH; the width checks (arch,
# depth, the prefix lengths of (c) and (d)) at WIDTH_B x WIDTH_T, float32
QWEN_ARCH, QWEN_B, QWEN_T, QWEN_S, QWEN_STEPS = "qwen3_14b", 8, 2048, 2080, 32
SWA_ARCH, SWA_B, SWA_T, SWA_STEPS = "h2o_danube3_4b", 2, 8192, 32
MUSIC_ARCH, MUSIC_B, MUSIC_T, MUSIC_STEPS = "musicgen_large", 8, 2048, 32
DENSE_F32_DEPTH, WIDTH_B, WIDTH_T = 2, 2, 512
WIDTH_CHECKS = (("paligemma_3b", 2, (256, 0, 512)),
                ("granite_3_8b", 2, (None,)), ("minitron_8b", 2, (None,)),
                ("dbrx_132b", 1, (None,)))
# bf16 gates of (c) and (d) at full depth: (RMS |d| / RMS |logit| at most,
# share of rows whose greedy token is equal at least), by architecture.
# DeepSeek's from the readings above; qwen3's and danube's from
# scripts/torch_lm_gates.py --arch on seeds 0-7 (PERF.md §6): qwen3
# 0.0149-0.0192 without a fault, 0.1756 at least with one (non-causal,
# decode one position early, KV head h % KV); danube 0.0139-0.0175
# without, 0.0442 at least with those three, but 0.0198-0.0283 with its
# window one key too wide, which no bf16 gate here separates (the flash
# checks, where |out| is small against one bf16 spacing, and the float32
# checks hold the window). The greedy share separated nothing (0.5-1.0
# of the rows without a fault, up to 0.875 with one).
BF16_GATES = {LM_ARCH: (LM_TOL_BF16, LM_GREEDY_SHARE),
              QWEN_ARCH: (0.06, 0.25), SWA_ARCH: (0.028, 0.25)}
# the ssm phase: jamba-v0.1-52b at full width and JAMBA_PERIODS of its 4
# periods (all 4 are ~103 GB in bf16; 2 are 52.1 GB: PERF.md §4), B
# prompts of T tokens, a cache of S positions, greedy decode steps, the
# warm-up's prompt length; (d) over rows SSM_D_ROWS at a time (with no
# drops an expert's buffer holds all of a group's tokens: 30 GB of GLU
# activations at 8 rows); float32 at full width, JAMBA_F32 = (periods, B,
# T); xlstm-350m as configured, and the card-against-CPU check's prompt,
# XLSTM_CPU_BT = (B, T); both profiled prefills SSM_PROFILE_T tokens a row
# (the profiler takes ~60 us of host time an event to read back: xlstm's
# 512-step prefill, 112,049 kernels, took ~50 s of the phase)
JAMBA_ARCH, JAMBA_PERIODS, JAMBA_B, JAMBA_T = "jamba_v01_52b", 2, 8, 2048
JAMBA_S, JAMBA_STEPS, JAMBA_F32, SSM_D_ROWS, SSM_WARM_T = 2080, 32, \
    (1, 2, 512), 2, 64
XLSTM_ARCH, XLSTM_B, XLSTM_T, XLSTM_S, XLSTM_STEPS = "xlstm_350m", 8, 2048, \
    2080, 32
SSM_PROFILE_T, XLSTM_CPU_BT = 128, (2, 16)
# Their bf16 gates, from scripts/torch_lm_gates.py --arch on seeds 0-7
# (PERF.md §6). jamba: (c) with every router choice of prefill(256) +
# decode frozen to prefill(259)'s (`routed_invariant`; unfrozen, the
# choices that flip at bf16 rounding, 3 of 4,144 on seed 0, spread (c)
# over 0.0236-0.3556) 0.0231-0.0254 without a fault, 0.0493 at least with
# early, 0.240 with kvmod, 1.126 with stale or convshift: the gate 0.035
# (their geometric mean with early's); noncausal (0.0288-0.0319) is not
# separated (at random init attention averages ~2,048 keys, so its
# output is small), nor in (d) (the kernel checks at jamba's shapes hold
# the mask). (d) 0.0146-0.1202 without a fault, kvmod 0.2093 at least:
# BF16_D_TOL 0.16. xlstm: (c) 0.79-1.06 without a fault (the mLSTM
# read-out amplifies bf16 rounding), 1.19 at least with stale or
# convshift; early changes nothing (no layer reads the position); the
# greedy share separates nothing.
BF16_GATES.update({JAMBA_ARCH: (0.035, 0.25), XLSTM_ARCH: (1.12, 0.0)})
BF16_D_TOL = {JAMBA_ARCH: 0.16}
# xlstm's float32 checks at full width: one mLSTM layer and one sLSTM
# layer alone within the reference's 2e-3 (LM_TOL_F32); the whole model,
# whose mLSTM read-out C q / max(|n q|, exp(-m)) divides by n q near 0 at
# random init and so amplifies rounding through 21 layers (PERF.md §6),
# within XLSTM_F32_TOL. From scripts/torch_lm_gates.py --arch xlstm_350m
# --f32 on seeds 0-7, the least tol that |d| <= tol + tol |want| passes:
# (c) 0.00075-0.173 without a fault (early the same), 2.495 at least with
# stale or convshift; the card against the CPU 0.00104-0.0207, 2.372 at
# least with either fault on the card's side. Each limit is twice the
# largest sound reading, 7x and 56x below the faults'.
XLSTM_F32_TOL = {"(c)": 0.35, "cpu": 0.042}
# the train phase: deepseek-v2-lite-16b at full width, TRAIN_PERIODS MoE
# periods after its dense layer, B x T tokens a step in TRAIN_ACCUM
# microbatches, TRAIN_STEPS timed steps after one warm-up, (b)'s float32
# batch, (d)'s steps, (e)'s TrainLoop (steps, death, checkpoint keep)
TRAIN_PERIODS, TRAIN_B, TRAIN_T, TRAIN_ACCUM, TRAIN_STEPS = 2, 2, 4096, 2, 5
TRAIN_F32_BT, TRAIN_DET_STEPS, TRAIN_LOOP = (1, 512), 3, (8, 5, 2)
# (a) the flash op's gradients against autograd through the plain version
# over the whole sequence: |d| <= rel x |want| + abs x max |want|. The op
# recomputes a query block at a time through the same plain version, so
# dq is the same arithmetic and dk, dv sum a key's G x T rows (up to
# 20,480) by block, in another order: float32 within that rounding (an
# H100 80GB HBM3 at 700 W read 3e-6 and 4e-6 of max |want| at MLA's and
# qwen3's dk); bf16 one bf16 rounding of a float32 value that differs by
# that (one bf16 spacing of the largest entry; MLA read 1.5e-3)
TRAIN_GRAD_TOL = {torch.float32: (1e-5, 1e-5),
                  torch.bfloat16: (2.0 ** -7, 2.0 ** -8)}
# (a)'s cases: (name, (BH, BKV, T, hd, V's live columns), mask)
# the tools phase: (b)'s architectures (an MLA cache with MoE, GQA k / v,
# the recurrent mLSTM / sLSTM state) at phase 8's decode cell; the caching
# allocator's block rounding and its most slack a large block (alloc_bounds);
# (c)'s kNN-LM gates, card against CPU: the LM's float32 tolerance, the
# least share of each step's retrieved ids in common, and the top-2 margin
# of the mixed distribution above which the decoded token must be equal
TOOLS_ARCHS = ("deepseek_v2_lite_16b", "qwen3_14b", "xlstm_350m")
ALLOC_ROUND, ALLOC_SLACK = 512, 1 << 20
KNN_LM_TOL, KNN_ID_OVERLAP, KNN_MARGIN = 2e-3, 0.9, 1e-3
TRAIN_FLASH_CASES = (("MLA", (16, 16, 4096, 192, 128), {}),
                     ("qwen3", (40, 8, 4096, 128, 128), {}),
                     ("danube window", (32, 8, 5120, 120, 120),
                      {"window": 4096}),
                     ("paligemma prefix", (8, 1, 4096, 256, 256),
                      {"prefix_len": 256}))


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def src_env() -> dict:
    """This process's environment with the checkout's src/ on PYTHONPATH,
    for the subprocesses that run the port's CLIs."""
    import os

    path = os.pathsep.join(filter(None, (str(ROOT / "src"),
                                         os.environ.get("PYTHONPATH"))))
    return dict(os.environ, PYTHONPATH=path)


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

    data = np.rint(VectorDataset(n, 128).vectors()).astype(np.float32)
    return data, main_queries(n, n_queries)


def main_queries(n: int, n_queries: int):
    """`main_data`'s queries alone."""
    from repro_torch.data import VectorDataset

    return np.rint(np.clip(VectorDataset(n, 128).queries(n_queries), 0,
                           255)).astype(np.float32)


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


@contextlib.contextmanager
def descent_window(what: str, expected: int | None = None):
    """The card's upper-layer descents while the block runs, both counts
    from 0: core/search.py's `greedy_descent` calls on CUDA tensors (one a
    search_lanes call: a request of a one-index backend, a shard's or a
    mesh slot's part of one) and descent.cu's launches. On the way out:
    at least one descent, one launch each (no other route on the card),
    and `expected` descents where the caller knows them. Yields a dict
    whose "launches" is set on the way out."""
    from repro_torch.core import search as cs
    from repro_torch.kernels import descent as ds

    fn, lock, n = cs.greedy_descent, threading.Lock(), {"calls": 0}

    def counting(vectors, *args, **kw):
        if vectors.is_cuda:
            with lock:
                n["calls"] += 1
        return fn(vectors, *args, **kw)

    ds.DESCENT_LAUNCHES = 0
    cs.greedy_descent = counting
    try:
        yield n
    finally:
        cs.greedy_descent = fn
    n["launches"] = ds.DESCENT_LAUNCHES
    log(f"[{what}] descent.cu launches {n['launches']} for {n['calls']} "
        f"descents on the card")
    check(n["calls"] > 0, f"the {what} path made no descent on the card")
    check(n["launches"] == n["calls"],
          f"the {what} path launched descent.cu {n['launches']} times for "
          f"{n['calls']} descents")
    check(expected is None or n["calls"] == expected,
          f"the {what} path made {n['calls']} descents, expected {expected}")


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
    # one descent a request: serve_paths serves n_batches + 1 a rerank
    with descent_window("main", 2 * (n_batches + 1)) as descents:
        ids_by, st = serve_paths(svc, queries, gt, "main",
                                 {False: 0.95, True: 0.95})
    launches = check_traversal_launches("main", n_batches)
    check_fused_hops(svc, queries, "main")
    with tempfile.TemporaryDirectory() as tmp:
        svc.save(tmp)
        cpu = SearchService.load(tmp, device="cpu")
    check_cpu_copy(svc, cpu, queries[:BATCH], "main")
    take_adc_counts("main")
    return {"launches": launches, "descent_launches": descents["launches"],
            "gt": gt, "ids": ids_by, "qps": st[False]["qps"]}


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
    from repro_torch.kernels import ops
    from repro_torch.kernels import traversal as tr

    db = svc.backend.pdb.db
    P, _, d_pad = db.vectors.shape
    p = svc.backend.params(10, 40).resolve(db.l0_nbrs.shape[-1])
    q = cs.prepare_queries(queries, d_pad, db.vectors.device)
    B = q.shape[0]
    qsq = (q * q).sum(-1)
    # host clock around each stage of one batch (each ends synchronized)
    split = {}
    for _ in range(3):                     # the last of 3 repeats is kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ep, ep_d, _ = ops.greedy_descent(
            db.vectors, db.sqnorms, db.up_ptr, db.up_nbrs, db.entry,
            db.max_level, q, qsq, upper_hops=p.upper_hops, metric=p.metric)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cs.search_layer0(db.vectors, db.sqnorms, db.l0_nbrs, q, qsq, ep,
                         ep_d, p)
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
        cs.search_layer0(db.vectors, db.sqnorms, db.l0_nbrs, q, qsq, ep,
                         ep_d, p)
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
    n_batches = len(queries) // BATCH
    with descent_window(dtype, 2 * (n_batches + 1)) as descents:
        ids_by, _ = serve_paths(svc, queries, main_out["gt"], dtype, gate)
    launches = check_traversal_launches(dtype, n_batches)
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
    return {"launches": launches, "descent_launches": descents["launches"],
            "timing": timing}


def pq_split(svc, q) -> dict:
    """Host clock around the stages of one PQ partitioned batch (each ends
    synchronized): LUT build, upper-layer descent, hop-stepped layer 0."""
    from repro_torch.core import search as cs
    from repro_torch.kernels.descent import greedy_upper
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
        ep, ep_d, _ = greedy_upper(db.up_ptr, db.up_nbrs, db.entry,
                                   db.max_level, part, dist, p.upper_hops)
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
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.ann_dryrun",
         "--calibrated", metrics], cwd=ROOT, capture_output=True, text=True,
        env=src_env(), timeout=300)
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
    # one descent a batch the servers formed
    with descent_window("serve sweep") as descents:
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
    batches = sum(sum(st.batch_sizes.values()) for st in out["runs"].values())
    check(descents["calls"] == batches,
          f"the serve sweep made {descents['calls']} descents for {batches} "
          f"batches")
    out["descent_launches"] = descents["launches"]
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
    # every segment of a request its own descent
    with descent_window("ingest") as descents, SearchServer(
            svc, replicas=2, max_batch=BATCH,
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
    return {"launches": launches, "descent_launches": descents["launches"],
            "rows_s": rows_s, "seal_s": seal_s,
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
    traversal.cu not; in a `descent_window`, whose descent.cu launches
    `seen["descent"]` adds up. `seen["ldg"]` adds up traversal.cu's
    launches since the previous reset, so the phase's total stays
    checked. Returns (fn's result, traversal_async.cu's launches)."""
    from repro_torch.kernels import traversal as tr

    seen["ldg"] += tr.LAUNCHES
    tr.ASYNC_LAUNCHES = tr.LAUNCHES = 0
    with descent_window(f"cluster {what}") as descents:
        out = fn()
    seen["descent"] = seen.get("descent", 0) + descents["launches"]
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
            "descent_launches": seen["descent"], "runs": runs, "base": base, "profile": prof,
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


def exact_route_check(tabs) -> None:
    """The exact services (uint8 and int8) over the scan phase's 1M rows,
    one request of EXACT_QUERIES queries each, the benchmark's request
    shape: the split rule past the card's width (more query groups than
    CTAs, so S by the waves), one l2topk_q_tc launch and no FMA launch a
    request (the kernel route, `backends._scan_route`), ids and distances
    bitwise those of bruteforce_topk over the same codes, rescaled as the
    chunk loop rescales them."""
    from repro_torch.api import IndexSpec, SearchRequest, SearchService
    from repro_torch.core.bruteforce import bruteforce_topk
    from repro_torch.kernels import l2topk, qdist

    x = tabs["float32"][0].cpu().numpy()
    q = main_queries(N_SCAN, EXACT_QUERIES)
    for dt in ("uint8", "int8"):
        svc = SearchService.build(x, IndexSpec(backend="exact", dtype=dt),
                                  device=DEVICE)
        be = svc.backend
        check(torch.equal(be.vectors[:N_SCAN], tabs[dt][0]),
              f"the exact {dt} service's codes differ from the scan tables'")
        rows = be.vectors.shape[0]
        splits = l2topk.splits_for(EXACT_QUERIES, rows, SCAN_K,
                                   qdist._TC_CTAS)
        groups = -(-EXACT_QUERIES // 64)
        check(groups > qdist._TC_CTAS and splits == EXACT_SPLITS,
              f"{EXACT_QUERIES} queries ({groups} groups) over {rows} rows: "
              f"{splits} splits, expected the wave rule's {EXACT_SPLITS}")
        svc.search(SearchRequest(q, k=SCAN_K)).ids.cpu()    # the build
        before = scan_counts()
        t0 = time.perf_counter()
        resp = svc.search(SearchRequest(q, k=SCAN_K))
        ids, dists = resp.ids.cpu(), resp.dists.cpu()
        ms = (time.perf_counter() - t0) * 1e3
        moved = {k: v - before[k] for k, v in scan_counts().items()
                 if v != before[k]}
        check(moved == {"l2topk_q": 1}, f"the exact {dt} service launched "
                                        f"{moved}, expected one l2topk_q_tc")
        codes = torch.from_numpy(svc.quantizer.encode_f32(q)).to(DEVICE)
        want_i, want_d = bruteforce_topk(be.vectors, be.sqnorms, codes,
                                         k=SCAN_K, chunk=be.CHUNK)
        scale = float(np.float32(svc.quantizer.dist_scale))
        check(torch.equal(ids, want_i.cpu())
              and torch.equal(dists, (want_d * scale).cpu()),
              f"the exact {dt} service != bruteforce_topk on its codes")
        log(f"[scan] exact {dt} service, {EXACT_QUERIES} queries over "
            f"{N_SCAN} rows: one l2topk_q_tc launch of {groups} x {splits} "
            f"CTAs, ids and dists bitwise equal to bruteforce_topk; "
            f"{ms:.3f} ms on the host clock")
        del svc, be, want_i, want_d
    torch.cuda.empty_cache()


def exact_spans(tabs) -> dict:
    """The exact uint8 service over the scan phase's rows, one request of
    BATCH queries after an untraced one, the port's TRACER on: `search`
    with the children `encode`, `upload` and `scan`; scan's attrs equal to
    the backend's (the kernel route, rows padded by less than a chunk),
    encode's queries, upload's bytes (float32 codes, cast on the device);
    scan's CUDA event pair resolved (`dev_ms`); and, a third
    request under torch.profiler, the four spans as host ranges. Returns
    each span's host ms and scan's device ms."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import IndexSpec, SearchRequest, SearchService
    from repro_torch.obs import TRACER

    x, q = tabs["float32"][0], tabs["float32"][1]
    svc = SearchService.build(x.cpu().numpy(),
                              IndexSpec(backend="exact", dtype="uint8"),
                              device=DEVICE)
    req = SearchRequest(q[:BATCH].cpu().numpy(), k=SCAN_K)
    svc.search(req).ids.cpu()
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    try:
        svc.search(req).ids.cpu()
        spans = TRACER.spans()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            svc.search(req).ids.cpu()
        ranges = {e.name for e in prof.events()}
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()
    ids = {ev["id"]: ev["name"] for ev in spans}
    tree = {ev["name"]: ids.get(ev["parent"]) for ev in spans}
    check(len(spans) == 4 and tree == {"search": None, "encode": "search",
                                       "upload": "search", "scan": "search"},
          f"the exact service's spans {tree}: expected search > encode, "
          f"upload, scan")
    by = {ev["name"]: ev for ev in spans}
    be = svc.backend
    rows = be.vectors.shape[0]
    check(by["scan"]["attrs"] == {"route": "l2topk_q", "rows": rows,
                                  "queries": BATCH, "k": SCAN_K}
          and rows % be.CHUNK == 0 and 0 <= rows - N_SCAN < be.CHUNK,
          f"scan's attrs {by['scan']['attrs']}: expected the l2topk_q "
          f"route, {N_SCAN} rows padded to a multiple of {be.CHUNK}, "
          f"{BATCH} queries, k {SCAN_K}")
    check(by["encode"]["attrs"] == {"queries": BATCH}
          and by["upload"]["attrs"] == {"bytes": BATCH * x.shape[1] * 4},
          f"encode's / upload's counts {by['encode']['attrs']} / "
          f"{by['upload']['attrs']}: expected {BATCH} float32 queries")
    check(by["scan"].get("dev_ms", 0.0) > 0.0,
          f"scan's device clock unresolved: {by['scan']}")
    check(set(tree) <= ranges, f"the spans are not profiler ranges under "
          f"torch.profiler: {sorted(set(tree) - ranges)} missing")
    out = {n: (ev["t1"] - ev["t0"]) * 1e3 for n, ev in by.items()}
    out["scan_dev"] = by["scan"]["dev_ms"]
    log(f"[scan] exact uint8 service, {BATCH} queries over {N_SCAN} rows "
        f"(one l2topk_q_tc launch), by TRACER span, host ms: search "
        f"{out['search']:.3f} = encode {out['encode']:.3f} + upload "
        f"{out['upload']:.3f} + scan {out['scan']:.3f} (device "
        f"{out['scan_dev']:.3f}) + the rest "
        f"{out['search'] - out['encode'] - out['upload'] - out['scan']:.3f}"
        f"; the spans are profiler ranges")
    del svc
    torch.cuda.empty_cache()
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
    exact_route_check(tabs)
    exact_spans(tabs)
    return {name: {"launches": launches[name], "err": err[name],
                   "timing": timing[name]} for name in launches}


# ---------------------------------------------------------------------------
# phase 7b: the batched graph build (core/batch_build.py) and the graph cell
# ---------------------------------------------------------------------------


def graph_cfgs(p: int) -> list:
    """The partitions' HNSWConfigs of a P-partition build at the phase's
    M and ef_construction, as `build_partitioned_db` seeds them."""
    from repro_torch.core.hnsw_graph import HNSWConfig

    return [HNSWConfig(M=HNSW_M, ef_construction=HNSW_EFC, seed=i)
            for i in range(p)]


def graph_parts(n: int, p: int, seed: int) -> list:
    """The benchmark's uint8 rows of `seed` (bench/generator.py), n a
    partition, split as `build_partitioned_db` splits them."""
    from bench import generator

    x = generator.base_rows(n * p, seed)
    return [x[i * n:(i + 1) * n] for i in range(p)]


def cpu_graph_worker(n: int, seed: int, threads: int) -> list:
    """Worker process: the batched build of P_MAIN x n rows on the CPU
    (the plain traversal)."""
    from repro_torch.core.batch_build import build_graphs

    torch.set_num_threads(threads)
    return build_graphs(graph_parts(n, P_MAIN, seed), graph_cfgs(P_MAIN),
                        "cpu")


def host_graph_worker(n: int, seed: int, p: int):
    """Worker process: build_hnsw's graph of partition p of P_MAIN x n
    rows (numpy, one point at a time)."""
    from repro_torch.core.hnsw_graph import build_hnsw

    return build_hnsw(graph_parts(n, P_MAIN, seed)[p], graph_cfgs(P_MAIN)[p])


def graph_db(graphs, parts, device):
    """The stacked uint8 DeviceDB of `graphs` on `device`, as
    `PartitionedBackend.build` makes it."""
    from repro_torch.core import hnsw_graph as hg
    from repro_torch.core.partitioned import (build_partitioned_db,
                                              quantize_db_vectors)

    pdb = build_partitioned_db(np.concatenate(parts), len(parts),
                               graph_cfgs(1)[0], lambda *_: graphs)
    pdb = quantize_db_vectors(pdb, "uint8")
    return pdb._replace(db=hg.device_db(pdb.db, device))


def graph_recall(base, queries, ids) -> float:
    """recall@10 of `ids` against bench/reference/exact.py: a returned id
    counts when its exact distance is at most the exact 10th (ties)."""
    from bench.reference import exact

    _, gt_d = exact.exact_topk(base, queries, SCAN_K, DEVICE)
    d = exact.exact_dists(base, queries, ids, DEVICE)
    return float((d <= gt_d[:, SCAN_K - 1:]).sum() / ids.size)


def graph_spans(svc, built, queries) -> dict:
    """The spans of the 1M-row build (`built`: the tracer's spans of it)
    and of one traced request of the cell's shape: `build` > one `insert`
    a batch (`batch_schedule`), its rows summing to the index's, each on
    the device's clock; `search` > `encode`, `descend`, `layer0`, `merge`
    with their attrs against the backend (lanes P x B, the descent on the
    kernel route: 0 syncs, 1 launch; supersteps >= 1, P x k candidates),
    layer0's device clock resolved;
    and under torch.profiler the search spans as host ranges. Returns host
    and device ms."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import SearchRequest
    from repro_torch.core.batch_build import batch_schedule
    from repro_torch.obs import TRACER

    n = sum(int(v) for v in np.atleast_1d(svc.backend.pdb.db.n_valid.cpu()))
    p = svc.backend.pdb.num_partitions
    names = {ev["id"]: ev["name"] for ev in built}
    tree = {(ev["name"], names.get(ev["parent"])) for ev in built}
    ins = [ev for ev in built if ev["name"] == "insert"]
    (root,) = [ev for ev in built if ev["name"] == "build"]
    check(tree == {("build", None), ("insert", "build")}
          and root["attrs"] == {"backend": "partitioned-batched", "rows": n,
                                "partitions": p}
          and len(ins) == len(batch_schedule(-(-n // p)))
          and sum(ev["attrs"]["rows"] for ev in ins) == n
          and all(ev.get("dev_ms", 0.0) > 0.0 for ev in ins),
          f"the build's spans {sorted(tree)} ({len(ins)} inserts, root "
          f"{root['attrs']}): expected build > one insert a batch of "
          f"batch_schedule, rows summing to {n}, each with dev_ms")
    req = SearchRequest(queries, k=SCAN_K, ef=GRAPH_EF)
    svc.search(req).ids.cpu()
    TRACER.configure(enabled=True, sample_rate=1.0)
    TRACER.clear()
    try:
        svc.search(req).ids.cpu()
        spans = TRACER.spans()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            svc.search(req).ids.cpu()
        ranges = {e.name for e in prof.events()}
    finally:
        TRACER.configure(enabled=False)
        TRACER.clear()
    names = {ev["id"]: ev["name"] for ev in spans}
    tree = {ev["name"]: names.get(ev["parent"]) for ev in spans}
    check(len(spans) == 5 and tree == {
        "search": None, "encode": "search", "descend": "search",
        "layer0": "search", "merge": "search"},
          f"the graph search's spans {tree}: expected search > encode, "
          f"descend, layer0, merge")
    by = {ev["name"]: ev["attrs"] for ev in spans}
    lanes = p * len(queries)
    check(by["descend"] == {"lanes": lanes, "route": "kernel", "syncs": 0,
                            "launches": 1}
          and by["layer0"]["lanes"] == lanes
          and by["layer0"]["supersteps"] >= 1
          and by["merge"] == {"candidates": p * SCAN_K},
          f"the graph spans' attrs {by}: expected {lanes} lanes, the "
          f"descent on the kernel route (0 syncs, 1 launch), supersteps >= "
          f"1, {p * SCAN_K} candidates")
    layer0 = next(ev for ev in spans if ev["name"] == "layer0")
    check(layer0.get("dev_ms", 0.0) > 0.0,
          f"layer0's device clock unresolved: {layer0}")
    check(set(tree) <= ranges, f"the graph spans are not profiler ranges: "
          f"{sorted(set(tree) - ranges)} missing")
    out = {ev["name"]: (ev["t1"] - ev["t0"]) * 1e3 for ev in spans}
    out["layer0_dev"] = layer0["dev_ms"]
    out["insert_dev"] = sum(ev["dev_ms"] for ev in ins)
    out["inserts"] = len(ins)
    out["build"] = (root["t1"] - root["t0"]) * 1e3
    log(f"[graph] spans, host ms: search {out['search']:.3f} = encode "
        f"{out['encode']:.3f} + descend {out['descend']:.3f} (route "
        f"{by['descend']['route']}, {by['descend']['launches']} launch, "
        f"{by['descend']['syncs']} syncs) + "
        f"layer0 {out['layer0']:.3f} ({by['layer0']['supersteps']} "
        f"supersteps, device {out['layer0_dev']:.3f}) + merge "
        f"{out['merge']:.3f}; build {out['build']:.1f} = {len(ins)} inserts "
        f"(device {out['insert_dev']:.1f}) + the rest; the spans are "
        f"profiler ranges")
    return out


def graph_replay(svc, queries) -> dict:
    """One request of the cell's shape through the 1M-row service, its
    traversal checked superstep by superstep as the path runs it: the
    route at these shapes is traversal_async.cu's global-bitmap one, and
    from each launch's input state both fused_traversal_cuda and the plain
    fused_traversal_ref give the path's own output, every state tensor
    bitwise. The states are compared as they come, not kept: each holds a
    1.25 GB bitmap. Returns the supersteps and the lanes' hops."""
    from repro_torch.api import SearchRequest
    from repro_torch.core import search as cs
    from repro_torch.kernels import traversal as tr

    db = svc.backend.pdb.db
    P, n_pad, d_pad = db.vectors.shape
    p = svc.backend.params(SCAN_K, GRAPH_EF).resolve(db.l0_nbrs.shape[-1])
    lanes = P * len(queries)
    route = tr.traversal_route(db.vectors.dtype, d_pad, db.l0_nbrs.shape[-1],
                               p.cand_size, p.ef, n_pad)
    check(route == ("async", "global"),
          f"the graph cell's route gives {route} at N_pad {n_pad}, "
          f"{lanes} lanes: expected ('async', 'global')")
    names = ("cand_d", "cand_i", "fin_d", "fin_i", "visited", "hops",
             "calcs")
    orig = cs.fused_layer0
    seen = {"steps": 0, "lanes": 0}

    def checked(*args, **kw):
        tables, state = args[:5], args[5:]
        a = [t.clone() for t in state]
        r = [t.clone() for t in state]
        out = orig(*args, **kw)
        tr.fused_traversal_cuda(*tables, *a, **kw)
        tr.fused_traversal_ref(*tables, *r, **kw)
        seen["steps"] += 1
        seen["lanes"] = max(seen["lanes"], state[0].shape[0])
        bad = [n for n, x, y, z in zip(names, state, a, r)
               if not (torch.equal(x, z) and torch.equal(y, z))]
        check(not bad, f"superstep {seen['steps']} at the graph cell's "
              f"shapes ({state[0].shape[0]} lanes, N_pad {n_pad}, global "
              f"bitmap): the path, fused_traversal_cuda and "
              f"fused_traversal_ref differ in {bad}")
        return out

    cs.fused_layer0 = checked
    try:
        svc.search(SearchRequest(queries, k=SCAN_K, ef=GRAPH_EF)).ids.cpu()
    finally:
        cs.fused_layer0 = orig
    check(seen["lanes"] == lanes and seen["steps"] >= 1,
          f"the replay saw {seen}: expected {lanes} lanes")
    log(f"[graph] the cell's request ({lanes} lanes, N_pad {n_pad}, C "
        f"{p.cand_size}, EF {p.ef}, H {max(p.fused_hops, 1)}): route "
        f"{route}; {seen['steps']} supersteps, each bitwise equal across "
        f"the path, fused_traversal_cuda and fused_traversal_ref")
    return {"steps": seen["steps"]}


def graph_phase(seed: int) -> dict:
    """The batched build on the card: byte for byte the CPU build's at
    P_MAIN x GRAPH_SAME rows; recall at ef 40 within GRAPH_RECALL_TOL of
    build_hnsw's graph at P_MAIN x GRAPH_RECALL rows (10,000 queries); the
    benchmark cell's configuration (GRAPH_CONFIG: 1M rows,
    `partitioned-batched`, uint8, P_MAIN partitions) through
    SearchService.build, timed; its recall at the cell's request against
    bench/reference/exact.py, held to the cell's 1 - miss_share; the
    request's traversal replayed at its shapes (`graph_replay`); its
    spans."""
    from bench import generator

    from repro_torch.api import IndexSpec, SearchRequest, SearchService
    from repro_torch.core.batch_build import build_graphs
    from repro_torch.core.hnsw_graph import DeviceDB
    from repro_torch.core.partitioned import search_partitioned
    from repro_torch.core.search import SearchParams
    from repro_torch.kernels import traversal as tv
    from repro_torch.obs import TRACER

    t_phase = time.perf_counter()
    out = {}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1 + P_MAIN,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = pool.submit(cpu_graph_worker, GRAPH_SAME, seed, 4)
        hosts = [pool.submit(host_graph_worker, GRAPH_RECALL, seed, p)
                 for p in range(P_MAIN)]
        # the card build the CPU's must equal
        parts = graph_parts(GRAPH_SAME, P_MAIN, seed)
        a0 = tv.ASYNC_LAUNCHES
        t0 = time.perf_counter()
        card = build_graphs(parts, graph_cfgs(P_MAIN), DEVICE)
        out["same_card_s"] = time.perf_counter() - t0
        card_db = graph_db(card, parts, "cpu")
        # the cell's configuration, through the service
        base = generator.base_rows(GRAPH_ROWS, seed)
        queries = generator.query_pool(GRAPH_ROWS, 1, GRAPH_QUERIES, seed)[0]
        spec = IndexSpec.from_json(json.loads(GRAPH_CONFIG.read_text())[
            "spec"])
        miss = json.loads(GRAPH_LIMITS.read_text())["checks"]["miss_share"]
        TRACER.configure(enabled=True, sample_rate=1.0)
        TRACER.clear()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            svc = SearchService.build(base, spec, device=DEVICE)
            torch.cuda.synchronize()
            out["build_1m_s"] = time.perf_counter() - t0
            built = TRACER.spans()
        finally:
            TRACER.configure(enabled=False)
            TRACER.clear()
        out["build_peak_bytes"] = torch.cuda.max_memory_allocated()
        ids = svc.search(SearchRequest(queries, k=SCAN_K, ef=GRAPH_EF)
                         ).ids.cpu().numpy()
        out["recall_1m"] = graph_recall(base, queries, ids)
        log(f"[graph] {GRAPH_ROWS} uint8 rows, P={P_MAIN}, M={HNSW_M}, "
            f"ef_construction={HNSW_EFC}: SearchService.build "
            f"(partitioned-batched) {out['build_1m_s']:.2f}s, peak "
            f"{out['build_peak_bytes']} bytes; recall@10 at ef {GRAPH_EF} "
            f"on the cell's request of {GRAPH_QUERIES} queries "
            f"{out['recall_1m']:.5f} (the cell's floor {1 - miss:.3f})")
        check(out["build_1m_s"] <= 60.0,
              f"the 1M-row build took {out['build_1m_s']:.1f}s (> 60 s)")
        check(out["recall_1m"] >= 1 - miss,
              f"the 1M-row graph's recall@10 {out['recall_1m']:.5f} is below "
              f"the cell's floor 1 - miss_share = {1 - miss:.3f}")
        out["replay"] = graph_replay(svc, queries)
        out["spans"] = graph_spans(svc, built, queries)
        del svc
        torch.cuda.empty_cache()
        # the batched graph's recall against build_hnsw's, on the card
        big = graph_parts(GRAPH_RECALL, P_MAIN, seed)
        rows = np.concatenate(big)
        q = generator.query_pool(len(rows), 1, GRAPH_QUERIES, seed)[0]
        t0 = time.perf_counter()
        batched = build_graphs(big, graph_cfgs(P_MAIN), DEVICE)
        out["recall_card_s"] = time.perf_counter() - t0
        params = SearchParams(ef=GRAPH_EF, k=SCAN_K)
        qt = torch.as_tensor(q, dtype=torch.float32, device=DEVICE)
        got = search_partitioned(graph_db(batched, big, DEVICE), qt, params)
        out["recall_batched"] = graph_recall(rows, q, got[0].cpu().numpy())
        out["launches"] = tv.ASYNC_LAUNCHES - a0
        check(tv.LAUNCHES == 0, f"the graph phase launched traversal.cu "
              f"{tv.LAUNCHES} times")
        t0 = time.perf_counter()
        host = [f.result() for f in hosts]
        cpu_graphs = cpu.result()
        log(f"[graph] waited {time.perf_counter() - t0:.1f}s for the CPU "
            f"build and the host builds")
    want = search_partitioned(graph_db(host, big, DEVICE), qt, params)
    out["recall_host"] = graph_recall(rows, q, want[0].cpu().numpy())
    cpu_db = graph_db(cpu_graphs, parts, "cpu")
    same = [f for f in DeviceDB._fields
            if not torch.equal(getattr(card_db.db, f), getattr(cpu_db.db, f))]
    check(not same, f"the card build of {P_MAIN} x {GRAPH_SAME} rows differs "
          f"from the CPU build in {same}")
    log(f"[graph] the card build of {P_MAIN} x {GRAPH_SAME} uint8 rows "
        f"({out['same_card_s']:.2f}s) equals the CPU build byte for byte "
        f"(every table); at {P_MAIN} x {GRAPH_RECALL} rows, {GRAPH_QUERIES} "
        f"queries, ef {GRAPH_EF}: recall@10 batched "
        f"{out['recall_batched']:.5f} (card build "
        f"{out['recall_card_s']:.2f}s), build_hnsw {out['recall_host']:.5f}; "
        f"traversal_async.cu launches {out['launches']}; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    check(out["recall_batched"] >= out["recall_host"] - GRAPH_RECALL_TOL,
          f"the batched graph's recall {out['recall_batched']:.5f} is below "
          f"build_hnsw's {out['recall_host']:.5f} - {GRAPH_RECALL_TOL}")
    return out


# ---------------------------------------------------------------------------
# phase 7c: the upper-layer descent (csrc/descent.cu)
# ---------------------------------------------------------------------------


def descent_pair(args, metric: str, what: str) -> tuple:
    """The kernel through ops.greedy_descent (one launch counted) and the
    plain version greedy_descent_ref on the same operands (`args`: the
    stacked tables, the queries and their qsq): cur, cur_d and calcs
    bitwise equal. Returns the plain version's outputs and the largest
    |cur_d| difference measured."""
    from repro_torch.kernels import descent as ds
    from repro_torch.kernels import ops

    kw = dict(upper_hops=DESCENT_HOPS, metric=metric)
    n0 = ds.DESCENT_LAUNCHES
    got = ops.greedy_descent(*args, **kw)
    want = ds.greedy_descent_ref(*args, **kw)
    torch.cuda.synchronize()
    n = ds.DESCENT_LAUNCHES - n0
    check(n == 1, f"{what} {metric}: {n} descent.cu launches, expected 1")
    err = float(torch.where(got[1] == want[1], 0.0,
                            (got[1] - want[1]).abs()).max())
    bad = [name for name, a, b in zip(("cur", "cur_d", "calcs"), got, want)
           if not torch.equal(a, b)]
    check(not bad, f"{what} {metric}: descent.cu differs from the plain "
          f"version in {bad} (|cur_d| differs by up to {err})")
    return want, err


def descent_args(db, queries, dtype: str) -> tuple:
    """ops.greedy_descent's operands over a stacked uint8 DB's tables with
    its rows as `dtype` rows: uint8 as they are, float32 their values, int8
    shifted by -128 (signed codes), the queries likewise ([B, D_pad]
    float32 code values), the sqnorms those of the stored rows with the
    +inf pads kept."""
    v, sq, q = db.vectors, db.sqnorms, queries
    if dtype != "uint8":
        shift = -128.0 if dtype == "int8" else 0.0
        f = v.float() + shift
        sq = torch.where(torch.isinf(sq), sq, (f * f).sum(-1))
        v, q = f.to(getattr(torch, dtype)), q + shift
        del f
    return (v.contiguous(), sq.contiguous(), db.up_ptr, db.up_nbrs,
            db.entry, db.max_level, q.contiguous(), (q * q).sum(-1))


def descent_tries(args, metric: str) -> tuple:
    """Each lane's tried hops on its walk: greedy_upper's walk, counted
    lane by lane. A tried hop waits on two dependent loads, the neighbour
    row and then the rows, sqnorms and up_ptr it names. Returns (tries
    [L] int64, the walk's end [L])."""
    from repro_torch.kernels.traversal import metric_distance

    vectors, sqnorms, up_ptr, up_nbrs, entry, max_level, q, qsq = args
    P, B = vectors.shape[0], q.shape[0]
    lane = torch.arange(P * B, device=vectors.device)
    part, qrow = lane // B, lane % B
    rows, qd, qs = part[:, None], q[qrow][:, None, :], qsq[qrow][:, None]

    def distances(idx):
        dot = (vectors[rows, idx].float() * qd).sum(-1)
        return metric_distance(metric, dot, sqnorms[rows, idx], qs)

    cur = entry[part]
    cur_d = distances(cur.long()[:, None])[:, 0]
    tries = torch.zeros_like(lane)
    for layer in range(up_nbrs.shape[1], 0, -1):
        running = layer <= max_level[part]
        for _ in range(DESCENT_HOPS):
            if not bool(running.any()):
                break
            tries += running
            row = up_ptr[part, cur.long()]
            nbrs = up_nbrs[part, layer - 1, row.clamp_min(0).long()]
            valid = (nbrs >= 0) & (row >= 0)[:, None]
            safe = torch.where(valid, nbrs, torch.zeros_like(nbrs))
            d = torch.where(valid, distances(safe.long()), float("inf"))
            j = d.argmin(dim=1, keepdim=True)
            best_d, best = d.gather(1, j)[:, 0], safe.gather(1, j)[:, 0]
            running = running & (best_d < cur_d)
            cur = torch.where(running, best, cur)
            cur_d = torch.where(running, best_d, cur_d)
    return tries, cur


def descent_small(seed: int) -> float:
    """The kernel against the plain version on small lattice graphs
    (`DESCENT_SMALL`: rows of small integers, so distances tie often),
    float32 / uint8 / int8 rows under l2 / ip / cosine: a graph of 8-wide
    upper rows at D_pad 128, and one of 24-wide rows (two tiles) at D_pad
    256 (two blocks of each 8-bit row, eight of a float32 row). Returns
    the largest |cur_d| difference measured."""
    from repro_torch.core import hnsw_graph as hg
    from repro_torch.core.partitioned import (build_partitioned_db,
                                              quantize_db_vectors)

    g = np.random.default_rng(seed)
    worst = 0.0
    for p, n, dim, m in DESCENT_SMALL:
        rows = g.integers(0, 4, (p * n, dim)).astype(np.float32)
        pdb = quantize_db_vectors(build_partitioned_db(
            rows, p, hg.HNSWConfig(M=m, ef_construction=40)), "uint8")
        db = hg.device_db(pdb.db, DEVICE)
        q = torch.zeros((DESCENT_SMALL_QUERIES, db.vectors.shape[-1]),
                        device=DEVICE)
        q[:, :dim] = torch.from_numpy(g.integers(
            0, 4, (DESCENT_SMALL_QUERIES, dim)).astype(np.float32))
        what = (f"lattice graph P={p} x {n} rows, D={dim} (D_pad "
                f"{db.vectors.shape[-1]}), upper rows of "
                f"{db.up_nbrs.shape[-1]}, max_level "
                f"{db.max_level.tolist()}")
        for dtype in ("float32", "uint8", "int8"):
            args = descent_args(db, q, dtype)
            for metric in ("l2", "ip", "cosine"):
                worst = max(worst, descent_pair(args, metric,
                                                f"{what}, {dtype}")[1])
        log(f"[descent] {what}: descent.cu bitwise equal to the plain "
            f"version (cur, cur_d, calcs) for float32 / uint8 / int8 rows "
            f"under l2 / ip / cosine, {DESCENT_SMALL_QUERIES} queries")
    return worst


def descent_request(svc, queries) -> dict:
    """One request of the cell through the service with the kernel route
    (DESCENT_LAUNCHES exactly 1 a request) and again with the torch-op
    descent swapped in (core/search.py's `greedy_descent` pointed at the
    plain version: no launch): ids, distances, hops and dist_calcs
    bitwise equal. Then the request's host ms on each route, in turns."""
    from repro_torch.api import SearchRequest
    from repro_torch.core import search as cs
    from repro_torch.kernels import descent as ds

    req = SearchRequest(queries, k=SCAN_K, ef=GRAPH_EF, with_stats=True)
    kernel = cs.greedy_descent

    def served(fn):
        cs.greedy_descent = fn
        try:
            n0 = ds.DESCENT_LAUNCHES
            t0 = time.perf_counter()
            r = svc.search(req)
            out = (r.ids.cpu(), r.dists.cpu(), r.stats.hops.cpu(),
                   r.stats.dist_calcs.cpu())
            return out, ds.DESCENT_LAUNCHES - n0, \
                (time.perf_counter() - t0) * 1e3
        finally:
            cs.greedy_descent = kernel

    served(kernel)
    got, n_kernel, _ = served(kernel)
    want, n_plain, _ = served(ds.greedy_descent_ref)
    check((n_kernel, n_plain) == (1, 0),
          f"the cell's request launched descent.cu {n_kernel} times on the "
          f"kernel route and {n_plain} on the plain one (expected 1, 0)")
    bad = [name for name, a, b in zip(("ids", "dists", "hops", "dist_calcs"),
                                      got, want) if not torch.equal(a, b)]
    check(not bad, f"the cell's request on the kernel route differs from "
          f"the torch-op descent in {bad}")
    ms = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel") * 3:
        fn = kernel if name == "kernel" else ds.greedy_descent_ref
        ms[name].append(served(fn)[2])
    return {k: float(np.median(v)) for k, v in ms.items()}


def descent_phase(seed: int) -> dict:
    """The upper-layer descent kernel on the card: against the plain
    version (`greedy_descent_ref`, the lockstep torch ops of
    `greedy_upper`) bitwise on the small lattice graphs, and on the
    graph cell's 1M-row, 4-partition uint8 graph (GRAPH_CONFIG, built
    through SearchService.build) at its 40,000 lanes for uint8 and int8
    rows under l2 and float32 rows of the same values under l2 / ip /
    cosine; one request of the cell through the service on both routes
    (`descent_request`); the kernel's device time at the cell's shapes
    beside the plain version's and its floors: the bytes it must read
    once from device memory, and the chain of dependent loads its lanes
    wait on (`descent_tries`), the larger of which is its bound."""
    from bench import generator

    from repro_torch.api import IndexSpec, SearchService
    from repro_torch.core.search import prepare_queries
    from repro_torch.kernels import descent as ds
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    worst = descent_small(seed)
    base = generator.base_rows(GRAPH_ROWS, seed)
    queries = generator.query_pool(GRAPH_ROWS, 1, GRAPH_QUERIES, seed)[0]
    spec = IndexSpec.from_json(json.loads(GRAPH_CONFIG.read_text())["spec"])
    t0 = time.perf_counter()
    svc = SearchService.build(base, spec, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[descent] the graph cell's index ({GRAPH_ROWS} uint8 rows, P="
        f"{spec.num_partitions}): built in {time.perf_counter() - t0:.1f}s")
    db = svc.backend.pdb.db
    q = prepare_queries(queries.astype(np.float32), db.vectors.shape[-1],
                        DEVICE)
    lanes = db.vectors.shape[0] * len(queries)
    what = (f"the cell's graph ({lanes} lanes, N_pad {db.vectors.shape[1]}, "
            f"upper rows of {db.up_nbrs.shape[-1]}, max_level "
            f"{db.max_level.tolist()})")
    out = {}
    for dtype in ("uint8", "int8", "float32"):
        args = descent_args(db, q, dtype)
        for metric in (("l2",) if dtype != "float32"
                       else ("l2", "ip", "cosine")):
            want, err = descent_pair(args, metric, f"{what}, {dtype}")
            worst = max(worst, err)
        if dtype == "uint8":
            calcs = int(want[2].sum())
            cell_args, want_cur = args, want[0]
        del args
        torch.cuda.empty_cache()
    log(f"[descent] {what}: descent.cu bitwise equal to the plain version "
        f"for uint8 / int8 rows (l2) and float32 rows (l2 / ip / cosine); "
        f"{calcs / lanes:.2f} upper-layer evaluations a lane")
    out["err"] = worst
    out["request_ms"] = descent_request(svc, queries)
    kw = dict(upper_hops=DESCENT_HOPS, metric="l2")
    reps = 20

    def kernel_runs():
        return lambda: [ops.greedy_descent(*cell_args, **kw)
                        for _ in range(reps)]

    out["ms"] = profiled_ms(kernel_runs, reps, "descent",
                            "descent.cu at the cell's shapes")
    out["plain_ms"] = device_ms(
        lambda: ds.greedy_descent_ref(*cell_args, **kw), reps=3)
    out["plain_call_ms"] = median_ms(
        lambda: ds.greedy_descent_ref(*cell_args, **kw), reps=3)
    # the bytes read at least once: the upper-layer nodes' rows, sqnorms
    # and up_ptr, their non-empty neighbour rows, the queries and their
    # qsq, and the outputs (the evaluations' bytes, calcs x (row + 8),
    # come again and again from L2)
    row_bytes = db.vectors.shape[-1] * db.vectors.element_size()
    n_upper = int((db.up_ptr >= 0).sum())
    nbr_rows = int((db.up_nbrs >= 0).any(-1).sum())
    once = (n_upper * (row_bytes + 8) + nbr_rows * db.up_nbrs.shape[-1] * 4
            + cell_args[6].numel() * 4 + len(queries) * 4 + lanes * 12)
    out["bytes_ms"] = once / HBM_BYTES_PER_S * 1e3
    # the dependent loads: the entry's, then two a tried hop; a lane's
    # chain is the launch's floor, and so is every chain's sum over the
    # most warps (a warp a lane) the card holds at once
    tries, end = descent_tries(cell_args, "l2")
    check(torch.equal(end, want_cur),
          "descent_tries walked to other entries than the plain version")
    chain = 1 + 2 * tries
    props = torch.cuda.get_device_properties(0)
    warps = props.multi_processor_count \
        * props.max_threads_per_multi_processor // 32
    out["latency_ms"] = max(int(chain.max()), int(chain.sum()) / warps) \
        * L2_LOAD_S * 1e3
    out["bound_ms"] = max(out["bytes_ms"], out["latency_ms"])
    out["bound_by"] = ("latency" if out["latency_ms"] >= out["bytes_ms"]
                       else "bytes")
    out["calcs"] = calcs
    log(f"[descent] at the cell's shapes ({lanes} lanes, uint8, l2): "
        f"descent.cu {out['ms']:.4f} device ms a launch (profiler, mean of "
        f"{reps}); the plain version {out['plain_ms']:.3f} device ms "
        f"({out['plain_call_ms']:.3f} ms a call, CUDA events, host syncs "
        f"included); floors: bytes {out['bytes_ms']:.4f} ms ({once} B read "
        f"once at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: {n_upper} upper-layer "
        f"nodes, {nbr_rows} neighbour rows, the queries; the evaluations' "
        f"{calcs} x {row_bytes + 8} B come from L2), latency "
        f"{out['latency_ms']:.4f} ms (tried hops a lane mean "
        f"{float(tries.float().mean()):.2f}, max {int(tries.max())}; "
        f"{int(chain.sum())} dependent loads over {warps} warps, the longest "
        f"chain {int(chain.max())}, at {L2_LOAD_S * 1e9:.1f} ns a load); "
        f"|cur_d| differences measured: {worst}; the cell's request, host "
        f"ms (median of 6, in turns): kernel route "
        f"{out['request_ms']['kernel']:.3f}, torch-op descent "
        f"{out['request_ms']['plain']:.3f}; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    del svc, cell_args
    torch.cuda.empty_cache()
    return out


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


def profile_split(fn, ranges=("moe.experts", "mla.decode_attention")
                  ) -> dict:
    """Device ms of one call of fn by torch.profiler: the flash and router
    kernels by name, the `record_function` ranges `ranges` (by default the
    expert einsums and the decode attention) and the kernels launched in
    each (`launched`), the rest by difference; and the wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    def launched(e) -> int:
        return len(e.kernels) + sum(launched(c) for c in e.cpu_children)

    out["launched"] = {}
    for name in ranges:
        spans = [e for e in events
                 if e.name == name and e.device_type == DeviceType.CPU]
        out[name] = sum(e.device_time_total for e in spans) / 1e3
        out["launched"][name] = sum(launched(e) for e in spans)
    out["rest_ms"] = (out["device_ms"] - out["attention_ms"]
                      - out["router_ms"] - sum(out[n] for n in ranges))
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
                worst[key] = max(worst[key], topk_check(
                    key, fn, x, kk, want, what))
            log(f"[lm] (a) topk {list(x.shape)}, k={kk}, {what}: "
                f"{' and '.join(k for k, _ in routes)} values (signs "
                f"included) and ids bitwise equal to the plain version "
                f"({int((want[1] < 0).sum())} unfilled slots, (+inf, -1) "
                f"in both)")
    del big, odd
    return worst


def topk_check(key: str, fn, x, kk: int, want, what: str) -> float:
    """fn(x, kk), a topk kernel's wrapper, bitwise equal to the plain
    version's `want` (values, their signs, ids). Returns the largest
    |kernel - plain| over finite values (0)."""
    got = [t.to(want[0].device) for t in fn(x, kk)]
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
          and torch.equal(torch.signbit(got[0]), torch.signbit(want[0])),
          f"{key} kernel != plain on {what}, k={kk}")
    fin = torch.isfinite(want[0])
    return float((got[0][fin] - want[0][fin]).abs().max())


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


def lm_invariant(model, cfg, toks, prefix_len=None) -> list:
    """The reference's invariant (tests/test_models.py): prefill(T) then
    decode(T..T+2) against a prefill over T+3 tokens (or embeddings) at
    those positions, both with the prefix-LM's `prefix_len`; returns the
    (got, want) logits pairs [B, V] (or [B, heads, V]) of the four
    positions."""
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.models.transformer import (
        compute_logits,
        forward,
        init_cache,
    )

    b, n = toks.shape[:2]
    t = n - 3
    with torch.no_grad():
        hidden, _, _ = forward(model, cfg, toks, mode="prefill",
                               prefix_len=prefix_len)
        full = compute_logits(model, cfg, hidden)
    cache = init_cache(cfg, b, n, dtype=cfg.param_dtype, device=DEVICE)
    got, cache = prefill_step(model, {"inputs": toks[:, :t],
                                      "prefix_len": prefix_len}, cache, cfg)
    pairs = [(got[:, 0], full[:, t - 1])]
    for pos in range(t, n):
        got, cache = decode_step(model, toks[:, pos:pos + 1], cache, pos, cfg)
        pairs.append((got[:, 0], full[:, pos]))
    return pairs


def logit_gap(pairs, V: int) -> dict:
    """(got, want) logits pairs [..., V] (a row per leading index: [B, V],
    or [B, heads, V] with a row per head): the max |d| and max |want|, the
    RMS of d over the RMS of want, the rows whose greedy token is equal
    (`same` of `n`), and (wanted top-2 margin, row max |d|) of each row
    whose greedy token differs."""
    pairs = [(a.reshape(-1, a.shape[-1])[:, :V],
              b.reshape(-1, b.shape[-1])[:, :V]) for a, b in pairs]
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


def bf16_gate(gap: dict, arch: str = LM_ARCH, check: str = "(c)") -> bool:
    """The bf16 gate of `arch` for `check`, "(c)" or "(d)" (BF16_GATES;
    BF16_D_TOL where (d)'s tolerance is tighter): RMS |d| within its
    tolerance x RMS |logit|, the greedy token equal on its share of the
    rows, and a row's greedy token differing only where the wanted top-2
    margin is within twice that row's max |d|, where the difference itself
    can swap the two."""
    tol, share = BF16_GATES[arch]
    if check == "(d)":
        tol = BF16_D_TOL.get(arch, tol)
    return (gap["rms"] <= tol and gap["same"] >= share * gap["n"]
            and all(m <= 2 * r for m, r in gap["flips"]))


def compare_logits(what: str, pairs, V: int, tol, gate=None,
                   near_ties: bool = False) -> dict:
    """Log and gate (got, want) logits pairs [..., V]: bf16 (`tol` None) by
    `gate` (default `bf16_gate`); float32 |d| <= tol + tol |want| and
    every greedy token equal (with `near_ties`, equal but where the wanted
    top-2 margin is within twice the row's max |d|). Returns the
    `logit_gap`."""
    gap = logit_gap(pairs, V)
    pairs = [(a.reshape(-1, a.shape[-1])[:, :V],
              b.reshape(-1, b.shape[-1])[:, :V]) for a, b in pairs]
    tag = "" if what.startswith("[") else "[lm] "
    log(f"{tag}{what}: max |d logits| {gap['err']:.6f} (max |logit| "
        f"{gap['scale']:.3f}; ratio {gap['err'] / gap['scale']:.4f}), RMS "
        f"|d| / RMS |logit| {gap['rms']:.4f}, greedy token equal on "
        f"{gap['same']}/{gap['n']}"
        + (f"; (top-2 margin, row max |d|) where it differs: "
           + ", ".join(f"({m:.4f}, {r:.4f})" for m, r in gap["flips"])
           if gap["flips"] else ""))
    if tol is None:
        check((gate or bf16_gate)(gap), f"{what}: beyond its bf16 gate (RMS "
              f"ratio {gap['rms']:.4f}), greedy tokens equal on "
              f"{gap['same']}/{gap['n']}, or a differing greedy token "
              f"where its margin exceeds twice the row's difference: "
              f"{gap['flips']}")
    else:
        ok = all(bool(((a - b).abs() <= tol + tol * b.abs()).all())
                 for a, b in pairs)
        greedy = gap["same"] == gap["n"] or (
            near_ties and all(m <= 2 * r for m, r in gap["flips"]))
        check(ok and greedy, f"{what}: beyond {tol} or greedy tokens equal "
              f"on {gap['same']}/{gap['n']} only")
    return gap


def no_drop_config(cfg):
    """cfg with the MoE capacity raised so that no token is dropped: two
    runs that group or route tokens differently then differ by the tokens'
    own values, not by which tokens a full expert turns away."""
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def prefill_last(model, cfg, prompts, prefix_len=None, **swap):
    """The last position's logits [B, V] (or [B, heads, V]) of a prefill
    over `prompts` (no cache) with ops swapped as `swapped_ops` takes
    them."""
    from repro_torch.models.model import prefill_step

    with swapped_ops(**swap):
        return prefill_step(model, {"inputs": prompts,
                                    "prefix_len": prefix_len}, None,
                            cfg)[0][:, 0]


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
# 9. dense: the GQA attention layer and the seven attention architectures
# ---------------------------------------------------------------------------


def dense_config(arch: str, **replace):
    """`arch` as the port's registry gives it, fields replaced."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), **replace)


def dense_inputs(cfg, b: int, n: int, g):
    """b x n seeded inputs on the card: token ids, or N(0, 1) embeddings
    in the parameters' dtype where the config takes embeddings."""
    if cfg.embed_inputs:
        return torch.randint(0, cfg.vocab_size, (b, n), generator=g,
                             device=DEVICE)
    return torch.randn((b, n, cfg.d_model), generator=g, device=DEVICE).to(
        cfg.param_dtype)


def flash_counts() -> tuple:
    from repro_torch.kernels import attention

    return attention.TC_LAUNCHES, attention.FMA_LAUNCHES


def launch_counts() -> tuple:
    """(flash tensor-core, flash FMA, topk short-row, topk select_k.cu)
    launches so far."""
    from repro_torch.kernels import topk

    return flash_counts() + (topk.SHORT_LAUNCHES, topk.LAUNCHES)


def dense_main(model, cfg, prompts, steps: int, s_max: int, what: str,
               step_inputs=None, tag: str = "dense", warm_t=None) -> dict:
    """The main path of one architecture: a warm-up prefill (of the first
    `warm_t` positions, default all) and decode step, then, with the
    flash and topk launch counters set to 0 just before, a prefill_step
    of `prompts` into a cache of s_max positions and `steps` decode_steps
    (greedy tokens, or `step_inputs` embeddings [B, steps, d]), read just
    after. Checks the launches (a prefill: a tensor-core flash launch an
    attention layer and a short-row topk launch a MoE layer whose router
    takes the kernel; a decode step: the topk launches alone; no FMA
    flash, no select_k.cu) and finite logits; logs the times. Returns the
    times, launches, the decode logits of every step and the cache."""
    from repro_torch.kernels import attention, topk
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.models.transformer import init_cache

    b, t = prompts.shape[:2]
    V = cfg.vocab_size
    n_attn = sum(s.kind == "attn" for s in cfg.all_specs())
    n_moe = sum(s.ffn == "moe" for s in cfg.all_specs()) if (
        cfg.moe is not None and cfg.moe.router_use_kernel) else 0

    def next_input(logits, i):
        if step_inputs is not None:
            return step_inputs[:, i:i + 1]
        return logits[:, -1, :V].argmax(-1)[:, None]

    cache = init_cache(cfg, b, s_max, dtype=cfg.param_dtype, device=DEVICE)
    t0 = time.perf_counter()
    warm, cache = prefill_step(model, {"inputs": prompts[:, :warm_t]},
                               cache, cfg)
    decode_step(model, next_input(warm, 0), cache, warm_t or t, cfg)
    torch.cuda.synchronize()
    log(f"[{tag}] {what}: warm-up prefill ({warm.shape[0]} x "
        f"{prompts[:, :warm_t].shape[1]}) and decode step "
        f"{time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    attention.TC_LAUNCHES = attention.FMA_LAUNCHES = 0
    topk.SHORT_LAUNCHES = topk.LAUNCHES = 0
    t0 = time.perf_counter()
    logits, cache = prefill_step(model, {"inputs": prompts}, cache, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    per_prefill = launch_counts()
    x = next_input(logits, 0)
    steps_ms, outs, per_step = [], [], set()
    for i in range(steps):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = decode_step(model, x, cache, t + i, cfg)
        x = next_input(out, i + 1) if i + 1 < steps else None
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        per_step.add(tuple(a - c for a, c in zip(launch_counts(), before)))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(per_prefill == (n_attn, 0, n_moe, 0),
          f"{what}: a prefill launched (flash tensor-core, flash FMA, topk "
          f"short-row, topk select_k.cu) {per_prefill}, expected ({n_attn}, "
          f"0, {n_moe}, 0)")
    check(per_step == {(0, 0, n_moe, 0)}, f"{what}: a decode step launched "
          f"(flash tensor-core, flash FMA, topk short-row, topk select_k.cu) "
          f"{sorted(per_step)}, expected (0, 0, {n_moe}, 0)")
    heads = () if cfg.num_output_heads == 1 else (cfg.num_output_heads,)
    check(logits.shape == (b, 1, *heads, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :V]).all())
          and all(bool(torch.isfinite(o[..., :V]).all()) for o in outs),
          f"{what}: prefill / decode logits not finite or of the wrong "
          f"shape {tuple(logits.shape)}")
    st = np.array(steps_ms)
    log(f"[{tag}] {what}: prefill {b} x {t}: {prefill_ms:.2f} ms "
        f"({b * t / prefill_ms * 1e3:.1f} tokens/s); flash launches "
        f"{per_prefill[0]} tensor-core, {per_prefill[1]} FMA; topk "
        f"launches {per_prefill[2]} short-row, {per_prefill[3]} select_k.cu")
    log(f"[{tag}] {what}: decode {steps} steps of {b} at positions "
        f"{t}..{t + steps - 1} (cache {cache_positions(cfg, s_max)}): p50 "
        f"{np.percentile(st, 50):.3f} ms, p99 {np.percentile(st, 99):.3f} "
        f"ms a step, {b / np.percentile(st, 50) * 1e3:.1f} tokens/s at "
        f"p50; topk launches {n_moe} a step; peak memory "
        f"{peak / 2**30:.2f} GiB")
    return {"prefill_ms": prefill_ms, "steps_ms": steps_ms,
            "launches": launches[0], "fma_launches": launches[1],
            "topk_launches": launches[2], "topk_stream_launches": launches[3],
            "logits": logits, "outs": outs, "cache": cache, "peak": peak}


def cache_positions(cfg, s_max: int) -> str:
    if not any(s.kind == "attn" for s in cfg.pattern):
        return "recurrent state only"
    spec = next(s for s in cfg.pattern if s.kind == "attn")
    if spec.window:
        return (f"a ring buffer of {min(spec.window, s_max)} slots, "
                f"slot = position % {min(spec.window, s_max)}")
    return f"{s_max} positions{', int8' if cfg.kv_quant else ''}"


def dense_bf16_pairs(model, cfg, main, c_toks, **swap) -> dict:
    """The logits pairs of (c) and (d) in bf16 at full depth: (c)
    prefill(n) + decode x3 against prefill(n + 3) over `c_toks` [2, n +
    3]; (d) the prefill of `main` with the plain flash_attention against
    the kernel. `swap` (ops as `swapped_ops` takes them) runs the whole of
    (c) and replaces the plain version in (d), to put a fault in."""
    from repro_torch.kernels.attention import flash_attention_ref

    n = c_toks.shape[1] - 3
    with swapped_ops(**swap):
        c = lm_invariant(model, cfg, c_toks)
    d = [(prefill_last(model, cfg, main,
                       **(swap or {"flash_fn": flash_attention_ref})),
          prefill_last(model, cfg, main))]
    return {f"(c) bf16, full depth: prefill({n}) + decode x3 against "
            f"prefill({n + 3}), B=2": c,
            f"(d) bf16, full depth: the {main.shape[0]} x {main.shape[1]} "
            f"prefill with the plain flash_attention against the kernel": d}


def dense_bf16_checks(model, cfg, main, c_toks, arch: str) -> None:
    """(c) and (d) of `dense_bf16_pairs`, gated by the bf16 gate of
    `arch`."""
    for what, pairs in dense_bf16_pairs(model, cfg, main, c_toks).items():
        compare_logits(f"[dense] {cfg.name} {what}", pairs, cfg.vocab_size,
                       None, lambda gap: bf16_gate(gap, arch))


def dense_f32_checks(arch: str, depth: int, b: int, t: int, prefixes, g,
                     quant_gate: bool = False, **replace) -> float:
    """(c) and (d) in float32 at full width and `depth` layers, b x t, at
    each prefix length of `prefixes` ((c) at the first only), within the
    reference's LM_TOL_F32 with every greedy token equal; MoE with the
    capacity raised so that no token is dropped and the router through
    the topk kernel, (d) swapping its plain version too. With
    `quant_gate`, the int8-cache decode against the exact cache's at the
    reference's bar (tests/test_models.py): max |d| < 0.05 x max |logit|
    + 0.1. Returns the largest |d| of (d)."""
    import dataclasses

    from repro_torch.kernels.attention import flash_attention_ref
    from repro_torch.kernels.topk import topk_ref
    from repro_torch.models.transformer import init_params

    cfg = dense_config(arch, num_periods=depth, param_dtype=torch.float32,
                       **replace)
    if cfg.moe is not None:
        cfg = no_drop_config(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router_use_kernel=True)))
    V = cfg.vocab_size
    model = init_params(cfg, device=DEVICE, generator=g)
    x = dense_inputs(cfg, b, t + 3, g)
    what = f"{cfg.name} float32, depth {depth}"
    compare_logits(f"[dense] {what} (c): prefill({t}) + decode x3 against "
                   f"prefill({t + 3}), B={b}"
                   + (f", prefix {prefixes[0]}" if prefixes[0] is not None
                      else ""),
                   lm_invariant(model, cfg, x, prefixes[0]), V, LM_TOL_F32)
    err = 0.0
    for prefix in prefixes:
        plain = prefill_last(model, cfg, x[:, :t], prefix,
                             flash_fn=flash_attention_ref, topk_fn=topk_ref)
        gap = compare_logits(
            f"[dense] {what} (d): prefill({t})"
            + (f", prefix {prefix}" if prefix is not None else "")
            + " with the plain flash_attention"
            + (" and topk" if cfg.moe is not None else "")
            + " against the kernels",
            [(plain, prefill_last(model, cfg, x[:, :t], prefix))], V,
            LM_TOL_F32)
        err = max(err, gap["err"])
    if quant_gate:
        outs = {}
        for name, c in (("exact", dataclasses.replace(cfg, kv_quant=False)),
                        ("int8", dataclasses.replace(cfg, kv_quant=True))):
            pairs = lm_invariant(model, c, x)
            outs[name] = torch.stack([p for p, _ in pairs])
        d = float((outs["exact"] - outs["int8"])[..., :V].abs().max())
        scale = float(outs["exact"][..., :V].abs().max())
        log(f"[dense] {what}: the int8-cache prefill + decode x3 against "
            f"the exact cache's: max |d| {d:.5f}, max |logit| {scale:.4f}, "
            f"bar 0.05 x max |logit| + 0.1 = {0.05 * scale + 0.1:.4f}")
        check(0 < d < 0.05 * scale + 0.1, f"{what}: int8-cache decode beyond "
              f"the reference's bar: {d} against {0.05 * scale + 0.1}")
    del model, x
    torch.cuda.empty_cache()
    return err


def dense_flash_checks(g) -> float:
    """The flash kernels within FLASH_TOL of their plain version at the
    dense paths' shapes, each on the kernel `flash_attention_cuda` picks:
    qwen3's [320, 2048, 128] over [64, 2048, 128] causal and danube's
    [64, 8192, 120] over [16, 8192, 120] with its 4,096 window (tensor
    cores; and in float32 on FMAs), musicgen's [256, 2048, 64];
    paligemma's hd 256 with G = 8 and a prefix of 256 in float32 (FMA) and
    bf16; a prefill continuation with q_offset; and a case whose every row
    sees no key (window 4 at q_offset 40 over 16 keys: zeros). Returns the
    largest |kernel - plain|."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [((320, 64, 2048, 2048, 128), bf, {}, "tc"),
             ((64, 16, 8192, 8192, 120), bf, {"window": 4096}, "tc"),
             ((64, 16, 8192, 8192, 120), f32, {"window": 4096}, "fma"),
             ((256, 256, 2048, 2048, 64), bf, {}, "tc"),
             ((16, 2, 512, 512, 256), f32, {"prefix_len": 256}, "fma"),
             ((16, 2, 512, 512, 256), bf, {"prefix_len": 256}, "tc"),
             ((40, 8, 300, 300, 128), bf, {"q_offset": 1000, "window": 64},
              "tc"),
             ((10, 2, 16, 16, 128), bf, {"window": 4, "q_offset": 40}, "tc"),
             ((10, 2, 16, 16, 128), f32, {"window": 4, "q_offset": 40},
              "fma")]
    worst = 0.0
    for (bh, bkv, t, s, hd), dtype, kw, kernel in cases:
        q = torch.randn((bh, t, hd), generator=g, device=DEVICE).to(dtype)
        k, v = (torch.randn((bkv, s, hd), generator=g, device=DEVICE).to(
            dtype) for _ in range(2))
        worst = max(worst, flash_check(q, k, v, kw, kernel, "[dense]"))
        del q, k, v
    return worst


def flash_check(q, k, v, kw: dict, kernel: str, tag: str) -> float:
    """`flash_attention_cuda` on q, k, v with the mask `kw` within
    FLASH_TOL of its plain version, on the kernel `kernel` ("tc" or
    "fma"); rows with no live key 0. Logs and returns the max |d|."""
    from repro_torch.kernels import attention

    (bh, t, hd), (bkv, s, _), dtype = q.shape, k.shape, q.dtype
    before = flash_counts()
    got = attention.flash_attention_cuda(q, k, v, **kw).float()
    took = "tc" if flash_counts()[0] > before[0] else "fma"
    check(took == kernel, f"flash_attention at {[bh, bkv, t, s, hd]} "
          f"{dtype} {kw} took the {took} kernel, expected {kernel}")
    want = attention.flash_attention_ref(q, k, v, **kw).float()
    rel, absol = FLASH_TOL[dtype]
    tol = rel * torch.maximum(got.abs(), want.abs()) + absol
    d = float((got - want).abs().max())
    check(bool(((got - want).abs() <= tol).all()),
          f"flash_attention {kernel} kernel beyond the tolerance at "
          f"{[bh, bkv, t, s, hd]} {dtype} {kw}: max {d}")
    if kw.get("q_offset") == 40:
        check(not bool(got.any()), "flash_attention: rows with no live "
              "key are not 0")
    log(f"{tag} flash_attention, {kernel} kernel, q {[bh, t, hd]} over "
        f"k, v {[bkv, s, hd]} {dtype} {kw or 'causal'}: within {rel:g} "
        f"x |out| + {absol:g} of its plain version (max |d| {d:.3g})")
    return d


def live_pairs(t: int, window: int) -> int:
    """(query, key) pairs a causal prefill of t from position 0 scores."""
    if not window or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def dense_timing(g, reps: int = 5) -> dict:
    """The tensor-core kernel at qwen3's, danube's and musicgen's prefill
    shapes (CUDA events, median of `reps`), beside the FMA kernel on the
    same inputs, the plain version, one library call
    (scaled_dot_product_attention with enable_gqa: causal, or danube's
    window as a boolean mask; timed only)
    and the bound: q.k^T and three bf16 pieces of P.V over the pairs the
    mask leaves, at the bf16 tensor cores' rate, or the bytes of q, k, v
    and out. Danube's kernel also without its window."""
    import torch.nn.functional as F

    from repro_torch.kernels import attention

    out = {}
    for name, (b, h, kvh, t, hd, window) in (
            ("qwen3", (QWEN_B, 40, 8, QWEN_T, 128, 0)),
            ("danube", (SWA_B, 32, 8, SWA_T, 120, 4096)),
            ("musicgen", (MUSIC_B, 32, 32, MUSIC_T, 64, 0))):
        q = torch.randn((b * h, t, hd), generator=g, device=DEVICE).to(
            torch.bfloat16)
        k, v = (torch.randn((b * kvh, t, hd), generator=g,
                            device=DEVICE).to(torch.bfloat16)
                for _ in range(2))
        q4, k4, v4 = (x.view(b, -1, t, hd) for x in (q, k, v))
        kw = {"window": window}
        if window:
            rows = torch.arange(t, device=DEVICE)
            mask = (rows[None, :] <= rows[:, None]) & (
                rows[None, :] > rows[:, None] - window)
            lib = {"attn_mask": mask}
        else:
            lib = {"is_causal": True}
        r = {"ms": median_ms(lambda: attention.flash_attention_tc_cuda(
                 q, k, v, **kw), reps),
             "fma_ms": median_ms(lambda: attention.flash_attention_fma_cuda(
                 q, k, v, **kw), reps),
             "plain_ms": median_ms(lambda: attention.flash_attention_ref(
                 q, k, v, **kw), reps),
             "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                 q4, k4, v4, enable_gqa=True, **lib), reps)}
        if window:
            r["full_ms"] = median_ms(
                lambda: attention.flash_attention_tc_cuda(q, k, v), reps)
        pairs = live_pairs(t, window)
        qk = 2.0 * b * h * hd * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        r["bound_ms"], r["bound_by"] = bound(nbytes, 4 * qk, BF16_FLOPS)
        r["shape"] = f"q [{b * h}, {t}, {hd}], k, v [{b * kvh}, {t}, {hd}]"
        log(f"[dense] timing flash_attention {r['shape']} bf16 causal"
            + (f", window {window}" if window else "")
            + f" (one {name} prefill layer), CUDA events: tensor-core kernel "
            f"{r['ms']:.4f} ms, FP32-FMA kernel {r['fma_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library (scaled_dot_product_attention"
            f", enable_gqa{', a boolean mask' if window else ''}) "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {qk / 1e9:.1f} GFLOP q.k^T + 3 x "
            f"{qk / 1e9:.1f} GFLOP P.V over {pairs:,} pairs a head at "
            f"989 TFLOP/s; {nbytes / 1e6:.0f} MB "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)"
            + (f"; without the window {r['full_ms']:.4f} ms (window / full "
               f"{r['ms'] / r['full_ms']:.3f}; pairs "
               f"{pairs / live_pairs(t, 0):.3f})" if window else ""))
        out[name] = r
        del q, k, v, q4, k4, v4, lib
        torch.cuda.empty_cache()
    return out


def dense_phase(seed: int) -> dict:
    """9. qwen3-14b's main path, h2o-danube3-4b across its window,
    musicgen-large on its int8 cache, and the width checks."""
    from repro_torch.models.model import decode_step
    from repro_torch.models.transformer import init_params

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    launches, t_phase = 0, time.perf_counter()

    def draw(cfg):
        t0 = time.perf_counter()
        model = init_params(cfg, device=dev, generator=g)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in model.parameters())
        log(f"[dense] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads}:{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n / 1e9:.3f} B parameters "
            f"({n * 2 / 1e9:.2f} GB bf16) drawn on the card in "
            f"{time.perf_counter() - t0:.1f}s")
        return model

    # (a) qwen3-14b at full width and depth: the slice's main path
    cfg = dense_config(QWEN_ARCH)
    model = draw(cfg)
    prompts = dense_inputs(cfg, QWEN_B, QWEN_T, g)
    run = dense_main(model, cfg, prompts, QWEN_STEPS, QWEN_S, cfg.name)
    launches += run["launches"]
    qwen = {"prefill_ms": run["prefill_ms"], "steps_ms": run["steps_ms"]}
    del run
    dense_bf16_checks(model, cfg, prompts, prompts[:2, :LM_C_T + 3],
                      QWEN_ARCH)
    del model, prompts
    torch.cuda.empty_cache()
    dense_f32_checks(QWEN_ARCH, DENSE_F32_DEPTH, 2, LM_C_T, (None,), g)

    # (b) h2o-danube3-4b across its window: a prefill of twice the window,
    # decode past it (the ring wraps), (c) across the window
    cfg = dense_config(SWA_ARCH)
    window = cfg.pattern[0].window
    model = draw(cfg)
    prompts = dense_inputs(cfg, SWA_B, SWA_T + 3, g)
    run = dense_main(model, cfg, prompts[:, :SWA_T], SWA_STEPS,
                     SWA_T + SWA_STEPS, cfg.name)
    ring = run["cache"]["periods"]["0"]["k"].shape[2]
    check(ring == window < SWA_T, f"{cfg.name}: a ring buffer of {ring} "
          f"slots, expected the window {window} < T {SWA_T}")
    log(f"[dense] {cfg.name}: every row past {window} of the {SWA_T}-token "
        f"prefill is cut by the window; decode writes slots "
        f"{SWA_T % ring}..{(SWA_T + SWA_STEPS - 1) % ring} of {ring} (the "
        f"ring wrapped at position {ring})")
    launches += run["launches"]
    swa = {"prefill_ms": run["prefill_ms"], "steps_ms": run["steps_ms"]}
    del run
    dense_bf16_checks(model, cfg, prompts[:, :SWA_T], prompts, SWA_ARCH)
    del model, prompts
    torch.cuda.empty_cache()
    dense_f32_checks(SWA_ARCH, DENSE_F32_DEPTH, 2, SWA_T, (None,), g)

    # (c) musicgen-large as configured: the int8 cache, embedded inputs,
    # four output heads; against the same run on the exact cache (logged)
    cfg = dense_config(MUSIC_ARCH)
    model = draw(cfg)
    emb = dense_inputs(cfg, MUSIC_B, MUSIC_T + MUSIC_STEPS, g)
    runs = {}
    for name, c in (("int8", cfg), ("exact", dense_config(MUSIC_ARCH,
                                                          kv_quant=False))):
        runs[name] = dense_main(model, c, emb[:, :MUSIC_T], MUSIC_STEPS,
                                MUSIC_T + MUSIC_STEPS,
                                f"{cfg.name} ({name} cache)",
                                step_inputs=emb[:, MUSIC_T:])
        if name == "int8":
            # one more step at the cache's last position
            split = profile_split(lambda: decode_step(
                model, emb[:, -1:], runs["int8"]["cache"],
                emb.shape[1] - 1, c),
                ("attn.dequant_kv", "attn.decode_attention"))
            log(f"[dense] {cfg.name}: one int8-cache decode step (B="
                f"{MUSIC_B}, {MUSIC_T + MUSIC_STEPS} positions) by "
                f"torch.profiler: dequantizing the whole cache "
                f"{split['attn.dequant_kv']:.3f} ms, the decode attention "
                f"{split['attn.decode_attention']:.3f} ms, device busy "
                f"{split['device_ms']:.3f} of {split['wall_ms']:.3f} ms wall")
        runs[name].pop("cache")
    launches += runs["int8"]["launches"]
    d = max(float((a - b)[..., :cfg.vocab_size].abs().max())
            for a, b in zip(runs["int8"]["outs"], runs["exact"]["outs"]))
    scale = max(float(b[..., :cfg.vocab_size].abs().max())
                for b in runs["exact"]["outs"])
    log(f"[dense] {cfg.name} bf16, full depth: {MUSIC_STEPS} decode steps on "
        f"the int8 cache against the exact cache: max |d logits| {d:.4f}, "
        f"max |logit| {scale:.4f} (ratio {d / scale:.4f}; printed, not "
        f"gated: the reference's bar is read on 2 float32 layers)")
    music = {"prefill_ms": runs["int8"]["prefill_ms"],
             "steps_ms": runs["int8"]["steps_ms"],
             "exact_steps_ms": runs["exact"]["steps_ms"]}
    del model, emb, runs
    torch.cuda.empty_cache()
    # (c) within 2e-3 on the exact cache; the int8 cache at the
    # reference's bar against it
    dense_f32_checks(MUSIC_ARCH, DENSE_F32_DEPTH, 2, LM_C_T, (None,), g,
                     quant_gate=True, kv_quant=False)

    # (d) the width checks, float32 at full width
    for arch, depth, prefixes in WIDTH_CHECKS:
        dense_f32_checks(arch, depth, WIDTH_B, WIDTH_T, prefixes, g)

    err = dense_flash_checks(g)
    timing = dense_timing(g)
    log(f"[dense] phase {time.perf_counter() - t_phase:.1f}s")
    return {"launches": launches, "err": err, "timing": timing,
            "qwen": qwen, "swa": swa, "music": music}


# ---------------------------------------------------------------------------
# 10. ssm: the recurrent layers, jamba-v0.1-52b and xlstm-350m
# ---------------------------------------------------------------------------

SSM_RANGES = ("ssm.scan", "moe.experts", "attn.decode_attention")


def ssm_config(arch: str, **replace):
    """`arch` as the port's registry gives it, fields replaced, its router
    (if it has one) through the topk kernel."""
    import dataclasses

    cfg = dense_config(arch, **replace)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_use_kernel=True))


def log_ssm_split(what: str, s: dict) -> None:
    log(f"[ssm] split of {what} (torch.profiler, device ms): recurrent scans "
        f"{s['ssm.scan']:.3f} ({s['launched']['ssm.scan']} kernels launched "
        f"in them), flash attention kernel {s['attention_ms']:.3f}, decode "
        f"attention {s['attn.decode_attention']:.3f}, router topk kernel "
        f"{s['router_ms']:.3f}, expert einsums {s['moe.experts']:.3f}, rest "
        f"{s['rest_ms']:.3f}; device busy {s['device_ms']:.3f} of "
        f"{s['wall_ms']:.3f} wall (idle share "
        f"{1 - s['device_ms'] / s['wall_ms']:.3f}), {s['kernels']} kernels")


def router_rows(b: int, t: int):
    """[b, t]: the row of each token's routing in `moe_apply`'s router
    input, whose tokens are grouped as the reference groups them."""
    from repro_torch.models.moe import _factor_groups

    gb, gt = _factor_groups(b, t)
    return torch.arange(b * t).reshape(gb, gt, b // gb, t // gt).permute(
        0, 2, 1, 3).reshape(b, t)


def routed_invariant(model, cfg, toks) -> tuple:
    """`lm_invariant` over toks [B, n + 3] with every router choice of
    prefill(n) + decode x3 taken from prefill(n + 3)'s for the same token
    and layer: a top-k that flips at bf16 rounding moves a token's whole
    expert output, so without this (c) measures the flips, not the two
    paths. The choices are the current `ops.topk`'s (the kernel, or a
    swapped version), and the gates are the decode path's own softmax
    values at them. Returns (pairs, flips, choices): how many of the
    decode path's token-layer choices its own top-k would have made
    otherwise, of all. Without MoE, lm_invariant's pairs, 0, 0."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import forward

    if cfg.moe is None:
        return lm_invariant(model, cfg, toks), 0, 0
    b, full = toks.shape[:2]
    n_moe = sum(s.ffn == "moe" for s in cfg.all_specs())
    topk_fn, recorded, calls, flips = ops.topk, [], [0], [0, 0]

    def record(x, k):               # each layer's choices [b, full, k]
        neg, idx = topk_fn(x, k)
        rows = router_rows(b, full).reshape(-1).to(x.device)
        recorded.append(idx[rows].reshape(b, full, k))
        return neg, idx

    def replay(x, k):
        i, t = calls[0], x.shape[0] // b
        calls[0] += 1
        # lm_invariant's router calls, n_moe a pass: its prefill over all
        # the tokens, prefill(full - 3), then one decode step a pass
        start = 0 if i < 2 * n_moe else full - 3 + i // n_moe - 2
        want = recorded[i % n_moe][:, start:start + t].reshape(-1, k)
        idx = torch.empty_like(want)
        idx[router_rows(b, t).reshape(-1).to(x.device)] = want
        if i >= n_moe:
            own = topk_fn(x, k)[1]
            flips[0] += int((own.sort(-1).values != idx.sort(-1).values)
                            .any(-1).sum())
            flips[1] += x.shape[0]
        return x.gather(1, idx.long()), idx

    with torch.no_grad(), swapped_ops(topk_fn=record):
        forward(model, cfg, toks, mode="prefill")
    with swapped_ops(topk_fn=replay):
        pairs = lm_invariant(model, cfg, toks)
    check(len(recorded) == n_moe and calls[0] == 5 * n_moe,
          f"routed_invariant: {len(recorded)} and {calls[0]} router calls, "
          f"expected {n_moe} and {5 * n_moe}")
    return pairs, flips[0], flips[1]


def jamba_kernel_checks(model, cfg, prompts, cache) -> dict:
    """jamba's two kernels against their plain versions on the inputs its
    path gives them: a prefill of `prompts` (no cache) and a decode step
    on `cache` at position T, with ops.flash_attention and ops.topk
    wrapped to keep each call's inputs; then every attention layer's q, k,
    v through `flash_check` (bf16, causal, the tensor-core kernel) and
    every router call's rows ([B*T, 16] and [B, 16], k = 2; the short-row
    kernel leaves 16 of each warp's 32 lanes without a column) through
    `topk_check`. These launches come after the path's counts were read.
    Returns each kernel's largest |kernel - plain|."""
    from repro_torch.kernels import ops, topk
    from repro_torch.models.model import decode_step, prefill_step

    flash_fn, topk_fn, seen = ops.flash_attention, ops.topk, []

    def flash(q, k, v, **kw):
        seen.append(("flash", (q, k, v), kw))
        return flash_fn(q, k, v, **kw)

    def router(x, k):
        seen.append(("topk", x, k))
        return topk_fn(x, k)

    b, t = prompts.shape
    with torch.no_grad(), swapped_ops(topk_fn=router, flash_fn=flash):
        logits = prefill_step(model, {"inputs": prompts}, None, cfg)[0]
        decode_step(model, logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None],
                    cache, t, cfg)
    del logits
    n_attn = sum(s.kind == "attn" for s in cfg.all_specs())
    n_moe = sum(s.ffn == "moe" for s in cfg.all_specs())
    kinds = [c[0] for c in seen]
    check(kinds.count("flash") == n_attn and kinds.count("topk") == 2 * n_moe,
          f"{cfg.name}: a prefill and a decode step called flash "
          f"{kinds.count('flash')} and topk {kinds.count('topk')} times, "
          f"expected {n_attn} and {2 * n_moe}")
    worst = {"flash_attention": 0.0, "topk": 0.0}
    for kind, x, arg in seen:     # arg: flash's mask, the router's k
        if kind == "flash":
            worst["flash_attention"] = max(worst["flash_attention"],
                                           flash_check(*x, arg, "tc", "[ssm]"))
            continue
        check(topk.takes_short_rows(x.shape[1], arg),
              f"{cfg.name}: router rows {list(x.shape)}, k={arg} not short")
        worst["topk"] = max(worst["topk"], topk_check(
            "topk", topk.topk_short_cuda, x, arg, topk.topk_ref(x, arg),
            f"{cfg.name}'s router rows"))
    shapes = sorted({tuple(x.shape) for kind, x, _ in seen if kind == "topk"})
    log(f"[ssm] {cfg.name}: topk short-row kernel values (signs included) "
        f"and ids bitwise equal to the plain version on all {2 * n_moe} "
        f"router calls of a prefill and a decode step, rows "
        f"{', '.join(str(list(r)) for r in shapes)}, k={cfg.moe.top_k}")
    del seen
    return worst


def ssm_bf16_pairs(model, cfg, main, c_toks, **swap) -> dict:
    """The logits pairs of (c) and (d) in bf16 at the phase's depth, the
    MoE capacity raised so that no token is dropped: (c) prefill(n) +
    decode x3 against prefill(n + 3) over `c_toks` [2, n + 3]; (d), where
    the model runs a kernel (flash attention, the router's topk), the
    prefill of `main` with the plain versions against the kernels, over
    SSM_D_ROWS rows at a time. `swap` (ops as `swapped_ops` takes them)
    runs the whole of (c) and replaces the plain versions in (d), to put a
    fault in."""
    from repro_torch.kernels.attention import flash_attention_ref
    from repro_torch.kernels.topk import topk_ref

    if cfg.moe is not None:
        cfg = no_drop_config(cfg)
    n = c_toks.shape[1] - 3
    with swapped_ops(**swap):
        c, flips, choices = routed_invariant(model, cfg, c_toks)
    frozen = (f", routing frozen to prefill({n + 3})'s (the decode path's "
              f"own top-{cfg.moe.top_k} differs on {flips} of {choices} "
              f"token-layer choices)" if cfg.moe is not None else "")
    out = {f"(c) bf16, depth {cfg.num_layers}: prefill({n}) + decode x3 "
           f"against prefill({n + 3}), B=2, no drops{frozen}": c}
    if any(s.kind == "attn" for s in cfg.all_specs()):
        plain = swap or {"flash_fn": flash_attention_ref, "topk_fn": topk_ref}
        rows = main.split(SSM_D_ROWS)
        d = [(torch.cat([prefill_last(model, cfg, r, **plain) for r in rows]),
              torch.cat([prefill_last(model, cfg, r) for r in rows]))]
        out[f"(d) bf16, depth {cfg.num_layers}: the {main.shape[0]} x "
            f"{main.shape[1]} prefill ({SSM_D_ROWS} rows at a time) with the "
            f"plain flash_attention and topk against the kernels, no "
            f"drops"] = d
    return out


def device_pairs(model, cfg, toks, fault=contextlib.nullcontext) -> list:
    """prefill(T - 2) + decode x2 over toks [B, T] on the card (under
    `fault`, a context) and on the CPU for the same weights, the model
    moved there and back: the (card, CPU) logits pairs [B, V]."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_cache

    b, t = toks.shape[0], toks.shape[1] - 2
    logits = []
    for dev, ctx in ((DEVICE, fault), ("cpu", contextlib.nullcontext)):
        model.to(dev)
        x = toks.to(dev)
        with ctx():
            cache = init_cache(cfg, b, t + 2, device=dev)
            out, cache = M.prefill_step(model, {"inputs": x[:, :t]}, cache,
                                        cfg)
            got = [out]
            for pos in (t, t + 1):
                out, cache = M.decode_step(model, x[:, pos:pos + 1], cache,
                                           pos, cfg)
                got.append(out)
        logits.append([o[:, 0].cpu() for o in got])
    model.to(DEVICE)
    return list(zip(*logits))


def xlstm_f32_checks(g) -> None:
    """xlstm-350m in float32 at full width: one mLSTM layer and one sLSTM
    layer alone, each within LM_TOL_F32, then the whole model within
    XLSTM_F32_TOL; each (c) prefill(LM_C_T) + decode x3 against
    prefill(LM_C_T + 3), B=2, and the card's prefill + decode x2 against
    the port's on the CPU over an XLSTM_CPU_BT prompt; every greedy token
    equal but near ties."""
    import dataclasses

    from repro_torch.models.transformer import LayerSpec, init_params

    full = ssm_config(XLSTM_ARCH, param_dtype=torch.float32)
    b, t = XLSTM_CPU_BT
    for kind in ("mlstm", "slstm", None):
        cfg = full if kind is None else dataclasses.replace(
            full, pattern=(LayerSpec(kind, "none"),), num_periods=1)
        tol = XLSTM_F32_TOL if kind is None else {
            "(c)": LM_TOL_F32, "cpu": LM_TOL_F32}
        what = (f"full depth ({cfg.num_layers} layers)" if kind is None
                else f"one {kind} layer")
        model = init_params(cfg, device=DEVICE, generator=g)
        x = dense_inputs(cfg, 2, LM_C_T + 3, g)
        compare_logits(f"[ssm] {cfg.name} float32, {what}, (c): prefill("
                       f"{LM_C_T}) + decode x3 against prefill({LM_C_T + 3}),"
                       f" B=2, within {tol['(c)']:g}",
                       lm_invariant(model, cfg, x), cfg.vocab_size,
                       tol["(c)"], near_ties=True)
        x = dense_inputs(cfg, b, t + 2, g)
        compare_logits(f"[ssm] {cfg.name} float32, {what}: prefill({t}) + "
                       f"decode x2 on the card against the port on the CPU, "
                       f"B={b}, within {tol['cpu']:g}",
                       device_pairs(model, cfg, x), cfg.vocab_size,
                       tol["cpu"], near_ties=True)
        del model, x
        torch.cuda.empty_cache()


def ssm_phase(seed: int) -> dict:
    """10. jamba-v0.1-52b at full width (JAMBA_PERIODS of its 4 periods)
    and xlstm-350m as configured, each through prefill and decode."""
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.models.transformer import init_params

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    t_phase = time.perf_counter()

    def draw(cfg):
        t0 = time.perf_counter()
        model = init_params(cfg, device=dev, generator=g)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in model.parameters())
        kinds = {k: sum(s.kind == k for s in cfg.all_specs())
                 for k in ("attn", "mamba", "mlstm", "slstm")}
        log(f"[ssm] {cfg.name}: {cfg.num_layers} layers "
            f"({', '.join(f'{v} {k}' for k, v in kinds.items() if v)}), d "
            f"{cfg.d_model}, vocab {cfg.vocab_size}, {n / 1e9:.3f} B "
            f"parameters ({n * torch.finfo(cfg.param_dtype).bits / 8e9:.2f} "
            f"GB) drawn on the card in {time.perf_counter() - t0:.1f}s")
        return model

    def profiled(model, cfg, prompts, run, t_prof):
        tok = run["logits"][:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        b, t_prof = prompts.shape[0], min(t_prof, prompts.shape[1])
        pre = profile_split(lambda: prefill_step(
            model, {"inputs": prompts[:, :t_prof]}, run["cache"], cfg),
            SSM_RANGES)
        log_ssm_split(f"one {cfg.name} prefill ({b} x {t_prof})", pre)
        dec = profile_split(lambda: decode_step(
            model, tok, run["cache"], prompts.shape[1], cfg), SSM_RANGES)
        log_ssm_split(f"one {cfg.name} decode step (B={b})", dec)
        n_rec = sum(s.kind in ("mamba", "mlstm", "slstm")
                    for s in cfg.all_specs())
        n_pre, n_dec = pre["launched"]["ssm.scan"], dec["launched"]["ssm.scan"]
        log(f"[ssm] {cfg.name}: the recurrent scans launch {n_pre} kernels "
            f"a prefill of {t_prof} steps ({n_pre / t_prof / n_rec:.2f} a "
            f"step a layer over {n_rec} recurrent layers), {n_dec} a decode "
            f"step; they take {pre['ssm.scan'] / pre['device_ms']:.3f} of the "
            f"prefill's device time and "
            f"{dec['ssm.scan'] / dec['device_ms']:.3f} of the step's")
        check(pre["ssm.scan"] > 0 and dec["ssm.scan"] > 0,
              f"{cfg.name}: the profiler saw no scan on the device")
        return {"prefill": pre, "decode": dec}

    # (a) jamba-v0.1-52b at full width, JAMBA_PERIODS periods
    cfg = ssm_config(JAMBA_ARCH, num_periods=JAMBA_PERIODS)
    model = draw(cfg)
    prompts = dense_inputs(cfg, JAMBA_B, JAMBA_T, g)
    run = dense_main(model, cfg, prompts, JAMBA_STEPS, JAMBA_S, cfg.name,
                     tag="ssm", warm_t=SSM_WARM_T)
    check(run["launches"] > 0 and run["topk_launches"] > 0,
          f"{cfg.name}: no flash or topk launch on the main path")
    jamba = {"prefill_ms": run["prefill_ms"], "steps_ms": run["steps_ms"],
             "peak": run["peak"],
             "split": profiled(model, cfg, prompts, run, SSM_PROFILE_T)}
    launches = {"flash_attention": run["launches"],
                "flash_attention_fma": run["fma_launches"],
                "topk": run["topk_launches"],
                "topk_stream": run["topk_stream_launches"]}
    check(jamba["split"]["prefill"]["attention_ms"] > 0
          and jamba["split"]["prefill"]["router_ms"] > 0
          and jamba["split"]["decode"]["router_ms"] > 0,
          f"{cfg.name}: the profiler saw no flash or topk kernel")
    err = jamba_kernel_checks(model, cfg, prompts, run["cache"])
    del run
    for what, pairs in ssm_bf16_pairs(model, cfg, prompts,
                                      prompts[:2, :LM_C_T + 3]).items():
        compare_logits(f"[ssm] {cfg.name} {what}", pairs, cfg.vocab_size,
                       None, lambda gap: bf16_gate(gap, JAMBA_ARCH,
                                                   what[:3]))
    del model, prompts
    torch.cuda.empty_cache()
    log(f"[ssm] {cfg.name} bf16: {time.perf_counter() - t_phase:.1f}s into "
        f"the phase")
    periods, b, t = JAMBA_F32
    dense_f32_checks(JAMBA_ARCH, periods, b, t, (None,), g)
    log(f"[ssm] {cfg.name} float32: {time.perf_counter() - t_phase:.1f}s into "
        f"the phase")

    # (b) xlstm-350m as configured
    cfg = ssm_config(XLSTM_ARCH)
    model = draw(cfg)
    prompts = dense_inputs(cfg, XLSTM_B, XLSTM_T, g)
    run = dense_main(model, cfg, prompts, XLSTM_STEPS, XLSTM_S, cfg.name,
                     tag="ssm", warm_t=SSM_WARM_T)
    xlstm = {"prefill_ms": run["prefill_ms"], "steps_ms": run["steps_ms"],
             "peak": run["peak"],
             "split": profiled(model, cfg, prompts, run, SSM_PROFILE_T)}
    del run
    for what, pairs in ssm_bf16_pairs(model, cfg, prompts,
                                      prompts[:2, :LM_C_T + 3]).items():
        compare_logits(f"[ssm] {cfg.name} {what}", pairs, cfg.vocab_size,
                       None, lambda gap: bf16_gate(gap, XLSTM_ARCH,
                                                   what[:3]))
    del model, prompts
    torch.cuda.empty_cache()
    log(f"[ssm] {cfg.name} bf16: {time.perf_counter() - t_phase:.1f}s into "
        f"the phase")
    xlstm_f32_checks(g)
    log(f"[ssm] phase {time.perf_counter() - t_phase:.1f}s")
    return {"launches": launches, "err": err, "jamba": jamba,
            "xlstm": xlstm}


# ---------------------------------------------------------------------------


def train_config(**replace):
    """deepseek-v2-lite-16b as `lm_config()` gives it (the router through
    the topk kernel), TRAIN_PERIODS periods, TRAIN_ACCUM microbatches."""
    import dataclasses

    return dataclasses.replace(lm_config(), num_periods=TRAIN_PERIODS,
                               grad_accum=TRAIN_ACCUM, **replace)


def train_flash_checks(g):
    """(a) the differentiable flash op on the card at the training shapes
    of MLA, qwen3 (G = 5), danube's window and paligemma's prefix, float32
    and bf16: its output (the kernel: tensor cores in bf16, FMA in float32)
    within FLASH_TOL of flash_attention_ref on the same inputs, and its
    dq, dk, dv (the plain recompute, 512 query rows at a time) against
    torch.autograd.grad through flash_attention_ref over the whole
    sequence; times the backward at MLA's bf16 shape
    (`train_flash_bwd_timing`). Returns each kernel row's largest forward
    |d|."""
    from repro_torch.kernels import attention, ops

    fwd = {"flash_attention": 0.0, "flash_attention_fma": 0.0}
    for name, (bh, bkv, t, hd, vd), kw in TRAIN_FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((bh, t, hd), generator=g, device=DEVICE)
            k, v = (torch.randn((bkv, t, hd), generator=g, device=DEVICE)
                    for _ in range(2))
            v[..., vd:] = 0.0                  # MLA's V padded to hd
            w = torch.randn((bh, t, hd), generator=g, device=DEVICE)
            q, k, v = (x.to(dtype).requires_grad_() for x in (q, k, v))
            before = flash_counts()
            out = ops.flash_attention_differentiable(q, k, v, **kw)
            got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
            took = [a - b for a, b in zip(flash_counts(), before)]
            check(took == ([1, 0] if dtype == torch.bfloat16 else [0, 1]),
                  f"train flash {name} {dtype}: launches {took}")
            ref = attention.flash_attention_ref(q, k, v, **kw)
            o, r = out.detach().float(), ref.detach().float()
            rel, absol = FLASH_TOL[dtype]
            d_out = float((o - r).abs().max())
            kernel = ("flash_attention" if dtype == torch.bfloat16
                      else "flash_attention_fma")
            tol = rel * torch.maximum(o.abs(), r.abs()) + absol
            check(bool(((o - r).abs() <= tol).all()),
                  f"train flash {name} {dtype}: the {kernel} kernel's "
                  f"output beyond {rel:g} x |out| + {absol:g} of its plain "
                  f"version (max |d| {d_out:.3g})")
            fwd[kernel] = max(fwd[kernel], d_out)
            del o, r, tol
            want = torch.autograd.grad((ref.float() * w).sum(), (q, k, v))
            rel, absol = TRAIN_GRAD_TOL[dtype]
            errs = []
            for label, a, b in zip("qkv", got, want):
                a, b = a.float(), b.float()
                top = float(b.abs().max())
                d = (a - b).abs()
                check(bool((d <= rel * b.abs() + absol * top).all()),
                      f"train flash {name} {dtype}: d{label} beyond "
                      f"{rel:g} |want| + {absol:g} max |want| (max |d| "
                      f"{float(d.max()):.3g}, max |want| {top:.3g})")
                errs.append(float(d.max()) / top)
            log(f"[train] (a) flash op, {name} q {[bh, t, hd]} over k, v "
                f"{[bkv, t, hd]} {dtype} {kw or 'causal'}: the output "
                f"({kernel} kernel) within FLASH_TOL of the plain version "
                f"(max |d| {d_out:.3g}); dq, dk, dv within {rel:g} |want| "
                f"+ {absol:g} max |want| of autograd through the plain version over the whole "
                f"sequence (max |d| / max |want| {errs[0]:.3g}, "
                f"{errs[1]:.3g}, {errs[2]:.3g})")
            if name == "MLA" and dtype == torch.bfloat16:
                train_flash_bwd_timing(q, k, v, w)
            del q, k, v, w, out, got, ref, want
    torch.cuda.empty_cache()
    return fwd


def train_flash_bwd_timing(q, k, v, dout) -> None:
    """The flash op's backward (the plain recompute) alone at MLA's
    training shape, one microbatch's layer: device ms (torch.profiler)
    and a call's ms with host work (CUDA events), beside the bound of a
    backward kernel: the recompute of q.k^T and the products dV, dP, dQ,
    dK over the causal pairs at the bf16 tensor cores, or q, k, v, dout
    read and dq, dk, dv written once."""
    from repro_torch.kernels import attention

    bh, t, hd = q.shape
    fn = lambda: attention.flash_attention_vjp(  # noqa: E731
        q.detach(), k.detach(), v.detach(), dout.to(q.dtype))
    # one call a trace: reading back a trace of its ~3,000 kernels and
    # ~10,000 host events takes seconds
    dev = device_ms(fn, reps=1, traces=1)
    events = median_ms(fn, reps=3)
    pairs = bh * t * (t + 1) / 2
    bound_ms, bound_by = bound(7 * bh * t * hd * q.element_size(),
                               5 * 2.0 * hd * pairs, BF16_FLOPS)
    log(f"[train] (a) the flash op's backward (plain recompute, 512 query "
        f"rows a block) at q, k, v [{bh}, {t}, {hd}] bf16 causal: device "
        f"{dev:.2f} ms, events {events:.2f} ms a call; a backward kernel's "
        f"bound {bound_ms:.4f} ms ({bound_by}: 5 products of "
        f"{2.0 * hd * pairs / 1e9:.1f} GFLOP at the bf16 tensor cores)")


def train_f32_check(g) -> None:
    """(b) one float32 forward and backward at full width and the phase's
    depth, B x T = TRAIN_F32_BT: the kernels (FMA flash, select_k_short)
    against their plain versions on the card, loss and every gradient
    within 2e-3 (the reference's own tolerance)."""
    from repro_torch.kernels import attention, topk
    from repro_torch.models.model import loss_fn
    from repro_torch.models.transformer import init_params

    cfg = train_config(param_dtype=torch.float32)
    model = init_params(cfg, device=DEVICE, generator=g)
    model.requires_grad_(True)
    b, t = TRAIN_F32_BT
    toks = torch.randint(0, cfg.vocab_size, (b, t + 1), generator=g,
                         device=DEVICE)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    names, params = zip(*model.named_parameters())
    runs = []
    for swap in ({}, {"flash_fn": attention.flash_attention_ref,
                      "topk_fn": topk.topk_ref}):
        with swapped_ops(**swap):
            before = launch_counts()
            loss, _ = loss_fn(model, cfg, batch)
            grads = torch.autograd.grad(loss, params)
            took = [a - b for a, b in zip(launch_counts(), before)]
        runs.append((loss.detach(), grads, took))
    (l_k, g_k, took_k), (l_p, g_p, took_p) = runs
    check(took_k[1] > 0 and took_k[2] > 0 and took_p == [0, 0, 0, 0],
          f"train (b): launches kernels {took_k}, plain {took_p}")
    worst = abs(float(l_k) - float(l_p))
    check(worst <= 2e-3 + 2e-3 * abs(float(l_p)),
          f"train (b): loss {float(l_k)} against {float(l_p)}")
    for name, a, w in zip(names, g_k, g_p):
        d = (a - w).abs()
        check(bool((d <= 2e-3 + 2e-3 * w.abs()).all()),
              f"train (b): gradient {name} beyond 2e-3 (max |d| "
              f"{float(d.max()):.3g})")
        worst = max(worst, float(d.max()))
    log(f"[train] (b) float32 at full width, {cfg.num_layers} layers, "
        f"B={b} x T={t}: loss {float(l_k):.6f} (kernels) against "
        f"{float(l_p):.6f} (plain flash and topk), {len(names)} gradient "
        f"leaves within 2e-3 (max |d| {worst:.3g}); kernel launches "
        f"(flash tc, flash fma, topk, topk_stream) {took_k}")
    del model, runs, g_k, g_p
    torch.cuda.empty_cache()


def train_state_snapshot(state) -> dict:
    """The parameters, m and v of a train state, copied to the host."""
    out = {f"p.{n}": p.detach().to("cpu", copy=True)
           for n, p in state["params"].named_parameters()}
    for key in ("m", "v"):
        out.update({f"{key}.{n}": t.to("cpu", copy=True)
                    for n, t in state["opt"][key].items()})
    return out


def train_timed(cfg, g) -> dict:
    """(c) TRAIN_B x TRAIN_T a step in TRAIN_ACCUM microbatches: one
    warm-up step, TRAIN_STEPS timed steps with the launch counters set to
    0 just before and read just after, then one profiled step."""
    from repro_torch.kernels import attention, topk
    from repro_torch.models.model import make_train_state, train_step
    from repro_torch.optim.adamw import AdamWConfig

    opt = AdamWConfig(total_steps=100, warmup_steps=2)
    t0 = time.perf_counter()
    state = make_train_state(cfg, opt, device=DEVICE, generator=g)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in state["params"].parameters())
    log(f"[train] {cfg.name}: {cfg.num_layers} of 27 layers at full width, "
        f"{n / 1e9:.3f} B parameters (bf16) with float32 m and v drawn on "
        f"the card in {time.perf_counter() - t0:.1f}s")

    def batch(step: int):
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1),
                             generator=g, device=DEVICE)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    # every weight matrix, on the host so that the card's peak is the
    # step's (a bf16 norm scale of ones may round back to ones)
    first = {n: p.detach().to("cpu", copy=True) for n, p in
             state["params"].named_parameters() if p.dim() >= 2}
    state, m = train_step(state, batch(0), cfg, opt)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batches = [batch(i + 1) for i in range(TRAIN_STEPS)]
    attention.TC_LAUNCHES = attention.FMA_LAUNCHES = 0
    topk.SHORT_LAUNCHES = topk.LAUNCHES = 0
    times, losses, norms = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = train_step(state, b, cfg, opt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches[0] > 0 and launches[2] > 0 and launches[1] == 0
          and launches[3] == 0,
          f"train (c): launches (flash tc, flash fma, topk, topk_stream) "
          f"{launches}; expected the tensor-core flash and select_k_short "
          f"only")
    check(all(np.isfinite(losses)) and all(np.isfinite(x) and x > 0
                                           for x in norms),
          f"train (c): loss {losses}, grad_norm {norms}")
    moved = [n for n, p in state["params"].named_parameters()
             if n in first and not torch.equal(p, first[n].to(p.device))]
    check(len(moved) == len(first), f"train (c): parameters unchanged: "
          f"{sorted(set(first) - set(moved))}")
    log(f"[train] (c) all {len(first)} weight matrices changed")
    del first
    p50, p99 = float(np.percentile(times, 50)), float(np.percentile(times,
                                                                    99))
    tokens = TRAIN_B * TRAIN_T
    log(f"[train] (c) {TRAIN_STEPS} timed steps of B={TRAIN_B} x T="
        f"{TRAIN_T} ({TRAIN_ACCUM} microbatches) bf16: p50 {p50:.1f} ms, "
        f"p99 {p99:.1f} ms ({', '.join(f'{x:.1f}' for x in times)}), "
        f"{tokens / p50 * 1e3:.0f} tokens/s, peak {peak:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad_norm {norms[-1]:.4f}; "
        f"launches (flash tc, flash fma, topk, topk_stream) {launches} "
        f"({launches[0] // TRAIN_STEPS} flash and {launches[2] // TRAIN_STEPS} "
        f"topk a step)")
    # the backward runs on autograd's device thread, outside the caller's
    # ranges: it is the step's device time less the forward and the
    # optimizer (the accumulator's adds count with it); the attention
    # backward's range is opened on that thread. Every range the path
    # opens is named, so that its device-side annotation is not counted
    # as a kernel
    ranges = ("train.forward", "attn.backward", "train.optimizer",
              "moe.experts")
    b = batch(TRAIN_STEPS + 1)
    split = profile_split(lambda: train_step(state, b, cfg, opt), ranges)
    split["attn_bwd_ms"] = split["attn.backward"]
    split["rest_bwd_ms"] = (split["device_ms"] - split["train.forward"]
                            - split["train.optimizer"] - split["attn_bwd_ms"])
    log(f"[train] (c) split of one step (torch.profiler, device ms): "
        f"forward {split['train.forward']:.1f}, attention backward (plain "
        f"recompute) {split['attn_bwd_ms']:.1f}, rest of the backward "
        f"(the periods' recompute and the accumulator included) "
        f"{split['rest_bwd_ms']:.1f}, "
        f"optimizer {split['train.optimizer']:.1f}; the expert einsums "
        f"(forward and recompute) {split['moe.experts']:.1f}, flash kernel "
        f"{split['attention_ms']:.1f}, router topk kernel "
        f"{split['router_ms']:.3f}; device busy {split['device_ms']:.1f} ms, "
        f"idle share {1 - split['device_ms'] / p50:.3f} of the unprofiled "
        f"p50 step ({1 - split['device_ms'] / split['wall_ms']:.3f} of the "
        f"profiled step's {split['wall_ms']:.1f} ms wall, which the "
        f"profiler lengthens), {split['kernels']} kernels")
    log(f"[train]   kernels with the most device time: " + "; ".join(
        f"{name[:70]} {us / 1e3:.3f} ms" for name, us in split["top"]))
    check(split["attn_bwd_ms"] > 0 and split["train.optimizer"] > 0,
          "train (c): the profiler saw no attention backward or optimizer")
    del state
    torch.cuda.empty_cache()
    return {"p50_ms": p50, "p99_ms": p99, "tokens_per_s": tokens / p50 * 1e3,
            "peak_gib": peak, "launches": launches, "split": split}


def train_determinism(cfg, seed: int) -> None:
    """(d) TRAIN_DET_STEPS steps from the same generator, twice: bitwise
    equal parameters, m and v."""
    from repro_torch.models.model import make_train_state, train_step
    from repro_torch.optim.adamw import AdamWConfig

    opt = AdamWConfig(total_steps=100, warmup_steps=2)
    snaps = []
    for _ in range(2):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        state = make_train_state(cfg, opt, device=DEVICE, generator=g)
        for _ in range(TRAIN_DET_STEPS):
            toks = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1),
                                 generator=g, device=DEVICE)
            state, _ = train_step(state, {"inputs": toks[:, :-1],
                                          "labels": toks[:, 1:]}, cfg, opt)
        snaps.append(train_state_snapshot(state))
        del state
        torch.cuda.empty_cache()
    differ = [n for n in snaps[0] if not torch.equal(snaps[0][n],
                                                       snaps[1][n])]
    check(not differ, f"train (d): {len(differ)} leaves differ between two "
          f"runs from one generator: {differ[:6]}")
    log(f"[train] (d) {TRAIN_DET_STEPS} steps twice from one generator: "
        f"{len(snaps[0])} leaves (parameters, m, v) bitwise equal")


def train_restart(tmp: str) -> None:
    """(e) a TrainLoop on DeepSeek's REDUCED config in bf16 dies and
    resumes bitwise; the GC keeps `keep` steps."""
    import dataclasses

    from repro_torch.checkpoint import list_steps
    from repro_torch.configs import reduced_config
    from repro_torch.data import make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import TrainLoop, TrainLoopConfig

    cfg = dataclasses.replace(reduced_config(LM_ARCH),
                              param_dtype=torch.bfloat16)
    opt = AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=1)
    steps, die, keep = TRAIN_LOOP

    def loop(d):
        return TrainLoop(cfg, opt, TrainLoopConfig(
            ckpt_dir=d, ckpt_every=1, keep=keep, log_every=100),
            lambda s: make_batch(cfg, "train", 64, 2, step=s),
            log=lambda *a: None, device=DEVICE)

    ref, _ = loop(f"{tmp}/train-a").run(steps)
    try:
        loop(f"{tmp}/train-b").run(steps, die_at_step=die)
        check(False, "train (e): the run did not die")
    except RuntimeError as e:
        check("simulated node failure" in str(e), f"train (e): {e}")
    resumed = loop(f"{tmp}/train-b")
    check(resumed.step == die, f"train (e): resumed at {resumed.step}")
    got, _ = resumed.run(steps)
    differ = [n for (n, a), b in zip(ref["params"].named_parameters(),
                                     got["params"].parameters())
              if not torch.equal(a, b)]
    kept = list_steps(f"{tmp}/train-b", committed_only=False)
    check(not differ and kept == list(range(steps - keep + 1, steps + 1)),
          f"train (e): {len(differ)} leaves differ, steps kept {kept}")
    log(f"[train] (e) TrainLoop, {cfg.name} REDUCED bf16: died at step "
        f"{die}, resumed, {steps} steps bitwise equal to an uninterrupted "
        f"run; checkpoints kept {kept}")


def train_phase(seed: int) -> dict:
    """11. training DeepSeek-V2-Lite at full width on the card."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    t_phase = time.perf_counter()
    fwd_err = train_flash_checks(g)
    log(f"[train] (a) {time.perf_counter() - t_phase:.1f}s into the phase")
    train_f32_check(g)
    log(f"[train] (b) {time.perf_counter() - t_phase:.1f}s into the phase")
    cfg = train_config()
    out = train_timed(cfg, g)
    log(f"[train] (c) {time.perf_counter() - t_phase:.1f}s into the phase")
    train_determinism(cfg, seed + 1)
    log(f"[train] (d) {time.perf_counter() - t_phase:.1f}s into the phase")
    with tempfile.TemporaryDirectory() as tmp:
        train_restart(tmp)
    log(f"[train] phase {time.perf_counter() - t_phase:.1f}s")
    out["fwd_err"] = fwd_err
    return out


# ---------------------------------------------------------------------------
# 12. tools: the LM dry run and sharding tools, and the last two examples


def alloc_bounds(sizes) -> tuple:
    """(least, most) rise of torch.cuda.memory_allocated() when tensors of
    `sizes` bytes are allocated on an emptied caching allocator. Its rule
    (c10/cuda/CUDACachingAllocator.cpp): a request of n > 0 bytes takes a
    block of n rounded up to a multiple of ALLOC_ROUND (512) bytes, and
    memory_allocated counts the block. A block of the large pool (above
    1 MiB) is split off a segment only when more than ALLOC_SLACK (1 MiB)
    would be left; otherwise the whole segment is the block, so such a
    request may take up to ALLOC_SLACK more."""
    least = most = 0
    for n in sizes:
        if n == 0:
            continue
        r = -(-n // ALLOC_ROUND) * ALLOC_ROUND
        least += r
        most += r + (ALLOC_SLACK if r > ALLOC_SLACK else 0)
    return least, most


def dryrun_sweep_check(jobs: ToolsJobs) -> None:
    """(a) the sweep subprocess's records: 80, none in error, the skips
    exactly the cells shape_runnable refuses (the reference's rule,
    tests/test_torch_dryrun.py); the largest per-device argument bytes and
    every cell past HW.hbm_bytes logged; then report over the file, and
    reterm over a copy, which must leave every analytic field as it is."""
    import shutil

    from repro_torch.configs import ARCHS, SHAPES, get_config
    from repro_torch.configs.shapes import shape_runnable
    from repro_torch.launch import report, reterm

    code, _, err = jobs.out["sweep"]
    check(code == 0, f"tools: the dry-run sweep exited {code}: "
                     f"{err[-2000:]}")
    path = jobs.sweep_path
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    check(len(recs) == len(ARCHS) * len(SHAPES) * 2,
          f"tools: the sweep wrote {len(recs)} records")
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error")) for r in recs
           if r["status"] == "error"]
    check(not bad, f"tools: dry-run cells in error: {bad}")
    skipped = {(r["arch"], r["shape"]) for r in recs
               if r["status"] == "skipped"}
    want = {(a, s) for a in ARCHS for s in SHAPES
            if not shape_runnable(get_config(a), SHAPES[s])[0]}
    check(skipped == want, f"tools: skipped {sorted(skipped)}, "
                           f"shape_runnable refuses {sorted(want)}")
    ok = [r for r in recs if r["status"] == "ok"]
    top = max(ok, key=lambda r: r["mem"]["argument_bytes"])
    unfit = [(r["arch"], r["shape"], r["mesh"], r["mem"]["argument_bytes"])
             for r in ok if not r["mem"]["fits_hbm"]]
    log(f"[tools] (a) dry run: {len(recs)} records, {len(ok)} ok, "
        f"{len(skipped) * 2} skipped, 0 error; largest arguments a device "
        f"{top['mem']['argument_bytes']} B ({top['arch']} {top['shape']} "
        f"{top['mesh']}); past {HW().hbm_bytes:.0f} B: {unfit or 'none'}")
    report.main([str(path)])
    fresh = path.with_name("reterm.jsonl")
    shutil.copy(path, fresh)
    reterm.main([str(fresh)])
    keys = ("flops_per_dev", "bytes_per_dev", "coll_bytes_analytic",
            "compute_s", "memory_s", "collective_s", "dominant",
            "compute_fraction", "model_flops_total", "model_flops_per_dev",
            "useful_flops_ratio")
    again = [json.loads(line) for line in fresh.read_text().splitlines()]
    moved = [(a["arch"], a["shape"], a["mesh"]) for a, b in zip(recs, again)
             if any(a.get(k) != b.get(k) for k in keys)]
    check(len(again) == len(recs) and not moved,
          f"tools: reterm moved the analytic fields of {moved}")


def card_bytes_check(arch: str) -> None:
    """(b) the dry run's bytes of one cell against the card's allocation:
    lower_cell on a one-slot mesh of this card at phase 8's decode cell
    (B = LM_B, a cache of LM_S positions), full width and depth; then the
    same parameters (model_skeleton: torch.empty), cache, tokens and pos
    allocated on the card, uninitialised. Gate 1: argument_bytes is the
    sum of the tensors' nbytes. Gate 2: the rise of memory_allocated lies
    within alloc_bounds of their sizes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCfg, cache_spec
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import leaves
    from repro_torch.models.transformer import model_skeleton

    cfg = get_config(arch)
    shape = ShapeCfg("card", "decode", LM_S, LM_B)
    mesh = make_mesh((1, 1), ("data", "model"), devices=DEVICE)
    rec = lower_cell(arch, shape, mesh=mesh)
    check(rec["status"] == "ok", f"tools: {arch}: {rec}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = model_skeleton(cfg, DEVICE)
    cache = {p: torch.empty(t.shape, dtype=t.dtype, device=DEVICE)
             for p, t in leaves(cache_spec(cfg, shape))}
    tokens = torch.empty((LM_B, 1), dtype=torch.int32, device=DEVICE)
    pos = torch.empty((), dtype=torch.int32, device=DEVICE)
    tensors = [*params.parameters(), *cache.values(), tokens, pos]
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - before
    sizes = [t.nbytes for t in tensors]
    least, most = alloc_bounds(sizes)
    want = rec["mem"]["argument_bytes"]
    log(f"[tools] (b) {arch}: argument_bytes {want}, the tensors' nbytes "
        f"{sum(sizes)} ({len(tensors)} tensors), memory_allocated rose "
        f"{rise} (allocator bounds [{least}, {most}]), alias_bytes "
        f"{rec['mem']['alias_bytes']}, fits_hbm {rec['mem']['fits_hbm']}")
    check(want == sum(sizes), f"tools: {arch}: argument_bytes {want} != "
                              f"{sum(sizes)} allocated")
    check(least <= rise <= most, f"tools: {arch}: memory_allocated rose "
                                 f"{rise}, outside [{least}, {most}]")
    del params, cache, tokens, pos, tensors
    torch.cuda.empty_cache()


def load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def knn_cpu_worker() -> dict:
    """Worker process: (c)'s kNN-LM run on the CPU, its weights drawn by
    `init_params` on the CPU from seed 0; the run's outputs and seconds."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import init_params

    torch.set_num_threads(1)
    knn = load_example("torch_knn_lm_decode")
    t0 = time.perf_counter()
    out = knn.run("cpu", params=init_params(reduced_config(knn.ARCH),
                                            device="cpu"))
    out["seconds"] = time.perf_counter() - t0
    return out


class ToolsJobs:
    """Phase 12's jobs that need no card of their own: (a)'s sweep and the
    quickstart as subprocesses, and (c)'s kNN-LM run on the CPU in a worker
    of the build pool. They start when phase 3 (whose timings include host
    time) is done, run beside phase 4's index build (set-up, which nothing
    times) and are waited for before phase 4's timed batches."""

    def __init__(self, tmp: str, pool):
        self.sweep_path = Path(tmp) / "dryrun.jsonl"
        cmds = {"sweep": [sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", "all", "--shape", "all", "--mesh",
                          "both", "--out", str(self.sweep_path), "--quiet"],
                "quickstart": [sys.executable,
                               str(ROOT / "examples" / "torch_quickstart.py"),
                               "--n", "2000", "--dim", "64", "--partitions",
                               "2"]}
        env = src_env()
        self.procs = {name: subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for name, cmd in cmds.items()}
        self.knn_cpu = pool.submit(knn_cpu_worker)
        self.out = {}

    def wait(self) -> None:
        """Each subprocess's (exit code, stdout, stderr) into `out`; the
        kNN-LM worker done."""
        for name, proc in self.procs.items():
            if name not in self.out:
                stdout, stderr = proc.communicate(timeout=600)
                self.out[name] = (proc.returncode, stdout, stderr)
        concurrent.futures.wait([self.knn_cpu])

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def knn_lm_check(want: dict) -> dict:
    """(c) the kNN-LM example on the card against its CPU run (`want`,
    knn_cpu_worker's), the same weights (init_params on the CPU from seed
    0, moved to the card): each step's LM log-probabilities within
    KNN_LM_TOL, retrieved ids overlapping >= KNN_ID_OVERLAP, both mixed
    distributions finite, the decoded token equal wherever the CPU's
    top-2 margin exceeds KNN_MARGIN (steps under it are logged). The
    launch counters are set to 0 just before the card's run and read just
    after: traversal_async.cu and flash_attention.cu (float32) > 0,
    traversal.cu and the tensor-core flash kernel 0; descent.cu once a
    descent (`descent_window`)."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import attention
    from repro_torch.kernels import traversal as tr
    from repro_torch.models.transformer import init_params

    knn = load_example("torch_knn_lm_decode")
    params = init_params(reduced_config(knn.ARCH), device="cpu").to(DEVICE)
    tr.ASYNC_LAUNCHES = tr.LAUNCHES = 0
    attention.TC_LAUNCHES = attention.FMA_LAUNCHES = 0
    t0 = time.perf_counter()
    with descent_window("tools kNN-LM") as descents:
        got = knn.run(DEVICE, params=params)
        torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launches = {"traversal_async": tr.ASYNC_LAUNCHES, "traversal": tr.LAUNCHES,
                "descent": descents["launches"],
                "flash_attention_fma": attention.FMA_LAUNCHES,
                "flash_attention": attention.TC_LAUNCHES}
    log(f"[tools] (c) kNN-LM: {got['memories']} memories, {knn.STEPS} steps "
        f"of B={knn.B}; card {t_card:.1f}s, CPU {want['seconds']:.1f}s (its "
        f"worker); launches {launches}")
    check(launches["traversal_async"] > 0 and launches["traversal"] == 0,
          f"tools: kNN-LM traversal launches {launches}")
    check(launches["flash_attention_fma"] > 0
          and launches["flash_attention"] == 0,
          f"tools: kNN-LM flash launches {launches}")
    check(np.isfinite(got["mixed"]).all() and np.isfinite(want["mixed"]).all(),
          "tools: kNN-LM mixed log-probabilities not finite")
    worst_lm, worst_overlap = 0.0, 1.0
    for t in range(knn.STEPS):
        d = np.abs(got["lm_logp"][t] - want["lm_logp"][t])
        bar = KNN_LM_TOL + KNN_LM_TOL * np.abs(want["lm_logp"][t])
        check(bool((d <= bar).all()), f"tools: kNN-LM step {t}: LM "
                                      f"log-probs differ by {d.max()}")
        worst_lm = max(worst_lm, float(d.max()))
        for b in range(knn.B):
            share = len(set(got["ids"][t, b]) & set(want["ids"][t, b])) \
                / got["ids"].shape[2]
            worst_overlap = min(worst_overlap, share)
            check(share >= KNN_ID_OVERLAP, f"tools: kNN-LM step {t} row {b}"
                                           f": ids overlap {share}")
        top = np.sort(want["mixed"][t], -1)
        margin = top[:, -1] - top[:, -2]
        for b in np.flatnonzero(margin <= KNN_MARGIN):
            log(f"[tools] (c) step {t} row {b}: top-2 margin "
                f"{margin[b]:.2e} under {KNN_MARGIN}; tokens card "
                f"{got['tokens'][b, t]}, CPU {want['tokens'][b, t]}")
        sure = margin > KNN_MARGIN
        check(np.array_equal(got["tokens"][sure, t],
                             want["tokens"][sure, t]),
              f"tools: kNN-LM step {t}: tokens {got['tokens'][:, t]} on the "
              f"card, {want['tokens'][:, t]} on the CPU")
    log(f"[tools] (c) kNN-LM card = CPU: max |d lm_logp| {worst_lm:.3e}, "
        f"least ids overlap {worst_overlap:.3f}, tokens "
        f"{got['tokens'].tolist()}")
    return {"launches": launches}


def quickstart_check(jobs: ToolsJobs) -> None:
    """(c) examples/torch_quickstart.py on the card (a subprocess): exit 0,
    its three recall lines and OK."""
    code, out, err = jobs.out["quickstart"]
    check(code == 0, f"tools: the quickstart exited {code}: {err[-2000:]}")
    lines = out.strip().splitlines()
    recall = [ln for ln in lines if "recall@10" in ln]
    for ln in recall:
        log(f"[tools] (c) quickstart: {ln}")
    check(len(recall) == 3 and lines[-1] == "OK",
          f"tools: the quickstart printed {lines[-6:]}")


def tools_phase(jobs: ToolsJobs) -> dict:
    """12. (b), then (c)'s card run against its CPU run; then (a) and the
    quickstart, from the jobs that ran beside phase 4's build (waited
    for here where no main path ran)."""
    t_phase = time.perf_counter()
    for arch in TOOLS_ARCHS:
        card_bytes_check(arch)
    log(f"[tools] (b) {time.perf_counter() - t_phase:.1f}s into the phase")
    out = knn_lm_check(jobs.knn_cpu.result())
    log(f"[tools] (c) kNN-LM {time.perf_counter() - t_phase:.1f}s into the "
        f"phase")
    jobs.wait()
    dryrun_sweep_check(jobs)
    quickstart_check(jobs)
    log(f"[tools] phase {time.perf_counter() - t_phase:.1f}s")
    return out


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
                            "cluster,scan,graph_build,descent,lm,dense,ssm,"
                            "train,tools",
                    help="comma list of kernel,main,quant,csd,cost,serve,"
                         "ingest,cluster,scan,graph_build,descent,lm,dense,"
                         "ssm,train,tools "
                         "(card and build always run; serve and cost need "
                         "csd, csd needs quant, quant, ingest and cluster "
                         "need main)")
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
    # every process a phase starts is stopped on the way out
    with contextlib.ExitStack() as stack:
        return run_phases(phases, stack, t_all)


def run_phases(phases: set, stack: contextlib.ExitStack, t_all: float
               ) -> int:
    """Phases 1-12 as `phases` asks; the kernels line and the last line."""
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
        # phase 12's jobs that need no card of their own: after phase 3's
        # timings, beside phase 4's build
        jobs = None
        if "tools" in phases:
            jobs = ToolsJobs(stack.enter_context(
                tempfile.TemporaryDirectory()), pool)
            stack.callback(jobs.stop)
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
            if jobs:
                jobs.wait()
            if builds or jobs:
                # no build or tools job competes with a timed batch: the
                # workers exit
                pool.shutdown(wait=True)
                log(f"[build] waited {time.perf_counter() - t0:.1f}s for the "
                    f"workers' builds{' and the tools jobs' if jobs else ''}")
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
    # 7b. graph_build
    if "graph_build" in phases:
        torch.cuda.empty_cache()
        graph_phase(seed=5)
    # 7c. descent
    descended = None
    if "descent" in phases:
        torch.cuda.empty_cache()
        descended = descent_phase(seed=6)
    # 8. lm
    lm = None
    if "lm" in phases:
        torch.cuda.empty_cache()
        lm = lm_phase(seed=0)
    # 9. dense, after the DeepSeek model and cache are freed
    dense = None
    if "dense" in phases:
        torch.cuda.empty_cache()
        dense = dense_phase(seed=0)
    # 10. ssm, after the dense phase's models are freed
    ssm = None
    if "ssm" in phases:
        torch.cuda.empty_cache()
        ssm = ssm_phase(seed=0)
    # 11. train, after the ssm phase's models are freed
    trained = None
    if "train" in phases:
        torch.cuda.empty_cache()
        trained = train_phase(seed=0)
    # 12. tools, after the train phase's model is freed
    tools = None
    if "tools" in phases:
        torch.cuda.empty_cache()
        tools = tools_phase(jobs)

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
            if tools:         # the kNN-LM example's datastore searches
                launches += tools["launches"]["traversal_async"]
        rows.append(kernel_row(f"fused_traversal_async{sfx}",
                               csrc + "traversal_async.cu", trav, launches,
                               kern.get(("async", dt)), t, "bytes"))
        # the paths launch traversal.cu no time (check_traversal_launches)
        rows.append(kernel_row(
            f"fused_traversal{sfx}", csrc + "traversal.cu", trav, 0,
            kern.get(("ldg", dt)),
            t and {"ms": t["ldg_ms"], "plain_ms": t["plain_ms"],
                   "bound_ms": t["bound_ms"]}, "bytes"))
    # the paths' descent launches, each path's counted in its own window
    # (the descent phase's checks and timings are not a path's)
    descents = sum(x["descent_launches"] for x in (
        main_out, quant and quant["uint8"], quant and quant["int8"], served,
        ingest, clustered) if x)
    if tools:         # the kNN-LM example's datastore searches
        descents += tools["launches"]["descent"]
    rows.append(kernel_row("greedy_descent", csrc + "descent.cu",
                           "src/repro/core/search.py:212", descents,
                           descended and descended["err"], descended,
                           descended["bound_by"] if descended else "latency"))
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
        launches, err = (r["launches"], r["err"]) if r else (0, None)
        if dense and name.startswith("flash"):
            # the dense phase's flash launches (all on the tensor cores)
            # and checks; its qwen3 timing where the lm phase did not run
            tc = name == "flash_attention"
            launches += dense["launches"] if tc else 0
            err = max(err or 0.0, dense["err"])
            q = dense["timing"]["qwen3"]
            t = t or dict(q, ms=q["ms"] if tc else q["fma_ms"])
        if ssm:   # jamba's attention layers and router, and their checks
            launches += ssm["launches"][name]
            if name in ssm["err"]:
                err = max(err or 0.0, ssm["err"][name])
        if trained:   # the timed train steps' forward and recompute
            launches += trained["launches"][
                ("flash_attention", "flash_attention_fma", "topk",
                 "topk_stream").index(name)]
            if name in trained["fwd_err"]:   # (a)'s forward checks
                err = max(err or 0.0, trained["fwd_err"][name])
        if tools and name.startswith("flash"):   # the kNN-LM example's LM
            launches += tools["launches"][name]
        row = kernel_row(name, csrc + source, replaces, launches, err, t,
                         t["bound_by"] if t else bound_by)
        if dense and name.startswith("flash"):
            # the dense paths' shapes, timed by the dense phase
            key = "ms" if name == "flash_attention" else "fma_ms"
            row["shapes"] = {
                k: {"shape": r["shape"], "ms": r[key],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "library_ms": r["library_ms"]}
                for k, r in dense["timing"].items()}
        rows.append(row)
    log(f"[done] {time.perf_counter() - t_all:.1f}s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
