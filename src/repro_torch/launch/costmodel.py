"""Loop-aware analytic FLOPs/bytes/collective model per (arch x shape)
cell, and the storage, dispatch, ingest and cluster terms of the ANN
engine: the reference's `launch/costmodel.py`, line for line, over the
port's `ModelConfig` / `LayerSpec`. Same inputs give bitwise-equal floats
(tests/test_torch_costmodel.py); the one difference is the default
`ssd_bw`, taken from the port's `roofline.HW` (the same 3.0e9 B/s).

The model enumerates the einsums the model code performs. The reference
checks it against XLA's cost_analysis on configs whose loops run once;
the port checks it against `torch.utils.flop_counter.FlopCounterMode`
over the reduced DeepSeek-V2-Lite prefill on the CPU, in the reference's
band.

Conventions:
  * 1 MAC = 2 FLOPs; train multiplies forward FLOPs by 4
    (fwd + 2x bwd + 1x remat recompute), inference by 1.
  * bytes = HBM traffic per device per step (params read + opt state r/w +
    carry/cache r/w + dominant activation traffic). Weights are priced at
    2 bytes (bf16) whatever `param_dtype` is, as the reference does.
  * collectives = bytes crossing links per device per step given the
    reference's baseline sharding (FSDP gathers, grad reduce-scatters, SP
    gathers, MoE all-to-all, vocab psum).
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.roofline import HW
from repro_torch.models.transformer import LayerSpec, ModelConfig

__all__ = ["cell_costs", "StorageCost", "storage_cost",
           "CompactionCost", "compaction_cost",
           "ClusterFanoutCost", "cluster_fanout_cost",
           "DispatchCost", "dispatch_cost",
           "VECTOR_DTYPE_BYTES", "vector_row_bytes"]


def _attn_flops_tok(cfg, t_kv):
    """Per-token attention flops against t_kv keys (projections + scores)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * d * hd * (2 * H + 2 * KV)          # q,o: H; k,v: KV
    sdpa = 2 * 2 * t_kv * H * hd                  # scores + AV
    return proj + sdpa


def _mla_flops_tok(cfg, t_kv, decode: bool):
    d, H = cfg.d_model, cfg.n_heads
    m = cfg.mla
    qd = m.qk_nope + m.qk_rope
    f = 2 * d * H * qd + 2 * d * (m.kv_lora + m.qk_rope)       # wq + w_dkv
    if decode:  # absorbed: q_eff [H,lora], scores vs c, out via w_uv
        f += 2 * H * m.qk_nope * m.kv_lora                      # absorb per tok
        f += 2 * t_kv * H * (m.kv_lora + m.qk_rope)             # scores
        f += 2 * t_kv * H * m.kv_lora                           # AV over c
        f += 2 * H * m.kv_lora * m.v_dim                        # up-proj out
    else:
        f += 2 * m.kv_lora * H * (m.qk_nope + m.v_dim)          # k/v up-proj
        f += 2 * 2 * t_kv * H * qd                              # scores + AV
    f += 2 * H * m.v_dim * d                                    # wo
    return f


def _ffn_flops_tok(cfg, spec: LayerSpec):
    d = cfg.d_model
    if spec.ffn == "glu":
        return 2 * 3 * d * cfg.d_ff
    if spec.ffn == "dense":
        return 2 * 2 * d * cfg.d_ff
    if spec.ffn == "moe":
        mc = cfg.moe
        f = 2 * d * mc.num_experts                               # router
        f += mc.top_k * 2 * 3 * d * mc.d_ff * mc.capacity_factor
        if mc.n_shared:
            f += 2 * 3 * d * mc.shared_ff()
        return f
    return 0


def _mamba_flops_tok(cfg):
    d = cfg.d_model
    mc = cfg.mamba
    di, r, S = mc.inner(d), mc.rank(d), mc.d_state
    f = 2 * d * 2 * di + 2 * mc.d_conv * di                      # in_proj+conv
    f += 2 * di * (r + 2 * S) + 2 * r * di                       # x_proj + dt
    f += 8 * di * S                                              # scan step
    f += 2 * di * d + 3 * di                                     # out + gate
    return f


def _mlstm_flops_tok(cfg):
    d = cfg.d_model
    xc = cfg.xlstm
    di = int(xc.m_proj_factor * d)
    dh = di // xc.n_heads
    f = 2 * d * 2 * di + 2 * xc.d_conv * di
    f += 3 * 2 * di * di                                         # q,k,v
    f += 6 * di * dh                                             # cell update
    f += 2 * di * d + 4 * di
    return f


def _slstm_flops_tok(cfg):
    d = cfg.d_model
    xc = cfg.xlstm
    dh = d // xc.n_heads
    f = 2 * d * 4 * d + 2 * 4 * d * dh                           # gates + rec
    f += 2 * 3 * d * int(xc.s_ffn_factor * d)                    # block ffn
    return f + 10 * d


def _layer_flops_tok(cfg, spec: LayerSpec, t_kv, decode):
    if spec.kind == "attn":
        eff = min(t_kv, spec.window) if spec.window else t_kv
        f = _attn_flops_tok(cfg, eff)
    elif spec.kind == "mla":
        f = _mla_flops_tok(cfg, t_kv, decode)
    elif spec.kind == "mamba":
        f = _mamba_flops_tok(cfg)
    elif spec.kind == "mlstm":
        f = _mlstm_flops_tok(cfg)
    else:
        f = _slstm_flops_tok(cfg)
    return f + _ffn_flops_tok(cfg, spec)


def _head_flops_tok(cfg):
    return 2 * cfg.d_model * cfg.num_output_heads * cfg.padded_vocab + \
        5 * cfg.num_output_heads * cfg.padded_vocab                # softmax/lse


@dataclasses.dataclass
class CellCost:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    flops_total: float
    detail: dict


def cell_costs(cfg: ModelConfig, kind: str, seq: int, batch: int,
               n_devices: int = 256, model_ax: int = 16, dp_ax: int = 16,
               fsdp: bool = True, state_mode: str = "fsdp") -> CellCost:
    """Analytic per-device roofline inputs for one cell."""
    decode = kind == "decode"
    tokens = batch * (1 if decode else seq)
    specs = cfg.all_specs()

    # ---- FLOPs ------------------------------------------------------------
    # t_kv = seq (NOT seq/2): the blockwise attention computes every KV block
    # and masks — executed flops are full T^2. The causal-average "useful"
    # count is what MODEL_FLOPS captures; the gap is a hillclimb target
    # (masked-block skipping, EXPERIMENTS.md §Perf).
    f_tok = 0.0
    for s in specs:
        t_kv = seq
        if (not decode and s.kind in ("attn", "mla")
                and getattr(cfg, "skip_masked_blocks", False)):
            t_kv = seq / 2          # causal block skipping executes ~T^2/2
        f_tok += _layer_flops_tok(cfg, s, t_kv, decode)
    fwd = f_tok * tokens
    # head/logit flops: every position in train (loss), ONLY the last
    # position per sequence in prefill, the single new token in decode.
    head_positions = batch if kind == "prefill" else tokens
    fwd += _head_flops_tok(cfg) * head_positions
    mult = 4.0 if kind == "train" else 1.0
    flops_total = fwd * mult
    flops_per_dev = flops_total / n_devices

    # ---- params / state bytes ----------------------------------------------
    p_bytes = 2.0  # bf16
    n_params = _count_params(cfg)
    if kind == "train":
        # fwd+bwd weight reads (all-gathered once each under FSDP) + grad
        # reduce + AdamW m/v/param r/w in f32.
        w_traffic = 3 * n_params * p_bytes / model_ax
        opt_traffic = n_params * (6 * 4.0) / n_devices
        act_traffic = _act_bytes(cfg, tokens, seq, kind) / n_devices
        bytes_per_dev = w_traffic / dp_ax + opt_traffic + act_traffic \
            + 2 * n_params * p_bytes / n_devices
    else:
        shard = n_devices if fsdp else model_ax
        w_read = n_params * p_bytes / shard
        cache_rw = _cache_bytes(cfg, batch, seq) / n_devices * (2 if decode else 1)
        act_traffic = _act_bytes(cfg, tokens, seq, kind) / n_devices
        bytes_per_dev = w_read + cache_rw + act_traffic

    # ---- collectives --------------------------------------------------------
    coll = 0.0
    if kind == "train":
        if state_mode == "zero1":
            # one grad all-reduce (f32, ring 2x) + post-update param bcast.
            coll += 2 * n_params * 4.0 / model_ax
            coll += n_params * p_bytes / model_ax
        elif fsdp:
            coll += 2 * 2 * n_params * p_bytes / model_ax      # AG fwd+bwd(remat)
            coll += 2 * n_params * 4.0 / model_ax              # grad RS (f32)
        # SP all-gathers: per layer, x gathered from T/model shards (fwd+bwd).
        coll += len(specs) * 3 * tokens * cfg.d_model * p_bytes / n_devices * 2
        # vocab-parallel loss psum (logsumexp partials, f32).
        coll += 2 * tokens * 4.0 * 4 / n_devices
    else:
        if fsdp:
            coll += 2 * n_params * p_bytes / model_ax          # AG weights
        # TP activation reductions: ~2 all-reduce of [tokens, d] per layer.
        coll += len(specs) * 2 * 2 * tokens * cfg.d_model * p_bytes / n_devices
    moe_layers = sum(1 for s in specs if s.ffn == "moe")
    if moe_layers:
        mc = cfg.moe
        coll += moe_layers * 2 * tokens * mc.top_k * cfg.d_model * p_bytes \
            / n_devices * (2 if kind == "train" else 1)        # a2a disp+comb
    coll_per_dev = coll

    detail = {"fwd_flops_tok": f_tok, "n_params": n_params, "tokens": tokens}
    return CellCost(flops_per_dev, bytes_per_dev, coll_per_dev,
                    flops_total, detail)


# ---------------------------------------------------------------------------
# Storage tier (repro_torch.store / the paper's SmartSSD flash, §6.5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StorageCost:
    """The storage-bandwidth roofline term for an out-of-core (csd) search.

    block_accesses : demand block accesses issued by the engine
    blocks_from_flash : accesses that miss the cache and touch flash
    bytes_from_flash  : blocks_from_flash * block_size (P2P-DMA traffic)
    storage_s         : seconds on the SSD link — compare against the
                        compute/memory/collective terms of roofline_terms;
                        at SIFT1B scale this term dominates (paper Fig. 12:
                        the platform is SSD-bound, 75.59 QPS)
    """

    block_accesses: float
    blocks_from_flash: float
    bytes_from_flash: float
    storage_s: float
    hit_rate: float


# Bytes per stored vector component, per IndexSpec.dtype. The paper's
# SIFT1B tables are uint8 — 1 byte/dim is the operating point that fits a
# billion rows on the SmartSSD and feeds the integer distance units.
# (dtype="pq" is priced per ROW, not per component — see vector_row_bytes.)
VECTOR_DTYPE_BYTES = {"float32": 4, "uint8": 1, "int8": 1}


def vector_row_bytes(dim: int, dtype: str = "float32",
                     lane: int = 128, pq_m: int = 8) -> int:
    """Bytes of one raw-data-table row (lane-padded, paper Fig. 5).

    This is the per-vector-read unit of the storage term: a quantized
    store (dtype uint8/int8) moves 4x fewer bytes per hop than float32 at
    identical traversal behavior — the `csd` backend's measured
    `QueryStats.bytes_read` reflects the same shrink (modulo unchanged
    neighbor-table traffic and block-granularity rounding).

    dtype="pq" breaks the bytes-per-component mold: a row is `pq_m` uint8
    subspace codes regardless of `dim` and is NOT lane-padded (the code
    row IS the stored unit — reader.d_pad == M for a PQ store), so at
    M=8, d=128 each hop moves 16x fewer raw-data bytes than uint8."""
    if dtype == "pq":
        if pq_m < 1:
            raise ValueError(f"pq_m must be >= 1, got {pq_m}")
        return int(pq_m)
    try:
        itemsize = VECTOR_DTYPE_BYTES[dtype]
    except KeyError:
        raise ValueError(
            f"unknown vector dtype {dtype!r}; "
            f"available: {sorted(VECTOR_DTYPE_BYTES) + ['pq']}") from None
    d_pad = ((dim + lane - 1) // lane) * lane
    return d_pad * itemsize


def storage_cost(block_accesses: float, block_size: int,
                 cache_hit_rate: float = 0.0,
                 ssd_bw: float | None = None) -> StorageCost:
    """Cache-hit-adjusted storage term: only misses cross the flash link.

    `block_accesses` is what the engine asks for (e.g. measured
    `QueryStats.block_reads` at hit rate 0, or the analytic
    hops * maxM0 * blocks-per-vector); the PageCache absorbs
    `cache_hit_rate` of it.
    """
    if not 0.0 <= cache_hit_rate <= 1.0:
        raise ValueError(f"cache_hit_rate must be in [0, 1], "
                         f"got {cache_hit_rate}")
    if ssd_bw is None:
        ssd_bw = HW().ssd_bw
    misses = block_accesses * (1.0 - cache_hit_rate)
    nbytes = misses * block_size
    return StorageCost(
        block_accesses=float(block_accesses),
        blocks_from_flash=float(misses),
        bytes_from_flash=float(nbytes),
        storage_s=float(nbytes / ssd_bw),
        hit_rate=float(cache_hit_rate),
    )


@dataclasses.dataclass(frozen=True)
class DispatchCost:
    """Host-side dispatch tax of the superstep traversal loop.

    Each superstep is one host<->device round trip (launch + sync); the
    per-superstep overhead is NOT in the analytic flash/flops terms, and
    the fused-hop loop (fused_hops=H) exists precisely to divide it by
    H. The overhead itself is a measured quantity — `repro_torch.obs.calibrate`
    fits it from the continuous profiler's superstep vs hop-kernel span
    times — so this term prices observed sync cost, not a guess.
    """

    supersteps: float                  # supersteps per query
    overhead_s_per_superstep: float
    dispatch_s: float                  # host seconds per query


def dispatch_cost(supersteps: float,
                  overhead_s_per_superstep: float) -> DispatchCost:
    """Price `supersteps` host round trips per query at a (measured)
    per-superstep overhead."""
    if supersteps < 0 or overhead_s_per_superstep < 0:
        raise ValueError("supersteps and overhead must be >= 0, got "
                         f"{supersteps}, {overhead_s_per_superstep}")
    return DispatchCost(
        supersteps=float(supersteps),
        overhead_s_per_superstep=float(overhead_s_per_superstep),
        dispatch_s=float(supersteps * overhead_s_per_superstep),
    )


# ---------------------------------------------------------------------------
# Ingest tier (repro_torch.ingest): write amplification of the mutable index
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompactionCost:
    """Storage-write cost of a streaming-ingest workload (repro_torch.ingest).

    The mutable index appends one sealed segment per `seal_threshold`
    inserts (bytes_ingested — the unavoidable write) and periodically
    compacts every live segment into one (bytes_rewritten — the
    maintenance tax). Write amplification is the LSM figure of merit:

        write_amp = (bytes_ingested + bytes_rewritten) / bytes_ingested

    `rewrite_s` prices the rewrites on the SSD link — compare against the
    read-side `StorageCost.storage_s` to see how much serving bandwidth a
    given compaction cadence steals (paper §6.5's SSD-bound regime means
    every rewritten byte is a byte not serving queries).
    """

    bytes_ingested: float
    bytes_rewritten: float
    write_amp: float
    seals: int
    compactions: int
    rewrite_s: float


def compaction_cost(n_inserted: int, row_bytes: float,
                    seal_threshold: int, compact_every: int,
                    delete_frac: float = 0.0,
                    ssd_bw: float | None = None) -> CompactionCost:
    """Simulate the seal/compact cadence of `repro_torch.ingest` exactly.

    n_inserted     : total rows streamed in
    row_bytes      : bytes per stored row (launch.costmodel.vector_row_bytes)
    seal_threshold : memtable rows per sealed segment
    compact_every  : run compact() after this many seals (compaction merges
                     ALL live segments — the implemented policy)
    delete_frac    : fraction of live rows tombstoned between compactions
                     (compaction drops them, shrinking later rewrites)

    The simulation replays the policy seal by seal, so the quadratic
    growth of repeated merge-everything compactions is priced honestly
    instead of hidden behind a closed form.
    """
    if not 0.0 <= delete_frac < 1.0:
        raise ValueError(f"delete_frac must be in [0, 1), got {delete_frac}")
    if seal_threshold < 1 or compact_every < 1:
        raise ValueError("seal_threshold and compact_every must be >= 1")
    seals = int(n_inserted // seal_threshold)
    live_rows = 0.0            # rows in the one compacted segment
    pending = 0                # seals since the last compaction
    rewritten_rows = 0.0
    compactions = 0
    for _ in range(seals):
        pending += 1
        if pending >= compact_every:
            merged = live_rows + pending * seal_threshold
            live_rows = merged * (1.0 - delete_frac)
            rewritten_rows += live_rows
            compactions += 1
            pending = 0
    bytes_ingested = float(n_inserted) * row_bytes
    bytes_rewritten = rewritten_rows * row_bytes
    if ssd_bw is None:
        ssd_bw = HW().ssd_bw
    return CompactionCost(
        bytes_ingested=bytes_ingested,
        bytes_rewritten=bytes_rewritten,
        write_amp=((bytes_ingested + bytes_rewritten) / bytes_ingested
                   if bytes_ingested else 1.0),
        seals=seals,
        compactions=compactions,
        rewrite_s=float(bytes_rewritten / ssd_bw),
    )


# ---------------------------------------------------------------------------
# Cluster tier (repro_torch.cluster): router scatter-gather vs aggregate flash
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterFanoutCost:
    """Fan-out economics of a sharded cluster (repro_torch.cluster).

    Sharding buys aggregate flash bandwidth (every shard replica brings its
    own SSD) but pays two taxes the single box does not: the router link
    (each query is scattered to all N shards and N top-k lists come back)
    and duplicated traversal (each shard runs the FULL-ef search over its
    1/N of the rows — that over-fetch is exactly what makes the merge
    bit-identical, so total flash work grows ~linearly with N).

    router_bytes_q     : per-query bytes on the router link (scatter+gather)
    flash_bytes_q      : per-query bytes from flash, summed over shards
    aggregate_ssd_bw   : n_shards * replicas * per-node ssd_bw
    router_qps / storage_qps : each side's throughput ceiling
    modeled_qps        : min of the two; `bound` names the binding side
    """

    n_shards: int
    replicas: int
    router_bytes_q: float
    flash_bytes_q: float
    aggregate_ssd_bw: float
    router_qps: float
    storage_qps: float
    modeled_qps: float
    bound: str


def cluster_fanout_cost(n_shards: int, replicas: int = 1, *, dim: int,
                        k: int, blocks_per_query: float, block_size: int,
                        cache_hit_rate: float = 0.0,
                        ssd_bw: float | None = None,
                        link_bw: float = 10e9) -> ClusterFanoutCost:
    """Price an N-shard x R-replica cluster for one query stream.

    blocks_per_query : PER-SHARD demand block accesses (a single shard's
                       measured `QueryStats.block_reads`, or the analytic
                       hops * blocks-per-hop — full-ef traversal over the
                       shard's rows, which is why it does not shrink 1/N)
    link_bw          : router NIC bandwidth, bytes/s (default 10 GbE)

    Router side: scatter `dim * 4` query bytes to each shard, gather
    `k * 12` result bytes (int64 id + f32 dist) back from each. Storage
    side: each query burns `flash_bytes_q` across its N owning replicas
    while the cluster's capacity is the aggregate of all N*R SSDs — so
    replicas raise storage QPS linearly, and shards raise it only through
    aggregation minus the duplicated-traversal tax.
    """
    if n_shards < 1 or replicas < 1:
        raise ValueError(
            f"n_shards and replicas must be >= 1, got {n_shards}, "
            f"{replicas}")
    if not 0.0 <= cache_hit_rate <= 1.0:
        raise ValueError(f"cache_hit_rate must be in [0, 1], "
                         f"got {cache_hit_rate}")
    if ssd_bw is None:
        ssd_bw = HW().ssd_bw
    router_bytes_q = float(n_shards) * (dim * 4.0 + k * 12.0)
    per_shard_bytes = blocks_per_query * block_size * (1.0 - cache_hit_rate)
    flash_bytes_q = float(n_shards) * per_shard_bytes
    aggregate_ssd_bw = float(n_shards * replicas) * ssd_bw
    router_qps = link_bw / router_bytes_q if router_bytes_q else float("inf")
    storage_qps = (aggregate_ssd_bw / flash_bytes_q if flash_bytes_q
                   else float("inf"))
    modeled = min(router_qps, storage_qps)
    return ClusterFanoutCost(
        n_shards=int(n_shards), replicas=int(replicas),
        router_bytes_q=router_bytes_q, flash_bytes_q=flash_bytes_q,
        aggregate_ssd_bw=aggregate_ssd_bw, router_qps=float(router_qps),
        storage_qps=float(storage_qps), modeled_qps=float(modeled),
        bound="router" if router_qps <= storage_qps else "storage")


def _count_params(cfg: ModelConfig) -> float:
    """Total param count (matches init_params; calibrated in tests)."""
    d = cfg.d_model
    n = 0.0
    if cfg.embed_inputs:
        n += cfg.padded_vocab * d
    for s in cfg.all_specs():
        n += d  # ln1
        if s.kind == "attn":
            n += d * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
            if cfg.qk_norm:
                n += 2 * cfg.head_dim
        elif s.kind == "mla":
            m = cfg.mla
            n += d * cfg.n_heads * (m.qk_nope + m.qk_rope)
            n += d * (m.kv_lora + m.qk_rope) + m.kv_lora
            n += m.kv_lora * cfg.n_heads * (m.qk_nope + m.v_dim)
            n += cfg.n_heads * m.v_dim * d
        elif s.kind == "mamba":
            mc = cfg.mamba
            di, r, S = mc.inner(d), mc.rank(d), mc.d_state
            n += d * 2 * di + mc.d_conv * di + di
            n += di * (r + 2 * S) + r * di + di + di * S + di + di * d
        elif s.kind == "mlstm":
            xc = cfg.xlstm
            di = int(xc.m_proj_factor * d)
            n += d * 2 * di + xc.d_conv * di + di
            n += 3 * di * di + 2 * di * xc.n_heads + 3 * di + di * d
        elif s.kind == "slstm":
            xc = cfg.xlstm
            dh = d // xc.n_heads
            ff = int(xc.s_ffn_factor * d)
            n += d * 4 * d + 4 * d * dh + 4 * d + d
            n += d * 2 * ff + ff * d
        if s.ffn == "glu":
            n += d + 3 * d * cfg.d_ff
        elif s.ffn == "dense":
            n += d + 2 * d * cfg.d_ff
        elif s.ffn == "moe":
            mc = cfg.moe
            n += d + d * mc.num_experts
            n += mc.num_experts * 3 * d * mc.d_ff
            if mc.n_shared:
                n += 3 * d * mc.shared_ff()
    n += d
    if not (cfg.tie_embeddings and cfg.embed_inputs):
        n += d * cfg.num_output_heads * cfg.padded_vocab
    return n


def _act_bytes(cfg: ModelConfig, tokens, seq, kind) -> float:
    """Dominant activation HBM traffic (global): layer inputs written+read,
    x2 for train (bwd reads the remat carry again)."""
    per_layer = tokens * cfg.d_model * 2.0
    mult = {"train": 4.0, "prefill": 2.0, "decode": 2.0}[kind]
    return cfg.num_layers * per_layer * mult


def _cache_bytes(cfg: ModelConfig, batch, seq) -> float:
    """Global KV/recurrent cache size in bytes (bf16 KV, f32 states)."""
    total = 0.0
    for s in cfg.all_specs():
        if s.kind == "attn":
            S = min(seq, s.window) if s.window else seq
            kv_b = 1.06 if getattr(cfg, "kv_quant", False) else 2.0
            total += 2 * batch * S * cfg.n_kv_heads * cfg.head_dim * kv_b
        elif s.kind == "mla":
            total += batch * seq * (cfg.mla.kv_lora + cfg.mla.qk_rope) * 2.0
        elif s.kind == "mamba":
            mc = cfg.mamba
            di = mc.inner(cfg.d_model)
            total += batch * di * (mc.d_state * 4.0 + (mc.d_conv - 1) * 2.0)
        elif s.kind == "mlstm":
            xc = cfg.xlstm
            di = int(xc.m_proj_factor * cfg.d_model)
            dh = di // xc.n_heads
            total += batch * (di * dh + di) * 4.0
        elif s.kind == "slstm":
            total += batch * 4 * cfg.d_model * 4.0
    return total
