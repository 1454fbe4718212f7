"""SIFT1B-scale dry-run of the paper's engine on the reference's production
layout, priced with the card's constants (the reference's
`launch/ann_dryrun.py`).

The paper's deployment: 1B x 128-dim vectors split into DRAM-sized
sub-graphs, graph parallelism across devices. Here, as in the reference:
256 partitions of ~3.9M vectors (cf. the paper's ~5M per SmartSSD), one a
device over ("data", "model"); with --multi-pod a second pod of 256
devices holds the same partitions and the queries split over "pod".
ef 40, k 10 (the paper's SIFT1B point).

Nothing is compiled or allocated. The reference lowers its distributed
search from ShapeDtypeStructs and reads XLA's memory analysis and HLO;
the port has neither, so:

  * the SIFT1B tables are tensors on device="meta" with the reference's
    shapes and dtypes; their `nbytes` over the 256 graph slots give
    `db_bytes_per_device`;
  * `resident_bytes` adds the working set of one batch on a device, the
    beam state `core/search.py` allocates for each lane (mostly the
    visited bitmap, `bitmap_words(n_pad)` int32 words a lane), and
    `fits_hbm` compares it with `HW.hbm_bytes`;
  * `collectives` holds the bytes the distributed search's stage-1 gather
    moves onto the first slot's device (`DistributedSearch.gather_bytes`,
    kind "gather"). The reference's kinds are XLA's collectives (an
    all-gather into every device); the port runs every slot from one
    controller and concatenates the pools on one device instead.

  PYTHONPATH=src python -m repro_torch.launch.ann_dryrun [--multi-pod] \\
      [--batch N] [--calibrated METRICS_JSON]

The record is printed as one line of JSON (the last line of the output).
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core.distributed import make_distributed_search
from repro_torch.core.hnsw_graph import DeviceDB
from repro_torch.core.search import SearchParams, bitmap_words
from repro_torch.launch.costmodel import (cluster_fanout_cost,
                                          compaction_cost, dispatch_cost,
                                          storage_cost, vector_row_bytes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HW

__all__ = ["sift1b_db_specs", "batch_working_set", "dryrun", "main"]

P_PARTS = 256


def sift1b_db_specs(n_total=1_000_000_000, dim=128, M=16, levels=7):
    """Meta-device stand-ins for the restructured SIFT1B database, stacked
    over its P_PARTS partitions."""
    n_pad = -(-(n_total // P_PARTS) // 32) * 32
    d_pad = 128 * -(-dim // 128)
    m0p, mp = 2 * M, M
    up_rows = -(-n_pad // 16) * 2        # ~1/(M-1) of points have level>=1

    def f(*shape, dtype=torch.int32):
        return torch.empty((P_PARTS, *shape), dtype=dtype, device="meta")

    return DeviceDB(
        vectors=f(n_pad, d_pad, dtype=torch.float32),
        sqnorms=f(n_pad, dtype=torch.float32),
        l0_nbrs=f(n_pad, m0p),
        up_nbrs=f(levels, up_rows, mp),
        up_ptr=f(n_pad),
        levels=f(n_pad),
        gids=f(n_pad),
        entry=f(),
        max_level=f(),
        n_valid=f(),
    ), n_pad, d_pad, m0p


def batch_working_set(lanes: int, n_pad: int, cand: int, ef: int) -> int:
    """Bytes of the layer-0 beam state `core.search._initial_beam`
    allocates for `lanes` lanes (a lane: one query in one partition): the
    visited bitmap, `bitmap_words(n_pad)` int32 words; the candidate and
    final lists, float32 distances and int32 ids, `cand` and `ef` long;
    hops and dist_calcs, int32."""
    return lanes * (4 * bitmap_words(n_pad) + 8 * cand + 8 * ef + 8)


def dryrun(multi_pod: bool = False, batch: int = 4096,
           calibrated: str | None = None, hw: HW = HW()) -> dict:
    """The record `main` prints (the reference's keys and sections)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    db, n_pad, d_pad, m0p = sift1b_db_specs()
    p = SearchParams(ef=40, k=10)                 # the paper's SIFT1B point
    qaxes = ("pod",) if multi_pod else ()
    search = make_distributed_search(mesh, p, m0p,
                                     graph_axes=("data", "model"),
                                     query_axes=qaxes)
    sp = search.p                                 # resolved: cand = ef + m0p
    db_bytes = sum(t.nbytes for t in db) // search.n_graph
    lanes = (P_PARTS // search.n_graph) * (batch // search.n_query)
    resident = db_bytes + batch_working_set(lanes, n_pad, sp.cand_size,
                                            sp.ef)
    gather = float(search.gather_bytes(batch, P_PARTS))
    coll = {"gather": gather, "total": gather}
    # memory-bound engine roofline: per-query HBM traffic per hop-budget.
    reads_per_query = 4 * p.ef + 16                # hop budget (worst case)
    bytes_per_query = reads_per_query * m0p * (d_pad * 4 + 4)
    qps_chip = hw.hbm_bw / bytes_per_query

    # storage-bound alternative (repro_torch.store csd mode): the same
    # traversal with the DB on flash — each vector read is one block read
    # over the SSD link; the PageCache absorbs part of it. This reproduces
    # the paper's storage-bound analysis (§6.5 / Fig. 12). SIFT1B itself
    # is uint8 (IndexSpec.dtype): rows shrink 4x, and because the SSD link
    # is byte-limited the effective blocks-per-read shrink with them — the
    # uint8 entry is the paper's actual operating point. The pq entry
    # (M=8 codes, 16x below uint8 at d=128) shows how far LUT-based ADC
    # pushes the same storage-bound roofline.
    block_size = 4096
    storage = {}
    for dtype in ("float32", "uint8", "pq"):
        row_b = vector_row_bytes(128, dtype)
        # row_bytes/block_size of a block per vector read: the byte-limited
        # SSD-link view (block-packing locality at 8..32 rows per block)
        blocks_per_query = reads_per_query * m0p * row_b / block_size
        per_hit = {}
        for hit in (0.0, 0.5, 0.9):
            sc = storage_cost(blocks_per_query, block_size,
                              cache_hit_rate=hit, ssd_bw=hw.ssd_bw)
            per_hit[f"hit_{hit:.1f}"] = {
                "bytes_from_flash_per_query": sc.bytes_from_flash,
                "modeled_qps_per_device": round(1.0 / sc.storage_s, 2),
            }
        storage[dtype] = {"vector_row_bytes": row_b,
                          "blocks_per_query": round(blocks_per_query, 1),
                          **per_hit}
    blocks_per_query = storage["float32"]["blocks_per_query"]

    # streaming-ingest term (repro_torch.ingest): what growing the same
    # database online would cost in SSD writes. One day of heavy insert
    # traffic at ~1% of the corpus, sealed in SmartSSD-DRAM-sized
    # memtables and compacted every 8 seals (the merge-everything policy
    # the compactor implements), priced as write amplification on the
    # same SSD link the reads contend for.
    ingest = {}
    n_daily = 10_000_000
    seal_threshold = 1_000_000
    compact_every = 8
    for dtype in ("float32", "uint8", "pq"):
        row_b = vector_row_bytes(128, dtype)
        cc = compaction_cost(n_daily, row_b, seal_threshold, compact_every,
                             delete_frac=0.05, ssd_bw=hw.ssd_bw)
        ingest[dtype] = {
            "bytes_ingested": cc.bytes_ingested,
            "bytes_rewritten": cc.bytes_rewritten,
            "write_amplification": round(cc.write_amp, 2),
            "seals": cc.seals,
            "compactions": cc.compactions,
            "rewrite_s_on_ssd_link": round(cc.rewrite_s, 1),
        }
    ingest_note = (
        "mutable-index (repro_torch.ingest) write path: {} inserts/day at "
        "seal_threshold={}, compact every {} seals, 5% churn; rewrite "
        "seconds come out of the same SSD link the storage-bound read "
        "roofline above prices".format(n_daily, seal_threshold,
                                       compact_every))

    # cluster fan-out term (repro_torch.cluster): the same storage-bound
    # search sharded across nodes. Each shard replica brings its own SSD
    # link, so aggregate flash bandwidth scales with N*R, but every query
    # pays the router scatter-gather plus full-ef traversal on EVERY shard
    # (the over-fetch that keeps the merge bit-identical) — this row shows
    # where the cluster stops being storage-bound and the router NIC
    # takes over.
    cluster = {}
    for n_shards in (1, 2, 4):
        for reps in (1, 2):
            fc = cluster_fanout_cost(
                n_shards, reps, dim=128, k=10,
                blocks_per_query=blocks_per_query, block_size=block_size,
                cache_hit_rate=0.5, ssd_bw=hw.ssd_bw)
            cluster[f"shards_{n_shards}x{reps}"] = {
                "router_bytes_per_query": fc.router_bytes_q,
                "flash_bytes_per_query": fc.flash_bytes_q,
                "aggregate_ssd_bw": fc.aggregate_ssd_bw,
                "modeled_qps": round(fc.modeled_qps, 1),
                "bound": fc.bound,
            }

    rec = {
        "mesh": "multi" if multi_pod else "single",
        "devices": int(mesh.size),
        "partitions": P_PARTS,
        "vectors_per_partition": n_pad,
        "db_bytes_per_device": int(db_bytes),
        "resident_bytes": int(resident),
        "fits_hbm": bool(resident < hw.hbm_bytes),
        "collectives": coll,
        "modeled_worstcase_qps_per_chip": round(qps_chip, 1),
        "csd_storage_bound": {
            "block_size": block_size,
            "blocks_per_query": blocks_per_query,
            "ssd_bw": hw.ssd_bw,
            **storage,
            "note": ("out-of-core (backend='csd') roofline: storage term "
                     "dominates HBM by ~{:.0f}x at hit 0 — the paper's "
                     "SSD-bound regime (75.59 QPS on 4 SmartSSDs)".format(
                         (blocks_per_query * block_size / hw.ssd_bw)
                         / (bytes_per_query / hw.hbm_bw))),
        },
        "ingest_write_amplification": {**ingest, "note": ingest_note},
        "cluster_fanout": {
            **cluster,
            "note": ("repro_torch.cluster scatter-gather at cache hit 0.5 "
                     "over a 10 GbE router link: replicas scale storage QPS "
                     "linearly; shards add SSDs but also duplicate full-ef "
                     "traversal, so gains flatten until the router binds"),
        },
        "note": ("stage-2 merge traffic per query = P*k*(4+4)B gathered "
                 "onto one device — negligible vs stage-1 HBM reads "
                 "(paper: 0.2%)"),
    }

    if calibrated:
        # capacity planning on observed numbers: fit the HW parameters
        # from the snapshot, report per-term error, and reprice the
        # MEASURED workload with the fitted parameters
        from repro_torch.obs.calibrate import compare_terms, load_calibration
        cal = load_calibration(calibrated)
        section = {
            "source": calibrated,
            "fitted": cal.asdict(),
            "terms": compare_terms(cal, hw=hw),
        }
        if (cal.queries and cal.blocks_per_query and cal.block_size
                and cal.effective_ssd_bw):
            sc = storage_cost(cal.blocks_per_query, cal.block_size,
                              cache_hit_rate=cal.cache_hit_rate or 0.0,
                              ssd_bw=cal.effective_ssd_bw)
            dc = dispatch_cost(cal.supersteps_per_query or 0.0,
                               cal.dispatch_overhead_s or 0.0)
            total_s = sc.storage_s + dc.dispatch_s
            section["measured_workload"] = {
                "storage_s_per_query": sc.storage_s,
                "dispatch_s_per_query": dc.dispatch_s,
                "calibrated_qps_per_device": (round(1.0 / total_s, 2)
                                              if total_s > 0 else None),
            }
        rec["calibration"] = section
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--calibrated", default=None, metavar="METRICS_JSON",
                    help="fit the cost-model HW parameters (effective SSD "
                         "bandwidth, cache hit rate, dispatch overhead) "
                         "from this metrics snapshot (the exporter's .json "
                         "output) and report per-term modeled-vs-measured "
                         "error alongside the prior-based numbers")
    args = ap.parse_args(argv)
    rec = dryrun(args.multi_pod, args.batch, args.calibrated)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
