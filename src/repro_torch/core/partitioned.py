"""Two-stage partitioned HNSW (paper §4.1, Fig. 3).

Stage 1: the dataset is split into P segments, each with its own HNSW
graph; every partition is searched for every query. Here the P stacked
partitions are folded into the lane axis, so one traversal launch serves
all P*B (partition, query) lanes.

Stage 2: the P x K intermediate results are reduced to the final K by a
stable sort on the exact distances; `api.rerank.batched_rerank` optionally
re-scores the P*K pool from the raw vectors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hnsw_graph as hg
from repro_torch.core.search import SearchParams, search_lanes
from repro_torch.obs.trace import TRACER
from repro_torch.optim.compression import code_dtype

__all__ = [
    "PartitionedDB",
    "build_partitioned_db",
    "quantize_db_vectors",
    "search_partitioned",
    "search_partitioned_candidates",
    "merge_topk",
]


class PartitionedDB(NamedTuple):
    """Stacked DeviceDB: every field has a leading partition axis P."""

    db: hg.DeviceDB              # each leaf: [P, ...]
    num_partitions: int
    dim: int


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _build_each(parts: list, cfgs: list) -> list[hg.HostGraph]:
    return [hg.build_hnsw(v, c) for v, c in zip(parts, cfgs)]


def build_partitioned_db(
    vectors: np.ndarray,
    num_partitions: int,
    cfg: hg.HNSWConfig,
    build_graphs=None,
) -> PartitionedDB:
    """Split -> build P independent graphs (seed cfg.seed + p) ->
    restructure to uniform shapes. Numpy tables; `hg.device_db` moves them
    to a device. `build_graphs(parts, cfgs) -> [HostGraph]` builds the P
    graphs at once; by default `hg.build_hnsw` builds each in turn, and
    the tables are byte-identical to the reference's."""
    n = vectors.shape[0]
    bounds = np.linspace(0, n, num_partitions + 1).astype(np.int64)
    parts, cfgs, gids = [], [], []
    for p in range(num_partitions):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        parts.append(vectors[lo:hi])
        cfgs.append(hg.HNSWConfig(**{**cfg.__dict__, "seed": cfg.seed + p}))
        gids.append(np.arange(lo, hi, dtype=np.int32))
    graphs = (build_graphs or _build_each)(parts, cfgs)
    n_pad = _round_up(max(int(b1 - b0) for b0, b1 in zip(bounds, bounds[1:])), 32)
    up_pad = _round_up(max(g.up_nbrs.shape[1] for g in graphs), 8)
    dbs = [
        hg.restructure(g, gids=gid, n_pad=n_pad, up_pad=up_pad)
        for g, gid in zip(graphs, gids)
    ]
    stacked = hg.DeviceDB(*(np.stack([getattr(d, f) for d in dbs]) for f in hg.DeviceDB._fields))
    return PartitionedDB(db=stacked, num_partitions=num_partitions, dim=vectors.shape[1])


def quantize_db_vectors(pdb: PartitionedDB, dtype: str,
                        quant=None) -> PartitionedDB:
    """Swap the stacked (numpy) DB's raw-data leaf for stored codes.

    uint8/int8: the graphs were built over code-valued float32, so the
    integer cast is exact and only the storage shrinks (4x for uint8).
    dtype="pq" needs the fitted PQQuantizer: the graphs were built over
    the original float32 rows (full-precision graph, PQ traversal) and
    each [N_pad, D_pad] row becomes an [N_pad, pq_m] uint8 code row; pad
    rows encode garbage but stay unreachable (no neighbor list points at
    them, and their sqnorms keep the +inf marker). A no-op for float32 or
    a leaf that already holds codes."""
    if dtype == "float32":
        return pdb
    vecs = np.asarray(pdb.db.vectors)
    if vecs.dtype == code_dtype(dtype) and (
            dtype != "pq" or vecs.shape[-1] == quant.m):
        return pdb
    if dtype == "pq":
        if quant is None:
            raise ValueError("dtype='pq' needs the fitted PQQuantizer")
        p_ax, n_pad, _ = vecs.shape
        flat = vecs.reshape(p_ax * n_pad, -1)[:, :pdb.dim]
        codes = quant.encode(np.ascontiguousarray(flat, np.float32))
        db = pdb.db._replace(vectors=codes.reshape(p_ax, n_pad, quant.m))
        return pdb._replace(db=db)
    db = pdb.db._replace(vectors=vecs.astype(code_dtype(dtype)))
    return pdb._replace(db=db)


def merge_topk(ids, dists, k: int):
    """Stage-2 reduction: [..., P, K] -> top-k by distance (stable, so
    among equal distances the earlier partition wins)."""
    *lead, P, K = ids.shape
    flat_i = ids.reshape(*lead, P * K)
    flat_d = dists.reshape(*lead, P * K)
    top = torch.sort(flat_d, dim=-1, stable=True).indices[..., :k]
    return flat_i.gather(-1, top), flat_d.gather(-1, top)


def search_partitioned(pdb: PartitionedDB, queries, p: SearchParams,
                       lut=None):
    """Single-device two-stage search: every partition, then the merge
    (the span `merge`; `candidates`: a query's P*k).

    Returns (ids [B, k], dists [B, k], stats [P, B]) with global ids.
    `lut` ([B, M, 256]) is the per-query ADC table of a dtype="pq" DB,
    shared by every partition (one code space per index)."""
    ids, ds, stats = search_lanes(pdb.db, queries, p, lut)
    with TRACER.child_span("merge", candidates=ids.shape[0] * ids.shape[2]):
        out_i, out_d = merge_topk(ids.transpose(0, 1), ds.transpose(0, 1),
                                  p.k)
    return out_i, out_d, stats


def search_partitioned_candidates(pdb: PartitionedDB, queries,
                                  p: SearchParams, lut=None):
    """Stage 1 only: the P*K intermediate candidates, unmerged.

    Returns (ids [B, P*k], dists [B, P*k], stats [P, B]) — the pool the
    paper's stage-2 brute force re-scores (api.rerank.batched_rerank)."""
    ids, ds, stats = search_lanes(pdb.db, queries, p, lut)
    b = ids.shape[1]
    return (ids.transpose(0, 1).reshape(b, -1),
            ds.transpose(0, 1).reshape(b, -1), stats)
