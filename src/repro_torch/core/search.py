"""Fixed-shape HNSW search in PyTorch (paper Algorithm 1, HW-modified).

The port of the reference's `core/search.py`, batched over query lanes
instead of vmapped:

  * single-bit visited list     -> packed bitmap, N/8 bytes a lane (int32
                                   words holding the reference's uint32 bits)
  * parallel distance calculator-> ||x||^2 - 2 x.q + ||q||^2 over a whole
                                   padded neighbor row, mul + sum
  * parallel insertion sort     -> rank-based merge of sorted rows
                                   (`merge_sorted`)
  * multi-query processing      -> a written-out lane axis; the stacked
                                   partition axis P is folded into it, so
                                   L = P*B lanes search at once

Upper layers run a greedy descent (ef = 1): `ops.greedy_descent`, one
launch of `csrc/descent.cu` on the card for every lane, layer and hop,
its plain version (lockstep torch ops with a per-lane `running` mask, a
host sync a hop) on the CPU. Layer 0
of a float32 or 8-bit DB always runs the superstep loop: `fused_layer0`
advances every lane by H = max(fused_hops, 1) hops per call — the CUDA
kernel on the card, its plain version on the CPU — until no lane is live.
The reference's own contract makes the result bit-identical at every
`fused_hops`.

Quantized DBs (IndexSpec.dtype uint8/int8): `db.vectors` holds integer
codes and the queries are code-valued float32. Every distance casts the
gathered rows to float32 and accumulates in float32, exact for 8-bit
codes up to 256 dims, so the traversal is the same in code space;
`db.sqnorms` stays float32 (code norms, +inf pad markers). The caller
rescales distances by scale**2.

Product-quantized DBs (dtype "pq"): `db.vectors` holds [N_pad, M] uint8
codes and the caller passes `lut`, the per-query [M, 256] ADC tables.
Every distance is `pq_lut_distances` (a table gather, then a sum over
subspaces). Queries are not padded, and the descent (kernels/descent.py
`greedy_upper`) and layer 0 (`_search_layer0_pq`) run as plain torch ops on every device,
as the reference's PQ path is plain JAX.

Ids are int32 everywhere, -1 padded; distances are +inf padded.

Spans (`TRACER.child_span`, under the caller's `search`): `descend`
around the upper layers (`lanes`; `route`: "kernel" with `syncs` 0 and
`launches` 1, or "plain" with `hops`, the lockstep hops, and `syncs`, the
host syncs that decided them) and `layer0` around layer 0 (`lanes`;
`supersteps`, the traversal launches; `dev_ms` on CUDA).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.hnsw_graph import DeviceDB
from repro_torch.kernels.descent import greedy_upper
from repro_torch.kernels.ops import fused_layer0, greedy_descent
from repro_torch.kernels.traversal import (
    layer0_hop,
    merge_sorted,
    metric_distance,
    visited_test_and_set,
)
from repro_torch.obs.trace import TRACER

__all__ = [
    "SearchParams",
    "SearchStats",
    "bitmap_words",
    "merge_sorted",
    "metric_distance",
    "pq_lut_distances",
    "visited_test_and_set",
    "prepare_queries",
    "search_layer0",
    "search_lanes",
    "batch_search",
]

_INF = float("inf")
# row dtypes of a table searched by mul + sum (PQ code tables take a LUT)
_ROW_DTYPES = (torch.float32, torch.uint8, torch.int8)


def bitmap_words(n: int) -> int:
    """Words needed for an n-bit visited bitmap: ceil(n / 32) (floor
    division here once aliased the last partial word)."""
    return (n + 31) // 32


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Search-time knobs (paper: ef=40, K=10 for all SIFT1B results).

    `metric`: l2 (squared Euclidean), ip (negative inner product) or
    cosine (1 - q.x over unit-norm inputs). `fused_hops` is the number of
    layer-0 hops per traversal launch; results are bit-identical at every
    value."""

    ef: int = 40
    k: int = 10
    cand_size: int = 0        # 0 -> resolved to ef + maxM0
    max_hops: int = 0         # 0 -> resolved to 4*ef + 16
    upper_hops: int = 32      # per-layer greedy budget in upper layers
    metric: str = "l2"
    fused_hops: int = 1

    def resolve(self, maxM0: int) -> "SearchParams":
        cand = self.cand_size or (self.ef + maxM0)
        hops = self.max_hops or (4 * self.ef + 16)
        return dataclasses.replace(self, cand_size=cand, max_hops=hops)


class SearchStats(NamedTuple):
    hops: torch.Tensor        # candidate pops at layer 0 (per query)
    dist_calcs: torch.Tensor  # distance evaluations == "vector reads" (Fig. 9)


def pq_lut_distances(lut, codes):
    """ADC distances of PQ code rows: lut [..., M, 256] x codes
    [..., N, M] -> [..., N].

    A gather of lut[..., m, codes[..., n, m]], then `.sum(-1)` over the
    subspaces: the reference's one accumulation for PQ distances
    (`take_along_axis` then `jnp.sum(..., -1)`)."""
    m = lut.shape[-2]
    flat = lut.reshape(*lut.shape[:-2], 1, m * 256)
    idx = codes.long() + torch.arange(m, device=codes.device) * 256
    vals = flat.expand(*idx.shape[:-1], m * 256).gather(-1, idx)
    return vals.sum(-1)


def _lane_distance_fn(db: DeviceDB, part, lut):
    """distances(idx [L, M] int64) -> [L, M]: lane l's ADC distances to
    rows idx[l] of its partition part[l], from its tables `lut` [L, M_pq,
    256] (dtype="pq"): a LUT gather + sum."""
    rows = part[:, None]
    return lambda idx: pq_lut_distances(lut, db.vectors[rows, idx])


# ---------------------------------------------------------------------------
# Layer 0: beam search driven by H-hop supersteps (paper §5.2.3, Fig. 6)
# ---------------------------------------------------------------------------


def _initial_beam(n_pad: int, ep, ep_d, p: SearchParams):
    """The layer-0 state of L lanes entering at (ep, ep_d): one entry a
    lane [L], or an entry list [L, K <= ef] ascending and (+inf, -1)
    padded. Candidate and final lists, the visited bitmap with the
    entries set, hops and dist_calcs."""
    if ep.dim() == 1:
        ep, ep_d = ep[:, None], ep_d[:, None]
    L, K = ep.shape
    dev = ep.device
    C, EF = p.cand_size, p.ef
    visited = torch.zeros((L, bitmap_words(n_pad)), dtype=torch.int32,
                          device=dev)
    _, visited = visited_test_and_set(visited, ep.clamp_min(0), ep >= 0)
    cand_d = torch.full((L, C), _INF, device=dev)
    cand_i = torch.full((L, C), -1, dtype=torch.int32, device=dev)
    fin_d = torch.full((L, EF), _INF, device=dev)
    fin_i = torch.full((L, EF), -1, dtype=torch.int32, device=dev)
    cand_d[:, :K], cand_i[:, :K] = ep_d, ep
    fin_d[:, :K], fin_i[:, :K] = ep_d, ep
    hops = torch.zeros(L, dtype=torch.int32, device=dev)
    calcs = torch.zeros(L, dtype=torch.int32, device=dev)
    return [cand_d, cand_i, fin_d, fin_i, visited, hops, calcs]


def search_layer0(vectors, sqnorms, l0_nbrs, queries, qsq, ep, ep_d,
                  p: SearchParams, span=None):
    """The beam search at layer 0 of partition-stacked tables [P, N_pad,
    ...] from (ep, ep_d) (as `_initial_beam` takes them): `fused_layer0`
    supersteps until no lane is live. Returns (fin_d, fin_i, hops,
    calcs); `span` (the `layer0` span) gets `supersteps`, the traversal
    launches."""
    state = _initial_beam(vectors.shape[1], ep, ep_d, p)
    cand_d, _, fin_d, fin_i, _, hops, calcs = state
    steps = 0
    # Algorithm 1 lines 2 & 5: a lane is live while its nearest candidate
    # can still improve the final list and its hop budget lasts
    while bool(((cand_d[:, 0] < fin_d[:, -1]) & (hops < p.max_hops)).any()):
        fused_layer0(vectors, sqnorms, l0_nbrs, queries, qsq, *state,
                     fused_hops=max(p.fused_hops, 1), max_hops=p.max_hops,
                     metric=p.metric)
        steps += 1
    if span is not None:
        span.set(supersteps=steps)
    return fin_d, fin_i, hops, calcs


def _search_layer0_pq(db: DeviceDB, part, distances, ep, ep_d,
                      p: SearchParams, span=None):
    """Layer 0 of a dtype="pq" DB: one hop for every live lane per loop
    iteration, as plain torch ops on the DB's device.

    This is the port of the reference's PQ layer 0, which is plain JAX
    (its fused traversal kernel has no PQ variant), not a fallback from
    a kernel. `fused_hops` does not apply, so results are trivially
    identical at every value. `span` gets `supersteps`, the hops."""
    state = _initial_beam(db.vectors.shape[1], ep, ep_d, p)
    steps = 0
    while layer0_hop(db.l0_nbrs, part, distances, *state,
                     max_hops=p.max_hops):
        steps += 1
    if span is not None:
        span.set(supersteps=steps)
    _, _, fin_d, fin_i, _, hops, calcs = state
    return fin_d, fin_i, hops, calcs


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def prepare_queries(queries, d_pad: int, device) -> torch.Tensor:
    """Float32 queries on `device`, zero-padded to the table width."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    if q.shape[-1] < d_pad:
        q = torch.nn.functional.pad(q, (0, d_pad - q.shape[-1]))
    return q.contiguous()


def search_lanes(db: DeviceDB, queries, p: SearchParams, lut=None):
    """Search every partition of a stacked DB for every query.

    db: partition-stacked tensors ([P, N_pad, ...]); queries [B, D];
    lut: the [B, M, 256] ADC tables of a dtype="pq" DB, else None.
    Returns global ids [P, B, k] int32, dists [P, B, k] and per-partition
    SearchStats ([P, B])."""
    P, _, d_pad = db.vectors.shape
    dev = db.vectors.device
    p = p.resolve(db.l0_nbrs.shape[-1])
    if lut is None:
        if db.vectors.dtype not in _ROW_DTYPES:
            raise TypeError(
                f"{db.vectors.dtype} rows are not searchable; tables hold "
                f"float32, uint8 or int8 rows, or PQ codes with a `lut`")
        queries = prepare_queries(queries, d_pad, dev)
        qsq = (queries * queries).sum(-1)
        B = queries.shape[0]
    else:
        lut = torch.as_tensor(lut, dtype=torch.float32, device=dev)
        B = lut.shape[0]
    lane = torch.arange(P * B, device=dev)
    part, qrow = lane // B, lane % B
    with TRACER.child_span("descend", lanes=P * B) as span:
        if lut is None:
            ep, ep_d, up_calcs = greedy_descent(
                db.vectors, db.sqnorms, db.up_ptr, db.up_nbrs, db.entry,
                db.max_level, queries, qsq, upper_hops=p.upper_hops,
                metric=p.metric, span=span)
        else:
            dist = _lane_distance_fn(db, part, lut[qrow])
            ep, ep_d, up_calcs = greedy_upper(
                db.up_ptr, db.up_nbrs, db.entry, db.max_level, part, dist,
                p.upper_hops, span)
    with TRACER.child_span("layer0", device_clock=dev, lanes=P * B) as span:
        if lut is None:
            fin_d, fin_i, hops, calcs = search_layer0(
                db.vectors, db.sqnorms, db.l0_nbrs, queries, qsq, ep, ep_d,
                p, span)
        else:
            fin_d, fin_i, hops, calcs = _search_layer0_pq(db, part, dist,
                                                          ep, ep_d, p, span)
    k_d, k_i = fin_d[:, : p.k], fin_i[:, : p.k]
    k_g = torch.where(k_i >= 0,
                      db.gids[part[:, None], k_i.clamp_min(0).long()], -1)
    return (k_g.reshape(P, B, -1), k_d.reshape(P, B, -1),
            SearchStats(hops.reshape(P, B), (calcs + up_calcs).reshape(P, B)))


def batch_search(db: DeviceDB, queries, p: SearchParams, lut=None):
    """Multi-query search of one (unstacked) DeviceDB.

    Returns (global ids [B, k] int32, dists [B, k], SearchStats [B])."""
    stacked = DeviceDB(*(t.unsqueeze(0) for t in db))
    ids, ds, st = search_lanes(stacked, queries, p, lut)
    return ids[0], ds[0], SearchStats(st.hops[0], st.dist_calcs[0])
