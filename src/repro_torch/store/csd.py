"""Out-of-core two-stage search over the block store (the `csd` backend).

The port of the reference's `store/csd.py`, the repo's model of the
paper's computational-storage dataflow: the restructured DB lives on
"flash" (the block store), a small PageCache stands in for the SmartSSD
DRAM, and only block-granular reads flow to the compute side — host
memory stays bounded by `cache_bytes` no matter how large the dataset is.

The traversal is the same algorithm as the device-resident one
(core/search.py), re-driven from the host so every data access becomes a
batched block read:

  per hop : pop the best candidates for the whole query batch in lockstep,
            read their neighbor-list rows (layer-0 table), test the visited
            bitmap on the host, read only the unvisited neighbors' vector +
            sqnorm rows, and feed the gathered tiles to a hop function on
            the index's device built from the same primitives the resident
            path uses (`metric_distance` on mul + sum, `pq_lut_distances`,
            `beam_merge`'s stable sort and rank merges) — so the csd backend
            returns the `partitioned` backend's top-k at equal ef/K/metric:
            bitwise on the same device where every sum is exact
            (integer-valued rows, 8-bit codes, integer PQ tables).

The hop functions (`_query_prep`, `_query_prep_pq`, `_upper_step`,
`_layer0_step`, `_layer0_superstep`) are batched torch functions, the
reference's jitted JAX line for line; the host side (the numpy shadow
planner, the gathers, the visited test-and-set, the speculative superstep
driver, stage-2 rerank from the store) is the reference's numpy. A
superstep's tiles are staged in pinned host memory on the card and copied
without blocking; the host syncs once a superstep, to read how many hops
each lane applied.

Quantized stores (IndexSpec.dtype uint8/int8): the raw-data table holds
1-byte codes; the traversal runs in code space (tiles cast to float32),
stage-1 distances are rescaled by `scale**2` at the edge, and stage-2
rerank dequantizes the gathered rows. Product-quantized stores (dtype
"pq"): the raw-data table holds M-byte code rows, every hop takes the
per-query [M, 256] ADC tables instead of (q, qsq), stage 1 reads no
sqnorms, the shadow predicts with a numpy twin of the tables, and stage-2
rerank reads TRUE float32 rows back from the extra `rerank_vectors` table.
"""

from __future__ import annotations

import threading
import typing

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.partitioned import (build_partitioned_db, merge_topk,
                                          quantize_db_vectors)
from repro_torch.core.search import (SearchParams, bitmap_words,
                                     metric_distance, pq_lut_distances)
from repro_torch.kernels.traversal import beam_merge
from repro_torch.obs.metrics import REGISTRY, next_uid
from repro_torch.obs.trace import TRACER
from repro_torch.optim.compression import build_pq_lut
from repro_torch.store.layout import (StoreReader, open_store, to_host,
                                      write_store)

if typing.TYPE_CHECKING:  # repro_torch.api imports this module to register
    from repro_torch.api.types import IndexSpec  # the backend: keep the
                                                 # runtime import acyclic

__all__ = ["CSDBackend", "store_search"]

_INF = float("inf")


# ---------------------------------------------------------------------------
# Hop functions — the device-side compute fed by store gathers. The
# arithmetic mirrors the reference's jitted hop kernels line for line;
# gathers the resident path does from device memory arrive as tiles.
# ---------------------------------------------------------------------------


def _tile_distances(vecs, sqs, q, qsq, metric: str, lut=None):
    """Distances of gathered tiles [B, N, D] (float32 rows or PQ codes
    [B, N, M]) to each lane's query: mul + sum, or the LUT gather + sum."""
    if lut is not None:
        return pq_lut_distances(lut, vecs)
    return metric_distance(metric, (vecs * q[:, None, :]).sum(-1), sqs,
                           qsq[:, None])


def _query_prep(q, ep_vec, ep_sq, metric: str):
    """qsq per query + distance to the partition entry point."""
    qsq = (q * q).sum(-1)
    ep_d = _tile_distances(ep_vec.expand(q.shape[0], 1, -1),
                           ep_sq.expand(q.shape[0], 1), q, qsq, metric)[:, 0]
    return qsq, ep_d


def _query_prep_pq(luts, ep_code):
    """ADC distance to the partition entry point, per query (dtype="pq")."""
    return pq_lut_distances(luts, ep_code.expand(luts.shape[0], 1, -1))[:, 0]


def _upper_step(improved, c, c_d, calcs, nbrs, valid, vecs, sqs, q, qsq,
                metric: str, lut=None):
    """One lockstep greedy hop in an upper layer (cf. kernels/descent.py
    greedy_upper). With `lut` set (dtype="pq") `vecs` holds the gathered
    [M0, M] uint8 code tiles; sqs/q/qsq ride along unused."""
    d = _tile_distances(vecs, sqs, q, qsq, metric, lut)
    d = torch.where(valid, d, _INF)
    safe = torch.where(valid, nbrs, torch.zeros_like(nbrs))
    j = d.argmin(dim=1, keepdim=True)               # first index on ties
    best_d, best = d.gather(1, j)[:, 0], safe.gather(1, j)[:, 0]
    imp = best_d < c_d
    take = improved & imp
    return (torch.where(take, best, c), torch.where(take, best_d, c_d),
            take, torch.where(improved,
                              calcs + valid.sum(1, dtype=calcs.dtype), calcs))


def _layer0_step(active, cand_d, cand_i, fin_d, fin_i, hops, calcs, nbrs,
                 act, vecs, sqs, q, qsq, metric: str, lut=None):
    """One lockstep beam hop at layer 0 (cf. _search_layer0's body). `act`
    = neighbor lanes that are valid AND unvisited — the visited bitmap is
    tested/updated on the host so only unvisited neighbors' rows were read
    from the store (the paper's single-bit visited list as a flash-read
    filter)."""
    d = _tile_distances(vecs, sqs, q, qsq, metric, lut)
    cd, ci, fd, fi, ncalcs = beam_merge(cand_d, cand_i, fin_d, fin_i, calcs,
                                        nbrs, act, d)
    a = active[:, None]
    return (torch.where(a, cd, cand_d), torch.where(a, ci, cand_i),
            torch.where(a, fd, fin_d), torch.where(a, fi, fin_i),
            hops + active.to(hops.dtype), torch.where(active, ncalcs, calcs))


def _layer0_superstep(cand_d, cand_i, fin_d, fin_i, hops, calcs, spec, nbrs,
                      act, vecs, sqs, q, qsq, metric: str, max_hops: int,
                      lut=None):
    """Replay up to H speculated beam hops in one call — the csd half of
    the fused traversal (paper Fig. 6).

    The host plans a superstep ahead (`spec[:, h]` = predicted pop, -1
    where the plan saw the lane terminate; `nbrs/act/vecs/sqs[:, h]` = that
    hop's neighbor row, unvisited mask and gathered rows). Each hop is
    validated before it applies: hop h of a lane counts only while every
    earlier hop matched, the lane is live by the device state's
    termination test, and the device candidate head equals the speculated
    pop. The visited evolution depends only on the pop sequence, so a
    validated hop is bit-exact. Returns the per-lane count of applied hops
    so that the host rolls back the rest."""
    H = spec.shape[1]
    ok = torch.ones_like(hops, dtype=torch.bool)
    applied = torch.zeros_like(hops, dtype=torch.int32)
    for h in range(H):
        live = (cand_d[:, 0] < fin_d[:, -1]) & (hops < max_hops)
        sim_live = spec[:, h] >= 0
        match = live & sim_live & (cand_i[:, 0] == spec[:, h])
        app = ok & match
        # a terminated lane the plan also saw terminate stays valid
        # (frozen); any live/spec disagreement ends the replay
        ok = ok & (match | (~live & ~sim_live))
        d = _tile_distances(vecs[:, h], sqs[:, h], q, qsq, metric, lut)
        cd, ci, fd, fi, ncalcs = beam_merge(cand_d, cand_i, fin_d, fin_i,
                                            calcs, nbrs[:, h], act[:, h], d)
        a = app[:, None]
        cand_d, cand_i = torch.where(a, cd, cand_d), torch.where(a, ci, cand_i)
        fin_d, fin_i = torch.where(a, fd, fin_d), torch.where(a, fi, fin_i)
        hops = hops + app.to(hops.dtype)
        calcs = torch.where(app, ncalcs, calcs)
        applied = applied + app.to(torch.int32)
    return cand_d, cand_i, fin_d, fin_i, hops, calcs, applied


def _metric_dist_np(metric: str, dot, xsq, qsq):
    """numpy twin of metric_distance — only used to *predict* the pop
    sequence for superstep planning; every applied decision is re-made on
    the device, so a last-ulp disagreement costs a shorter superstep,
    never a wrong result."""
    if metric == "l2":
        return np.maximum(xsq - 2.0 * dot + qsq, 0.0)
    if metric == "ip":
        return -dot
    if metric == "cosine":
        return 1.0 - dot
    raise ValueError(f"unknown metric {metric!r}")


def _adc_np(lut_h: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """numpy twin of pq_lut_distances over [B, M0, M] code tiles —
    prediction-only (superstep planning), with `_metric_dist_np`'s
    rollback safety."""
    b_ix = np.arange(lut_h.shape[0])[:, None, None]
    m_ix = np.arange(lut_h.shape[1])[None, None, :]
    return lut_h[b_ix, m_ix, codes.astype(np.int64)].sum(-1)


# ---------------------------------------------------------------------------
# Host-driven traversal over store reads
# ---------------------------------------------------------------------------


def _gather_vec_sq(reader: StoreReader, p: int, ids: np.ndarray,
                   mask: np.ndarray, vecs=None, sqs=None):
    """Vector + sqnorm tiles for masked neighbor lanes; zeros elsewhere
    (masked lanes are forced to +inf downstream, so zeros are inert). The
    store read is issued over the *unique* ids and the rows scattered
    back. `vecs` / `sqs` are zeroed arrays to fill (a superstep's staging
    buffers), else new ones."""
    if vecs is None:
        vecs = np.zeros(ids.shape + (reader.d_pad,), np.float32)
        sqs = np.zeros(ids.shape, np.float32)
    if mask.any():
        uniq, inv = np.unique(ids[mask], return_inverse=True)
        rows = reader.row("vectors", p, uniq)
        vecs[mask] = reader.read_rows("vectors", rows)[inv]
        sqs[mask] = reader.read_rows("sqnorms", rows)[inv, 0]
    return vecs, sqs


def _gather_codes(reader: StoreReader, p: int, ids: np.ndarray,
                  mask: np.ndarray, codes=None) -> np.ndarray:
    """PQ variant of `_gather_vec_sq`: M-byte uint8 code tiles only
    (reader.d_pad == M for a PQ store); the sqnorm table is never read in
    stage 1."""
    if codes is None:
        codes = np.zeros(ids.shape + (reader.d_pad,), np.uint8)
    if mask.any():
        uniq, inv = np.unique(ids[mask], return_inverse=True)
        rows = reader.row("vectors", p, uniq)
        codes[mask] = reader.read_rows("vectors", rows)[inv]
    return codes


def _visited_test_and_set(bitmap: np.ndarray, ids: np.ndarray,
                          valid: np.ndarray) -> np.ndarray:
    """Host mirror of core.search.visited_test_and_set over [B, M] lanes
    (uint32 words, ceil(n / 32) of them). Returns `was` (visited-before OR
    invalid); sets bits for valid lanes."""
    B = bitmap.shape[0]
    safe = np.where(valid, ids, 0).astype(np.int64)
    w = safe >> 5
    b5 = (safe & 31).astype(np.uint32)
    rows = np.arange(B)[:, None]
    was = ((bitmap[rows, w] >> b5) & np.uint32(1)) > 0
    was |= ~valid
    bits = np.where(~was, np.left_shift(np.uint32(1), b5), np.uint32(0))
    np.bitwise_or.at(bitmap, (rows, w), bits)
    return was


class _Staging:
    """Host buffers of one superstep's tiles: pinned where the device is a
    card, so their copies run without blocking (the caching host allocator
    keeps each buffer until its copy is done); `arrays` are numpy views
    the planner fills, `upload()` the device tensors."""

    def __init__(self, device, shapes: dict):
        pinned = device.type == "cuda"
        self.device = device
        self.tensors = {k: torch.zeros(s, dtype=dt, pin_memory=pinned)
                        for k, (s, dt) in shapes.items()}
        self.arrays = {k: t.numpy() for k, t in self.tensors.items()}

    def upload(self, name):
        return self.tensors[name].to(self.device, non_blocking=True)


def _layer0_supersteps(reader: StoreReader, p: int, q_pad, qsq, bitmap,
                       cand_d, cand_i, fin_d, fin_i, hops, calcs,
                       sp: SearchParams, luts=None, lut_h=None):
    """Speculative, pipelined H-hop supersteps over layer 0
    (`fused_hops > 1`).

    The host shadows the beam in numpy to *predict* the next H pops —
    reading neighbor rows and vector/sqnorm tiles as it goes, and applying
    the visited test-and-set for the whole superstep up front — then
    `_layer0_superstep` replays the hops on the device, validating each
    against the true device state. While superstep k runs on the device,
    the host plans superstep k+1 from the shadow, and only the per-lane
    `applied` count is synced per superstep. Full beam state crosses to
    the host only at pipeline bubbles: the start, a misprediction (a
    last-ulp tie ordering differently in numpy than on the device), or the
    shadow terminating while the device disagrees.

    Every applied hop re-derives its pop, guard and merge on the device,
    so the result is bit-identical to the hop-stepped loop at any H. A
    lane whose speculation was rejected has its visited bits rolled back
    and its shadow resynced from the device, after which its next
    superstep is planned from truth and applies >= 1 hop. Returns the
    updated beam plus the number of supersteps taken.

    dtype="pq": `luts` is the device [B, M, 256] ADC table and `lut_h` its
    host copy — the shadow predicts with `_adc_np` over the same values."""
    B = bitmap.shape[0]
    H = sp.fused_hops
    M0, D = reader.m0_pad, reader.d_pad
    C, EF = sp.cand_size, sp.ef
    metric = sp.metric
    device = cand_d.device
    pq = lut_h is not None
    qh = q_pad.cpu().numpy()
    qsqh = qsq.cpu().numpy()
    steps = 0

    # shadow of the device beam, advanced in place by plan(); resynced
    # from the device only at pipeline bubbles
    scand_d = cand_d.cpu().numpy().copy()
    scand_i = cand_i.cpu().numpy().copy()
    sfin_d = fin_d.cpu().numpy().copy()
    shops = hops.cpu().numpy().copy()

    def plan():
        """Plan up to H hops from shadow state (store reads + visited
        test-and-set happen here). Returns None if the shadow sees every
        lane terminated; otherwise the per-hop tiles for the device."""
        live0 = (scand_d[:, 0] < sfin_d[:, -1]) & (shops < sp.max_hops)
        if not live0.any():
            return None
        snap = bitmap.copy()
        stage = _Staging(device, {
            "spec": ((B, H), torch.int32), "nbrs": ((B, H, M0), torch.int32),
            "act": ((B, H, M0), torch.bool),
            "vecs": ((B, H, M0, D), torch.uint8 if pq else torch.float32),
            "sqs": ((B, H, M0), torch.float32)})
        t = stage.arrays
        t["spec"][:] = -1
        t["nbrs"][:] = -1
        planned = np.zeros(B, np.int32)          # shadow-live hops per lane
        for h in range(H):
            live = (scand_d[:, 0] < sfin_d[:, -1]) & (shops < sp.max_hops)
            if not live.any():
                break
            pops = np.where(live, scand_i[:, 0], -1).astype(np.int32)
            t["spec"][:, h] = pops
            planned += live
            lanes = np.flatnonzero(live)
            nbrs = t["nbrs"][:, h]
            nbrs[lanes] = reader.read_rows(
                "l0_nbrs", reader.row("l0_nbrs", p, pops[lanes]))
            valid = (nbrs >= 0) & live[:, None]
            was = _visited_test_and_set(bitmap, nbrs, valid)
            act = valid & ~was
            t["act"][:, h] = act
            if pq:
                v = _gather_codes(reader, p, nbrs, act, t["vecs"][:, h])
                d = _adc_np(lut_h, v)
            else:
                v, s = _gather_vec_sq(reader, p, nbrs, act, t["vecs"][:, h],
                                      t["sqs"][:, h])
                # shadow hop: the same pop/guard/merge, numpy arithmetic
                d = _metric_dist_np(metric,
                                    np.einsum("bmd,bd->bm", v, qh),
                                    s, qsqh[:, None])
            d = np.where(act, d, np.inf)
            d = np.where(d < sfin_d[:, -1:], d, np.inf)
            ids = np.where(np.isfinite(d), np.where(act, nbrs, 0), -1)
            o = np.argsort(d, axis=1, kind="stable")
            bd = np.take_along_axis(d, o, axis=1)
            bi = np.take_along_axis(ids, o, axis=1)
            pc_d = np.concatenate(
                [scand_d[:, 1:], np.full((B, 1), np.inf, np.float32)], 1)
            pc_i = np.concatenate(
                [scand_i[:, 1:], np.full((B, 1), -1, scand_i.dtype)], 1)
            o2 = np.argsort(np.concatenate([pc_d, bd], axis=1),
                            axis=1, kind="stable")
            sel = live[:, None]
            scand_d[:] = np.where(sel, np.take_along_axis(
                np.concatenate([pc_d, bd], 1), o2, 1)[:, :C], scand_d)
            scand_i[:] = np.where(sel, np.take_along_axis(
                np.concatenate([pc_i, bi], 1), o2, 1)[:, :C], scand_i)
            sfin_d[:] = np.where(sel, np.sort(
                np.concatenate([sfin_d, bd], 1), axis=1)[:, :EF], sfin_d)
            shops[:] = shops + live
        return dict(snap=snap, stage=stage, spec=t["spec"], nbrs=t["nbrs"],
                    act=t["act"], planned=planned)

    def resync(lanes):
        """Pull the true device beam state back into the shadow for
        `lanes` (a boolean mask) — the only full-state host syncs here."""
        scand_d[lanes] = cand_d.cpu().numpy()[lanes]
        scand_i[lanes] = cand_i.cpu().numpy()[lanes]
        sfin_d[lanes] = fin_d.cpu().numpy()[lanes]
        shops[lanes] = hops.cpu().numpy()[lanes]

    def settle(prev, applied_h, nxt):
        """Handle rejected speculation of the just-finished superstep
        `prev`: per bad lane, restore its visited bits to the pre-`prev`
        snapshot plus the applied prefix (this also wipes any bits the
        in-flight plan `nxt` set from that lane's diverged shadow), resync
        its shadow from the device, and void its slots in `nxt` so the
        device skips it there."""
        bad = applied_h < prev["planned"]
        if not bad.any():
            return False
        for b in np.flatnonzero(bad):
            bitmap[b] = prev["snap"][b]
            for h in range(int(applied_h[b])):
                ib = prev["nbrs"][b, h][prev["act"][b, h]]
                np.bitwise_or.at(
                    bitmap[b], ib >> 5,
                    np.left_shift(np.uint32(1),
                                  (ib & 31).astype(np.uint32)))
        resync(bad)
        if nxt is not None:
            nxt["spec"][bad] = -1
            nxt["act"][bad] = False
            nxt["planned"][bad] = 0
        return True

    pending = None                   # (plan, applied) in flight on device
    while True:
        ps = plan()                  # overlaps the in-flight superstep
        if pending is not None:
            prev, applied = pending
            applied_h = applied.cpu().numpy()     # sync: superstep done
            pending = None
            if settle(prev, applied_h, ps) and ps is None:
                ps = plan()          # resynced lanes may still be live
        if ps is None:
            # shadow says done; the device has the final word (a last-ulp
            # tie can terminate the shadow while the device beam is live)
            live = ((cand_d[:, 0] < fin_d[:, -1])
                    & (hops < sp.max_hops)).cpu().numpy()
            if not live.any():
                break
            resync(live)
            ps = plan()
            if ps is None:           # cannot happen: resynced == live
                break
        stage = ps["stage"]
        with TRACER.child_span("hop_superstep", superstep=steps,
                               fused_hops=H,
                               active=int((ps["planned"] > 0).sum())):
            with TRACER.child_span("hop-kernel"):
                (cand_d, cand_i, fin_d, fin_i, hops, calcs,
                 applied) = _layer0_superstep(
                    cand_d, cand_i, fin_d, fin_i, hops, calcs,
                    stage.upload("spec"), stage.upload("nbrs"),
                    stage.upload("act"), stage.upload("vecs"),
                    stage.upload("sqs"), q_pad, qsq, metric, sp.max_hops,
                    lut=luts)
        pending = (ps, applied)
        steps += 1
    return cand_d, cand_i, fin_d, fin_i, hops, calcs, steps


def _host_f32(queries) -> np.ndarray:
    """Queries (an array, a list, or a tensor on any device) as host
    float32."""
    if isinstance(queries, torch.Tensor):
        queries = queries.cpu().numpy()
    return np.asarray(queries, np.float32)


def _search_one_partition(reader: StoreReader, p: int, q_pad,
                          params: SearchParams, luts=None, lut_h=None):
    """Lockstep batched search of one sub-graph, all data via the store.

    Returns (gids [B,k], dists [B,k], hops [B], calcs [B], steps) as host
    arrays, numerically the resident partition's search. `steps` counts
    host-synced traversal rounds: one per hop on the hop-stepped path, one
    per `fused_hops`-hop superstep on the fused path. `q_pad` (and `luts`,
    the [B, M, 256] ADC tables of dtype="pq", with `lut_h` their host copy)
    live on the device the hop functions run on."""
    B = int(q_pad.shape[0])
    dev = q_pad.device
    pq = luts is not None
    sp = params.resolve(reader.m0_pad)
    C, EF, K = sp.cand_size, sp.ef, sp.k
    metric = sp.metric

    def up(a):                       # a host tile onto the device
        return torch.as_tensor(a, device=dev)

    ep = int(reader.entry[p] if reader.entry.ndim else reader.entry)
    max_level = int(reader.max_level[p] if reader.max_level.ndim
                    else reader.max_level)
    ep_row = reader.row("vectors", p, [ep])
    if pq:
        ep_code = up(reader.read_rows("vectors", ep_row)[0])
        qsq = torch.zeros((B,), dtype=torch.float32, device=dev)  # unused
        ep_d = _query_prep_pq(luts, ep_code)
    else:
        ep_vec = up(reader.read_rows("vectors", ep_row)[0].astype(np.float32))
        ep_sq = up(reader.read_rows("sqnorms", ep_row)[0, 0])
        qsq, ep_d = _query_prep(q_pad, ep_vec, ep_sq, metric)

    # -- upper layers: lockstep greedy descent (paper §5.2.2) ---------------
    cur = torch.full((B,), ep, dtype=torch.int32, device=dev)
    cur_d = ep_d
    calcs = torch.ones((B,), dtype=torch.int32, device=dev)
    for layer in range(min(reader.n_layers, max_level), 0, -1):
        improved = torch.ones((B,), dtype=torch.bool, device=dev)
        hop = 0
        while hop < sp.upper_hops:
            imp_h = improved.cpu().numpy()
            if not imp_h.any():
                break
            cur_h = cur.cpu().numpy()
            nbrs = np.full((B, reader.m_pad), -1, np.int32)
            ptr = reader.read_rows(
                "up_ptr", reader.row("up_ptr", p, cur_h[imp_h]))[:, 0]
            has = ptr >= 0
            if has.any():
                urows = reader.up_row(p, layer - 1, ptr[has])
                lanes = np.flatnonzero(imp_h)[has]
                nbrs[lanes] = reader.read_rows("up_nbrs", urows)
            valid = (nbrs >= 0) & imp_h[:, None]
            if pq:
                vecs = _gather_codes(reader, p, nbrs, valid)
                sqs = np.zeros(nbrs.shape, np.float32)
            else:
                vecs, sqs = _gather_vec_sq(reader, p, nbrs, valid)
            cur, cur_d, improved, calcs = _upper_step(
                improved, cur, cur_d, calcs, up(nbrs), up(valid), up(vecs),
                up(sqs), q_pad, qsq, metric, lut=luts)
            hop += 1

    # -- layer 0: lockstep beam search (paper §5.2.3) -----------------------
    bitmap = np.zeros((B, bitmap_words(reader.n_pad)), np.uint32)
    _visited_test_and_set(bitmap, cur.cpu().numpy()[:, None],
                          np.ones((B, 1), bool))
    cand_d = torch.full((B, C), _INF, device=dev)
    cand_i = torch.full((B, C), -1, dtype=torch.int32, device=dev)
    fin_d = torch.full((B, EF), _INF, device=dev)
    fin_i = torch.full((B, EF), -1, dtype=torch.int32, device=dev)
    cand_d[:, 0], cand_i[:, 0] = cur_d, cur
    fin_d[:, 0], fin_i[:, 0] = cur_d, cur
    hops = torch.zeros((B,), dtype=torch.int32, device=dev)

    if sp.fused_hops > 1:
        # the superstep driver batches its own store reads per H-hop plan,
        # so the speculative next-hop prefetcher would be redundant
        # traffic; it is not invoked here
        (cand_d, cand_i, fin_d, fin_i, hops, calcs,
         steps) = _layer0_supersteps(reader, p, q_pad, qsq, bitmap,
                                     cand_d, cand_i, fin_d, fin_i,
                                     hops, calcs, sp, luts=luts,
                                     lut_h=lut_h)
    else:
        hop_no = 0
        while True:
            active = ((cand_d[:, 0] < fin_d[:, -1])
                      & (hops < sp.max_hops)).cpu().numpy()
            if not active.any():
                break
            with TRACER.child_span("hop", hop=hop_no,
                                   active=int(active.sum())):
                pops = cand_i[:, 0].cpu().numpy()
                nbrs = np.full((B, reader.m0_pad), -1, np.int32)
                lanes = np.flatnonzero(active)
                nbrs[lanes] = reader.read_rows(
                    "l0_nbrs", reader.row("l0_nbrs", p, pops[lanes]))
                valid = (nbrs >= 0) & active[:, None]
                was = _visited_test_and_set(bitmap, nbrs, valid)
                act = valid & ~was
                if pq:
                    vecs = _gather_codes(reader, p, nbrs, act)
                    sqs = np.zeros(nbrs.shape, np.float32)
                else:
                    vecs, sqs = _gather_vec_sq(reader, p, nbrs, act)
                # hop-kernel covers the submission only: the device work
                # overlaps the next hop's host work
                with TRACER.child_span("hop-kernel"):
                    cand_d, cand_i, fin_d, fin_i, hops, calcs = _layer0_step(
                        up(active), cand_d, cand_i, fin_d, fin_i, hops,
                        calcs, up(nbrs), up(act), up(vecs), up(sqs), q_pad,
                        qsq, metric, lut=luts)
                # overlap the next hop's fetches with this round-trip
                reader.prefetch_next_hop(p, cand_i[:, :2].cpu().numpy())
            hop_no += 1
        steps = hop_no

    k_i = fin_i[:, :K].cpu().numpy()
    k_d = fin_d[:, :K].cpu().numpy()
    k_g = np.full_like(k_i, -1)
    vmask = k_i >= 0
    if vmask.any():
        k_g[vmask] = reader.read_rows(
            "gids", reader.row("gids", p, k_i[vmask]))[:, 0]
    return k_g, k_d, hops.cpu().numpy(), calcs.cpu().numpy(), steps


def store_search(reader: StoreReader, queries, params: SearchParams,
                 merge: bool = True, pq_quant=None, device=None):
    """Two-stage search over every partition of the store, its hop
    functions on `device` (default: the card).

    merge=True  -> (ids [B,k], dists [B,k] tensors on `device`, hops [B],
                    calcs [B], supersteps)
    merge=False -> the unmerged [B, P*k] stage-1 pool as host arrays
                   (rerank consumes it).

    `supersteps` is the total host-synced traversal rounds across
    partitions. `pq_quant` is the index's fitted PQQuantizer for dtype="pq"
    stores: queries stay float32 (not padded to the store's d_pad, which
    is the code width M) and the per-query ADC tables are built once here
    and reused by every partition."""
    device = resolve_device(device)
    REGISTRY.gauge("traversal_fused_hops").set(float(params.fused_hops))
    q = _host_f32(queries)
    luts = lut_h = None
    if pq_quant is not None:
        luts = build_pq_lut(torch.as_tensor(q, device=device),
                            torch.as_tensor(pq_quant.codebooks,
                                            device=device))
        lut_h = luts.cpu().numpy()    # the shadow planner's prediction twin
    elif q.shape[-1] < reader.d_pad:
        q = np.pad(q, ((0, 0), (0, reader.d_pad - q.shape[-1])))
    q_pad = torch.as_tensor(q, device=device)
    per_ids, per_ds = [], []
    hops = np.zeros(q.shape[0], np.int64)
    calcs = np.zeros(q.shape[0], np.int64)
    supersteps = 0
    for p in range(reader.num_partitions):
        with TRACER.child_span("traversal", partition=p):
            gi, gd, h, c, s = _search_one_partition(reader, p, q_pad, params,
                                                    luts=luts, lut_h=lut_h)
        per_ids.append(gi)
        per_ds.append(gd)
        hops += h
        calcs += c
        supersteps += s
    ids = np.stack(per_ids, axis=1)          # [B, P, k]
    ds = np.stack(per_ds, axis=1)
    if not merge:
        b = ids.shape[0]
        return ids.reshape(b, -1), ds.reshape(b, -1), hops, calcs, supersteps
    out_i, out_d = merge_topk(torch.as_tensor(ids, device=device),
                              torch.as_tensor(ds, device=device), params.k)
    return out_i, out_d, hops, calcs, supersteps


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------


def _collect_csd(be: "CSDBackend"):
    """Snapshot-time metric samples per live csd backend (obs): the
    per-query counters `QueryStats` carries (supersteps, dist_calcs,
    bytes_read) as cumulative REGISTRY series, plus the store geometry
    gauges the reference's `obs/calibrate.py` prices the workload with."""
    r = be.reader
    labels = {"backend": be.uid}
    with be._tlock:
        q, hops, calcs, steps = (be._queries, be._hops, be._dist_calcs,
                                 be._supersteps)
    t = r.blockfile.tables["vectors"]
    row_bytes = int(t["cols"]) * np.dtype(t["dtype"]).itemsize
    return [
        ("counter", "csd_queries_total", labels, q),
        ("counter", "csd_hops_total", labels, hops),
        ("counter", "csd_supersteps_total", labels, steps),
        ("counter", "search_dist_calcs_total", labels, calcs),
        ("counter", "csd_bytes_read_total", labels,
         r.cache.snapshot()["bytes_read"]),
        ("gauge", "csd_graph_degree", labels, r.m0_pad),
        ("gauge", "csd_vector_row_bytes", labels, row_bytes),
        ("gauge", "csd_block_size", labels, r.block_size),
    ]


class CSDBackend:
    """Storage-resident two-stage engine (registered as `csd`).

    Build restructures the dataset into the block store at
    `spec.storage_path`; serving holds only the PageCache (`cache_bytes`)
    on the host and each batch's tiles on `device` (the card unless the
    caller asks for the CPU). `rerank` needs no `keep_vectors` — stage 2
    reads the raw vectors back from the store.
    """

    uses_graph = True

    def __init__(self, spec: IndexSpec, reader: StoreReader, device=None):
        self.spec = spec
        self.reader = reader
        self.device = resolve_device(device)
        self.quant = spec.quantizer()
        self.is_pq = spec.dtype == "pq"
        # cumulative engine counters behind the csd_*/search_* series
        self.uid = next_uid()
        self._tlock = threading.Lock()
        self._queries = 0
        self._hops = 0
        self._dist_calcs = 0
        self._supersteps = 0
        REGISTRY.register_collector(self, _collect_csd)

    @staticmethod
    def _storage_path(spec: IndexSpec) -> str:
        if not spec.storage_path:
            raise ValueError(
                "backend='csd' persists the database to a block store: set "
                "IndexSpec(storage_path=...) to its directory")
        return spec.storage_path

    @classmethod
    def build(cls, vectors: np.ndarray, spec: IndexSpec, device=None,
              mesh=None):
        path = cls._storage_path(spec)
        pdb = build_partitioned_db(vectors, spec.num_partitions, spec.hnsw)
        return cls._write(path, pdb, spec, device=device)

    @classmethod
    def from_partitioned(cls, pdb, spec: IndexSpec, raw=None, *,
                         device=None):
        """Convert an already-built PartitionedDB (numpy, or a partitioned
        backend's tensors on any device) into an out-of-core service on
        `device`, reusing its graph.

        For a dtype="pq" pdb whose vectors leaf already holds code rows,
        pass `raw` — the ORIGINAL [n, d] float32 rows — so the store still
        gets its `rerank_vectors` table."""
        return cls._write(cls._storage_path(spec), pdb, spec, raw=raw,
                          device=device)

    @classmethod
    def _write(cls, path: str, pdb, spec: IndexSpec, raw=None, device=None):
        """Quantize the raw-data leaf and commit the block store.

        dtype="pq": the vectors leaf shrinks to M-byte code rows AND the
        TRUE float32 rows are persisted as an extra `rerank_vectors` table
        (same p * n_pad + i row addressing) — stage-2 rerank reads real
        vectors back, because re-scoring decoded PQ rows would reproduce
        the ADC distances exactly and recover no recall."""
        device = resolve_device(device)
        pdb = pdb._replace(db=to_host(pdb.db))
        extra = None
        if spec.dtype == "pq":
            quant = spec.quantizer()
            vecs = np.asarray(pdb.db.vectors)
            if vecs.dtype != np.uint8:     # true rows still in hand
                extra = {"rerank_vectors": np.ascontiguousarray(
                    vecs.reshape(-1, vecs.shape[-1]), np.float32)}
            elif raw is not None:          # scatter raw rows to pad layout
                raw = np.asarray(raw, np.float32)
                gids = np.asarray(pdb.db.gids)
                n_valid = np.atleast_1d(np.asarray(pdb.db.n_valid))
                n_pad = gids.shape[-1]
                p_ax = gids.shape[0] if gids.ndim == 2 else 1
                table = np.zeros((p_ax * n_pad, raw.shape[1]), np.float32)
                for pi in range(p_ax):
                    nv = int(n_valid[pi])
                    g = gids[pi, :nv] if gids.ndim == 2 else gids[:nv]
                    table[pi * n_pad: pi * n_pad + nv] = raw[g]
                extra = {"rerank_vectors": table}
            pdb = quantize_db_vectors(pdb, "pq", quant)
        else:
            # quantized spec: on-flash vector rows shrink to 1 byte/dim
            pdb = quantize_db_vectors(pdb, spec.dtype)
        write_store(path, pdb, block_size=spec.block_size,
                    extra_tables=extra)
        del pdb                     # from here on, the store is the database
        return cls(spec, open_store(path, spec.cache_bytes,
                                    prefetch=spec.prefetch), device)

    def params(self, k: int, ef: int) -> SearchParams:
        return SearchParams(ef=ef, k=k, metric=self.spec.metric,
                            fused_hops=self.spec.fused_hops)

    def search(self, queries, k: int, ef: int, rerank: bool,
               with_stats: bool):
        from repro_torch.api.types import QueryStats

        r = self.reader
        before = None
        if with_stats:
            if r.prefetcher is not None:
                r.prefetcher.drain()     # don't attribute a previous
            before = r.cache.snapshot()  # request's in-flight reads to us
        p = self.params(k, ef)
        pq_quant = self.quant if self.is_pq else None
        if rerank:
            cand, _, hops, calcs, steps = store_search(
                r, queries, p, merge=False, pq_quant=pq_quant,
                device=self.device)
            with TRACER.child_span("rerank", pool=int(cand.shape[1])):
                ids, dists = self._rerank_from_store(queries, cand, k)
        else:
            ids, dists, hops, calcs, steps = store_search(
                r, queries, p, pq_quant=pq_quant, device=self.device)
            if self.quant is not None and not self.is_pq:
                # code space -> real space (ADC is already real space)
                dists = dists * float(np.float32(self.quant.dist_scale))
        with self._tlock:
            self._queries += int(len(queries))
            self._hops += int(hops.sum())
            self._dist_calcs += int(calcs.sum())
            self._supersteps += int(steps)
        stats = None
        if with_stats:
            if r.prefetcher is not None:
                r.prefetcher.drain()     # settle in-flight reads (counters)
            after = r.cache.snapshot()
            demand = ((after["hits"] - before["hits"])
                      + (after["misses"] - before["misses"]))
            hit_rate = ((after["hits"] - before["hits"]) / demand
                        if demand else 0.0)
            stats = QueryStats(
                hops=torch.as_tensor(hops, dtype=torch.int32,
                                     device=self.device),
                dist_calcs=torch.as_tensor(calcs, dtype=torch.int32,
                                           device=self.device),
                block_reads=after["block_reads"] - before["block_reads"],
                cache_hits=after["hits"] - before["hits"],
                cache_misses=after["misses"] - before["misses"],
                cache_hit_rate=hit_rate,
                bytes_read=after["bytes_read"] - before["bytes_read"],
                supersteps=steps,
            )
        return ids, dists, stats

    def _rerank_from_store(self, queries, cand: np.ndarray, k: int):
        """Stage-2 exact re-score from store reads (paper Fig. 4 stage 2).

        Candidates are remapped onto a compact, monotonically-ordered id
        space so `batched_rerank` behaves exactly as it does over the full
        resident vector table."""
        from repro_torch.api.rerank import batched_rerank

        r = self.reader
        dev = self.device
        if r.partition_starts is None:
            raise ValueError(
                "rerank over this store is unsupported: partition global "
                "ids are not contiguous ranges")
        valid = cand >= 0
        uniq = np.unique(cand[valid])
        if uniq.size == 0:
            b = cand.shape[0]
            return (torch.full((b, k), -1, dtype=torch.int32, device=dev),
                    torch.full((b, k), _INF, device=dev))
        part = np.searchsorted(r.partition_starts, uniq, side="right") - 1
        local = uniq - r.partition_starts[part]
        rows = part * r.n_pad + local
        if self.is_pq:
            # stage 2 over TRUE float32 rows from the extra table — the
            # code rows carry no information beyond their ADC distance
            if "rerank_vectors" not in r.blockfile.tables:
                raise ValueError(
                    "this PQ store has no 'rerank_vectors' table, so "
                    "stage-2 rerank cannot read true float32 rows: "
                    "rebuild it with CSDBackend.build/from_partitioned "
                    "over the original vectors")
            rows_f = r.read_rows("rerank_vectors", rows).astype(np.float32)
        else:
            rows_f = r.read_rows("vectors", rows)[:, :r.dim].astype(
                np.float32)
            if self.quant is not None:
                # stage 2 stays float32: dequantize the gathered code rows
                rows_f = self.quant.decode(rows_f)
        vecs = torch.as_tensor(rows_f, device=dev)
        sqs = (vecs * vecs).sum(-1)
        compact = np.where(valid,
                           np.searchsorted(uniq, np.where(valid, cand, 0)),
                           -1).astype(np.int32)
        q = torch.as_tensor(_host_f32(queries), device=dev)
        if self.quant is not None and not self.is_pq:
            q = self.quant.decode(q)     # code-valued queries -> f32 values
        ids_c, dists = batched_rerank(vecs, sqs, q,
                                      torch.as_tensor(compact, device=dev),
                                      k, self.spec.metric)
        ids = torch.as_tensor(uniq.astype(np.int32), device=dev)[
            ids_c.clamp_min(0).long()]
        return torch.where(ids_c >= 0, ids, -1), dists

    # -- persistence ---------------------------------------------------------
    # The block store IS the database: state_tree carries only a format tag,
    # and the index manifest's spec points at the block files (storage_path)
    # instead of saved arrays — the reference's leaves, so either package
    # loads the other's csd index.

    def state_tree(self) -> dict:
        return {"meta": {"csd_store": np.int32(1),
                         "block_size": np.int32(self.spec.block_size)}}

    @classmethod
    def from_state(cls, spec: IndexSpec, leaves: dict, device=None,
                   mesh=None):
        path = cls._storage_path(spec)
        return cls(spec, open_store(path, spec.cache_bytes,
                                    prefetch=spec.prefetch), device)
