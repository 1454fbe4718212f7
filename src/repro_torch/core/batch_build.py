"""Batched HNSW construction on the index's device: hnswlib's insertion
(the HNSW paper's Algorithms 1-4) applied to a batch of points at once.

`hnsw_graph.build_hnsw` inserts one point at a time on the host, at
110-150 rows a second, so a graph past the card's 50 MB L2 takes hours.
`build_graphs` builds every partition of an index at once, batch by
batch, with torch ops and the port's traversal kernel:

- Levels: `hnsw_graph.draw_levels`, the stream `build_hnsw` draws, so a
  partition's levels, entry point and upper-table row order are
  `build_hnsw`'s.
- Batches (`batch_schedule`): points go in in ascending id order, the
  first alone, then batches of at most 1 / BATCH_FRACTION of the graph
  built so far and at most BATCH_CAP points a partition. The partitions
  advance together: their tables are stacked into one id space (flat id
  p * n_pad + i, each partition a component of its own) and their batch
  points are the lanes of one traversal, as the search folds them.
- A batch: every point descends greedily (ef 1) from its partition's
  entry to its level + 1, then runs the beam search at ef_construction on
  each layer from there down to 0 through `search.search_layer0`, the
  search's own layer-0 loop (the traversal kernel on CUDA, its plain
  version on the CPU). Its candidates at a layer are the beam's results
  and the earlier points of its batch that reach the layer, at their
  exact distances (sequential insertion would have linked those before
  it); `select_heuristic` (Algorithm 4 with hnswlib's keep-pruned fill)
  picks M of them. Reverse links are grouped by target, appended to the
  target's list in ascending id order and, where the list overflows
  maxM0 (layer 0) or maxM, pruned by the same heuristic.
- Determinism: every sort is stable and the smaller id wins an equal
  distance. On integer-valued rows of at most 8 bits and D <= 129, every
  distance ||x||^2 - 2 x.q + ||q||^2 and each of its partial sums is an
  exact float32 integer below 2^24 (2 * 129 * 255^2 < 2^24), so the card
  and the CPU build byte-identical graphs. Wider or other rows build the
  same way, but the two devices may round a distance differently.

Each batch is an `insert` span (`rows`, `ef_construction`,
`reverse_prunes`, and `dev_ms` on CUDA) under the caller's open span.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hnsw_graph as hg
from repro_torch.core.search import SearchParams, search_layer0
from repro_torch.kernels.traversal import metric_distance
from repro_torch.obs.trace import TRACER

__all__ = ["BATCH_CAP", "BATCH_FRACTION", "batch_schedule", "build_graphs",
           "select_heuristic"]

_INF = float("inf")

# A batch is at most an eighth of the graph built so far: its points
# search a graph that lacks one another, and an eighth keeps that graph
# close to the one sequential insertion would have shown them (the exact
# distances among the batch's own points make up the rest).
BATCH_FRACTION = 8
# ... and at most 2,048 points a partition: each lane's visited bitmap
# holds a bit per row of the stacked tables (1M rows: 125 KB a lane, 1 GB
# at 4 x 2,048 lanes), and the batch's exact distances are [P, b, b].
BATCH_CAP = 2048
# layer-0 hops a traversal launch, each launch one host sync: a launch
# lasts as long as its slowest lane's hops whatever this is, so a beam
# at ef_construction takes one or two launches (results equal at every
# value; 1M rows: 14.9 s at 8, 11.5-12.6 s at 128 on an H100)
_FUSED_HOPS = 128
# selection rounds between two host checks for the fixed point: most
# blocks settle within a few rounds (results equal at every value)
_SELECT_ROUNDS = 4
# elements of one gathered [rows, K, D] block of candidate rows
_BLOCK = 1 << 26


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def batch_schedule(n: int) -> list[tuple[int, int]]:
    """The batches [(start, end)] that insert local ids 0 .. n-1."""
    out, s = [], 0
    while s < n:
        b = 1 if s == 0 else min(BATCH_CAP, max(1, s // BATCH_FRACTION))
        out.append((s, min(s + b, n)))
        s = out[-1][1]
    return out


def _by_distance(d, ids):
    """Each row of (d, ids) in ascending (distance, id) order."""
    o = torch.sort(ids, dim=-1, stable=True).indices
    d, ids = d.gather(-1, o), ids.gather(-1, o)
    o = torch.sort(d, dim=-1, stable=True).indices
    return d.gather(-1, o), ids.gather(-1, o)


def _dists(x, xsq, q, qsq, ids):
    """Squared L2 [R, K] from q [R, D] (float32) to the rows ids [R, K]
    (valid ids) of x: ||x||^2 - 2 x.q + ||q||^2, as the traversal has it."""
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    step = max(1, _BLOCK // max(1, ids.shape[1] * x.shape[1]))
    for r in range(0, ids.shape[0], step):
        i = ids[r:r + step].long()
        dot = torch.matmul(x[i].float(), q[r:r + step, :, None])[..., 0]
        out[r:r + step] = metric_distance("l2", dot, xsq[i],
                                          qsq[r:r + step, None])
    return out


def select_heuristic(x, xsq, cand_d, cand_i, m: int):
    """Algorithm 4 with hnswlib's keep-pruned fill, for every row at once.

    cand_d / cand_i [R, K]: each row's candidates in ascending (distance,
    id) order, (+inf, -1) padded. A candidate is taken while fewer than m
    are, unless a taken one is nearer to it than its own distance; the
    slots left are filled with the pruned ones in order. Returns [R, m]
    int32 ids: the taken in order, then the fill, -1 padded."""
    out = torch.full((cand_i.shape[0], m), -1, dtype=torch.int32,
                     device=cand_i.device)
    if cand_i.numel() == 0:
        return out
    step = max(1, _BLOCK // (cand_i.shape[1] * x.shape[1]))
    for r in range(0, cand_i.shape[0], step):
        out[r:r + step] = _select_block(x, xsq, cand_d[r:r + step],
                                        cand_i[r:r + step], m)
    return out


def _select_block(x, xsq, d, ids, m: int):
    valid = ids >= 0
    k = int(valid.sum(1).max())
    out = torch.full((ids.shape[0], m + 1), -1, dtype=torch.int32,
                     device=ids.device)
    if k == 0:
        return out[:, :m]
    d, ids, valid = d[:, :k], ids[:, :k], valid[:, :k]
    safe = ids.clamp_min(0).long()
    rows = x[safe].float()
    sq = xsq[safe]
    # pair[r, a, b]: the distance between candidates a and b of row r
    pair = metric_distance("l2", torch.bmm(rows, rows.transpose(1, 2)),
                           sq[:, None, :], sq[:, :, None])
    # near[r, t, s]: an earlier candidate s prunes t if taken
    near = (pair < d[:, :, None]) & valid[:, None, :] & torch.ones(
        (k, k), dtype=torch.bool, device=ids.device).tril(-1)
    near = near.float()
    # Without the cap of m, t is taken iff no taken s < t prunes it: a
    # rule whose one fixed point the rounds reach, each round settling at
    # least the next candidate (usually all within a few rounds). The
    # cap then keeps the first m taken: a candidate past the m-th decides
    # nothing before it. A round at the fixed point changes nothing, so
    # the host checks for it only every _SELECT_ROUNDS rounds.
    taken = valid
    while True:
        for _ in range(_SELECT_ROUNDS):
            last = taken
            taken = valid & ~(torch.bmm(near, last.float()[:, :, None])[..., 0]
                              > 0)
        if torch.equal(taken, last):
            break
    taken = taken & (torch.cumsum(taken, 1) <= m)
    count = taken.sum(1)
    fill = valid & ~taken
    fill &= torch.cumsum(fill, 1) <= (m - count)[:, None]
    pos = torch.where(taken, torch.cumsum(taken, 1) - 1,
                      count[:, None] + torch.cumsum(fill, 1) - 1)
    # what is neither taken nor filled goes to the spare column m
    out.scatter_(1, torch.where(taken | fill, pos, m), ids.int())
    return out[:, :m]


def _greedy(adj, x, xsq, q, qsq, cur, cur_d):
    """hnswlib's greedy search on one layer (ef 1) for every lane: move to
    the nearest neighbour (the first in the list on a tie) while it is
    strictly nearer. cur / cur_d are updated in place."""
    live = torch.arange(cur.shape[0], device=cur.device)
    while live.numel():
        nb = adj[cur[live].long()]
        valid = nb >= 0
        d = torch.where(valid, _dists(x, xsq, q[live], qsq[live],
                                      nb.clamp_min(0)), _INF)
        j = d.argmin(1, keepdim=True)
        best_d, best = d.gather(1, j)[:, 0], nb.gather(1, j)[:, 0]
        move = best_d < cur_d[live]
        live = live[move]
        cur[live], cur_d[live] = best[move], best_d[move]


def _beam(x, xsq, adj, q, qsq, eps_d, eps_i, ef: int):
    """The beam search at `ef` on one layer's table adj [N, M_pad] for
    every lane, from its entry list (eps_d, eps_i) [L, K <= ef] (ascending,
    (+inf, -1) padded): the final lists (fin_d, fin_i) [L, ef]."""
    # a lane can pop each of the N rows once: N hops never cut a search
    p = SearchParams(ef=ef, cand_size=ef + adj.shape[1],
                     max_hops=adj.shape[0], fused_hops=_FUSED_HOPS)
    fin_d, fin_i, _, _ = search_layer0(x[None], xsq[None], adj[None], q, qsq,
                                       eps_i, eps_d, p)
    return fin_d, fin_i


def _link_back(adj, width: int, x, xsq, src, fwd) -> int:
    """Reverse links of one layer: each id of fwd [S, M] gains the source
    src[s] of its row. Proposals are grouped by target and appended to its
    list in ascending source order; a list past `width` is pruned by
    `select_heuristic` over its entries' distances to the target. Returns
    the number of lists pruned."""
    tgt = fwd.reshape(-1)
    s = src[:, None].expand_as(fwd).reshape(-1)
    ok = tgt >= 0
    tgt, s = tgt[ok], s[ok]
    if tgt.numel() == 0:
        return 0
    o = torch.sort(tgt, stable=True).indices      # sources stay ascending
    tgt, s = tgt[o], s[o]
    rows, counts = torch.unique_consecutive(tgt, return_counts=True)
    rows = rows.long()
    group = torch.repeat_interleave(
        torch.arange(rows.shape[0], device=rows.device), counts)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tgt.shape[0], device=rows.device) - start[group]
    new = torch.full((rows.shape[0], int(counts.max())), -1,
                     dtype=torch.int32, device=rows.device)
    new[group, rank] = s.int()
    merged = torch.cat([adj[rows, :width], new], 1)
    o = torch.sort((merged < 0).int(), dim=1, stable=True).indices
    merged = merged.gather(1, o)
    over = (merged >= 0).sum(1) > width
    adj[rows[~over], :width] = merged[~over, :width]
    pruned = rows[over]
    if pruned.numel():
        cand = merged[over]
        valid = cand >= 0
        d = torch.where(valid, _dists(x, xsq, x[pruned].float(), xsq[pruned],
                                      cand.clamp_min(0)), _INF)
        d, cand = _by_distance(d, cand)
        adj[pruned, :width] = select_heuristic(x, xsq, d, cand, width)
    return int(pruned.numel())


def _insert_batch(x, xsq, adj, cfg: hg.HNSWConfig, gids: np.ndarray,
                  part: np.ndarray, lv: np.ndarray, span: int,
                  entry: list, top: list) -> int:
    """Insert one batch: gids [L] flat ids (partition-major, ascending),
    their partitions and levels; `span` the batch's width b, so that lane
    (p, i) sits in slot p * b + (i - first id) of the exact-distance
    block. entry / top: each partition's flat entry id and top layer
    before the batch (-1: empty). Returns the lists pruned."""
    dev = x.device
    n_part = len(entry)
    g = torch.as_tensor(gids, device=dev)
    q = x[g].float()
    qsq = xsq[g]
    efc = cfg.ef_construction
    first = np.zeros(n_part, np.int64)
    for p in np.unique(part):
        first[p] = gids[part == p].min()
    slot = torch.as_tensor(part * span + (gids - first[part]), device=dev)
    # the batch's exact distances: lane slot -> every slot of its partition
    qb = torch.zeros((n_part * span, q.shape[1]), device=dev)
    qb[slot] = q
    sqb = torch.zeros(n_part * span, device=dev)
    sqb[slot] = qsq
    gb = torch.full((n_part * span,), -1, dtype=torch.int32, device=dev)
    gb[slot] = g.int()
    lvb = torch.full((n_part * span,), -1, dtype=torch.int64, device=dev)
    lvb[slot] = torch.as_tensor(lv, dtype=torch.int64, device=dev)
    qb, sqb = qb.view(n_part, span, -1), sqb.view(n_part, span)
    intra = metric_distance("l2", torch.bmm(qb, qb.transpose(1, 2)),
                            sqb[:, None, :], sqb[:, :, None])
    intra = intra.view(n_part * span, span)
    earlier = torch.ones((span, span), dtype=torch.bool,
                         device=dev).tril(-1)          # [t, t']: t' < t
    part_t = torch.as_tensor(part, device=dev)
    top_lane = np.asarray(top)[part]

    cur = torch.as_tensor(np.asarray(entry)[part], device=dev).int()
    cur_d = _dists(x, xsq, q, qsq, cur[:, None])[:, 0]
    eps_d = torch.full((len(gids), efc), _INF, device=dev)
    eps_i = torch.full((len(gids), efc), -1, dtype=torch.int32, device=dev)
    eps_d[:, 0], eps_i[:, 0] = cur_d, cur
    prunes = 0
    for layer in range(max(int(top_lane.max()), int(lv.max())), -1, -1):
        if layer >= 1:       # greedy, ef 1, above each point's own level
            idx = np.flatnonzero((layer <= top_lane) & (layer > lv))
            if idx.size:
                i = torch.as_tensor(idx, device=dev)
                c, cd = cur[i], cur_d[i]
                _greedy(adj[layer], x, xsq, q[i], qsq[i], c, cd)
                cur[i], cur_d[i] = c, cd
                eps_d[i], eps_i[i] = _INF, -1
                eps_d[i, 0], eps_i[i, 0] = cd, c
        idx = np.flatnonzero((layer <= top_lane) & (layer <= lv))
        if idx.size:         # the beam at ef_construction
            i = torch.as_tensor(idx, device=dev)
            eps_d[i], eps_i[i] = _beam(x, xsq, adj[layer], q[i], qsq[i],
                                       eps_d[i], eps_i[i], efc)
        idx = np.flatnonzero(lv >= layer)
        if not idx.size:
            continue
        i = torch.as_tensor(idx, device=dev)
        searched = torch.as_tensor(top_lane[idx] >= layer, device=dev)
        graph_d = torch.where(searched[:, None], eps_d[i], _INF)
        graph_i = torch.where(searched[:, None], eps_i[i], -1)
        # the batch's earlier points that reach this layer
        t = slot[i] % span
        near = earlier[t] & (lvb.view(n_part, span)[part_t[i]] >= layer)
        bd = torch.where(near, intra[slot[i]], _INF)
        o = torch.sort(bd, dim=1, stable=True).indices[:, :efc]
        bd = bd.gather(1, o)
        bi = torch.where(torch.isfinite(bd),
                         gb.view(n_part, span)[part_t[i]].gather(1, o), -1)
        cd, ci = _by_distance(torch.cat([graph_d, bd], 1),
                              torch.cat([graph_i, bi], 1))
        fwd = select_heuristic(x, xsq, cd[:, :efc], ci[:, :efc], cfg.M)
        adj[layer][g[i], :cfg.M] = fwd
        prunes += _link_back(adj[layer], cfg.maxM0 if layer == 0
                             else cfg.maxM, x, xsq, g[i], fwd)
    return prunes


def build_graphs(parts: list, cfgs: list, device) -> list[hg.HostGraph]:
    """One graph a partition (rows parts[p], config cfgs[p]), all built at
    once on `device`, as `build_hnsw` would return them. The configs
    differ only in their seeds. 8-bit rows stay 8-bit on the device;
    others are float32."""
    cfg = cfgs[0]
    dev = torch.device(device)
    sizes = [len(v) for v in parts]
    n_part, dim = len(parts), parts[0].shape[1]
    n_pad = _round_up(max(sizes), 32)
    n = n_part * n_pad
    d_pad = _round_up(dim, cfg.lane)
    dtype = parts[0].dtype if parts[0].dtype in (np.uint8, np.int8) \
        else np.float32
    rows = np.zeros((n, d_pad), dtype)
    sq = np.full(n, np.inf, np.float32)
    levels = [hg.draw_levels(k, c) for k, c in zip(sizes, cfgs)]
    for p, v in enumerate(parts):
        rows[p * n_pad:p * n_pad + sizes[p], :dim] = v
        f = np.asarray(v, np.float32)
        sq[p * n_pad:p * n_pad + sizes[p]] = np.einsum("nd,nd->n", f, f)
    x = torch.as_tensor(rows, device=dev)
    xsq = torch.as_tensor(sq, device=dev)
    top_level = max(int(lv.max()) for lv in levels)
    widths = [_round_up(cfg.maxM0, cfg.nbr_pad)] + \
        [_round_up(cfg.maxM, cfg.nbr_pad)] * top_level
    adj = [torch.full((n, w), -1, dtype=torch.int32, device=dev)
           for w in widths]
    entry = [p * n_pad for p in range(n_part)]
    top = [-1] * n_part
    for s, e in batch_schedule(max(sizes)):
        ps = [p for p in range(n_part) if s < sizes[p]]
        local = [np.arange(s, min(e, sizes[p])) for p in ps]
        gids = np.concatenate([p * n_pad + i for p, i in zip(ps, local)])
        part = np.concatenate([np.full(len(i), p) for p, i in zip(ps, local)])
        lv = np.concatenate([levels[p][i] for p, i in zip(ps, local)])
        with TRACER.child_span("insert", device_clock=dev, rows=len(gids),
                               ef_construction=cfg.ef_construction) as sp:
            sp.set(reverse_prunes=_insert_batch(
                x, xsq, adj, cfg, gids, part, lv, e - s, entry, top))
        for p, i in zip(ps, local):
            hi = int(levels[p][i].max())
            if hi > top[p]:
                entry[p] = p * n_pad + int(i[np.argmax(levels[p][i])])
                top[p] = hi
    return [_host_graph(adj, levels[p], p * n_pad, parts[p], entry[p],
                        top[p], cfgs[p]) for p in range(n_part)]


def _host_graph(adj, levels, base: int, vectors, entry: int, top: int,
                cfg: hg.HNSWConfig) -> hg.HostGraph:
    """Partition `base`'s rows of the stacked tables as a HostGraph, in
    the partition's own ids."""
    n = len(levels)

    def local(t):
        t = t.cpu().numpy()
        return np.where(t >= 0, t - base, -1).astype(np.int32)

    up_rows = np.flatnonzero(levels >= 1)
    up_ptr = np.full(n, -1, np.int32)
    up_ptr[up_rows] = np.arange(up_rows.size, dtype=np.int32)
    up = np.full((cfg.max_level_cap - 1, max(1, up_rows.size), cfg.maxM), -1,
                 np.int32)
    rows = base + torch.as_tensor(up_rows, device=adj[0].device)
    for layer in range(1, len(adj)):
        up[layer - 1, :up_rows.size] = local(adj[layer][rows, :cfg.maxM])
    return hg.HostGraph(
        vectors=np.asarray(vectors, np.float32),
        levels=levels.astype(np.int32),
        l0_nbrs=local(adj[0][base:base + n, :cfg.maxM0]),
        up_nbrs=up, up_ptr=up_ptr, entry=entry - base, max_level=top,
        cfg=cfg)
