"""Host-side HNSW graph construction and the restructured device database.

A numpy copy of the reference package's builder: for the same vectors and
seed it emits byte-identical tables, so an index built by either package
searches identically in both. `device_db` is the one addition — it turns
the numpy tables into tensors on a device.

The construction path is a numpy re-implementation of hnswlib's insertion
algorithm (Malkov & Yashunin, Algorithms 1-5): per-point level sampling,
greedy descent through upper layers, ef_construction beam at the insertion
level, and heuristic neighbor selection with reverse-link pruning.

The *restructured database* follows the paper's Fig. 5: instead of hnswlib's
compact variable-stride layout (which forces unaligned, multi-read accesses),
we emit fixed-stride, padded structure-of-arrays tables:

  - raw-data table   : vectors[N, D_pad]            (lane-aligned, D_pad % 128 == 0)
  - layer-0 table    : l0_nbrs[N, maxM0_pad] int32  (-1 padded)
  - upper list table : up_nbrs[L_max, U, maxM_pad]  (rows only for points with
                       level >= 1; U is the padded count of such points)
  - index table      : up_ptr[N] int32 (row into the upper tables, -1 if the
                       point only exists at layer 0) + levels[N]

A single index-table read per point yields everything needed to address its
neighbor lists — the paper's "one access per point" property. Degrees are not
stored separately: padding with -1 encodes list length (the paper stores an
explicit size; a sentinel is the SoA equivalent and removes one fetch).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "HNSWConfig",
    "HostGraph",
    "DeviceDB",
    "GraphBuilder",
    "build_hnsw",
    "draw_levels",
    "restructure",
    "db_size_bytes",
    "db_to_tables",
    "db_from_tables",
    "device_db",
]


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    """Construction/search parameters (paper Table nomenclature).

    maxM is the per-node list budget in upper layers; maxM0 = 2*maxM at
    layer 0, both exactly as hnswlib / the paper set them.
    """

    M: int = 16
    ef_construction: int = 100
    max_level_cap: int = 8          # fixed upper bound so device shapes are static
    seed: int = 0
    # Device-layout padding knobs (the paper's 64B alignment analogue).
    lane: int = 128                 # vector feature padding (TPU lane width)
    nbr_pad: int = 8                # neighbor-list stride rounding

    @property
    def maxM(self) -> int:
        return self.M

    @property
    def maxM0(self) -> int:
        return 2 * self.M

    @property
    def ml(self) -> float:
        return 1.0 / math.log(self.M)


class HostGraph(NamedTuple):
    """Mutable-free snapshot of a built HNSW graph (host representation)."""

    vectors: np.ndarray          # [N, D] float32
    levels: np.ndarray           # [N] int32, level of each point (0-based)
    l0_nbrs: np.ndarray          # [N, maxM0] int32, -1 padded
    up_nbrs: np.ndarray          # [L_max, N_up, maxM] int32 (-1 padded)
    up_ptr: np.ndarray           # [N] int32 row into up_nbrs, -1 if level==0
    entry: int                   # entry point id
    max_level: int               # current top layer
    cfg: HNSWConfig


class DeviceDB(NamedTuple):
    """Restructured, alignment-padded database (pytree of arrays).

    This is the object that lives in HBM (the paper's DRAM-resident
    per-partition database). All shapes are static given (N_pad, D_pad,
    strides), so it can be stacked across partitions and sharded.
    """

    vectors: np.ndarray          # [N_pad, D_pad] float32 (rows >= n_valid are 0)
    sqnorms: np.ndarray          # [N_pad] float32, ||x||^2 (pad rows = +inf)
    l0_nbrs: np.ndarray          # [N_pad, maxM0_pad] int32, -1 padded
    up_nbrs: np.ndarray          # [L_max, U_pad, maxM_pad] int32, -1 padded
    up_ptr: np.ndarray           # [N_pad] int32 (-1 for level-0-only/pad rows)
    levels: np.ndarray           # [N_pad] int32 (pad rows = -1)
    gids: np.ndarray             # [N_pad] int32 global ids (pad rows = -1)
    entry: np.ndarray            # [] int32
    max_level: np.ndarray        # [] int32
    n_valid: np.ndarray          # [] int32


# ---------------------------------------------------------------------------
# Construction (hnswlib-equivalent, numpy)
# ---------------------------------------------------------------------------


def _dist(vectors: np.ndarray, ids: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Squared L2 distance between q and vectors[ids] (batched)."""
    diff = vectors[ids] - q[None, :]
    return np.einsum("nd,nd->n", diff, diff)


def _search_layer_host(
    vectors: np.ndarray,
    nbr_of,                      # callable(point_id) -> np.ndarray of neighbor ids
    q: np.ndarray,
    eps: list[int],
    ef: int,
) -> tuple[list[int], list[float]]:
    """Algorithm 2 of the HNSW paper: beam search at one layer (host)."""
    visited = set(eps)
    ep_d = _dist(vectors, np.asarray(eps, dtype=np.int64), q)
    # candidate min-heap and result max-heap emulated with sorted lists —
    # sizes here are tiny (<= ef + maxM0), simplicity over asymptotics.
    cand: list[tuple[float, int]] = sorted(zip(ep_d.tolist(), eps))
    found: list[tuple[float, int]] = sorted(zip(ep_d.tolist(), eps))[:ef]
    while cand:
        d_c, c = cand.pop(0)
        if found and d_c > found[-1][0] and len(found) >= ef:
            break
        nbrs = [int(e) for e in nbr_of(c) if e >= 0 and int(e) not in visited]
        if not nbrs:
            continue
        visited.update(nbrs)
        ds = _dist(vectors, np.asarray(nbrs, dtype=np.int64), q)
        bound = found[-1][0] if len(found) >= ef else np.inf
        for d_e, e in zip(ds.tolist(), nbrs):
            if d_e < bound or len(found) < ef:
                _insort(cand, (d_e, e))
                _insort(found, (d_e, e))
                if len(found) > ef:
                    found.pop()
                    bound = found[-1][0]
    return [i for _, i in found], [d for d, _ in found]


def _insort(lst: list[tuple[float, int]], item: tuple[float, int]) -> None:
    lo, hi = 0, len(lst)
    while lo < hi:
        mid = (lo + hi) // 2
        if lst[mid][0] < item[0]:
            lo = mid + 1
        else:
            hi = mid
    lst.insert(lo, item)


def _select_heuristic(
    vectors: np.ndarray, cand_ids: list[int], cand_ds: list[float], m: int
) -> list[int]:
    """Algorithm 4: heuristic neighbor selection (keeps diverse neighbors)."""
    order = np.argsort(cand_ds)
    selected: list[int] = []
    for idx in order:
        if len(selected) >= m:
            break
        e, d_e = cand_ids[idx], cand_ds[idx]
        ok = True
        for s in selected:
            diff = vectors[e] - vectors[s]
            if float(diff @ diff) < d_e:
                ok = False
                break
        if ok:
            selected.append(e)
    # hnswlib keepPrunedConnections: fill remaining slots by distance order.
    if len(selected) < m:
        for idx in order:
            e = cand_ids[idx]
            if e not in selected:
                selected.append(e)
                if len(selected) >= m:
                    break
    return selected


class GraphBuilder:
    """Incremental HNSW construction: one `insert_point` call per vector.

    This is the insertion loop of Algorithm 1, factored out of `build_hnsw`
    so mutable indexes (the ingest layer) can grow a graph point by point:
    `build_hnsw` is now exactly `GraphBuilder` + one `insert_point` per row
    and produces bit-identical graphs to the pre-factoring implementation
    (levels are drawn from the same seeded stream, upper-table rows are
    assigned in the same ascending-id order, and the beam/heuristic logic
    is byte-for-byte the same helpers).

    Arrays grow by doubling; `graph()` snapshots the current state as a
    `HostGraph` (trimmed to the live prefix) at any point — a sealed
    memtable is just `restructure(builder.graph())`.
    """

    def __init__(self, dim: int, cfg: HNSWConfig):
        self.cfg = cfg
        self.dim = int(dim)
        self._rng = np.random.default_rng(cfg.seed)
        self.n = 0
        self.entry = 0
        self.max_level = 0
        cap = 64
        self._vectors = np.zeros((cap, self.dim), dtype=np.float32)
        self._levels = np.zeros(cap, dtype=np.int32)
        self._l0 = np.full((cap, cfg.maxM0), -1, dtype=np.int32)
        self._up_ptr = np.full(cap, -1, dtype=np.int32)
        self.n_up = 0
        up_cap = 16
        self._up = np.full((cfg.max_level_cap - 1, up_cap, cfg.maxM), -1,
                           dtype=np.int32)

    # -- growth --------------------------------------------------------------

    def _grow_points(self, need: int) -> None:
        cap = self._vectors.shape[0]
        if need <= cap:
            return
        new = max(need, 2 * cap)
        for name in ("_vectors", "_levels", "_l0", "_up_ptr"):
            old = getattr(self, name)
            fill = -1 if old.dtype == np.int32 and name != "_levels" else 0
            grown = np.full((new,) + old.shape[1:], fill, dtype=old.dtype)
            grown[:cap] = old
            setattr(self, name, grown)

    def _grow_upper(self, need: int) -> None:
        cap = self._up.shape[1]
        if need <= cap:
            return
        new = max(need, 2 * cap)
        grown = np.full((self.cfg.max_level_cap - 1, new, self.cfg.maxM), -1,
                        dtype=np.int32)
        grown[:, :cap] = self._up
        self._up = grown

    # -- the factored insertion routine --------------------------------------

    def draw_level(self) -> int:
        """Next level from the seeded exponential stream (Algorithm 1 l.4)."""
        u = float(self._rng.uniform(1e-12, 1.0))
        return min(int(-math.log(u) * self.cfg.ml), self.cfg.max_level_cap - 1)

    def _nbrs_at(self, layer: int):
        if layer == 0:
            return lambda p: self._l0[p]
        return lambda p: self._up[layer - 1, self._up_ptr[p]]

    def _set_nbrs(self, layer: int, p: int, ids: list[int]) -> None:
        cfg = self.cfg
        if layer == 0:
            row, width = self._l0[p], cfg.maxM0
        else:
            row, width = self._up[layer - 1, self._up_ptr[p]], cfg.maxM
        row[:] = -1
        row[: min(len(ids), width)] = ids[:width]

    def insert_point(self, q: np.ndarray, level: int | None = None) -> int:
        """Insert one vector (HNSW paper Algorithm 1); returns its local id.

        `level` overrides the sampled layer (used by `build_hnsw` to keep
        the vectorized level stream; incremental callers leave it None).
        """
        cfg = self.cfg
        q = np.ascontiguousarray(q, dtype=np.float32)
        if q.shape != (self.dim,):
            raise ValueError(f"expected a [{self.dim}] vector, "
                             f"got shape {q.shape}")
        lvl = self.draw_level() if level is None else int(level)
        i = self.n
        self._grow_points(i + 1)
        self._vectors[i] = q
        self._levels[i] = lvl
        self._l0[i] = -1
        if lvl >= 1:
            self._grow_upper(self.n_up + 1)
            self._up_ptr[i] = self.n_up
            self._up[:, self.n_up] = -1
            self.n_up += 1
        else:
            self._up_ptr[i] = -1
        self.n = i + 1
        if i == 0:
            self.entry, self.max_level = 0, lvl
            return i

        vectors = self._vectors
        eps = [self.entry]
        # 1) greedy descent from the top to lvl+1.
        for layer in range(self.max_level, lvl, -1):
            changed = True
            cur_d = float(_dist(vectors, np.asarray(eps[:1]), q)[0])
            cur = eps[0]
            while changed:
                changed = False
                nb = [int(e) for e in self._nbrs_at(layer)(cur) if e >= 0]
                if nb:
                    ds = _dist(vectors, np.asarray(nb), q)
                    j = int(np.argmin(ds))
                    if float(ds[j]) < cur_d:
                        cur, cur_d, changed = nb[j], float(ds[j]), True
            eps = [cur]
        # 2) beam insert from min(max_level, lvl) down to 0.
        for layer in range(min(self.max_level, lvl), -1, -1):
            width = cfg.maxM0 if layer == 0 else cfg.maxM
            cand_ids, cand_ds = _search_layer_host(
                vectors, self._nbrs_at(layer), q, eps, cfg.ef_construction
            )
            sel = _select_heuristic(vectors, cand_ids, cand_ds, cfg.M)
            self._set_nbrs(layer, i, sel)
            # reverse links with pruning (Algorithm 1 lines 10-17).
            for e in sel:
                row = self._nbrs_at(layer)(e)
                cur = [int(x) for x in row if x >= 0]
                if i not in cur:
                    cur.append(i)
                if len(cur) > width:
                    ds = _dist(vectors, np.asarray(cur), vectors[e]).tolist()
                    cur = _select_heuristic(vectors, cur, ds, width)
                self._set_nbrs(layer, e, cur)
            eps = cand_ids
        if lvl > self.max_level:
            self.entry, self.max_level = i, lvl
        return i

    # -- snapshot ------------------------------------------------------------

    def graph(self) -> HostGraph:
        """Immutable `HostGraph` view of the points inserted so far."""
        if self.n == 0:
            raise ValueError("cannot snapshot an empty graph")
        n, n_up = self.n, max(1, self.n_up)
        return HostGraph(
            vectors=self._vectors[:n].copy(),
            levels=self._levels[:n].copy(),
            l0_nbrs=self._l0[:n].copy(),
            up_nbrs=self._up[:, :n_up].copy(),
            up_ptr=self._up_ptr[:n].copy(),
            entry=self.entry,
            max_level=self.max_level,
            cfg=self.cfg,
        )


def draw_levels(n: int, cfg: HNSWConfig) -> np.ndarray:
    """The levels [n] int32 of a build of n points: one vectorized draw of
    -log(U) * ml from the seeded stream, capped (the historical stream)."""
    rng = np.random.default_rng(cfg.seed)
    return np.minimum(
        (-np.log(rng.uniform(1e-12, 1.0, size=n)) * cfg.ml).astype(np.int32),
        cfg.max_level_cap - 1,
    )


def build_hnsw(vectors: np.ndarray, cfg: HNSWConfig) -> HostGraph:
    """Insert all points (Algorithm 1 of the HNSW paper), return the graph.

    Levels are sampled for the whole batch up front (one vectorized draw
    from the seeded rng — the historical stream) and fed to the factored
    `GraphBuilder.insert_point`, so batch builds stay bit-identical across
    the incremental-construction refactor.
    """
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, dim = vectors.shape
    levels = draw_levels(n, cfg)
    b = GraphBuilder(dim, cfg)
    for i in range(n):
        b.insert_point(vectors[i], level=int(levels[i]))
    return b.graph()


# ---------------------------------------------------------------------------
# Restructuring (paper Fig. 5) — host graph -> aligned device DB
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _dedup_rows(table: np.ndarray) -> np.ndarray:
    """Mask duplicate ids within each neighbor list to -1 (keep first).

    The device search kernel's visited-bitmap update scatter-adds one
    power-of-two bit per list entry; uniqueness within a row makes that
    exactly bitwise-OR. Construction already produces unique lists — this is
    the enforcement point for externally-loaded graphs.
    """
    flat = table.reshape(-1, table.shape[-1])
    out = flat.copy()
    srt = np.sort(flat, axis=1)
    has_dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    for r in np.flatnonzero(has_dup.any(axis=1)):
        seen: set[int] = set()
        for j, v in enumerate(flat[r]):
            if v < 0:
                continue
            if int(v) in seen:
                out[r, j] = -1
            else:
                seen.add(int(v))
    return out.reshape(table.shape)


def restructure(
    g: HostGraph,
    gids: np.ndarray | None = None,
    n_pad: int | None = None,
    up_pad: int | None = None,
) -> DeviceDB:
    """Emit the aligned SoA tables. Padding makes shapes partition-uniform."""
    cfg = g.cfg
    n, d = g.vectors.shape
    n_pad = n_pad or _round_up(n, 32)   # multiple of 32 -> whole bitmap words
    d_pad = _round_up(d, cfg.lane)
    m0p = _round_up(cfg.maxM0, cfg.nbr_pad)
    mp = _round_up(cfg.maxM, cfg.nbr_pad)
    n_up = g.up_nbrs.shape[1]
    up_pad_n = up_pad or _round_up(max(n_up, 1), 8)

    vec = np.zeros((n_pad, d_pad), dtype=np.float32)
    vec[:n, :d] = g.vectors
    sq = np.full((n_pad,), np.inf, dtype=np.float32)
    sq[:n] = np.einsum("nd,nd->n", g.vectors, g.vectors)
    l0 = np.full((n_pad, m0p), -1, dtype=np.int32)
    l0[:n, : cfg.maxM0] = _dedup_rows(g.l0_nbrs)
    up = np.full((cfg.max_level_cap - 1, up_pad_n, mp), -1, dtype=np.int32)
    up[:, :n_up, : cfg.maxM] = _dedup_rows(g.up_nbrs)
    ptr = np.full((n_pad,), -1, dtype=np.int32)
    ptr[:n] = g.up_ptr
    lv = np.full((n_pad,), -1, dtype=np.int32)
    lv[:n] = g.levels
    if gids is None:
        gids = np.arange(n, dtype=np.int32)
    gid = np.full((n_pad,), -1, dtype=np.int32)
    gid[:n] = gids.astype(np.int32)
    return DeviceDB(
        vectors=vec,
        sqnorms=sq,
        l0_nbrs=l0,
        up_nbrs=up,
        up_ptr=ptr,
        levels=lv,
        gids=gid,
        entry=np.asarray(g.entry, dtype=np.int32),
        max_level=np.asarray(g.max_level, dtype=np.int32),
        n_valid=np.asarray(n, dtype=np.int32),
    )


# ---------------------------------------------------------------------------
# Block-layout serialization — DeviceDB <-> row-major tables
# ---------------------------------------------------------------------------


# The paper's Fig. 5 tables, in on-flash order: raw-data table, layer-0
# table, upper-list table, index table (up_ptr/levels/gids/sqnorms are the
# per-point index records; sqnorms ride along so one row read yields the
# ||x||^2 term of the distance).
TABLE_ORDER = ("vectors", "sqnorms", "l0_nbrs", "up_nbrs", "up_ptr",
               "levels", "gids")


def db_to_tables(db: DeviceDB) -> tuple[dict[str, np.ndarray], dict]:
    """Flatten a (possibly partition-stacked) DeviceDB into 2-D row-major
    tables addressable as fixed-stride rows — the unit the block store
    persists. Returns (tables, meta); `db_from_tables` inverts exactly.

    Row addressing for a stacked DB with P partitions:
      vectors/sqnorms/l0_nbrs/up_ptr/levels/gids : row = p * n_pad + i
      up_nbrs                                    : row = (p * L + layer) * u_pad + r
    """
    v = np.asarray(db.vectors)
    stacked = v.ndim == 3
    P = v.shape[0] if stacked else 1

    def flat(name, width):
        a = np.asarray(getattr(db, name))
        return np.ascontiguousarray(a.reshape(-1, width))

    n_pad, d_pad = v.shape[-2], v.shape[-1]
    up = np.asarray(db.up_nbrs)
    n_layers, u_pad, mp = up.shape[-3], up.shape[-2], up.shape[-1]
    tables = {
        "vectors": flat("vectors", d_pad),
        "sqnorms": flat("sqnorms", 1),
        "l0_nbrs": flat("l0_nbrs", np.asarray(db.l0_nbrs).shape[-1]),
        "up_nbrs": flat("up_nbrs", mp),
        "up_ptr": flat("up_ptr", 1),
        "levels": flat("levels", 1),
        "gids": flat("gids", 1),
    }
    as_list = lambda x: np.atleast_1d(np.asarray(x)).astype(int).tolist()
    meta = {
        "stacked": stacked,
        "num_partitions": P,
        "n_pad": n_pad,
        "d_pad": d_pad,
        "m0_pad": int(tables["l0_nbrs"].shape[1]),
        "n_layers": n_layers,
        "up_pad": u_pad,
        "m_pad": mp,
        "entry": as_list(db.entry),
        "max_level": as_list(db.max_level),
        "n_valid": as_list(db.n_valid),
    }
    return tables, meta


def db_from_tables(tables: dict[str, np.ndarray], meta: dict) -> DeviceDB:
    """Rebuild the DeviceDB from row-major tables (inverse of db_to_tables)."""
    P, n_pad = meta["num_partitions"], meta["n_pad"]
    lead = (P,) if meta["stacked"] else ()
    scalar = lambda xs: (np.asarray(xs, np.int32) if meta["stacked"]
                         else np.asarray(xs[0], np.int32))
    shp = lambda *tail: lead + tail
    return DeviceDB(
        vectors=np.asarray(tables["vectors"]).reshape(shp(n_pad, meta["d_pad"])),
        sqnorms=np.asarray(tables["sqnorms"]).reshape(shp(n_pad)),
        l0_nbrs=np.asarray(tables["l0_nbrs"]).reshape(shp(n_pad, meta["m0_pad"])),
        up_nbrs=np.asarray(tables["up_nbrs"]).reshape(
            shp(meta["n_layers"], meta["up_pad"], meta["m_pad"])),
        up_ptr=np.asarray(tables["up_ptr"]).reshape(shp(n_pad)),
        levels=np.asarray(tables["levels"]).reshape(shp(n_pad)),
        gids=np.asarray(tables["gids"]).reshape(shp(n_pad)),
        entry=scalar(meta["entry"]),
        max_level=scalar(meta["max_level"]),
        n_valid=scalar(meta["n_valid"]),
    )


def db_size_bytes(db: DeviceDB) -> dict[str, int]:
    """Table sizes — used to reproduce the paper's '+4% size' observation."""
    out = {}
    for name in ("vectors", "l0_nbrs", "up_nbrs", "up_ptr", "sqnorms"):
        out[name] = getattr(db, name).nbytes
    out["total"] = sum(out.values())
    return out


def device_db(db: DeviceDB, device) -> DeviceDB:
    """Move a DeviceDB of numpy arrays or tensors (single or partition-
    stacked) onto `device` as tensors. Dtypes are kept: float32 tables
    stay float32 and every id / pointer / level table stays int32, -1
    padded. A tensor already on `device` is used as it is."""
    return DeviceDB(*(a.to(device).contiguous() if isinstance(a, torch.Tensor)
                      else torch.as_tensor(np.array(a, order="C"),
                                           device=device) for a in db))
