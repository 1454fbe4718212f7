"""Fused multi-hop layer-0 traversal (paper §5.2, Fig. 6): the plain
PyTorch superstep and the wrapper of its CUDA kernel.

One superstep advances every query lane of the layer-0 beam search by up
to H hops. Each hop pops the head of the lane's candidate list, gathers
its neighbor row, test-and-sets the packed visited bitmap, computes the
distances to the not-yet-visited neighbors, drops those that cannot enter
the final list (Algorithm 1's line-11 guard), stable-sorts the new batch
and rank-merges it into the candidate [C] and final [EF] lists. A lane
whose termination condition holds keeps its state unchanged — the
per-lane `live` guard of the reference's lockstep loop.

Lanes: the stacked partition axis is folded into the lane axis. The state
tensors have L = P*B rows; lane l searches partition l // B for query
l % B, so the tables are the partition-stacked [P, N_pad, ...] tensors and
`queries` / `qsq` are the [B, ...] batch shared by every partition.
`vectors` holds float32 rows or 8-bit code rows (uint8 / int8, with
code-valued float32 queries); code rows are cast to float32, and for
8-bit codes at D <= 256 every dot product is an exact integer.

Both versions update the state tensors in place (cand_d, cand_i, fin_d,
fin_i, visited, hops, calcs) and also return them.

The visited bitmap is int32 holding the reference's uint32 bits: torch has
no `>>`, `<<` or `scatter_add_` for uint32 on every backend. Testing a bit
as `(word >> b) & 1` is exact although `>>` on int32 is arithmetic, and
setting bits is a scatter-add of distinct not-yet-set bits (ids within a
neighbor row are unique), so no add carries and bit 31 wraps to the right
two's-complement pattern.

`fused_traversal_ref` is the plain version: the CPU path and the yardstick
the kernels are compared with on the card. `fused_traversal_cuda` launches
one of two CUDA kernels (built by `_build.py`), chosen by
`traversal_route` from the shapes alone, never by value and never as a
fallback (a failed build or launch raises):

- `csrc/traversal_async.cu` (`fused_traversal_async_cuda`, counted in
  `ASYNC_LAUNCHES`), the main path's: the visited bitmap in shared memory
  where it fits, every active row gathered in one round of TMA bulk
  copies, the next hop's neighbour list loaded while the merges run; it
  takes M0_pad <= 32 and shapes whose CTA fits `SMEM_BUDGET`;
- `csrc/traversal.cu` (`fused_traversal_ldg_cuda`, counted in
  `LAUNCHES`) for the rest: rows gathered into registers 16 at a time,
  the bitmap in global memory.

Both compute the same function bitwise on integer-valued rows.
`ops.fused_layer0` picks the plain version or `fused_traversal_cuda` by
the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2dist import raise_on

__all__ = ["ASYNC_LAUNCHES", "LAUNCHES", "METRICS",
           "async_blocks_per_sm", "async_smem_bytes", "async_smem_bytes_cuda",
           "beam_merge", "fused_traversal_ref", "fused_traversal_async_cuda",
           "fused_traversal_cuda", "fused_traversal_ldg_cuda", "layer0_hop",
           "merge_sorted", "metric_distance", "traversal_route",
           "visited_test_and_set"]

# launches of each CUDA kernel since import (or since a caller reset them)
LAUNCHES = 0                      # csrc/traversal.cu
ASYNC_LAUNCHES = 0                # csrc/traversal_async.cu

METRICS = {"l2": 0, "ip": 1, "cosine": 2}

# shape limits of csrc/traversal.cu (its static shared-memory lists)
MAX_M0, MAX_C = 128, 256

_INF = float("inf")


# ---------------------------------------------------------------------------
# Building blocks (batched over leading axes)
# ---------------------------------------------------------------------------


def metric_distance(metric: str, dot, xsq, qsq):
    """Distance from a dot product, ascending == better.

    l2 is ``max(xsq - 2*dot + qsq, 0)`` evaluated as three separately
    rounded float32 ops — the order the CUDA kernel reproduces with
    `__fmul_rn` / `__fsub_rn` / `__fadd_rn`."""
    if metric == "l2":
        return torch.clamp_min(xsq - 2.0 * dot + qsq, 0.0)
    if metric == "ip":
        return -dot
    if metric == "cosine":                       # unit-norm inputs assumed
        return 1.0 - dot
    raise ValueError(f"unknown metric {metric!r}")


def merge_sorted(ad, ai, bd, bi):
    """Merge ascending (dist, id) rows along the last axis; ties keep `a`
    first.

    Insert positions are ranks: ``pa = i + #(b < a_i)`` (searchsorted
    left) and ``pb = j + #(a <= b_j)`` (searchsorted right) — the paper's
    comparison-bit-vector popcount. Returns rows of length na + nb."""
    na, nb = ad.shape[-1], bd.shape[-1]
    ad, bd = ad.contiguous(), bd.contiguous()
    pa = (torch.arange(na, device=ad.device)
          + torch.searchsorted(bd, ad, side="left"))
    pb = (torch.arange(nb, device=ad.device)
          + torch.searchsorted(ad, bd, side="right"))
    shape = ad.shape[:-1] + (na + nb,)
    od = ad.new_empty(shape).scatter_(-1, pa, ad).scatter_(-1, pb, bd)
    oi = ai.new_empty(shape).scatter_(-1, pa, ai).scatter_(-1, pb, bi)
    return od, oi


def visited_test_and_set(bitmap, ids, valid):
    """Packed visited bitmap [L, W] int32; ids / valid [L, M].

    Returns (was_visited [L, M] bool, new_bitmap): the new bitmap has one
    more bit set for each id that was valid and not yet visited. `ids`
    must be unique where valid, so the scatter-add of distinct bits within
    a word equals bitwise OR."""
    w = (ids >> 5).long()
    b = ids & 31
    old = bitmap.gather(1, w)
    was = (((old >> b) & 1) != 0) | ~valid
    add = torch.where(was, torch.zeros_like(b), torch.ones_like(b) << b)
    return was, bitmap.scatter_add(1, w, add)


# ---------------------------------------------------------------------------
# The plain superstep
# ---------------------------------------------------------------------------


def beam_merge(cand_d, cand_i, fin_d, fin_i, calcs, nbrs, act, d):
    """The rest of one beam hop of every lane once its distances `d` [L,
    M0] to the neighbors `nbrs` are known, `act` marking the valid and
    unvisited ones: pop the candidate head (line 3), count the distance
    evaluations, drop what cannot enter the final list (line 11 guard),
    stable-sort the batch and rank-merge it into both lists. Returns the
    new (cand_d, cand_i, fin_d, fin_i, calcs) of every lane; the caller
    keeps the old ones where a lane does not move."""
    C, EF = cand_d.shape[1], fin_d.shape[1]
    pcand_d = torch.cat([cand_d[:, 1:], torch.full_like(cand_d[:, :1], _INF)],
                        dim=1)
    pcand_i = torch.cat([cand_i[:, 1:], torch.full_like(cand_i[:, :1], -1)],
                        dim=1)
    d = torch.where(act, d, _INF)
    ncalcs = calcs + act.sum(1, dtype=calcs.dtype)
    d = torch.where(d < fin_d[:, -1:], d, _INF)
    ids = torch.where(torch.isfinite(d), nbrs, -1)
    bd, order = torch.sort(d, dim=1, stable=True)
    bi = ids.gather(1, order)
    fd, fi = merge_sorted(fin_d, fin_i, bd, bi)
    cd, ci = merge_sorted(pcand_d, pcand_i, bd, bi)
    return cd[:, :C], ci[:, :C], fd[:, :EF], fi[:, :EF], ncalcs


def layer0_hop(l0_nbrs, part, distances, cand_d, cand_i, fin_d, fin_i,
               visited, hops, calcs, *, max_hops: int) -> bool:
    """One layer-0 hop for every live lane, in place.

    `part` [L] is each lane's partition; `distances(idx)` maps neighbor
    ids [L, M0] (int64, 0 in invalid slots) to the lanes' distances
    [L, M0]. Returns False, having changed nothing, when no lane is live.
    The superstep below and the hop-stepped PQ layer 0 of `core/search.py`
    share this body."""
    live = (cand_d[:, 0] < fin_d[:, -1]) & (hops < max_hops)
    if not bool(live.any()):
        return False
    c = cand_i[:, 0].clamp_min(0).long()
    nbrs = l0_nbrs[part, c]                                    # [L, M0]
    valid = nbrs >= 0
    safe = torch.where(valid, nbrs, torch.zeros_like(nbrs))
    was, vis2 = visited_test_and_set(visited, safe, valid)
    cd, ci, fd, fi, ncalcs = beam_merge(cand_d, cand_i, fin_d, fin_i, calcs,
                                        safe, valid & ~was,
                                        distances(safe.long()))
    lv = live[:, None]
    visited.copy_(torch.where(lv, vis2, visited))
    cand_d.copy_(torch.where(lv, cd, cand_d))
    cand_i.copy_(torch.where(lv, ci, cand_i))
    fin_d.copy_(torch.where(lv, fd, fin_d))
    fin_i.copy_(torch.where(lv, fi, fin_i))
    calcs.copy_(torch.where(live, ncalcs, calcs))
    hops.add_(live.to(hops.dtype))
    return True


def fused_traversal_ref(vectors, sqnorms, l0_nbrs, queries, qsq,
                        cand_d, cand_i, fin_d, fin_i, visited, hops, calcs,
                        *, fused_hops: int, max_hops: int, metric: str = "l2"):
    """Advance every lane by up to `fused_hops` hops with batched torch ops
    (in place; see the module docstring for shapes). `vectors` may hold
    float32 rows or uint8/int8 code rows; rows are cast to float32."""
    L = cand_d.shape[0]
    B = queries.shape[0]
    lane = torch.arange(L, device=cand_d.device)
    part = lane // B
    q = queries[lane % B][:, None, :]            # [L, 1, D]
    qs = qsq[lane % B][:, None]

    def distances(idx):
        dot = (vectors[part[:, None], idx].float() * q).sum(-1)
        return metric_distance(metric, dot, sqnorms[part[:, None], idx], qs)

    for _ in range(fused_hops):
        if not layer0_hop(l0_nbrs, part, distances, cand_d, cand_i, fin_d,
                          fin_i, visited, hops, calcs, max_hops=max_hops):
            break
    return cand_d, cand_i, fin_d, fin_i, visited, hops, calcs


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers and the route between them
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# row dtype -> each kernel's C entry point for it
_LDG_ENTRY = {torch.float32: "repro_fused_traversal_f32",
              torch.uint8: "repro_fused_traversal_u8",
              torch.int8: "repro_fused_traversal_i8"}
_ASYNC_ENTRY = {torch.float32: "repro_traversal_async_f32",
                torch.uint8: "repro_traversal_async_u8",
                torch.int8: "repro_traversal_async_i8"}
_DTYPE_CODE = {torch.float32: 0, torch.uint8: 1, torch.int8: 2}
_LDG_SIGNATURES = {
    **{fn: (ctypes.c_int, [_P] * 12 + [_I] * 12 + [_P])
       for fn in _LDG_ENTRY.values()},
    "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
}
_ASYNC_SIGNATURES = {
    **{fn: (ctypes.c_int, [_P] * 12 + [_I] * 13 + [_P])
       for fn in _ASYNC_ENTRY.values()},
    "repro_traversal_async_smem_bytes": (ctypes.c_int, [_I] * 6),
    "repro_traversal_async_blocks_per_sm": (ctypes.c_int, [_I] * 7),
    "repro_traversal_async_error_string": (ctypes.c_char_p, [_I]),
}

# csrc/traversal_async.cu: a lane of warp 0 a neighbour, so M0_pad <= 32;
# 8 CTAs an SM (L = 1,024 lanes in one wave on 132 SMs), so a CTA's shared
# memory stays within an eighth of an SM's 228 KB less the 1 KB the card
# reserves for each CTA
ASYNC_MAX_M0 = 32
SMEM_BUDGET = 233_472 // 8 - 1024           # 28,160 bytes
# the widest visited bitmap kept in shared memory: 8 KB, 65,536 rows
MAX_SHARED_BITMAP_WORDS = 2048


def async_smem_bytes(dtype, d_pad: int, m0_pad: int, C: int, EF: int,
                     w_smem: int) -> int:
    """Dynamic shared memory of a `csrc/traversal_async.cu` launch, as its
    `layout` counts it: the mbarrier (16), M0_pad staged rows, the float32
    query, the batch's 32 slots (distance, id, sqnorm, row id), the
    candidate and final lists twice, and `w_smem` bitmap words (0 when the
    bitmap stays in global memory)."""
    return (16 + m0_pad * d_pad * dtype.itemsize + 4 * d_pad
            + 16 * ASYNC_MAX_M0 + 16 * C + 16 * EF + 4 * w_smem)


@functools.lru_cache(maxsize=None)
def traversal_route(dtype, d_pad: int, m0_pad: int, C: int, EF: int,
                    n_pad: int) -> tuple[str, str]:
    """(kernel, bitmap placement) that `fused_traversal_cuda` launches for
    these shapes, by shape alone:

    - ("async", "shared"): `csrc/traversal_async.cu` with the visited
      bitmap in shared memory, where W = ceil(N_pad / 32) <=
      `MAX_SHARED_BITMAP_WORDS` and the CTA, bitmap included, stays within
      `SMEM_BUDGET` (the main path: W = 256, float32 20,240 bytes);
    - ("async", "global"): the same kernel with the bitmap in global
      memory, where only the bitmap does not fit (1M-row tables);
    - ("ldg", "global"): `csrc/traversal.cu` for every other shape (M0_pad
      > 32; staged rows past the budget, e.g. float32 D_pad >= 256 at
      M0_pad = 32), which raises on what it cannot take either."""
    w = (n_pad + 31) // 32
    if (dtype in _ASYNC_ENTRY and d_pad > 0 and d_pad % 128 == 0
            and 0 < m0_pad <= ASYNC_MAX_M0 and 0 < EF <= C):
        if w <= MAX_SHARED_BITMAP_WORDS and async_smem_bytes(
                dtype, d_pad, m0_pad, C, EF, w) <= SMEM_BUDGET:
            return "async", "shared"
        if async_smem_bytes(dtype, d_pad, m0_pad, C, EF, 0) <= SMEM_BUDGET:
            return "async", "global"
    return "ldg", "global"


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _shapes(vectors, l0_nbrs, queries, cand_d, fin_d):
    """(P, N_pad, D_pad, M0_pad, B, L, C, EF) of a launch."""
    if vectors.dim() != 3:
        raise ValueError("vectors must be partition-stacked [P, N_pad, D_pad]")
    P, N, D = vectors.shape
    L, C = cand_d.shape
    return P, N, D, l0_nbrs.shape[-1], queries.shape[0], L, C, fin_d.shape[-1]


def _operands(entries, vectors, sqnorms, l0_nbrs, queries, qsq, cand_d,
              cand_i, fin_d, fin_i, visited, hops, calcs, *, fused_hops,
              metric, what):
    """Check a launch's operands; returns (device, shapes) or raises."""
    dev = vectors.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    P, N, D, M0, B, L, C, EF = shape = _shapes(vectors, l0_nbrs, queries,
                                               cand_d, fin_d)
    if L != P * B:
        raise ValueError(f"L={L} lanes, expected P*B = {P * B}")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if fused_hops < 1:
        raise ValueError("fused_hops must be >= 1")
    if vectors.dtype not in entries:
        raise TypeError(f"vectors has dtype {vectors.dtype}; the kernel "
                        f"takes {sorted(map(str, entries))}")
    f32, i32 = torch.float32, torch.int32
    _check("vectors", vectors, vectors.dtype, (P, N, D), dev)
    _check("sqnorms", sqnorms, f32, (P, N), dev)
    _check("l0_nbrs", l0_nbrs, i32, (P, N, M0), dev)
    _check("queries", queries, f32, (B, D), dev)
    _check("qsq", qsq, f32, (B,), dev)
    _check("cand_d", cand_d, f32, (L, C), dev)
    _check("cand_i", cand_i, i32, (L, C), dev)
    _check("fin_d", fin_d, f32, (L, EF), dev)
    _check("fin_i", fin_i, i32, (L, EF), dev)
    _check("visited", visited, i32, (L, (N + 31) // 32), dev)
    _check("hops", hops, i32, (L,), dev)
    _check("calcs", calcs, i32, (L,), dev)
    if vectors.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("vectors and queries must be 16-byte aligned")
    return dev, shape


def fused_traversal_ldg_cuda(vectors, sqnorms, l0_nbrs, queries, qsq,
                             cand_d, cand_i, fin_d, fin_i, visited, hops,
                             calcs, *, fused_hops: int, max_hops: int,
                             metric: str = "l2"):
    """Launch `csrc/traversal.cu` on the current stream (in place), counted
    in `LAUNCHES`: rows gathered into registers 16 at a time, the bitmap
    in global memory.

    Takes float32, uint8 or int8 rows with D_pad % 128 == 0, M0_pad <= 128,
    C <= 256 and EF <= C; raises on any other device, dtype, shape or
    layout."""
    dev, (P, N, D, M0, B, L, C, EF) = _operands(
        _LDG_ENTRY, vectors, sqnorms, l0_nbrs, queries, qsq, cand_d, cand_i,
        fin_d, fin_i, visited, hops, calcs, fused_hops=fused_hops,
        metric=metric, what="fused_traversal_ldg_cuda")
    if D % 128 or not 0 < M0 <= MAX_M0 or not 0 < C <= MAX_C \
            or not 0 < EF <= C:
        raise ValueError(
            f"unsupported shapes: D_pad={D} (multiple of 128), M0_pad={M0} "
            f"(<= {MAX_M0}), C={C} (<= {MAX_C}), EF={EF} (<= C)")
    lib = _build.load("traversal", _LDG_SIGNATURES)
    err = getattr(lib, _LDG_ENTRY[vectors.dtype])(
        vectors.data_ptr(), sqnorms.data_ptr(), l0_nbrs.data_ptr(),
        queries.data_ptr(), qsq.data_ptr(), cand_d.data_ptr(),
        cand_i.data_ptr(), fin_d.data_ptr(), fin_i.data_ptr(),
        visited.data_ptr(), hops.data_ptr(), calcs.data_ptr(),
        dev.index or 0, L, B, N, D, M0, C, EF, (N + 31) // 32, fused_hops,
        max_hops, METRICS[metric], torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "repro_cuda_error_string", err, "fused traversal")
    _build.count_launch(__name__, "LAUNCHES")
    return cand_d, cand_i, fin_d, fin_i, visited, hops, calcs


def fused_traversal_async_cuda(vectors, sqnorms, l0_nbrs, queries, qsq,
                               cand_d, cand_i, fin_d, fin_i, visited, hops,
                               calcs, *, fused_hops: int, max_hops: int,
                               metric: str = "l2"):
    """Launch `csrc/traversal_async.cu` on the current stream (in place),
    counted in `ASYNC_LAUNCHES`, with the bitmap where `traversal_route`
    places it. Raises on shapes the route gives to `traversal.cu`, on any
    other device, dtype, shape or layout, and if the launch fails."""
    dev, (P, N, D, M0, B, L, C, EF) = _operands(
        _ASYNC_ENTRY, vectors, sqnorms, l0_nbrs, queries, qsq, cand_d,
        cand_i, fin_d, fin_i, visited, hops, calcs, fused_hops=fused_hops,
        metric=metric, what="fused_traversal_async_cuda")
    kernel, bitmap = traversal_route(vectors.dtype, D, M0, C, EF, N)
    if kernel != "async":
        raise ValueError(
            f"traversal_async.cu does not take D_pad={D}, M0_pad={M0}, "
            f"C={C}, EF={EF} for {vectors.dtype} rows (M0_pad <= "
            f"{ASYNC_MAX_M0}, D_pad % 128 == 0, {SMEM_BUDGET} bytes of "
            f"shared memory a CTA)")
    lib = _build.load("traversal_async", _ASYNC_SIGNATURES)
    err = getattr(lib, _ASYNC_ENTRY[vectors.dtype])(
        vectors.data_ptr(), sqnorms.data_ptr(), l0_nbrs.data_ptr(),
        queries.data_ptr(), qsq.data_ptr(), cand_d.data_ptr(),
        cand_i.data_ptr(), fin_d.data_ptr(), fin_i.data_ptr(),
        visited.data_ptr(), hops.data_ptr(), calcs.data_ptr(),
        dev.index or 0, L, B, N, D, M0, C, EF, (N + 31) // 32, fused_hops,
        max_hops, METRICS[metric], int(bitmap == "shared"),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "repro_traversal_async_error_string", err,
              "fused traversal (async)")
    _build.count_launch(__name__, "ASYNC_LAUNCHES")
    return cand_d, cand_i, fin_d, fin_i, visited, hops, calcs


def fused_traversal_cuda(vectors, sqnorms, l0_nbrs, queries, qsq,
                         cand_d, cand_i, fin_d, fin_i, visited, hops, calcs,
                         *, fused_hops: int, max_hops: int,
                         metric: str = "l2"):
    """One superstep on the card (in place) by the kernel `traversal_route`
    picks from the shapes: `fused_traversal_async_cuda` or
    `fused_traversal_ldg_cuda`. Never a fallback: either raises on what it
    cannot take or if its launch fails."""
    P, N, D, M0, B, L, C, EF = _shapes(vectors, l0_nbrs, queries, cand_d,
                                       fin_d)
    kernel, _ = traversal_route(vectors.dtype, D, M0, C, EF, N)
    fn = fused_traversal_async_cuda if kernel == "async" \
        else fused_traversal_ldg_cuda
    return fn(vectors, sqnorms, l0_nbrs, queries, qsq, cand_d, cand_i,
              fin_d, fin_i, visited, hops, calcs, fused_hops=fused_hops,
              max_hops=max_hops, metric=metric)


def async_smem_bytes_cuda(dtype, d_pad: int, m0_pad: int, C: int, EF: int,
                          w_smem: int) -> int:
    """The kernel's own count of `async_smem_bytes` (builds it first)."""
    lib = _build.load("traversal_async", _ASYNC_SIGNATURES)
    return lib.repro_traversal_async_smem_bytes(
        d_pad * dtype.itemsize, d_pad, m0_pad, C, EF, w_smem)


def async_blocks_per_sm(dtype, d_pad: int, m0_pad: int, C: int, EF: int,
                        n_pad: int) -> int:
    """CTAs of `csrc/traversal_async.cu` resident on one SM at these shapes
    and the route's bitmap placement (CUDA's occupancy calculator)."""
    _, bitmap = traversal_route(dtype, d_pad, m0_pad, C, EF, n_pad)
    lib = _build.load("traversal_async", _ASYNC_SIGNATURES)
    n = lib.repro_traversal_async_blocks_per_sm(
        _DTYPE_CODE[dtype], d_pad, m0_pad, C, EF, (n_pad + 31) // 32,
        int(bitmap == "shared"))
    if n < 0:
        raise_on(lib, "repro_traversal_async_error_string", -n,
                  "occupancy query")
    return n
