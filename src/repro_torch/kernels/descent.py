"""Greedy descent of the HNSW upper layers (ef = 1, paper §5.2.2): the
plain PyTorch loop and the wrapper of its CUDA kernel.

Every query lane starts at its partition's entry point and walks the
upper layers from the top down to layer 1: on each layer it moves to its
nearest upper-layer neighbour (the first on a tie) while that neighbour is
strictly nearer, for at most `upper_hops` hops, and skips the layers above
its partition's `max_level`. The walk returns the layer-0 entry (id,
distance) and the distance evaluations, which start at 1 for the entry
point itself.

Lanes: the stacked partition axis is folded into the lane axis, as in
kernels/traversal.py. L = P*B lanes; lane l searches partition l // B for
query l % B, over the partition-stacked tables of a `DeviceDB` (vectors
[P, N_pad, D_pad], sqnorms and up_ptr [P, N_pad], up_nbrs [P, NL, U_pad,
Mu_pad], entry and max_level [P]) and the [B, D_pad] queries.

`greedy_upper` is the plain version: lockstep torch ops over all lanes,
with a host sync a hop to decide whether another is needed, over any
distance function (the PQ path's LUT distances too). `greedy_descent_ref`
runs it with the mul + sum distances of float32 or 8-bit rows.
`greedy_descent_cuda` launches `csrc/descent.cu` (counted in
`DESCENT_LAUNCHES`): the whole walk of every lane in one launch, no host
sync. On 8-bit rows (and integer-valued float32 rows) every dot product is
an exact integer below 2^24, so the two agree bitwise. `ops.greedy_descent`
picks one by the tensors' device, never as a fallback.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2dist import raise_on
from repro_torch.kernels.traversal import METRICS, _check, metric_distance

__all__ = ["DESCENT_LAUNCHES", "greedy_descent_cuda", "greedy_descent_ref",
           "greedy_upper"]

# launches of csrc/descent.cu since import (or since a caller reset it)
DESCENT_LAUNCHES = 0

# csrc/descent.cu stages 8 lanes' float32 queries in a CTA's shared
# memory, which may hold 227 KB
_SMEM_BYTES_PER_D = 8 * 4
_MAX_SMEM_BYTES = 232_448

_INF = float("inf")


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def greedy_upper(up_ptr, up_nbrs, entry, max_level, part, distances,
                 upper_hops: int, span=None):
    """Descend every lane from its partition's top layer to layer 1 with
    lockstep torch ops.

    `part` [L] is each lane's partition; `distances(idx)` maps row ids
    [L, M] (int64, 0 in invalid slots) to the lanes' distances [L, M].
    Returns the layer-0 entry (id, distance) and the distance evaluations
    so far, which start at 1 for the entry point itself. `span` (the
    `descend` span) gets `route` "plain", `hops`, the lockstep hops taken,
    and `syncs`, the host syncs that decided whether to take one."""
    ep = entry[part]
    ep_d = distances(ep.long()[:, None])[:, 0]
    cur, cur_d = ep, ep_d
    calcs = torch.ones_like(ep)
    max_level = max_level[part]
    n_layers = up_nbrs.shape[1]                    # static cap - 1
    hops = syncs = 0
    for layer in range(n_layers, 0, -1):
        running = layer <= max_level               # this partition has it
        for _ in range(upper_hops):
            syncs += 1
            if not bool(running.any()):
                break
            hops += 1
            row = up_ptr[part, cur.long()]
            nbrs = up_nbrs[part, layer - 1, row.clamp_min(0).long()]
            valid = (nbrs >= 0) & (row >= 0)[:, None]
            safe = torch.where(valid, nbrs, torch.zeros_like(nbrs))
            d = torch.where(valid, distances(safe.long()), _INF)
            j = d.argmin(dim=1, keepdim=True)      # first index on ties
            best_d = d.gather(1, j)[:, 0]
            best = safe.gather(1, j)[:, 0]
            calcs = torch.where(running,
                                calcs + valid.sum(1, dtype=calcs.dtype), calcs)
            running = running & (best_d < cur_d)
            cur = torch.where(running, best, cur)
            cur_d = torch.where(running, best_d, cur_d)
    if span is not None:
        span.set(route="plain", hops=hops, syncs=syncs)
    return cur, cur_d, calcs


def greedy_descent_ref(vectors, sqnorms, up_ptr, up_nbrs, entry, max_level,
                       queries, qsq, *, upper_hops: int, metric: str = "l2",
                       span=None):
    """`greedy_upper` over float32 or 8-bit rows: each distance is a mul +
    sum over the row cast to float32, as the reference's
    `_batch_distances`. Returns (cur [L] int32, cur_d [L] float32, calcs
    [L] int32)."""
    P, B = vectors.shape[0], queries.shape[0]
    lane = torch.arange(P * B, device=vectors.device)
    part, qrow = lane // B, lane % B
    rows, q, qs = part[:, None], queries[qrow][:, None, :], qsq[qrow][:, None]

    def distances(idx):
        dot = (vectors[rows, idx].float() * q).sum(-1)
        return metric_distance(metric, dot, sqnorms[rows, idx], qs)

    return greedy_upper(up_ptr, up_nbrs, entry, max_level, part, distances,
                        upper_hops, span)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "repro_greedy_descent_f32",
          torch.uint8: "repro_greedy_descent_u8",
          torch.int8: "repro_greedy_descent_i8"}
_SIGNATURES = {
    **{fn: (ctypes.c_int, [_P] * 11 + [_I] * 10 + [_P])
       for fn in _ENTRY.values()},
    "repro_descent_error_string": (ctypes.c_char_p, [_I]),
}


def _operands(vectors, sqnorms, up_ptr, up_nbrs, entry, max_level, queries,
              qsq, metric):
    """Check a launch's dtypes, shapes, layout and devices, then that they
    are CUDA tensors; returns (device, (P, N_pad, D_pad, NL, U_pad,
    Mu_pad, B)) or raises."""
    if vectors.dtype not in _ENTRY:
        raise TypeError(f"vectors has dtype {vectors.dtype}; the kernel "
                        f"takes {sorted(map(str, _ENTRY))}")
    if vectors.dim() != 3 or up_nbrs.dim() != 4 or queries.dim() != 2:
        raise ValueError("the tables must be partition-stacked: vectors "
                         "[P, N_pad, D_pad], up_nbrs [P, NL, U_pad, Mu_pad]; "
                         "queries [B, D_pad]")
    P, N, D = vectors.shape
    _, NL, U, Mu = up_nbrs.shape
    B = queries.shape[0]
    if D * vectors.element_size() % 128 or Mu < 1:
        raise ValueError(
            f"unsupported shapes: D_pad={D} ({vectors.dtype} rows of a "
            f"multiple of 128 bytes), Mu_pad={Mu} (>= 1)")
    if _SMEM_BYTES_PER_D * D > _MAX_SMEM_BYTES:
        raise ValueError(f"D_pad={D}: 8 lanes' queries take "
                         f"{_SMEM_BYTES_PER_D * D} bytes of shared memory "
                         f"(> {_MAX_SMEM_BYTES})")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    f32, i32, dev = torch.float32, torch.int32, vectors.device
    _check("vectors", vectors, vectors.dtype, (P, N, D), dev)
    _check("sqnorms", sqnorms, f32, (P, N), dev)
    _check("up_ptr", up_ptr, i32, (P, N), dev)
    _check("up_nbrs", up_nbrs, i32, (P, NL, U, Mu), dev)
    _check("entry", entry, i32, (P,), dev)
    _check("max_level", max_level, i32, (P,), dev)
    _check("queries", queries, f32, (B, D), dev)
    _check("qsq", qsq, f32, (B,), dev)
    if dev.type != "cuda":
        raise ValueError(f"greedy_descent_cuda needs CUDA tensors, got {dev}")
    if vectors.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("vectors and queries must be 16-byte aligned")
    return dev, (P, N, D, NL, U, Mu, B)


def greedy_descent_cuda(vectors, sqnorms, up_ptr, up_nbrs, entry, max_level,
                        queries, qsq, *, upper_hops: int, metric: str = "l2",
                        span=None):
    """Launch `csrc/descent.cu` on the current stream, counted in
    `DESCENT_LAUNCHES`: the whole descent of all P*B lanes. Returns (cur
    [L] int32, cur_d [L] float32, calcs [L] int32), `greedy_descent_ref`'s
    outputs. `span` gets `route` "kernel", `syncs` 0 and `launches` 1.

    Takes float32, uint8 or int8 rows of a multiple of 128 bytes; raises
    on any other dtype, shape, layout or device, before any launch, and if
    the launch fails."""
    dev, (P, N, D, NL, U, Mu, B) = _operands(
        vectors, sqnorms, up_ptr, up_nbrs, entry, max_level, queries, qsq,
        metric)
    if upper_hops < 0:
        raise ValueError("upper_hops must be >= 0")
    L = P * B
    cur = torch.empty(L, dtype=torch.int32, device=dev)
    cur_d = torch.empty(L, dtype=torch.float32, device=dev)
    calcs = torch.empty(L, dtype=torch.int32, device=dev)
    if L == 0:
        return cur, cur_d, calcs
    lib = _build.load("descent", _SIGNATURES)
    err = getattr(lib, _ENTRY[vectors.dtype])(
        vectors.data_ptr(), sqnorms.data_ptr(), up_ptr.data_ptr(),
        up_nbrs.data_ptr(), entry.data_ptr(), max_level.data_ptr(),
        queries.data_ptr(), qsq.data_ptr(), cur.data_ptr(), cur_d.data_ptr(),
        calcs.data_ptr(), dev.index or 0, L, B, N, D, NL, U, Mu, upper_hops,
        METRICS[metric], torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "repro_descent_error_string", err, "greedy descent")
    _build.count_launch(__name__, "DESCENT_LAUNCHES")
    if span is not None:
        span.set(route="kernel", syncs=0, launches=1)
    return cur, cur_d, calcs
