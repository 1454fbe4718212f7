"""Distances over quantized rows: the exact scans over 8-bit code rows
(`l2dist_q`, `l2topk_q`) and the product-quantization ADC (dtype="pq"),
the plain PyTorch versions and the wrappers of their CUDA kernels.

    l2dist_q: queries [Bq, D] x codes [Bx, D] uint8 / int8
              -> d [Bq, Bx] f32 = max(code-space squared L2, 0) * out_scale
    l2topk_q: the k smallest of each row of that matrix, never materialized;
              the selection is made in code space and `out_scale` (the
              quantizer's scale^2) multiplies the k winners after it
              -> (dists [Bq, k] f32 ascending, ids [Bq, k] int32)

Queries are codes or code-valued float32; at D <= 256 every dot product
is an exact integer and kernel, plain version and reference agree
bitwise. Each scan runs on one of two kernels, chosen by dtype and shape:

- `l2dist_q`: `csrc/l2dist_q_tc.cu`, u8 / s8 `wgmma` into exact int32
  sums and a TMA-stored output, for queries given as codes of the rows'
  dtype with D a multiple of 16 up to 256, Bx a multiple of 4 (the
  output's 16-byte row pitch) and 16-byte aligned bases
  (`takes_tensor_cores_dist`); `l2dist_q_tc_cuda` launches it and counts
  in `L2DIST_Q_TC_LAUNCHES`. Else `csrc/l2dist.cu` (see
  `kernels/l2dist.py`; codes widened to float32, int8 sign-extended);
  `l2dist_q_fma_cuda` launches it and counts in `L2DIST_Q_LAUNCHES`.
- `l2topk_q` (the order, pad and tail rules of `kernels/l2topk.py`):
  `csrc/l2topk_q_tc.cu`, u8 / s8 `wgmma` with selection warps, for the
  same queries and D with no rule on Bx (`takes_tensor_cores`);
  `l2topk_q_tc_cuda` launches it and counts in `L2TOPK_Q_TC_LAUNCHES`.
  Else `csrc/l2topk.cu`, FP32 FMAs over codes widened to float32;
  `l2topk_q_fma_cuda` launches it and counts in `L2TOPK_Q_LAUNCHES`.

Code-valued float32 queries take the FMA kernels.

No value of the input is read to choose, and a failed build or launch of
either raises.

    pq_adc : luts [Bq, M, 256] f32 x codes [Bx, M] uint8 (+ xpad [Bx] f32)
             -> d [Bq, Bx] f32,  d[q, x] = xpad[x] + sum_m lut[q, m, code[x, m]]
    pq_topk: the k smallest of each row of that matrix, never materialized
             -> (dists [Bq, k] f32 ascending, ids [Bq, k] int32)

The sum starts at `xpad` (0 when absent; +inf marks a padding row) and
adds one table entry per subspace, in subspace order, each add rounded on
its own — the reference's order (`_pq_block_dists`), so kernel, plain
version and reference agree bitwise on any input.

`pq_topk` orders by distance, then by row id: among equal distances the
lower row wins, as the reference's `lax.top_k` does. A slot that no
finite distance fills (fewer than k rows, or padding rows) holds
(+inf, -1). There the reference returns ids that depend on its block
size; the finite slots agree.

`*_ref` are the plain versions: the CPU path and the yardstick the
kernels are compared with on the card. `pq_adc_cuda` picks one of two
kernels by shape and alignment (`pq_adc_route`), never by value:

- M in {16, 32, 64}, 16-byte aligned codes and xpad, Bx >= 1 ->
  `pq_adc_smem_cuda`, `csrc/pq_adc_smem.cu` (`pq_topk_smem.cu`'s layout
  without the selection: each warp stages its tile's distances in shared
  memory and writes whole 128-byte row segments), counted in
  `ADC_SMEM_LAUNCHES`;
- the rest -> `pq_adc_v1_cuda`, `csrc/qdist.cu` (a thread a row), counted
  in `ADC_LAUNCHES`.

`pq_topk_cuda` picks one of two kernels by shape and alignment
(`pq_topk_route`), never by value:

- M in {16, 32, 64}, 16-byte aligned codes and xpad, k <= 64 ->
  `pq_topk_smem_cuda`, `csrc/pq_topk_smem.cu` (queries across lanes over
  interleaved tables, code rows staged by TMA bulk copies, lists in
  registers), counted in `TOPK_SMEM_LAUNCHES`;
- the rest -> `pq_topk_v1_cuda`, `csrc/qdist.cu` (a thread a row, lists in
  local memory), counted in `TOPK_LAUNCHES`.

All are built by `_build.py`. `ops.*` pick the CUDA or the plain path by
the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2dist import (
    ROW_DTYPES,
    as_f32,
    distance_matrix_ref,
    launch_distance_matrix,
    raise_on,
    row_operands,
    sqnorms,
)
from repro_torch.kernels.l2topk import (
    fused_topk_ref,
    launch_fused_topk,
    splits_for,
)

__all__ = ["ADC_LAUNCHES", "ADC_SMEM_LAUNCHES", "TOPK_LAUNCHES",
           "TOPK_SMEM_LAUNCHES",
           "L2DIST_Q_LAUNCHES",
           "L2DIST_Q_TC_LAUNCHES", "L2TOPK_Q_LAUNCHES",
           "L2TOPK_Q_TC_LAUNCHES", "MAX_K", "l2dist_q_ref", "l2dist_q_cuda",
           "l2dist_q_fma_cuda", "l2dist_q_tc_cuda", "l2topk_q_ref",
           "l2topk_q_cuda", "l2topk_q_fma_cuda", "l2topk_q_tc_cuda",
           "pq_adc_ref", "pq_topk_ref", "pq_adc_cuda", "pq_adc_route",
           "pq_adc_smem_bytes", "pq_adc_smem_cuda", "pq_adc_v1_cuda",
           "pq_topk_cuda",
           "pq_topk_route", "pq_topk_smem_bytes", "pq_topk_smem_cuda",
           "pq_topk_splits", "pq_topk_v1_cuda", "takes_tensor_cores",
           "takes_tensor_cores_dist"]

# launches of each CUDA kernel since import (or since a caller reset them)
ADC_LAUNCHES = 0                  # csrc/qdist.cu's pq_adc
ADC_SMEM_LAUNCHES = 0             # csrc/pq_adc_smem.cu
TOPK_LAUNCHES = 0                 # csrc/qdist.cu's pq_topk
TOPK_SMEM_LAUNCHES = 0            # csrc/pq_topk_smem.cu
L2DIST_Q_LAUNCHES = 0             # csrc/l2dist.cu over code rows
L2DIST_Q_TC_LAUNCHES = 0          # csrc/l2dist_q_tc.cu
L2TOPK_Q_LAUNCHES = 0             # csrc/l2topk.cu over code rows
L2TOPK_Q_TC_LAUNCHES = 0          # csrc/l2topk_q_tc.cu

# row types of the 8-bit scans
_CODE_DTYPES = (torch.uint8, torch.int8)

# shape limits of csrc/qdist.cu: k per query, splits of the rows, and
# subspaces (M * 1 KB of table per query must fit in shared memory)
MAX_K, MAX_SPLITS, MAX_M = 64, 32, 128
_THREADS = 256
# CTAs that fill the card: a few per SM of the H100's 132
_ADC_CTAS, _TOPK_CTAS = 8 * 132, 4 * 132

# csrc/pq_topk_smem.cu and csrc/pq_adc_smem.cu: the subspace counts they
# are compiled for (128 / M queries a CTA, 128 KB of tables), their warps
# and rows a bulk copy, and the dynamic shared memory a CTA may take on
# the H100
SMEM_M = (16, 32, 64)
_SMEM_WARPS, _SMEM_TILE_ROWS = 16, 32
SMEM_BUDGET = 232_448


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def l2dist_q_ref(queries, xs, xsq=None, *, out_scale: float = 1.0):
    """Code-space distance matrix [Bq, Bx]: max(squared L2, 0) * out_scale."""
    return distance_matrix_ref(queries, xs, xsq, out_scale=out_scale)


def l2topk_q_ref(queries, xs, xsq=None, *, k: int = 10,
                 out_scale: float = 1.0):
    """(dists [Bq, k] ascending, ids [Bq, k] int32) over code rows, selected
    in code space, then times out_scale; unfilled slots are (+inf, -1)."""
    return fused_topk_ref(queries, xs, xsq, k=k, out_scale=out_scale)


def pq_adc_ref(luts, codes, xpad=None):
    """ADC matrix [Bq, Bx]: one gather and one add per subspace, in
    subspace order."""
    luts = luts.float()
    idx = codes.long()
    acc = luts.new_zeros((luts.shape[0], codes.shape[0]))
    if xpad is not None:
        acc = acc + xpad.float()[None, :]
    for m in range(luts.shape[1]):
        acc = acc + luts[:, m, :].index_select(1, idx[:, m])
    return acc


def pq_topk_ref(luts, codes, xpad=None, *, k: int = 10):
    """(dists [Bq, k] ascending, ids [Bq, k] int32) of the ADC matrix;
    ties go to the lower row, unfilled slots are (+inf, -1)."""
    d = pq_adc_ref(luts, codes, xpad)
    if d.shape[1] < k:
        d = torch.nn.functional.pad(d, (0, k - d.shape[1]),
                                    value=float("inf"))
    vals, order = torch.sort(d, dim=1, stable=True)
    vals, ids = vals[:, :k], order[:, :k].to(torch.int32)
    fin = vals < float("inf")
    return (torch.where(fin, vals, float("inf")),
            torch.where(fin, ids, torch.full_like(ids, -1)))


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_pq_adc": (ctypes.c_int, [_P] * 4 + [_I] * 7 + [_P]),
    "repro_pq_topk": (ctypes.c_int, [_P] * 7 + [_I] * 8 + [_P]),
    "repro_qdist_error_string": (ctypes.c_char_p, [_I]),
}
_ADC_SMEM_SIGNATURES = {
    "repro_pq_adc_smem": (ctypes.c_int, [_P] * 4 + [_I] * 5 + [_P]),
    "repro_pq_adc_smem_bytes": (ctypes.c_int, [_I]),
    "repro_pq_adc_smem_error_string": (ctypes.c_char_p, [_I]),
}
_SMEM_SIGNATURES = {
    "repro_pq_topk_smem": (ctypes.c_int, [_P] * 7 + [_I] * 7 + [_P]),
    "repro_pq_topk_smem_bytes": (ctypes.c_int, [_I]),
    "repro_pq_topk_smem_error_string": (ctypes.c_char_p, [_I]),
}
_TC_SIGNATURES = {
    "repro_l2topk_q_tc": (ctypes.c_int,
                          [_P] * 8 + [_I] * 7 + [ctypes.c_float, _P]),
    "repro_l2topk_q_tc_error_string": (ctypes.c_char_p, [_I]),
}
_DIST_TC_SIGNATURES = {
    "repro_l2dist_q_tc": (ctypes.c_int,
                          [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P]),
    "repro_l2dist_q_tc_error_string": (ctypes.c_char_p, [_I]),
}
# the integer kernels' widest D: int32 sums of D code products stay exact
# in float32 (below 2^24) up to 256 uint8 columns
TC_MAX_D = 256
# CTAs that fill the card: one per SM of the H100's 132 (800 threads)
_TC_CTAS = 132


def _launch_shape(luts, codes, xpad):
    """Check the operands; returns (Bq, Bx, M, kq, vec, device).

    kq is the number of queries a CTA holds (its tables take kq * M KB of
    shared memory); vec is the code load width in bytes."""
    dev = luts.device
    if dev.type != "cuda":
        raise ValueError(f"the PQ kernels need CUDA tensors, got {dev}")
    if luts.dim() != 3 or luts.shape[2] != 256:
        raise ValueError(f"luts must be [Bq, M, 256], got {tuple(luts.shape)}")
    bq, m, _ = luts.shape
    if codes.dim() != 2 or codes.shape[1] != m:
        raise ValueError(f"codes must be [Bx, {m}], got {tuple(codes.shape)}")
    bx = codes.shape[0]
    if not 0 < m <= MAX_M:
        raise ValueError(f"M={m} subspaces; the kernels take 1..{MAX_M}")
    kq = 4 if m <= 16 else 2 if m <= 32 else 1
    if bx >= 2 ** 31 or -(-bq // kq) > 65535:
        raise ValueError(f"Bq={bq}, Bx={bx} exceed the kernels' grid")
    for name, t, dtype in (("luts", luts, torch.float32),
                           ("codes", codes, torch.uint8)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xpad is not None:
        if (xpad.device != dev or xpad.dtype != torch.float32
                or tuple(xpad.shape) != (bx,) or not xpad.is_contiguous()):
            raise ValueError(f"xpad must be a contiguous float32 [{bx}] "
                             f"tensor on {dev}")
    ptr = codes.data_ptr()
    vec = 16 if m % 16 == 0 and ptr % 16 == 0 else \
        4 if m % 4 == 0 and ptr % 4 == 0 else 1
    return bq, bx, m, kq, vec, dev


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.repro_qdist_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def pq_adc_v1_cuda(luts, codes, xpad=None):
    """Launch `csrc/qdist.cu`'s ADC matrix kernel on the current stream;
    returns d [Bq, Bx] float32. Raises on any other device, dtype, shape
    or layout."""
    bq, bx, m, kq, vec, dev = _launch_shape(luts, codes, xpad)
    out = torch.empty((bq, bx), dtype=torch.float32, device=dev)
    groups = -(-bq // kq)
    grid_x = max(1, min(-(-bx // _THREADS), -(-_ADC_CTAS // max(groups, 1))))
    lib = _build.load("qdist", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_pq_adc(luts.data_ptr(), codes.data_ptr(),
                           None if xpad is None else xpad.data_ptr(),
                           out.data_ptr(), dev.index or 0, bq, bx, m, vec, kq,
                           grid_x, stream)
    _raise_on(lib, err, "pq_adc")
    _build.count_launch(__name__, "ADC_LAUNCHES")
    return out


def pq_adc_smem_bytes(m: int) -> int:
    """Dynamic shared memory of a `csrc/pq_adc_smem.cu` CTA at m
    subspaces, its `Layout<M>` in the same order: 128 / m queries' tables,
    each warp's ring of code and xpad stages (3 stages at m <= 32, else
    2), a mbarrier a stage, and each warp's staged distances, 32 + 32 /
    (128 / m) words a query."""
    kq, stages = 128 // m, 3 if m <= 32 else 2
    ring = _SMEM_WARPS * stages
    return (kq * m * 256 * 4 + ring * _SMEM_TILE_ROWS * m
            + ring * _SMEM_TILE_ROWS * 4 + ring * 8
            + _SMEM_WARPS * kq * (_SMEM_TILE_ROWS + 32 // kq) * 4)


def pq_adc_route(luts, codes, xpad=None) -> bool:
    """Whether `pq_adc_cuda` gives these operands to
    `csrc/pq_adc_smem.cu`: float32 tables [Bq, M, 256] with M in `SMEM_M`
    and a CTA within `SMEM_BUDGET`, uint8 codes [Bx, M] with Bx >= 1, Bq
    within the grid, and 16-byte aligned codes and xpad (TMA bulk copies
    move 16-byte multiples between 16-byte aligned addresses; every copy
    is whole rows of M bytes, M % 16 == 0). The output needs nothing more:
    the wrapper allocates it, and its row segments are plain coalesced
    stores. Reads shapes, dtypes and addresses only, never values."""
    if luts.dim() != 3 or codes.dim() != 2:
        return False
    bq, m = luts.shape[0], luts.shape[1]
    return (m in SMEM_M and pq_adc_smem_bytes(m) <= SMEM_BUDGET
            and luts.dtype == torch.float32 and codes.dtype == torch.uint8
            and 0 < codes.shape[0] < 2 ** 31
            and -(-bq // (128 // m)) <= 65535
            and codes.data_ptr() % 16 == 0
            and (xpad is None or xpad.data_ptr() % 16 == 0))


def pq_adc_smem_cuda(luts, codes, xpad=None):
    """Launch `csrc/pq_adc_smem.cu` on the current stream; returns d [Bq,
    Bx] float32. Raises on operands `pq_adc_route` refuses, as
    `pq_adc_v1_cuda` does, and if the launch fails."""
    bq, bx, m, _, _, dev = _launch_shape(luts, codes, xpad)
    if not pq_adc_route(luts, codes, xpad):
        raise ValueError(f"pq_adc: the shared-memory kernel takes M in "
                         f"{SMEM_M}, Bx >= 1 and 16-byte aligned codes and "
                         f"xpad; got M={m}, Bx={bx}")
    out = torch.empty((bq, bx), dtype=torch.float32, device=dev)
    # one CTA an SM: S CTAs along the rows of each of the query groups,
    # near the H100's 132 SMs and never past a warp's share of the tiles
    groups = -(-bq // (128 // m))
    tiles = -(-bx // _SMEM_TILE_ROWS)
    splits = max(1, min(132 // groups, -(-tiles // _SMEM_WARPS)))
    lib = _build.load("pq_adc_smem", _ADC_SMEM_SIGNATURES)
    err = lib.repro_pq_adc_smem(
        luts.data_ptr(), codes.data_ptr(),
        None if xpad is None else xpad.data_ptr(), out.data_ptr(),
        dev.index or 0, bq, bx, m, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "repro_pq_adc_smem_error_string", err,
             "pq_adc (shared memory)")
    _build.count_launch(__name__, "ADC_SMEM_LAUNCHES")
    return out


def pq_adc_cuda(luts, codes, xpad=None):
    """d [Bq, Bx] float32 from one of the two CUDA kernels, chosen by
    shape and alignment: `pq_adc_smem_cuda` where `pq_adc_route` holds,
    else `pq_adc_v1_cuda`. Raises as they do."""
    if pq_adc_route(luts, codes, xpad):
        return pq_adc_smem_cuda(luts, codes, xpad)
    return pq_adc_v1_cuda(luts, codes, xpad)


def pq_topk_v1_cuda(luts, codes, xpad=None, *, k: int = 10):
    """Launch `csrc/qdist.cu`'s fused ADC top-k on the current stream;
    returns (dists [Bq, k] float32, ids [Bq, k] int32). k <= 64; raises on
    any other device, dtype, shape or layout."""
    bq, bx, m, kq, vec, dev = _launch_shape(luts, codes, xpad)
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k}; the kernel takes 1..{MAX_K}")
    groups = -(-bq // kq)
    splits = max(1, min(MAX_SPLITS, -(-_TOPK_CTAS // max(groups, 1)),
                        -(-bx // _THREADS)))
    part_d = torch.empty((bq, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((bq, splits, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    lib = _build.load("qdist", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_pq_topk(luts.data_ptr(), codes.data_ptr(),
                            None if xpad is None else xpad.data_ptr(),
                            part_d.data_ptr(), part_i.data_ptr(),
                            out_d.data_ptr(), out_i.data_ptr(),
                            dev.index or 0, bq, bx, m, vec, kq, k, splits,
                            stream)
    _raise_on(lib, err, "pq_topk")
    _build.count_launch(__name__, "TOPK_LAUNCHES")
    return out_d, out_i


def pq_topk_smem_bytes(m: int) -> int:
    """Dynamic shared memory of a `csrc/pq_topk_smem.cu` CTA at m
    subspaces, its `Layout<M>` in the same order: 128 / m queries' tables,
    each warp's ring of code and xpad stages (3 stages at m <= 32, else
    2), a mbarrier a stage, a list count a (query, warp), a buffer of 32
    (distance, row) candidates a (warp, query) and a 64-entry merge
    scratch a warp."""
    kq, stages = 128 // m, 3 if m <= 32 else 2
    ring = _SMEM_WARPS * stages
    return (kq * m * 256 * 4 + ring * _SMEM_TILE_ROWS * m
            + ring * _SMEM_TILE_ROWS * 4 + ring * 8 + kq * _SMEM_WARPS * 4
            + _SMEM_WARPS * kq * 32 * 8 + _SMEM_WARPS * MAX_K * 8)


def pq_topk_route(luts, codes, xpad=None, k: int = 10) -> bool:
    """Whether `pq_topk_cuda` gives these operands to
    `csrc/pq_topk_smem.cu`: float32 tables [Bq, M, 256] with M in `SMEM_M`
    and a CTA within `SMEM_BUDGET`, uint8 codes [Bx, M] with Bx >= 1,
    1 <= k <= 64, Bq within the grid, and 16-byte aligned codes and xpad
    (TMA bulk copies move 16-byte multiples between 16-byte aligned
    addresses; every copy is whole rows of M bytes, M % 16 == 0). Reads
    shapes, dtypes and addresses only, never values."""
    if luts.dim() != 3 or codes.dim() != 2:
        return False
    bq, m = luts.shape[0], luts.shape[1]
    return (m in SMEM_M and pq_topk_smem_bytes(m) <= SMEM_BUDGET
            and luts.dtype == torch.float32 and codes.dtype == torch.uint8
            and codes.shape[0] > 0 and 0 < k <= MAX_K
            and -(-bq // (128 // m)) <= 65535
            and codes.data_ptr() % 16 == 0
            and (xpad is None or xpad.data_ptr() % 16 == 0))


def pq_topk_splits(bq: int, bx: int, m: int) -> tuple[int, int]:
    """(S, chunk) of `csrc/pq_topk_smem.cu`: one CTA an SM, so S splits of
    `chunk` rows (whole 32-row tiles) make the grid of ceil(Bq / (128 /
    m)) query groups x S come near the H100's 132 SMs without passing
    them, at most `MAX_SPLITS` and no empty split."""
    groups = -(-bq // (128 // m))
    tiles = -(-bx // _SMEM_TILE_ROWS)
    splits = max(1, min(MAX_SPLITS, 132 // groups, tiles))
    chunk = -(-tiles // splits) * _SMEM_TILE_ROWS
    return -(-bx // chunk), chunk


def pq_topk_smem_cuda(luts, codes, xpad=None, *, k: int = 10):
    """Launch `csrc/pq_topk_smem.cu` and its split merge on the current
    stream; returns (dists [Bq, k] float32, ids [Bq, k] int32). Raises on
    operands `pq_topk_route` refuses, as `pq_topk_v1_cuda` does, and if
    the launch fails."""
    bq, bx, m, _, _, dev = _launch_shape(luts, codes, xpad)
    if not pq_topk_route(luts, codes, xpad, k):
        raise ValueError(f"pq_topk: the shared-memory kernel takes M in "
                         f"{SMEM_M}, k <= {MAX_K}, Bx >= 1 and 16-byte "
                         f"aligned codes and xpad; got M={m}, k={k}, Bx={bx}")
    splits, chunk = pq_topk_splits(bq, bx, m)
    part_d = torch.empty((bq, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((bq, splits, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    lib = _build.load("pq_topk_smem", _SMEM_SIGNATURES)
    err = lib.repro_pq_topk_smem(
        luts.data_ptr(), codes.data_ptr(),
        None if xpad is None else xpad.data_ptr(), part_d.data_ptr(),
        part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        dev.index or 0, bq, bx, m, k, splits, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "repro_pq_topk_smem_error_string", err,
             "pq_topk (shared memory)")
    _build.count_launch(__name__, "TOPK_SMEM_LAUNCHES")
    return out_d, out_i


def pq_topk_cuda(luts, codes, xpad=None, *, k: int = 10):
    """(dists [Bq, k] float32, ids [Bq, k] int32) from one of the two CUDA
    kernels, chosen by shape and alignment: `pq_topk_smem_cuda` where
    `pq_topk_route` holds, else `pq_topk_v1_cuda`. Raises as they do."""
    if pq_topk_route(luts, codes, xpad, k):
        return pq_topk_smem_cuda(luts, codes, xpad, k=k)
    return pq_topk_v1_cuda(luts, codes, xpad, k=k)


def takes_tensor_cores(queries, xs) -> bool:
    """Whether `l2topk_q_cuda` gives these operands to the integer
    tensor-core kernel: queries given as codes of the rows' dtype (uint8
    or int8), D a multiple of 16 up to `TC_MAX_D` (TMA's 16-byte row
    pitch), at least one row (a tensor map has no empty dimension) and
    16-byte aligned bases. Code-valued float32 queries and the other
    shapes go to the FP32-FMA kernel."""
    d = xs.shape[-1]
    return (xs.dtype in _CODE_DTYPES and queries.dtype == xs.dtype
            and d % 16 == 0 and d <= TC_MAX_D and xs.shape[0] > 0
            and queries.data_ptr() % 16 == 0 and xs.data_ptr() % 16 == 0)


def takes_tensor_cores_dist(queries, xs) -> bool:
    """Whether `l2dist_q_cuda` gives these operands to the integer
    tensor-core kernel: `takes_tensor_cores`' rule, and Bx a multiple of 4
    (TMA stores the [Bq, Bx] float32 output, whose row pitch must be a
    multiple of 16 bytes). Code-valued float32 queries and the other
    shapes go to the FP32-FMA kernel."""
    return takes_tensor_cores(queries, xs) and xs.shape[0] % 4 == 0


def l2dist_q_fma_cuda(queries, xs, xsq=None, *, out_scale: float = 1.0):
    """Launch `csrc/l2dist.cu` (FP32 FMAs) over uint8 / int8 code rows on
    the current stream; returns d [Bq, Bx] float32. Raises on any other
    device, dtype, shape or layout."""
    out = launch_distance_matrix(queries, xs, xsq, metric="l2",
                                 out_scale=out_scale,
                                 row_dtypes=_CODE_DTYPES, what="l2dist_q")
    _build.count_launch(__name__, "L2DIST_Q_LAUNCHES")
    return out


def l2dist_q_tc_cuda(queries, xs, xsq=None, *, out_scale: float = 1.0):
    """Launch `csrc/l2dist_q_tc.cu` (u8 / s8 wgmma) on the current stream;
    returns d [Bq, Bx] float32. Raises on operands
    `takes_tensor_cores_dist` refuses, as `row_operands` does, and if the
    launch fails."""
    _, _, _, dev = row_operands(queries, xs, xsq, _CODE_DTYPES, "l2dist_q")
    if not takes_tensor_cores_dist(queries, xs) or \
            not queries.is_contiguous():
        raise ValueError(f"l2dist_q: the tensor-core kernel takes contiguous "
                         f"code queries of the rows' dtype, D % 16 == 0, D <= "
                         f"{TC_MAX_D}, Bx % 4 == 0 and 16-byte aligned bases; "
                         f"got {queries.dtype} queries, {xs.dtype} rows "
                         f"{tuple(xs.shape)}")
    (bq, d), bx = queries.shape, xs.shape[0]
    qsq = sqnorms(queries)
    xsq = sqnorms(xs) if xsq is None else xsq
    out = torch.empty((bq, bx), dtype=torch.float32, device=dev)
    lib = _build.load("l2dist_q_tc", _DIST_TC_SIGNATURES)
    err = lib.repro_l2dist_q_tc(
        queries.data_ptr(), xs.data_ptr(), qsq.data_ptr(), xsq.data_ptr(),
        out.data_ptr(), dev.index or 0, bq, bx, d, ROW_DTYPES[xs.dtype],
        as_f32(out_scale), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "repro_l2dist_q_tc_error_string", err,
             "l2dist_q (tensor cores)")
    _build.count_launch(__name__, "L2DIST_Q_TC_LAUNCHES")
    return out


def l2dist_q_cuda(queries, xs, xsq=None, *, out_scale: float = 1.0):
    """d [Bq, Bx] float32 from one of the two CUDA kernels, chosen by
    dtype and shape: `l2dist_q_tc_cuda` where `takes_tensor_cores_dist`
    holds, else `l2dist_q_fma_cuda`. Raises as they do."""
    if takes_tensor_cores_dist(queries, xs):
        return l2dist_q_tc_cuda(queries, xs, xsq, out_scale=out_scale)
    return l2dist_q_fma_cuda(queries, xs, xsq, out_scale=out_scale)


def l2topk_q_fma_cuda(queries, xs, xsq=None, *, k: int = 10,
                      out_scale: float = 1.0):
    """Launch `csrc/l2topk.cu` (FP32 FMAs) over uint8 / int8 code rows on
    the current stream; returns (dists [Bq, k] float32, ids [Bq, k]
    int32). k <= 64; raises on any other device, dtype, shape or
    layout."""
    out = launch_fused_topk(queries, xs, xsq, k=k, out_scale=out_scale,
                            row_dtypes=_CODE_DTYPES, what="l2topk_q")
    _build.count_launch(__name__, "L2TOPK_Q_LAUNCHES")
    return out


def l2topk_q_tc_cuda(queries, xs, xsq=None, *, k: int = 10,
                     out_scale: float = 1.0):
    """Launch `csrc/l2topk_q_tc.cu` (u8 / s8 wgmma) and its split merge on
    the current stream; returns (dists [Bq, k] float32, ids [Bq, k]
    int32). k <= 64; raises on operands `takes_tensor_cores` refuses, as
    `row_operands` does, and if the launch fails."""
    _, _, _, dev = row_operands(queries, xs, xsq, _CODE_DTYPES, "l2topk_q")
    if not takes_tensor_cores(queries, xs) or not queries.is_contiguous():
        raise ValueError(f"l2topk_q: the tensor-core kernel takes contiguous "
                         f"code queries of the rows' dtype, D % 16 == 0, D <= "
                         f"{TC_MAX_D} and 16-byte aligned bases; got "
                         f"{queries.dtype} queries, {xs.dtype} rows "
                         f"{tuple(xs.shape)}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k}; the l2topk_q kernel takes 1..{MAX_K}")
    (bq, d), bx = queries.shape, xs.shape[0]
    qsq = sqnorms(queries)
    xsq = sqnorms(xs) if xsq is None else xsq
    splits = splits_for(bq, bx, k, _TC_CTAS)
    part_d = torch.empty((bq, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((bq, splits, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    lib = _build.load("l2topk_q_tc", _TC_SIGNATURES)
    err = lib.repro_l2topk_q_tc(
        queries.data_ptr(), xs.data_ptr(), qsq.data_ptr(), xsq.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), dev.index or 0, bq, bx, d,
        ROW_DTYPES[xs.dtype], k, splits, as_f32(out_scale),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, "repro_l2topk_q_tc_error_string", err,
             "l2topk_q (tensor cores)")
    _build.count_launch(__name__, "L2TOPK_Q_TC_LAUNCHES")
    return out_d, out_i


def l2topk_q_cuda(queries, xs, xsq=None, *, k: int = 10,
                  out_scale: float = 1.0):
    """(dists [Bq, k] float32, ids [Bq, k] int32) from one of the two CUDA
    kernels, chosen by dtype and shape: `l2topk_q_tc_cuda` where
    `takes_tensor_cores` holds, else `l2topk_q_fma_cuda`. Raises as they
    do."""
    if takes_tensor_cores(queries, xs):
        return l2topk_q_tc_cuda(queries, xs, xsq, k=k, out_scale=out_scale)
    return l2topk_q_fma_cuda(queries, xs, xsq, k=k, out_scale=out_scale)
