"""Vector quantizers of the ANN path: scalar uint8/int8 codes and PQ.

The port's copy of the reference's quantizers (`optim/compression.py`).
Fitting and encoding are numpy, line for line the reference's, so the
same data and seed give byte-identical codes and codebooks in both
packages; an index built by either one carries the same quantizer state
in its manifest (`IndexSpec.qscale`/`qzero`, `IndexSpec.pq_codebooks`).

* `VectorQuantizer` — one scale and one zero-point for the whole dataset;
  codes are `clip(round(x/scale) + zero_point)`. Squared L2 over codes
  times `scale**2` is real-space squared L2 up to rounding (the zero-point
  cancels), so the traversal runs in code space and the caller rescales.
* `PQQuantizer` — d dims -> m uint8 codes, one per subspace of d/m dims,
  each snapped to the nearest of 256 k-means centroids. Distances are
  asymmetric (ADC): the query stays float32 and a per-query [m, 256]
  table (`build_pq_lut`) is gathered by the codes and summed.

* `compress_grads` / `decompress_grads` — the training substrate's
  int8 gradient compression: one float32 scale a leaf (max |g| / 127),
  values rounded half to even, and error feedback (what rounding lost is
  returned, to be added to the next step's gradient).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["VectorQuantizer", "PQQuantizer", "CODE_DTYPES", "code_dtype",
           "PQ_K", "build_pq_lut", "CompressionConfig", "compress_grads",
           "decompress_grads"]


# ---------------------------------------------------------------------------
# Scalar quantization (the uint8/int8 path)
# ---------------------------------------------------------------------------

# dtype name -> (lowest code, highest code, numpy dtype)
CODE_DTYPES: dict[str, tuple[int, int, np.dtype]] = {
    "uint8": (0, 255, np.dtype(np.uint8)),
    "int8": (-127, 127, np.dtype(np.int8)),
}


def code_dtype(name: str) -> np.dtype:
    """Numpy dtype of the stored codes for a quantized IndexSpec.dtype."""
    if name == "pq":
        return np.dtype(np.uint8)
    try:
        return CODE_DTYPES[name][2]
    except KeyError:
        raise ValueError(
            f"unknown quantized dtype {name!r}; "
            f"available: {sorted(CODE_DTYPES) + ['pq']}") from None


@dataclasses.dataclass(frozen=True)
class VectorQuantizer:
    """Symmetric scalar quantizer: x ≈ (code - zero_point) * scale.

    `fit` maps the observed range onto the full code range; the zero-point
    is fixed by the dtype and the data's sign (0 for int8 and for
    non-negative uint8 data — integer bytes with max 255 then round-trip
    exactly — 128 for signed data stored as uint8), which keeps
    `dist_scale == scale**2` a pure rescaling of squared L2.

    Round-trip bound inside the representable range:
        |x - decode(encode(x))| <= scale / 2        (per component)
    """

    dtype: str            # "uint8" | "int8"
    scale: float
    zero_point: int

    @classmethod
    def fit(cls, vectors: np.ndarray, dtype: str) -> "VectorQuantizer":
        lo, hi, _ = CODE_DTYPES[dtype]  # validates dtype
        x = np.asarray(vectors, np.float32)
        if dtype == "uint8" and float(x.min(initial=0.0)) >= 0.0:
            zero_point = 0
            scale = float(x.max(initial=0.0)) / hi
        else:
            # symmetric around 0; uint8 parks 0 at code 128
            zero_point = 128 if dtype == "uint8" else 0
            span = min(hi - zero_point, zero_point - lo) or hi
            scale = float(np.abs(x).max(initial=0.0)) / span
        return cls(dtype=dtype, scale=max(scale, 1e-12),
                   zero_point=zero_point)

    @property
    def dist_scale(self) -> float:
        """Multiply a code-space squared-L2 distance by this to get the
        (approximate) real-space squared-L2 distance."""
        return self.scale * self.scale

    def encode(self, x: np.ndarray) -> np.ndarray:
        """float32 -> codes (np.uint8 / np.int8), round-half-even then
        clip: the one encoder every backend funnels through."""
        lo, hi, np_dt = CODE_DTYPES[self.dtype]
        q = np.round(np.asarray(x, np.float32) / self.scale) + self.zero_point
        return np.clip(q, lo, hi).astype(np_dt)

    def encode_f32(self, x: np.ndarray) -> np.ndarray:
        """Codes as float32: the query-side representation the traversal
        consumes."""
        return self.encode(x).astype(np.float32)

    def decode(self, codes):
        """Codes (numpy or torch, any int/float dtype) -> float32 values,
        `(c - zp) * scale` with one rounding, identical wherever run."""
        if isinstance(codes, torch.Tensor):
            return ((codes.float() - float(np.float32(self.zero_point)))
                    * float(np.float32(self.scale)))
        return ((np.asarray(codes).astype(np.float32)
                 - np.float32(self.zero_point)) * np.float32(self.scale))

    def to_json(self) -> dict:
        return {"dtype": self.dtype, "scale": self.scale,
                "zero_point": self.zero_point}

    @classmethod
    def from_json(cls, d: dict) -> "VectorQuantizer":
        return cls(dtype=d["dtype"], scale=float(d["scale"]),
                   zero_point=int(d["zero_point"]))


# ---------------------------------------------------------------------------
# Product quantization (the dtype="pq" path)
# ---------------------------------------------------------------------------

PQ_K = 256  # centroids per subspace; one uint8 code per subspace


def build_pq_lut(queries, codebooks) -> torch.Tensor:
    """Per-query ADC lookup tables: [B, d] x [m, 256, dsub] -> [B, m, 256].

    lut[b, m, c] = ||q_b[sub m] - codebook[m, c]||^2 in float32, computed
    as the reference computes it: the difference, its square, then a sum
    over `dsub`. Every PQ backend takes its tables from here. Tensors stay
    on their device; numpy input becomes a CPU tensor."""
    q = torch.as_tensor(queries).float()
    cb = torch.as_tensor(codebooks).float().to(q.device)
    b = q.shape[0]
    m, _, dsub = cb.shape
    diff = q.reshape(b, m, 1, dsub) - cb[None]
    return (diff * diff).sum(-1)


@dataclasses.dataclass(frozen=True, eq=False)
class PQQuantizer:
    """Product quantizer: d dims -> m uint8 codes (one per subspace).

    A row shrinks from `4*d` bytes (or `d` at uint8) to `m` bytes. The
    query stays float32 and `adc(q, codes) == ||q - decode(codes)||^2`,
    computed as a LUT gather + sum over subspaces. Codebooks ride the
    index manifest (format_version 3) as nested JSON lists; float32 ->
    repr -> float32 round-trips exactly.

    `fit` is deterministic under a pinned seed (an
    `np.random.default_rng(seed)` row sample, Lloyd updates with
    `np.add.at` / `bincount`), and equal to the reference's fit byte for
    byte.
    """

    m: int
    dsub: int
    codebooks: np.ndarray  # [m, 256, dsub] float32

    @classmethod
    def fit(cls, vectors: np.ndarray, m: int, *, iters: int = 10,
            seed: int = 0) -> "PQQuantizer":
        x = np.asarray(vectors, np.float32)
        if x.ndim != 2:
            raise ValueError(f"fit expects [n, d] vectors, got {x.shape}")
        n, d = x.shape
        if m <= 0 or d % m != 0:
            raise ValueError(
                f"pq_m={m} must be a positive divisor of dim={d}")
        dsub = d // m
        rng = np.random.default_rng(seed)
        codebooks = np.empty((m, PQ_K, dsub), np.float32)
        for mi in range(m):
            sub = np.ascontiguousarray(x[:, mi * dsub:(mi + 1) * dsub])
            idx = rng.choice(n, size=PQ_K, replace=n < PQ_K)
            cb = sub[idx].astype(np.float32)
            sub_sq = np.einsum("nd,nd->n", sub, sub)
            for _ in range(iters):
                # n x 256 assignment via the expanded form (argmin is
                # invariant to the q^2 term, kept for numeric sanity)
                d2 = (sub_sq[:, None] - 2.0 * (sub @ cb.T)
                      + np.einsum("kd,kd->k", cb, cb)[None])
                assign = d2.argmin(axis=1)
                counts = np.bincount(assign, minlength=PQ_K)
                sums = np.zeros((PQ_K, dsub), np.float64)
                np.add.at(sums, assign, sub)
                live = counts > 0
                cb[live] = (sums[live] / counts[live, None]).astype(
                    np.float32)
            codebooks[mi] = cb
        return cls(m=m, dsub=dsub, codebooks=codebooks)

    @property
    def dim(self) -> int:
        return self.m * self.dsub

    @property
    def dist_scale(self) -> float:
        """ADC distances are already real-space squared L2 (to the
        reconstruction): no rescale."""
        return 1.0

    def encode(self, x: np.ndarray) -> np.ndarray:
        """float32 [n, d] -> codes [n, m] uint8 (nearest centroid per
        subspace; argmin takes the first minimum)."""
        x = np.asarray(x, np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        if x.shape[-1] != self.dim:
            raise ValueError(
                f"expected dim {self.dim}, got {x.shape[-1]}")
        codes = np.empty((x.shape[0], self.m), np.uint8)
        for mi in range(self.m):
            sub = x[:, mi * self.dsub:(mi + 1) * self.dsub]
            cb = self.codebooks[mi]
            d2 = (np.einsum("nd,nd->n", sub, sub)[:, None]
                  - 2.0 * (sub @ cb.T)
                  + np.einsum("kd,kd->k", cb, cb)[None])
            codes[:, mi] = d2.argmin(axis=1).astype(np.uint8)
        return codes[0] if squeeze else codes

    def decode(self, codes):
        """Codes [..., m] (numpy or torch) -> float32 [..., d]
        reconstructions (centroid concatenation), on the codes' side."""
        if isinstance(codes, torch.Tensor):
            cbs = torch.as_tensor(self.codebooks, device=codes.device)
            idx = codes.long()
            return torch.cat([cbs[mi][idx[..., mi]] for mi in range(self.m)],
                             dim=-1)
        codes = np.asarray(codes)
        parts = [self.codebooks[mi][codes[..., mi].astype(np.int64)]
                 for mi in range(self.m)]
        return np.concatenate(parts, axis=-1).astype(np.float32)

    def lut_np(self, q: np.ndarray) -> np.ndarray:
        """Numpy twin of `build_pq_lut` for ONE query: [d] -> [m, 256].
        For prediction only: its sums may differ from `build_pq_lut` in
        the last ulp, so no reported distance comes from it."""
        q = np.asarray(q, np.float32).reshape(self.m, 1, self.dsub)
        diff = q - self.codebooks
        return np.sum(diff * diff, axis=-1, dtype=np.float32)

    def to_json(self) -> dict:
        return {"m": self.m, "dsub": self.dsub,
                "codebooks": self.codebooks.astype(np.float32).tolist()}

    @classmethod
    def from_json(cls, d: dict) -> "PQQuantizer":
        cb = np.asarray(d["codebooks"], np.float32)
        return cls(m=int(d["m"]), dsub=int(d["dsub"]), codebooks=cb)


# ---------------------------------------------------------------------------
# Gradient compression (training substrate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    bits: int = 8


def _q(x, err):
    x = x.float() + (err if err is not None else 0.0)
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale, x - q.float() * scale


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def compress_grads(grads, err_state=None):
    """(int8 values, float32 scales, new error state), each a tree (nested
    dicts) shaped as `grads`; `err_state` (the previous call's error
    state, or None) is added to the gradients first."""
    if err_state is None:
        err_state = _tree_map(lambda g: None, grads)
    triples = _tree_map(_q, grads, err_state)
    pick = lambda i: _tree_map(lambda t: t[i], triples)  # noqa: E731
    return pick(0), pick(1), pick(2)


def decompress_grads(q_grads, scales, denom: float = 1.0):
    """float32 gradients q * scale / denom."""
    return _tree_map(lambda q, s: q.float() * s / denom, q_grads, scales)
