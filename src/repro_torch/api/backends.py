"""Backend registry: one search contract over the ported engines.

Every backend answers `search(queries, k, ef, rerank, with_stats)` over
metric-prepared queries and exposes `state_tree()` / `from_state()` for
versioned save/load, with the reference's leaf paths, so either package
loads an index the other saved:

  exact       : chunked brute-force scan (the ground truth); ignores ef
  hnsw        : one monolithic graph (partitioned with P=1)
  partitioned : the paper's two-stage engine — P sub-graphs, stage-2 merge,
                optional exact rerank
  partitioned-batched : partitioned with its graphs built on the device,
                a batch of points at a time (the port's alone)
  distributed : partitions sharded over a mesh's `model` slots, queries
                over its `data` slots, with a gather-and-merge stage 2
                (paper Fig. 10/11; `core/distributed.py`)
  csd         : out-of-core over the block store (repro_torch.store) — the
                paper's computational-storage platform

Every backend serves float32, scalar-quantized (uint8 / int8) and
product-quantized (`pq`) rows, as `IndexSpec.dtype` says. Every backend
holds its tensors on one `device` (`cuda` unless the caller asked for the
CPU) but `distributed`, which places them over its mesh's slots and
answers on the first slot's device. `build` / `from_state` take the mesh
as `mesh=` (None: every card, or one CPU slot); the others ignore it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.api.rerank import batched_rerank
from repro_torch.api.types import IndexSpec, QueryStats
from repro_torch.core import batch_build
from repro_torch.core import hnsw_graph as hg
from repro_torch.core.bruteforce import bruteforce_topk
from repro_torch.core.partitioned import (
    PartitionedDB,
    build_partitioned_db,
    quantize_db_vectors,
    search_partitioned,
    search_partitioned_candidates,
)
from repro_torch.core.search import SearchParams
from repro_torch.kernels.ops import l2topk_q, pq_topk
from repro_torch.kernels.qdist import MAX_K
from repro_torch.obs.trace import TRACER
from repro_torch.optim.compression import build_pq_lut

__all__ = ["register_backend", "get_backend", "available_backends",
           "CSDBackend", "DistributedBackend", "ExactBackend",
           "HNSWBackend", "PartitionedBackend", "PartitionedBatchedBackend"]

_BACKENDS: dict[str, type] = {}
# in the reference, not yet in the port
_UNPORTED: tuple = ()


def register_backend(name: str):
    def deco(cls):
        cls.name = name
        _BACKENDS[name] = cls
        return cls
    return deco


def get_backend(name: str) -> type:
    if name in _UNPORTED:
        raise NotImplementedError(
            f"backend {name!r} is not yet ported; see ROADMAP.md")
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(_BACKENDS)}"
        ) from None


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def _device_vectors(vectors: np.ndarray, device):
    """Raw vectors + sqnorms on the device (rerank / exact scoring)."""
    v = torch.as_tensor(np.asarray(vectors, np.float32), device=device)
    return v, (v * v).sum(-1)


# ---------------------------------------------------------------------------
# exact
# ---------------------------------------------------------------------------


# the largest code magnitude of each 8-bit row dtype
_CODE_MAX = {torch.uint8: 255, torch.int8: 128}


def _scan_route(dtype, metric: str, k: int, d: int, device) -> str:
    """The exact backend's scan for rows of `dtype` and width `d` on
    `device`: "l2topk_q" for l2 over 8-bit code rows on a CUDA device with
    1 <= k <= MAX_K and D small enough that every distance is an exact
    float32 integer (2 * D * the largest code^2 below 2^24: D <= 129 for
    uint8), so that the fused kernel answers as the chunk loop does; else
    "chunks". `ops.l2topk_q` picks its kernel by shape (the tensor cores
    where `qdist.takes_tensor_cores` holds, FP32 FMAs else). Reads dtypes,
    shapes, the metric and the device, never a value."""
    top = _CODE_MAX.get(dtype)
    if (torch.device(device).type == "cuda" and top is not None
            and metric == "l2" and 0 < k <= MAX_K
            and 2 * d * top * top < 2 ** 24):
        return "l2topk_q"
    return "chunks"


@register_backend("exact")
class ExactBackend:
    """Exact scan; the ground-truth engine and the Fig. 9 baseline.

    uint8/int8: `raw` is the code table, scanned as is, and the queries
    are codes, as code-valued float32 (`SearchService.search` encodes
    them); distances are rescaled by scale**2. pq: `raw` is the
    float32 rows (build) or the [n, M] code table (checkpoint); the scan
    is the fused ADC top-k over the codes.

    The scan takes one of two routes (`_scan_route`). On a CUDA device,
    an l2 search of 1 <= k <= MAX_K over 8-bit code rows is one fused
    `ops.l2topk_q` launch and its split merge (csrc/l2topk_q_tc.cu at the
    tensor cores' shapes), the uploaded queries cast to codes of the rows'
    dtype on the device. Everything else, and every search on the CPU, is
    the chunk loop `bruteforce_topk`. Both answer bit for bit alike: every
    distance there is an exact float32 integer, and among equal distances
    the lowest id wins.

    A search records the spans `upload` (the queries becoming a device
    tensor; `bytes`) and, but for pq, `scan` (on the device's clock too;
    `route`, `rows` padded, `queries`, `k`, and `chunks` where the chunk
    loop ran)."""

    uses_graph = False
    CHUNK = 512

    def __init__(self, spec: IndexSpec, raw: np.ndarray, device):
        self.spec = spec
        self.device = torch.device(device)
        self.quant = spec.quantizer()
        self.is_pq = spec.dtype == "pq"
        raw = np.asarray(raw)
        if self.is_pq:
            if raw.dtype != np.uint8 or raw.shape[-1] != self.quant.m:
                raw = self.quant.encode(np.asarray(raw, np.float32))
            self.raw = raw
            self.codes = torch.as_tensor(raw, device=self.device)
            self.codebooks = torch.as_tensor(self.quant.codebooks,
                                             device=self.device)
            self.n = raw.shape[0]
            self.vectors = self.sqnorms = None
            return
        if self.quant is None:
            raw = raw.astype(np.float32, copy=False)
        self.raw = raw
        n, d = self.raw.shape
        n_pad = ((n + self.CHUNK - 1) // self.CHUNK) * self.CHUNK
        vp = np.zeros((n_pad, d), self.raw.dtype)
        vp[:n] = self.raw
        rf = self.raw.astype(np.float32)
        sq = np.full(n_pad, np.inf, np.float32)   # +inf == pad marker
        sq[:n] = np.einsum("nd,nd->n", rf, rf)
        self.vectors = torch.as_tensor(vp, device=self.device)
        self.sqnorms = torch.as_tensor(sq, device=self.device)
        self.n = n

    @classmethod
    def build(cls, vectors: np.ndarray, spec: IndexSpec, device, mesh=None):
        return cls(spec, vectors, device)

    def search(self, queries, k: int, ef: int, rerank: bool,
               with_stats: bool):
        route = None if self.is_pq else _scan_route(
            self.vectors.dtype, self.spec.metric, k, self.vectors.shape[1],
            self.device)
        with TRACER.child_span("upload") as span:
            q = torch.as_tensor(queries, dtype=torch.float32,
                                device=self.device)
            span.set(bytes=q.nbytes)
        if self.is_pq:
            dists, ids = pq_topk(build_pq_lut(q, self.codebooks), self.codes,
                                 k=k)
        else:
            rows = self.vectors.shape[0]
            scale = (1.0 if self.quant is None
                     else float(np.float32(self.quant.dist_scale)))
            loop = {"chunks": rows // self.CHUNK} if route == "chunks" else {}
            with TRACER.child_span("scan", device_clock=self.device,
                                   route=route, rows=rows, **loop,
                                   queries=q.shape[0], k=k):
                if route == "chunks":
                    ids, dists = bruteforce_topk(self.vectors, self.sqnorms,
                                                 q, k=k, chunk=self.CHUNK,
                                                 metric=self.spec.metric)
                else:   # codes, so the cast is exact; the kernel's
                    # merge rescales its k winners
                    dists, ids = l2topk_q(q.to(self.vectors.dtype),
                                          self.vectors, self.sqnorms, k=k,
                                          out_scale=scale)
            if route == "chunks" and self.quant is not None:
                dists = dists * scale     # code space -> real space
        stats = None
        if with_stats:
            stats = QueryStats(dist_calcs=torch.full(
                (ids.shape[0],), self.n, dtype=torch.int32,
                device=self.device))
        return ids, dists, stats

    def state_tree(self) -> dict:
        return {"exact": {"raw": self.raw},
                "meta": {"n": np.int32(self.n),
                         "dim": np.int32(self.raw.shape[1])}}

    @classmethod
    def from_state(cls, spec: IndexSpec, leaves: dict, device, mesh=None):
        return cls(spec, leaves["exact/raw"], device)


# ---------------------------------------------------------------------------
# partitioned (and its P=1 alias, hnsw)
# ---------------------------------------------------------------------------


@register_backend("partitioned")
class PartitionedBackend:
    """The paper's engine: P device-resident sub-graphs searched as P*B
    lanes of one traversal, the stage-2 merge, optional exact rerank over
    the P*K intermediates.

    uint8/int8: the DB holds code rows and the queries arrive as codes;
    distances are rescaled by scale**2 after the merge, and rerank
    re-scores over the DEQUANTIZED rows (stage 2 stays float32). pq: the
    DB holds [N_pad, M] code rows searched through per-query LUTs, and
    `raw` is the TRUE float32 rows — re-scoring decoded PQ rows would
    change nothing, since ADC already is the distance to the
    reconstruction."""

    uses_graph = True
    forced_partitions: int | None = None

    def __init__(self, spec: IndexSpec, pdb: PartitionedDB,
                 raw: np.ndarray | None, device, mesh=None):
        self.spec = spec
        self.device = torch.device(device)
        self.quant = spec.quantizer()
        self.is_pq = spec.dtype == "pq"
        self._place(pdb, mesh)
        self.codebooks = (torch.as_tensor(self.quant.codebooks,
                                          device=self.device)
                          if self.is_pq else None)
        self.scalar = self.quant is not None and not self.is_pq
        self.raw = (None if raw is None else np.asarray(raw) if self.scalar
                    else np.asarray(raw, np.float32))
        if self.raw is not None:
            flt = self.quant.decode(self.raw) if self.scalar else self.raw
            self.dev_vectors, self.dev_sqnorms = _device_vectors(
                flt, self.device)
        else:
            self.dev_vectors = self.dev_sqnorms = None

    def _place(self, pdb: PartitionedDB, mesh) -> None:
        self.pdb = pdb._replace(db=hg.device_db(pdb.db, self.device))

    @classmethod
    def build(cls, vectors: np.ndarray, spec: IndexSpec, device, mesh=None,
              build_graphs=None):
        """`vectors` are codes for uint8/int8 (the service encodes them)
        and the original float32 rows for pq: the graphs are built at
        full precision and the code rows swapped in afterwards.
        `build_graphs`: `build_partitioned_db`'s (None: `build_hnsw`)."""
        p = cls.forced_partitions or spec.num_partitions
        pdb = build_partitioned_db(vectors, p, spec.hnsw, build_graphs)
        pdb = quantize_db_vectors(
            pdb, spec.dtype, spec.quantizer() if spec.dtype == "pq" else None)
        return cls(spec, pdb, vectors if spec.keep_vectors else None, device,
                   mesh=mesh)

    def params(self, k: int, ef: int) -> SearchParams:
        return SearchParams(ef=ef, k=k, metric=self.spec.metric,
                            fused_hops=self.spec.fused_hops)

    def stage1(self, q, p: SearchParams, merge: bool):
        """Stage 1 over every partition: merged (ids, dists [B, k]) or the
        unmerged [B, P*k] pool, and the raw per-partition stats."""
        lut = build_pq_lut(q, self.codebooks) if self.is_pq else None
        if merge:
            return search_partitioned(self.pdb, q, p, lut)
        return search_partitioned_candidates(self.pdb, q, p, lut)

    def query_stats(self, st) -> QueryStats:
        return QueryStats(hops=st.hops.sum(0, dtype=torch.int32),
                          dist_calcs=st.dist_calcs.sum(0, dtype=torch.int32))

    def search(self, queries, k: int, ef: int, rerank: bool,
               with_stats: bool):
        p = self.params(k, ef)
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if rerank:
            if self.dev_vectors is None:
                raise ValueError(
                    "rerank=True needs the raw vectors: build the index "
                    "with IndexSpec(keep_vectors=True)")
            cand, _, st = self.stage1(q, p, merge=False)
            rq = self.quant.decode(q) if self.scalar else q
            ids, dists = batched_rerank(self.dev_vectors, self.dev_sqnorms,
                                        rq, cand, k, self.spec.metric)
        else:
            ids, dists, st = self.stage1(q, p, merge=True)
            if self.scalar:               # code space -> real space
                dists = dists * float(np.float32(self.quant.dist_scale))
        stats = self.query_stats(st) if with_stats else None
        return ids, dists, stats

    def state_tree(self) -> dict:
        tree = {"db": {f: t.cpu().numpy()
                       for f, t in self.pdb.db._asdict().items()},
                "meta": {"num_partitions": np.int32(self.pdb.num_partitions),
                         "dim": np.int32(self.pdb.dim)}}
        if self.raw is not None:
            tree["vectors"] = {"raw": self.raw}
        return tree

    @classmethod
    def from_state(cls, spec: IndexSpec, leaves: dict, device, mesh=None):
        """Rebuild from the {leaf-path: np.ndarray} dict of a checkpoint
        step — the port's or the reference's (`read_step_leaves`)."""
        db = hg.DeviceDB(**{k.split("/", 1)[1]: np.asarray(v)
                            for k, v in leaves.items()
                            if k.startswith("db/")})
        pdb = PartitionedDB(db=db,
                            num_partitions=int(leaves["meta/num_partitions"]),
                            dim=int(leaves["meta/dim"]))
        return cls(spec, pdb, leaves.get("vectors/raw"), device, mesh=mesh)


@register_backend("hnsw")
class HNSWBackend(PartitionedBackend):
    """Single monolithic graph — partitioned with exactly one partition."""

    forced_partitions = 1


@register_backend("partitioned-batched")
class PartitionedBatchedBackend(PartitionedBackend):
    """`partitioned` with its graphs built on the index's device, every
    partition at once, batch by batch (`core/batch_build.py`), where
    `partitioned` inserts one point at a time on the host. It searches,
    saves and loads as `partitioned` does. The build is the span `build`
    (`backend`, `rows`, `partitions`), one `insert` under it a batch."""

    @classmethod
    def build(cls, vectors: np.ndarray, spec: IndexSpec, device, mesh=None):
        with TRACER.span("build", backend=cls.name, rows=len(vectors),
                         partitions=spec.num_partitions):
            return super().build(
                vectors, spec, device, mesh=mesh,
                build_graphs=functools.partial(batch_build.build_graphs,
                                               device=device))


# ---------------------------------------------------------------------------
# distributed
# ---------------------------------------------------------------------------


@register_backend("distributed")
class DistributedBackend(PartitionedBackend):
    """Graph parallelism over the mesh `model` axis (paper §6.3): each
    slot searches only its resident block of sub-graphs, the query batch
    splits over the `data` / `pod` slots, and stage 2 gathers the pools
    in slot order and merges them (`core/distributed.py`). Every slot's
    layer 0 runs the fused traversal at `fused_hops`, as partitioned's
    does, so the answers are partitioned's, bit for bit. The search
    callables are cached per (k, ef, merge)."""

    def __init__(self, spec: IndexSpec, pdb: PartitionedDB,
                 raw: np.ndarray | None, device, mesh=None):
        mesh = _check_mesh(pdb.num_partitions, device, mesh)
        self.mesh = mesh
        self._fns: dict = {}
        super().__init__(spec, pdb, raw, mesh.devices.flat[0], mesh=mesh)

    def _place(self, pdb: PartitionedDB, mesh) -> None:
        from repro_torch.core.distributed import shard_db

        self.sdb = shard_db(pdb, mesh)

    @classmethod
    def build(cls, vectors: np.ndarray, spec: IndexSpec, device, mesh=None):
        mesh = _check_mesh(spec.num_partitions, device, mesh)  # pre-build
        return super().build(vectors, spec, device, mesh=mesh)

    def _fn(self, p: SearchParams, merge: bool):
        key = (p.k, p.ef, merge)
        if key not in self._fns:
            from repro_torch.core.distributed import make_distributed_search
            from repro_torch.launch.mesh import dp_axes

            maxM0 = int(next(iter(self.sdb.slots.values()))[1]
                        .l0_nbrs.shape[-1])
            self._fns[key] = make_distributed_search(
                self.mesh, p, maxM0, graph_axes=("model",),
                query_axes=dp_axes(self.mesh), merge=merge)
        return self._fns[key]

    def stage1(self, q, p: SearchParams, merge: bool):
        """(ids, dists, calcs [B, 1]) over the mesh."""
        lut = build_pq_lut(q, self.codebooks) if self.is_pq else None
        return self._fn(p, merge)(self.sdb, q, lut)

    def query_stats(self, calcs) -> QueryStats:
        # the reference's: dist_calcs summed over every slot, no hops
        return QueryStats(dist_calcs=calcs[:, 0])

    def state_tree(self) -> dict:
        tree = {"db": self.sdb.host_db()._asdict(),
                "meta": {"num_partitions": np.int32(self.sdb.num_partitions),
                         "dim": np.int32(self.sdb.dim)}}
        if self.raw is not None:
            tree["vectors"] = {"raw": self.raw}
        return tree


def _check_mesh(num_partitions: int, device, mesh):
    """The mesh a distributed index runs on: `mesh`, or the default one on
    `device`'s kind (every visible card over ("model",), or one CPU
    slot); its slots must be of `device`'s kind and P must divide over
    its `model` axis."""
    from repro_torch.launch.mesh import make_mesh

    device = torch.device(device)
    if mesh is None:
        mesh = (make_mesh((torch.cuda.device_count(),), ("model",))
                if device.type == "cuda"
                else make_mesh((1,), ("model",), devices=("cpu",)))
    kinds = {d.type for d in mesh.devices.flat}
    if kinds != {device.type}:
        raise ValueError(f"the mesh's slots are on {sorted(kinds)}; the "
                         f"index was asked for {device.type!r}")
    n_model = mesh.shape.get("model", 1)
    if num_partitions % n_model != 0:
        raise ValueError(
            f"num_partitions={num_partitions} must divide over the mesh "
            f"model axis ({n_model})")
    return mesh


# ---------------------------------------------------------------------------
# csd — out-of-core over the block store (defined in repro_torch.store.csd,
# which imports this package's types only lazily)
# ---------------------------------------------------------------------------

from repro_torch.store.csd import CSDBackend  # noqa: E402

register_backend("csd")(CSDBackend)
