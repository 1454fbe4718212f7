"""SearchService: the public entry point over the ported backends.

    spec = IndexSpec(metric="l2", backend="partitioned", num_partitions=4)
    svc = SearchService.build(vectors, spec)            # on the card
    resp = svc.search(SearchRequest(queries, k=10, ef=40, rerank=True))
    svc.save("/ckpt/index")                  # versioned; step auto-advances
    svc2 = SearchService.load("/ckpt/index")   # latest committed version

`build` and `load` run on CUDA unless `device="cpu"` is passed; with no
CUDA device they raise. `mesh=` (a `launch.mesh.make_mesh` grid of device
slots) places a `distributed` index; its slots must be of the device's
kind. The on-disk layout is the reference's:

    <path>/index_manifest.json   (format version + IndexSpec)
    <path>/step_<N>/             (checkpoint steps; load opens the latest)

so an index saved by either package loads into the other: version 1 for
float32 and scalar-quantized indexes, version 3 for product-quantized
ones (the manifest then carries the codebooks).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api import metrics as _metrics
from repro_torch.api.backends import get_backend
from repro_torch.api.types import (
    FORMAT_VERSION,
    PQ_FORMAT_VERSION,
    IndexSpec,
    SearchRequest,
    SearchResponse,
)
from repro_torch.checkpoint import latest_step, save_checkpoint, step_dir
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER
from repro_torch.optim.compression import PQQuantizer, VectorQuantizer

__all__ = ["SearchService", "MANIFEST_NAME", "read_step_leaves"]

MANIFEST_NAME = "index_manifest.json"


def read_step_leaves(path: str, step: int) -> dict:
    """Flat {leaf-path: np.ndarray} view of one committed checkpoint step."""
    d = step_dir(path, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return {e["path"]: np.load(os.path.join(d, e["file"] + ".npy"))
            for e in manifest["leaves"]}


class SearchService:
    """Build/load once, search many times."""

    def __init__(self, spec: IndexSpec, backend):
        self.spec = spec
        self.backend = backend
        self.device = backend.device
        self.metric = _metrics.get_metric(spec.metric)
        self.quantizer = spec.quantizer()

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, vectors, spec: IndexSpec | None = None, *,
              device=None, mesh=None) -> "SearchService":
        """Build an index over raw vectors on `device` (default: the card).
        The metric's data preprocessing (cosine normalization) happens
        here — backends only see metric-prepared vectors. A quantized spec
        is fitted here and its state written back onto the spec (and so
        into the manifest): uint8/int8 backends then receive codes; pq
        backends receive the float32 rows, and pre-fitted codebooks on
        the spec are reused."""
        device = resolve_device(device)
        spec = spec or IndexSpec()
        metric = _metrics.get_metric(spec.metric)     # validates the name
        backend_cls = get_backend(spec.backend)       # validates the name
        if getattr(backend_cls, "uses_graph", True) and not metric.graph_safe:
            raise ValueError(
                f"metric {spec.metric!r} is not graph-safe: the HNSW graphs "
                f"are built with L2 geometry, so graph search under it is "
                f"unreliable — use backend='exact', or normalize your data "
                f"(then ip == cosine)")
        prepared = metric.prepare_data(np.asarray(vectors))
        if spec.dtype != "float32":
            if spec.metric != "l2":
                raise ValueError(
                    f"dtype={spec.dtype!r} supports metric='l2' only (the "
                    f"paper's metric): code-space squared-L2 is a pure "
                    f"rescaling of real-space squared-L2, which does not "
                    f"hold for {spec.metric!r}")
            if spec.dtype == "pq":
                if spec.pq_codebooks is None:
                    quant = PQQuantizer.fit(prepared, spec.pq_m,
                                            seed=spec.hnsw.seed)
                    spec = dataclasses.replace(
                        spec, pq_codebooks=quant.to_json()["codebooks"])
            else:
                quant = VectorQuantizer.fit(prepared, spec.dtype)
                spec = dataclasses.replace(spec, qscale=quant.scale,
                                           qzero=quant.zero_point)
                prepared = quant.encode(prepared)
        return cls(spec, backend_cls.build(prepared, spec, device,
                                           mesh=mesh))

    # -- serving ------------------------------------------------------------

    def search(self, request: SearchRequest) -> SearchResponse:
        """One batched request; accepts a raw query array as shorthand.
        Results are tensors on the service's device. uint8/int8 queries
        are encoded here, once, so every backend sees the same codes; pq
        queries stay float32 (asymmetric distance). Emits the reference's
        `search` span and its `api_searches_total` / `api_queries_total`
        counters; the span parents on `request.trace` when the calling
        thread has no open span. The query preparation, where there is
        any (normalizing, encoding to codes), is its `encode` child."""
        if not isinstance(request, SearchRequest):
            request = SearchRequest(queries=request)
        # nest under this thread's open span when there is one (a replica's
        # dispatch span); on a cold thread, under the parent the serving
        # layer stamped on the request
        if request.trace is not None and TRACER.current_ctx() is None:
            span = TRACER.span("search", parent=request.trace,
                               backend=self.spec.backend, k=request.k,
                               ef=request.ef)
        else:
            span = TRACER.span("search", backend=self.spec.backend,
                               k=request.k, ef=request.ef)
        with span:
            q = request.queries
            scalar = self.quantizer is not None and self.spec.dtype != "pq"
            if self.metric.normalize_queries or scalar:
                with TRACER.child_span("encode", queries=len(q)):
                    if isinstance(q, torch.Tensor):
                        q = q.cpu().numpy()
                    if self.metric.normalize_queries:
                        q = self.metric.prepare_queries(np.asarray(q))
                    if scalar:
                        q = self.quantizer.encode_f32(np.asarray(q))
            ids, dists, stats = self.backend.search(
                q, k=request.k, ef=request.ef, rerank=request.rerank,
                with_stats=request.with_stats)
        REGISTRY.counter("api_searches_total",
                         backend=self.spec.backend).inc()
        REGISTRY.counter("api_queries_total",
                         backend=self.spec.backend).inc(len(request.queries))
        return SearchResponse(ids=ids, dists=dists, stats=stats)

    # -- persistence --------------------------------------------------------

    def save(self, path: str, step: int | None = None) -> str:
        """Persist a new version. Steps auto-advance (0, 1, 2, ...) so
        repeated saves never clobber a committed version."""
        if step is None:
            prev = latest_step(path)
            step = 0 if prev is None else prev + 1
        out = save_checkpoint(path, step, self.backend.state_tree())
        version = (PQ_FORMAT_VERSION if self.spec.dtype == "pq"
                   else FORMAT_VERSION)
        manifest = {"format_version": version,
                    "spec": self.spec.to_json(),
                    "latest_saved_step": step}
        with open(os.path.join(path, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=1)
        return out

    @classmethod
    def load(cls, path: str, *, device=None,
             mesh=None) -> "SearchService":
        """Re-open the latest committed version of a saved index on
        `device` (default: the card): format version 1 or 3. Indexes saved
        before the manifest existed (bare step dirs) load as partitioned
        with default knobs. A mutable (version 2) index is refused with a
        pointer to `MutableSearchService.load`."""
        device = resolve_device(device)
        manifest_path = os.path.join(path, MANIFEST_NAME)
        step = latest_step(path)
        if not os.path.exists(manifest_path):
            if step is None:
                raise FileNotFoundError(
                    f"no index manifest or committed checkpoint "
                    f"under {path!r}")
            leaves = read_step_leaves(path, step)
            spec = IndexSpec(backend="partitioned",
                             num_partitions=int(leaves["meta/num_partitions"]))
            return cls(spec, get_backend(spec.backend).from_state(
                spec, leaves, device, mesh=mesh))
        with open(manifest_path) as f:
            manifest = json.load(f)
        version = manifest.get("format_version")
        if version not in (FORMAT_VERSION, PQ_FORMAT_VERSION):
            hint = (" (a mutable segmented index — open it with "
                    "repro_torch.api.MutableSearchService.load)"
                    if version == 2 else "")
            raise ValueError(
                f"index at {path!r} has format_version={version}; "
                f"this build reads versions {FORMAT_VERSION} and "
                f"{PQ_FORMAT_VERSION}{hint}")
        spec = IndexSpec.from_json(manifest["spec"])
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint step under {path!r}")
        leaves = read_step_leaves(path, step)
        return cls(spec, get_backend(spec.backend).from_state(
            spec, leaves, device, mesh=mesh))
