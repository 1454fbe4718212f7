"""SearchService: the public entry point over the ported backends.

    spec = IndexSpec(metric="l2", backend="partitioned", num_partitions=4)
    svc = SearchService.build(vectors, spec)            # on the card
    resp = svc.search(SearchRequest(queries, k=10, ef=40, rerank=True))
    svc.save("/ckpt/index")                  # versioned; step auto-advances
    svc2 = SearchService.load("/ckpt/index")   # latest committed version

`build` and `load` run on CUDA unless `device="cpu"` is passed; with no
CUDA device they raise. The on-disk layout is the reference's:

    <path>/index_manifest.json   (format version + IndexSpec)
    <path>/step_<N>/             (checkpoint steps; load opens the latest)

so an index saved by either package loads into the other.
"""

from __future__ import annotations

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

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, vectors, spec: IndexSpec | None = None, *,
              device=None) -> "SearchService":
        """Build an index over raw vectors on `device` (default: the card).
        The metric's data preprocessing (cosine normalization) happens
        here — backends only see metric-prepared vectors."""
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
        spec.quantizer()                              # float32 only for now
        prepared = metric.prepare_data(np.asarray(vectors))
        return cls(spec, backend_cls.build(prepared, spec, device))

    # -- serving ------------------------------------------------------------

    def search(self, request: SearchRequest) -> SearchResponse:
        """One batched request; accepts a raw query array as shorthand.
        Results are tensors on the service's device."""
        if not isinstance(request, SearchRequest):
            request = SearchRequest(queries=request)
        q = request.queries
        if self.metric.normalize_queries:
            if isinstance(q, torch.Tensor):
                q = q.cpu().numpy()
            q = self.metric.prepare_queries(np.asarray(q))
        ids, dists, stats = self.backend.search(
            q, k=request.k, ef=request.ef, rerank=request.rerank,
            with_stats=request.with_stats)
        return SearchResponse(ids=ids, dists=dists, stats=stats)

    # -- persistence --------------------------------------------------------

    def save(self, path: str, step: int | None = None) -> str:
        """Persist a new version. Steps auto-advance (0, 1, 2, ...) so
        repeated saves never clobber a committed version."""
        if step is None:
            prev = latest_step(path)
            step = 0 if prev is None else prev + 1
        out = save_checkpoint(path, step, self.backend.state_tree())
        manifest = {"format_version": FORMAT_VERSION,
                    "spec": self.spec.to_json(),
                    "latest_saved_step": step}
        with open(os.path.join(path, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=1)
        return out

    @classmethod
    def load(cls, path: str, *, device=None) -> "SearchService":
        """Re-open the latest committed version of a saved index on
        `device` (default: the card). Indexes saved before the manifest
        existed (bare step dirs) load as partitioned with default knobs."""
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
                spec, leaves, device))
        with open(manifest_path) as f:
            manifest = json.load(f)
        version = manifest.get("format_version")
        if version in (2, PQ_FORMAT_VERSION):
            kind = "mutable segmented" if version == 2 else "product-quantized"
            raise NotImplementedError(
                f"index at {path!r} is a {kind} index (format_version="
                f"{version}), not yet ported; see ROADMAP.md")
        if version != FORMAT_VERSION:
            raise ValueError(
                f"index at {path!r} has format_version={version}; "
                f"this build reads version {FORMAT_VERSION}")
        spec = IndexSpec.from_json(manifest["spec"])
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint step under {path!r}")
        leaves = read_step_leaves(path, step)
        return cls(spec, get_backend(spec.backend).from_state(
            spec, leaves, device))
