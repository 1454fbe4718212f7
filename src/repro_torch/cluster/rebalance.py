"""Cluster construction and elastic growth.

`build_cluster` is the one-call path from a vector table to a serving
cluster: it splits rows with `topology.shard_bounds` (the same linspace
split `build_partitioned_db` applies inside one index), builds each shard
as an independent `SearchService` with `topology.shard_spec` (per-shard
seed offset), clones replicas with the same backend-aware logic
`repro_torch.serve` uses (csd replicas get their own reader + page cache,
like independent nodes would; in-memory replicas spread over the visible
cards, or share the service on one), and hands the shard clients to a
`ClusterRouter`. The two shared choices — row split and seed schedule —
are exactly what makes `router.search` bit-identical to a single index
built over the full table.

`make_shard` is the elastic unit: build one shard over an arbitrary row
set (contiguous range or any ascending gid assignment) so tests and
operators can grow a live cluster with `router.add_shard`.

Both build on the card unless `device="cpu"` is passed, and raise
without CUDA, as `SearchService.build` does.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch import resolve_device
from repro_torch.api.service import SearchService
from repro_torch.cluster.router import ClusterRouter, ShardClient
from repro_torch.cluster.shard import ShardWorker
from repro_torch.cluster.topology import shard_bounds, shard_spec
from repro_torch.optim.compression import PQQuantizer

__all__ = ["build_cluster", "make_shard"]


def make_shard(vectors, spec, *, name: str, gid_map, shard_index: int = 0,
               replicas: int = 1, storage_root: str | None = None,
               device=None) -> ShardClient:
    """Build one shard (primary + replicas) over `vectors`, whose global
    ids are `gid_map` (ascending), on `device`. `shard_index` positions
    the shard in the cluster's seed schedule; csd shards persist under
    `storage_root/<name>`."""
    from repro_torch.serve.dispatch import _clone_service

    device = resolve_device(device)
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    storage_path = None
    if spec.backend == "csd":
        if storage_root is None and spec.storage_path is None:
            raise ValueError(
                "csd shards need a storage directory: pass storage_root "
                "(or set spec.storage_path)")
        storage_path = os.path.join(storage_root or spec.storage_path, name)
    sspec = shard_spec(spec, shard_index, storage_path=storage_path)
    service = SearchService.build(np.ascontiguousarray(vectors), sspec,
                                  device=device)
    gid_map = np.asarray(gid_map, np.int64)
    workers = [ShardWorker(name, service, gid_map, rid=0)]
    for r in range(1, replicas):
        svc, owns = _clone_service(service, r)
        workers.append(ShardWorker(name, svc, gid_map, rid=r,
                                   owns_backend=owns))
    return ShardClient(name, workers)


def build_cluster(vectors, spec, n_shards: int, *, replicas: int = 1,
                  path: str | None = None, slo=None,
                  device=None) -> ClusterRouter:
    """Shard `vectors` N ways and stand up the full serving cluster on
    `device` (default: the card).

    The returned router's results are bit-identical to a single
    `SearchService` built over `vectors` with
    `num_partitions = n_shards * spec.num_partitions`.

    dtype="pq": the codebooks are fit ONCE here, over the union, and ride
    the spec into every shard (SearchService.build reuses pre-fitted
    codebooks instead of fitting per shard) — one code space cluster-wide.
    The deterministic fit makes them bitwise equal to what the equivalent
    single index would fit over the same rows and seed, which is what
    extends the bit-parity contract to PQ.
    """
    device = resolve_device(device)
    vectors = np.ascontiguousarray(np.asarray(vectors, np.float32))
    if getattr(spec, "dtype", "float32") == "pq" \
            and spec.pq_codebooks is None:
        quant = PQQuantizer.fit(vectors, spec.pq_m, seed=spec.hnsw.seed)
        spec = dataclasses.replace(
            spec, pq_codebooks=quant.to_json()["codebooks"])
    bounds = shard_bounds(vectors.shape[0], n_shards)
    storage_root = None
    if spec.backend == "csd":
        storage_root = spec.storage_path or (
            os.path.join(path, "shards") if path is not None else None)
    clients = []
    for i in range(n_shards):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        clients.append(make_shard(
            vectors[lo:hi], spec, name=f"shard-{i:03d}",
            gid_map=np.arange(lo, hi, dtype=np.int64), shard_index=i,
            replicas=replicas, storage_root=storage_root, device=device))
    return ClusterRouter(spec, clients, path=path, slo=slo, device=device)
