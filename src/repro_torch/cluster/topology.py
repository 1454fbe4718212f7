"""Cluster topology: the shard layout and the atomically-swapped manifest.

One logical index spans N shards; each shard owns a contiguous row range
(the SAME `linspace` split `core.partitioned.build_partitioned_db` uses,
which is what makes a cluster of per-shard builds bit-identical to one
index built over the union — see `rebalance.build_cluster`) and runs R
replicas. The layout is described by a `ClusterTopology` and, when the
cluster is given a directory, published as `cluster.json` with the same
commit-then-swap discipline as the block store's `segments.json`:

    <dir>/cluster.json          {"format": ..., "version": N,
                                 "shards": [{"name", "replicas", "rows"}]}

Every elastic change (add/remove shard, add/remove replica) writes a full
tmp manifest, fsyncs, and renames — a crash at any point leaves either the
old or the new manifest, never a torn one, and the version number makes
stale manifests refuse to regress.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.api.types import IndexSpec
from repro_torch.core.hnsw_graph import HNSWConfig

__all__ = ["CLUSTER_MANIFEST", "CLUSTER_FORMAT", "ShardInfo",
           "ClusterTopology", "shard_bounds", "shard_spec",
           "read_topology", "write_topology"]

CLUSTER_MANIFEST = "cluster.json"
CLUSTER_FORMAT = "repro-cluster-v1"


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """One shard's manifest entry."""

    name: str
    replicas: int = 1
    rows: int = 0                  # live row count (skew reporting)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ShardInfo":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class ClusterTopology:
    """The live shard set plus a monotonically-advancing version."""

    shards: tuple = ()
    version: int = 0

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def to_json(self) -> dict:
        return {"format": CLUSTER_FORMAT, "version": self.version,
                "shards": [s.to_json() for s in self.shards]}

    @classmethod
    def from_json(cls, d: dict) -> "ClusterTopology":
        if d.get("format") != CLUSTER_FORMAT:
            raise ValueError(
                f"cluster manifest has format {d.get('format')!r}; this "
                f"build reads {CLUSTER_FORMAT!r}")
        return cls(shards=tuple(ShardInfo.from_json(s)
                                for s in d.get("shards", [])),
                   version=int(d.get("version", 0)))


def shard_bounds(n: int, n_shards: int) -> np.ndarray:
    """Row boundaries of an N-way shard split — identical to the partition
    split inside `build_partitioned_db`, so shard i's rows are exactly the
    rows partition i of a single N-partition index would hold."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return np.linspace(0, n, n_shards + 1).astype(np.int64)


def shard_spec(spec: IndexSpec, shard_index: int, *,
               storage_path: str | None = None) -> IndexSpec:
    """The per-shard IndexSpec derived from the cluster's base spec.

    `spec.num_partitions` is interpreted as partitions PER SHARD; the HNSW
    seed advances by `shard_index * num_partitions` so shard i's local
    partitions get the same construction seeds as global partitions
    [i*q, (i+1)*q) of the equivalent single index — the second half of the
    bit-parity contract (row split being the first).
    """
    hnsw = HNSWConfig(**{**spec.hnsw.__dict__,
                         "seed": spec.hnsw.seed
                         + shard_index * spec.num_partitions})
    kw = dict(hnsw=hnsw)
    if storage_path is not None:
        kw["storage_path"] = storage_path
    return dataclasses.replace(spec, **kw)


def read_topology(path: str) -> ClusterTopology:
    """The committed topology under `path` (empty when none published)."""
    mf = os.path.join(path, CLUSTER_MANIFEST)
    if not os.path.exists(mf):
        return ClusterTopology()
    with open(mf) as f:
        return ClusterTopology.from_json(json.load(f))


def write_topology(path: str, topo: ClusterTopology) -> ClusterTopology:
    """Atomic manifest swap (full tmp write + fsync + rename). Refuses to
    regress: the incoming version must advance past the committed one."""
    committed = read_topology(path)
    if topo.version <= committed.version and committed.shards:
        raise ValueError(
            f"stale topology: version {topo.version} does not advance "
            f"past committed version {committed.version}")
    os.makedirs(path, exist_ok=True)
    mf = os.path.join(path, CLUSTER_MANIFEST)
    tmp = mf + ".tmp"
    with open(tmp, "w") as f:
        json.dump(topo.to_json(), f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, mf)
    return topo
