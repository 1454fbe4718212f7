"""repro_torch.cluster — one logical index sharded across N workers.

The port of the reference's `repro.cluster`: shard workers behind a
wire-serializable transport boundary (the reference's codec, byte for
byte, so either package's router talks to either package's workers), a
scatter-gather router whose merged results are bit-identical to a single
index over the union of rows, replica failover, heartbeat health checks,
and elastic topology changes published through an atomically-swapped
`cluster.json` (the reference's format). Shards build on the card unless
`device="cpu"` is passed. See `src/repro/cluster/README.md` for the
dataflow.
"""

from repro_torch.cluster.health import HealthMonitor
from repro_torch.cluster.rebalance import build_cluster, make_shard
from repro_torch.cluster.router import (ClusterRouter, ClusterStats,
                                        ShardClient)
from repro_torch.cluster.shard import (ShardFault, ShardWorker, from_wire,
                                       to_wire)
from repro_torch.cluster.topology import (CLUSTER_FORMAT, CLUSTER_MANIFEST,
                                          ClusterTopology, ShardInfo,
                                          read_topology, shard_bounds,
                                          shard_spec, write_topology)

__all__ = [
    "HealthMonitor", "build_cluster", "make_shard", "ClusterRouter",
    "ClusterStats", "ShardClient", "ShardFault", "ShardWorker",
    "from_wire", "to_wire", "CLUSTER_FORMAT", "CLUSTER_MANIFEST",
    "ClusterTopology", "ShardInfo", "read_topology", "shard_bounds",
    "shard_spec", "write_topology",
]
