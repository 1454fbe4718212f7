"""repro_torch.serve — async dynamic-batching query scheduler + replica
dispatch, the port of the reference's `repro.serve`.

The deployment layer (paper Fig. 10-11): clients submit single queries and
get futures; a dynamic batcher packs them into device-sized
`SearchRequest`s; a replica pool spreads batches over N `SearchService`
replicas (independent PageCaches over one block store for the `csd`
backend — the paper's 4-SmartSSD scale-up; on CUDA, each replica on its
own stream, placed round-robin over the visible cards).
"""

from repro_torch.serve.batcher import DynamicBatcher, bucket_size, slice_stats
from repro_torch.serve.dispatch import Replica, ReplicaPool
from repro_torch.serve.queue import (
    PendingQuery,
    QueryResult,
    RequestQueue,
    ServeClosed,
)
from repro_torch.serve.server import SearchServer, ServeStats

__all__ = [
    "DynamicBatcher",
    "bucket_size",
    "slice_stats",
    "Replica",
    "ReplicaPool",
    "PendingQuery",
    "QueryResult",
    "RequestQueue",
    "ServeClosed",
    "SearchServer",
    "ServeStats",
]
