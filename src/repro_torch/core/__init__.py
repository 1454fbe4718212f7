"""The paper's contribution in PyTorch: two-stage partitioned HNSW search
with the graph database resident on the accelerator."""

from repro_torch.core.hnsw_graph import (
    DeviceDB,
    GraphBuilder,
    HNSWConfig,
    build_hnsw,
    device_db,
    restructure,
)
from repro_torch.core.search import SearchParams, batch_search
from repro_torch.core.partitioned import (
    PartitionedDB,
    build_partitioned_db,
    search_partitioned,
)
from repro_torch.core.bruteforce import bruteforce_topk

__all__ = [
    "HNSWConfig",
    "DeviceDB",
    "GraphBuilder",
    "build_hnsw",
    "restructure",
    "device_db",
    "SearchParams",
    "batch_search",
    "PartitionedDB",
    "build_partitioned_db",
    "search_partitioned",
    "bruteforce_topk",
]
