"""repro_torch.api — the search-service surface of the port.

The same request/response API as the reference package over the ported
engines: exact brute force, monolithic HNSW, the paper's partitioned
two-stage engine and its out-of-core `csd` form over a block store, on
float32, scalar-quantized and product-quantized rows.
"""

from repro_torch.api.backends import (
    available_backends,
    get_backend,
    register_backend,
)
from repro_torch.api.metrics import (
    Metric,
    available_metrics,
    exact_topk_np,
    get_metric,
    register_metric,
)
from repro_torch.api.rerank import batched_rerank
from repro_torch.api.service import SearchService, read_step_leaves
from repro_torch.api.types import (
    FORMAT_VERSION,
    IndexSpec,
    QueryStats,
    SearchRequest,
    SearchResponse,
)

__all__ = [
    "FORMAT_VERSION",
    "IndexSpec",
    "SearchRequest",
    "SearchResponse",
    "QueryStats",
    "SearchService",
    "read_step_leaves",
    "Metric",
    "register_metric",
    "get_metric",
    "available_metrics",
    "exact_topk_np",
    "register_backend",
    "get_backend",
    "available_backends",
    "batched_rerank",
]
