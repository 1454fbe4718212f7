"""repro_torch.api — the search-service surface of the port.

The same request/response API as the reference package over the ported
engines: exact brute force, monolithic HNSW, the paper's partitioned
two-stage engine, its graph-parallel `distributed` form over a mesh of
device slots and its out-of-core `csd` form over a block store, on
float32, scalar-quantized and product-quantized rows, and the mutable
segmented index (`MutableSearchService`, exported lazily).
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


def __getattr__(name):
    """Lazy export of the mutable service (PEP 562), as the reference's:
    `repro_torch.ingest` composes the objects defined above, so an eager
    import here would be a cycle whenever `repro_torch.ingest` is the
    import entry point."""
    if name == "MutableSearchService":
        from repro_torch.ingest.service import MutableSearchService
        return MutableSearchService
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
