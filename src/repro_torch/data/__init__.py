from repro_torch.data.pipeline import (
    VectorDataset, clustered_vectors, sift_like_vectors,
)

__all__ = ["VectorDataset", "clustered_vectors", "sift_like_vectors"]
