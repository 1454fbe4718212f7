from repro_torch.data.pipeline import (
    Prefetcher, TokenDataset, VectorDataset, batch_to_device,
    clustered_vectors, make_batch, sift_like_vectors,
)

__all__ = ["Prefetcher", "TokenDataset", "VectorDataset", "batch_to_device",
           "clustered_vectors", "make_batch", "sift_like_vectors"]
