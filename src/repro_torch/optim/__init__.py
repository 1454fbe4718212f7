"""repro_torch.optim — AdamW, the vector quantizers of the quantized ANN
path, and the training substrate's gradient compression."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
    global_norm,
)
from repro_torch.optim.compression import (
    CODE_DTYPES,
    PQ_K,
    CompressionConfig,
    PQQuantizer,
    VectorQuantizer,
    build_pq_lut,
    code_dtype,
    compress_grads,
    decompress_grads,
)

__all__ = ["AdamWConfig", "CODE_DTYPES", "CompressionConfig", "PQ_K",
           "PQQuantizer", "VectorQuantizer", "adamw_init", "adamw_update",
           "build_pq_lut", "code_dtype", "compress_grads", "cosine_lr",
           "decompress_grads", "global_norm"]
