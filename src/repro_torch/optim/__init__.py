"""repro_torch.optim — the vector quantizers of the quantized ANN path."""

from repro_torch.optim.compression import (
    CODE_DTYPES,
    PQ_K,
    PQQuantizer,
    VectorQuantizer,
    build_pq_lut,
    code_dtype,
)

__all__ = ["CODE_DTYPES", "PQ_K", "PQQuantizer", "VectorQuantizer",
           "build_pq_lut", "code_dtype"]
