"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

`csrc/` holds the CUDA C++ sources; `_build.py` compiles them with nvcc at
first use; `ops.py` dispatches on the tensors' device."""
