"""The benchmark of the PyTorch port (`repro_torch`): one command runs one
cell once (`python3 bench/run.py --help`). Nothing here imports JAX or
the JAX package."""
