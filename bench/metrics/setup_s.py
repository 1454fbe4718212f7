"""setup_s: process start to the first timed request: the imports, the
inputs, the index build, the kernels' build or load, the warm-up."""


def read(run):
    return run["setup_s"]
