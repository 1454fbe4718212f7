"""The bytes of a graph search: the least time the card could take for
the rows a request's distance evaluations read.

Every distance evaluation of the graph search (`QueryStats.dist_calcs`,
the upper layers' and layer 0's) reads one row of the index, its squared
norm and its id: D bytes of an 8-bit row (4 D of a float32 one) and 8
more. The arithmetic is a dot product a row, far below the card's rates,
so the bound is the bytes at the HBM rate, each row read once a
evaluation (`bench/roofline.py`'s `HBM_BW`).
"""

from __future__ import annotations

from bench.roofline import HBM_BW

__all__ = ["ROW_BYTES", "graph_bound_s"]

# bytes of a row's component, by the configuration's dtype
ROW_BYTES = {"uint8": 1, "int8": 1, "float32": 4}


def graph_bound_s(queries: int, calcs_per_query: float, dim: int,
                  dtype: str) -> float:
    """The least time `queries` graph searches of `calcs_per_query`
    distance evaluations each can take: every evaluation's row, squared
    norm (4 bytes) and id (4 bytes) read once at the HBM rate."""
    return queries * calcs_per_query * (dim * ROW_BYTES[dtype] + 8) / HBM_BW
