"""The benchmark's frozen copy of the SIFT-like generator equals the
port's byte for byte, and the query pool keeps its sizes on every seed."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import generator  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402

SEEDS = (0, 7, 2**31 + 11, 3_000_000_019)


@pytest.mark.parametrize("n", [1, 17, 2_000, 16_384])
@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_copy_equals_the_port(n, seed):
    a = generator.sift_like_vectors(n, seed)
    b = pipeline.sift_like_vectors(n, seed)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_base_rows_are_the_rounded_rows(seed):
    rows = generator.base_rows(4_096, seed)
    assert rows.dtype == np.uint8 and rows.shape == (4_096, 128)
    want = np.rint(pipeline.sift_like_vectors(4_096, seed))
    assert np.array_equal(rows, want)
    # the uint8 quantizer then fits scale 1: the full range is used
    assert rows.max() == 255


@pytest.mark.parametrize("seed", SEEDS)
def test_query_pool(seed):
    pool = generator.query_pool(4_096, 3, 50, seed)
    again = generator.query_pool(4_096, 3, 50, seed)
    assert pool.shape == (3, 50, 128) and pool.dtype == np.uint8
    assert np.array_equal(pool, again)
    assert not np.array_equal(pool, generator.query_pool(4_096, 3, 50,
                                                         seed + 1))
