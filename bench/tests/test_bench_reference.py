"""The plain reference's exact top-k against a numpy brute force, ties
included, and the comparison's numbers on answers with known faults."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from bench import compare  # noqa: E402
from bench.reference import exact  # noqa: E402


def _numpy_topk(base, queries, k):
    d = ((queries[:, None, :].astype(np.int64)
          - base[None, :, :].astype(np.int64)) ** 2).sum(-1)
    ids = np.lexsort((np.broadcast_to(np.arange(len(base)), d.shape), d),
                     axis=1)[:, :k]
    return ids, np.take_along_axis(d, ids, 1)


def _tied_rows(seed, n=700, dim=16):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, (n, dim)).astype(np.uint8)   # many ties
    base[n // 2:n // 2 + 40] = base[:40]                   # exact duplicates
    queries = rng.integers(0, 4, (37, dim)).astype(np.uint8)
    return base, queries


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("x_block", [64, 65536])
def test_exact_topk_equals_numpy_with_ties(seed, x_block):
    base, queries = _tied_rows(seed)
    want_i, want_d = _numpy_topk(base, queries, 10)
    ids, d = exact.exact_topk(base, queries, 10, "cpu", q_block=16,
                              x_block=x_block)
    assert np.array_equal(ids, want_i)
    assert np.array_equal(d, want_d)


def test_exact_dists_marks_missing_ids():
    base, queries = _tied_rows(3)
    ids = np.array([[0, 5, -1], [len(base), 2, 3]] * 18 + [[1, 2, 3]])
    d = exact.exact_dists(base, queries, ids, "cpu", q_block=5)
    full = ((queries[:, None].astype(np.int64)
             - base[None].astype(np.int64)) ** 2).sum(-1)
    ok = (ids >= 0) & (ids < len(base))
    assert np.isnan(d[~ok]).all()
    assert np.array_equal(d[ok], np.take_along_axis(
        full, np.where(ok, ids, 0), 1)[ok])


def test_quantized_topk_is_the_topk_of_the_codes():
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (300, 8)).astype(np.uint8)
    queries = rng.integers(0, 256, (9, 8)).astype(np.uint8)
    ids, d = exact.quantized_topk(base, queries, 5, "cpu", bits=4)
    codes = lambda a: np.rint(a / 17.0).astype(np.int64)  # noqa: E731
    want_i, want_d = _numpy_topk(codes(base), codes(queries), 5)
    assert np.array_equal(ids, want_i)
    assert np.allclose(d, want_d * 289.0)


def _judge(answers, base, pool, k=10):
    flat = pool.reshape(-1, pool.shape[-1])
    gi, gd = exact.exact_topk(base, flat, k, "cpu")
    shape = (pool.shape[0], pool.shape[1], k)
    return compare.judge(answers, pool, gi.reshape(shape), gd.reshape(shape),
                         lambda q, i: exact.exact_dists(base, q, i, "cpu"))


def test_judge_counts_each_fault():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (500, 16)).astype(np.uint8)
    pool = rng.integers(0, 256, (2, 20, 16)).astype(np.uint8)
    right = []
    for r in range(2):
        i, d = exact.exact_topk(base, pool[r], 10, "cpu")
        right.append((r, i.astype(np.int32), d.astype(np.float32)))
    n = _judge(right * 3, base, pool)
    assert n["queries"] == 120
    assert (n["invalid"], n["dist_err"], n["miss_share"],
            n["id_mismatch"]) == (0, 0, 0, 0)
    r, i, d = right[0]
    wrong_d = d.copy()
    wrong_d[3, 9] += 1
    assert _judge([(r, i, wrong_d)], base, pool)["dist_err"] == 1
    dup = i.copy()
    dup[0, 9] = dup[0, 0]
    n = _judge([(r, dup, d)], base, pool)
    assert n["invalid"] >= 1 and n["id_mismatch"] == 1
    assert n["miss_share"] == pytest.approx(1 / 200)
    missing = i.copy()
    missing[:, 5:] = -1
    n = _judge([(r, missing, d)], base, pool)
    assert n["invalid"] == 100 and n["miss_share"] == 0.5


def test_verdict():
    ok, checks = compare.verdict({"invalid": 0.0, "miss_share": 0.01},
                                 {"invalid": 0, "miss_share": 0.02})
    assert ok and checks["miss_share"] == {"value": 0.01, "limit": 0.02}
    ok, _ = compare.verdict({"invalid": 1.0}, {"invalid": 0})
    assert not ok
