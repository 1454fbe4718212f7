"""Shared latency/percentile summaries.

This is the one home for the percentile math that used to be duplicated
(differently) in `serve/server.py` (`_pct`) and `cluster/shard.py`
(inline `np.percentile` with its own empty-guard). Both now call
`latency_summary`; the empty-input edge case — `np.percentile` raising on
a zero-length array — is fixed exactly once, here, by returning zeros.

The p50/p99/mean values are bit-identical to the old call sites'
formulas (pinned in tests/test_obs.py); p999 and count are additions the
paper-style load reports (p50/p99/p999 under load, ROADMAP item 5) need.
"""

from __future__ import annotations

import numpy as np

__all__ = ["latency_summary"]


def latency_summary(xs) -> dict:
    """Summary of a latency sample: {"p50", "p99", "p999", "mean", "count"}.

    Accepts any array-like (list, deque, ndarray); an empty sample returns
    all-zero fields instead of raising (the once-duplicated edge case)."""
    a = np.asarray(tuple(xs) if not isinstance(xs, np.ndarray) else xs,
                   np.float64).ravel()
    if a.size == 0:
        return {"p50": 0.0, "p99": 0.0, "p999": 0.0, "mean": 0.0, "count": 0}
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "p999": float(np.percentile(a, 99.9)),
            "mean": float(a.mean()),
            "count": int(a.size)}
