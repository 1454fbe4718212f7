"""The comparison that decides `correct`: every answer a run served,
against the plain reference.

A run hands over its answers in the order served: (pool slice, ids
[B, k], dists [B, k]). Answers to the same slice that are equal byte for
byte are judged once and counted as often as they were served. Numbers
(all "lower is better"; a cell's workload file gives the limit of each
number it compares):

  invalid     : result slots with an id outside [0, n), an id repeated in
                its row, a distance that is not finite, or a distance
                below the slot before it
  dist_err    : the largest |returned distance - the exact distance of
                the returned id| over the valid slots
  miss_share  : 1 - recall@k over every served query; a returned id
                counts as found when its exact distance is at most the
                exact k-th nearest distance (ties at the k-th count)
  id_mismatch : slots whose id differs from the reference's exact top-k,
                the lowest id first among equal distances
"""

from __future__ import annotations

import numpy as np

__all__ = ["NUMBERS", "judge", "verdict"]

NUMBERS = ("invalid", "dist_err", "miss_share", "id_mismatch")


def _distinct(answers):
    """{slice: [[ids, dists, times served], ...]}"""
    groups: dict = {}
    for r, ids, dists in answers:
        seen = groups.setdefault(r, [])
        for g in seen:
            if np.array_equal(g[0], ids) and np.array_equal(g[1], dists):
                g[2] += 1
                break
        else:
            seen.append([ids, dists, 1])
    return groups


def judge(answers, pool, gt_ids, gt_d, exact_dists) -> dict:
    """The numbers above over `answers`.

    pool: [R, B, D] queries; gt_ids / gt_d: [R, B, k] the reference's
    exact top-k and distances; exact_dists(queries [B, D], ids [B, k]) ->
    [B, k] float64 exact distances (NaN where an id names no row)."""
    k = gt_ids.shape[-1]
    invalid = id_mismatch = 0
    found = queries = 0
    dist_err = 0.0
    for r, group in _distinct(answers).items():
        for ids, dists, times in group:
            if ids.shape != gt_ids[r].shape or dists.shape != ids.shape:
                invalid += times * gt_ids[r].size     # a malformed answer
                queries += times * gt_ids[r].shape[0]
                continue
            ids = ids.astype(np.int64)
            d = dists.astype(np.float64)
            ex = exact_dists(pool[r], ids)
            ok = np.isfinite(ex)               # the id names a row
            # the first slot of each distinct valid id (invalid slots
            # never count as repeats)
            key = np.where(ok, ids, -1 - np.arange(k))
            order = np.argsort(key, axis=1, kind="stable")
            s = np.take_along_axis(key, order, 1)
            rep = np.zeros_like(ok)
            rep[:, 1:] = s[:, 1:] == s[:, :-1]
            first = np.ones_like(ok)
            np.put_along_axis(first, order, ~rep, 1)
            unsorted = np.zeros_like(ok)
            unsorted[:, 1:] = d[:, 1:] < d[:, :-1]
            bad = ~ok | ~np.isfinite(d) | unsorted | ~first
            invalid += times * int(bad.sum())
            if ok.any():
                err = np.abs(d[ok] - ex[ok])
                err = np.where(np.isfinite(err), err, np.inf)
                dist_err = max(dist_err, float(err.max()))
            within = ok & (np.where(ok, ex, np.inf) <= gt_d[r][:, k - 1:k])
            hits = np.minimum((within & first).sum(1), k)
            found += times * int(hits.sum())
            queries += times * ids.shape[0]
            id_mismatch += times * int((ids != gt_ids[r]).sum())
    return {"invalid": float(invalid), "dist_err": dist_err,
            "miss_share": 1.0 - found / (k * queries) if queries else 1.0,
            "id_mismatch": float(id_mismatch), "queries": queries}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers a cell
    compares: correct when each is at most its limit."""
    checks = {name: {"value": numbers[name], "limit": float(limit)}
              for name, limit in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
