"""The one host-side rank-merge every fan-out shares (numpy, as the
reference's).

Three layers reduce ragged per-source top-k lists to one global top-k:

  * `repro_torch.ingest` merges memtable + sealed segments (tombstoned
    lanes masked dead first),
  * the cluster router (`repro_torch.cluster`)
    merges per-shard scatter-gather results,
  * both are the host-side mirror of `core.partitioned.merge_topk`, the
    on-device stage-2 reduction (paper §4.1).

The contract that makes the merge *bit-identical* to a single index built
over the union of rows: every source list is already sorted ascending by
distance, sources are concatenated in global partition order, and the
reduction is one stable argsort — so ties resolve exactly as the single
index's partition-major stable sort resolves them. Dead lanes carry
(+inf, -1) and can never displace a live id.
"""

from __future__ import annotations

import numpy as np

__all__ = ["mask_dead_lanes", "rank_merge"]


def mask_dead_lanes(ids, dists, dead):
    """Mask candidate lanes out of a (ids, dists) list: masked lanes become
    (-1, +inf) so the downstream rank-merge can never surface them. Used
    for tombstones (ingest) and for any source whose rows must not win."""
    ids = np.asarray(ids)
    dists = np.asarray(dists)
    return (np.where(dead, ids.dtype.type(-1), ids),
            np.where(dead, np.float32(np.inf), dists.astype(np.float32)))


def rank_merge(ids_list, dists_list, k: int):
    """Merge per-source sorted top-k lists into one global top-k.

    ids_list   : sequence of [B, k_i] id arrays (-1 marks empty lanes)
    dists_list : matching [B, k_i] float32 distances (+inf on empty lanes)
    returns    : (ids [B, k], dists [B, k]) — -1 / +inf padded when fewer
                 than k finite candidates exist.

    The reduction is a stable argsort over the concatenated candidate
    axis — the same tie-break as `core.partitioned.merge_topk`'s flat
    partition-major sort, which is what pins cluster == single-index and
    segment-fan-out == fresh-build bit-identity.
    """
    cat_i = np.concatenate([np.asarray(i) for i in ids_list], axis=1)
    cat_d = np.concatenate([np.asarray(d, np.float32) for d in dists_list],
                           axis=1)
    order = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
    out_i = np.take_along_axis(cat_i, order, axis=1)
    out_d = np.take_along_axis(cat_d, order, axis=1)
    out_i = np.where(np.isfinite(out_d), out_i, -1)
    if out_i.shape[1] < k:                 # fewer candidates than k
        pad = k - out_i.shape[1]
        out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
        out_d = np.pad(out_d, ((0, 0), (0, pad)),
                       constant_values=np.inf)
    return out_i, out_d
