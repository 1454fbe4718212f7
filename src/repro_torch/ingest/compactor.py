"""Compaction: merge live segments + tombstones into one rebuilt segment.

The LSM-style maintenance step of the mutable index. Searches fan out over
every live segment, so cost grows with segment count and with tombstone
debt (dead rows still burn traversal hops and over-fetch slots until they
are reclaimed). `compact()` restores both: it gathers every *surviving*
row (local-order reads through each segment's own backend — page-cache
reads for csd), rebuilds one segment with the spec's full partition count
via `SearchService.build`, and swaps it in.

Because the rebuild goes through the exact same build path as a
from-scratch index, a compacted csd segment is bit-identical to an
in-memory `partitioned` build over the same merged rows — the parity
tests pin that.

Write amplification: one compaction rewrites `survivors * row_bytes`
while ingestion appended `inserted * row_bytes` (the reference's cost
model prices it; its port waits, ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from repro_torch.ingest.segments import Segment, build_segment, segment_vectors
from repro_torch.ingest.tombstones import TombstoneSet

__all__ = ["merge_survivors", "compact_segments", "CompactionResult"]


class CompactionResult:
    """What one compaction did (sizes in rows; bytes derived by callers)."""

    def __init__(self, merged: Segment | None, old_names: list[str],
                 rows_read: int, rows_written: int, rows_reclaimed: int):
        self.merged = merged
        self.old_names = old_names
        self.rows_read = rows_read
        self.rows_written = rows_written
        self.rows_reclaimed = rows_reclaimed


def merge_survivors(segments: list[Segment], tombstones: TombstoneSet
                    ) -> tuple[np.ndarray, np.ndarray, int]:
    """Gather (vectors, gids) of every non-tombstoned row, sorted by gid.

    Returns (vectors [n, D], gids [n], rows_read)."""
    vecs, gids, rows_read = [], [], 0
    for seg in segments:
        rows_read += seg.n
        live = ~tombstones.contains(seg.gid_map)
        if not live.any():
            continue
        v = segment_vectors(seg)
        vecs.append(v[live])
        gids.append(seg.gid_map[live])
    if not vecs:
        return (np.zeros((0, 0), np.float32), np.zeros(0, np.int64),
                rows_read)
    v = np.concatenate(vecs)
    g = np.concatenate(gids)
    order = np.argsort(g, kind="stable")
    return v[order], g[order], rows_read


def compact_segments(spec, segments: list[Segment],
                     tombstones: TombstoneSet, name: str, *, device,
                     storage_path: str | None = None,
                     cache_bytes: int | None = None) -> CompactionResult:
    """Rebuild `segments` minus tombstones into one segment named `name`,
    on `device`.

    Pure build step — the caller owns publication (store segment-manifest
    swap, in-memory list swap, tombstone retirement), so a failed build
    leaves the index untouched."""
    old_names = [s.name for s in segments]
    vectors, gids, rows_read = merge_survivors(segments, tombstones)
    if gids.size == 0:
        return CompactionResult(None, old_names, rows_read, 0, rows_read)
    seg = build_segment(spec, name, vectors, gids, device=device,
                        storage_path=storage_path, cache_bytes=cache_bytes)
    return CompactionResult(seg, old_names, rows_read, int(gids.size),
                            rows_read - int(gids.size))
