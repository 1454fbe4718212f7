"""Tombstone set: deleted global ids as a growable packed bitmap.

`delete(ids)` in the mutable index never touches segment data — it only
sets bits here (the same single-bit-per-point trick as the search kernel's
visited list, paper §5.1.1). The bitmap is consulted at result-merge time,
so a deleted id can never surface, and at seal/compaction time, when the
space is actually reclaimed. One bit per assigned global id: 1 GB of
tombstones covers 8G inserts, so the bitmap itself never needs segmenting.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TombstoneSet"]


class TombstoneSet:
    """Packed uint32 bitmap over the global-id space, grown on demand."""

    def __init__(self, words: np.ndarray | None = None):
        self._words = (np.zeros(4, np.uint32) if words is None
                       else np.ascontiguousarray(words, np.uint32).copy())
        self.count = int(np.unpackbits(self._words.view(np.uint8)).sum())

    def _grow(self, max_id: int) -> None:
        need = (max_id >> 5) + 1
        if need > self._words.size:
            grown = np.zeros(max(need, 2 * self._words.size), np.uint32)
            grown[: self._words.size] = self._words
            self._words = grown

    def add(self, ids) -> int:
        """Mark ids deleted; returns how many were newly dead."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size == 0:
            return 0
        if (ids < 0).any():
            raise ValueError("tombstones take non-negative global ids")
        self._grow(int(ids.max()))
        ids = np.unique(ids)
        fresh = ~self.contains(ids)
        w, b = ids >> 5, (ids & 31).astype(np.uint32)
        np.bitwise_or.at(self._words, w[fresh],
                         np.left_shift(np.uint32(1), b[fresh]))
        self.count += int(fresh.sum())
        return int(fresh.sum())

    def discard(self, ids) -> None:
        """Clear bits (compaction: the merged segment no longer holds the
        dead rows, so their ids stop counting toward the live-debt)."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size == 0:
            return
        ids = np.unique(ids[ids < self._words.size * 32])
        dead = self.contains(ids)
        w, b = ids >> 5, (ids & 31).astype(np.uint32)
        np.bitwise_and.at(self._words, w[dead],
                          ~np.left_shift(np.uint32(1), b[dead]))
        self.count -= int(dead.sum())

    def contains(self, ids) -> np.ndarray:
        """Boolean mask over `ids` (any shape); negative ids are False."""
        ids = np.asarray(ids, np.int64)
        safe = np.clip(ids, 0, self._words.size * 32 - 1)
        out = ((self._words[safe >> 5]
                >> (safe & 31).astype(np.uint32)) & np.uint32(1)) > 0
        return out & (ids >= 0) & (ids < self._words.size * 32)

    def copy(self) -> "TombstoneSet":
        return TombstoneSet(self._words)

    # -- persistence ---------------------------------------------------------

    def words(self) -> np.ndarray:
        return self._words.copy()

    @classmethod
    def from_words(cls, words: np.ndarray) -> "TombstoneSet":
        return cls(words)

    def __len__(self) -> int:
        return self.count
