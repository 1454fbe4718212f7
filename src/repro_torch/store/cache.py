"""LRU page cache in front of the block file (the SmartSSD DRAM tier).

Every demand access is a hit or a miss; every miss (and every prefetch) is
one `BlockFile.read_block` call — the emulated flash read. The counters are
the repo's stand-in for the paper's "number of vector reads" / P2P-DMA
traffic (Fig. 9):

    hits, misses      demand accesses served from / missing the cache
    prefetch_reads    blocks pulled in by the Prefetcher thread
    prefetch_hits     demand accesses that waited on an in-flight prefetch
                      (counted as hits — the flash read was the prefetch)
    block_reads       misses + prefetch_reads == total flash block transfers
    bytes_read        block_reads * block_size
    evictions         LRU evictions
    peak_bytes        high-water mark of resident cached bytes — the bound
                      the out-of-core guarantee is measured against

Thread safety: one lock around the LRU + counters; `get` waits outside the
lock on in-flight prefetches so the worker can complete them.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from repro_torch.obs.metrics import REGISTRY, next_uid
from repro_torch.store.blockfile import BlockFile

__all__ = ["PageCache"]


def _collect_cache(cache: "PageCache"):
    """Collector samples for the metrics registry (repro_torch.obs): read
    at snapshot time under the cache's own lock — zero hot-path cost. Every
    live cache publishes one labeled series per counter; summing the
    `store_block_reads_total` series over `cache` labels is the paper's
    Fig. 9 P2P-DMA traffic."""
    snap = cache.snapshot()
    labels = {"cache": cache.uid}
    counters = ("hits", "misses", "prefetch_reads", "prefetch_hits",
                "evictions", "block_reads", "bytes_read")
    out = [("counter", f"store_cache_{c}_total" if not c.startswith("b")
            else f"store_{c}_total", labels, snap[c]) for c in counters]
    out.append(("gauge", "store_cache_resident_bytes", labels,
                snap["current_bytes"]))
    out.append(("gauge", "store_cache_peak_bytes", labels,
                snap["peak_bytes"]))
    out.append(("gauge", "store_cache_capacity_bytes", labels,
                cache.capacity_bytes))
    return out


class PageCache:
    def __init__(self, blockfile: BlockFile, capacity_bytes: int):
        if capacity_bytes < blockfile.block_size:
            raise ValueError(
                f"cache capacity {capacity_bytes} is smaller than one block "
                f"({blockfile.block_size}) — cannot hold a single read")
        self.blockfile = blockfile
        self.capacity_bytes = int(capacity_bytes)
        self.block_size = blockfile.block_size
        self.uid = next_uid()
        self._lru: OrderedDict[int, bytes] = OrderedDict()
        self._inflight: dict[int, threading.Event] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.prefetch_reads = 0
        self.prefetch_hits = 0
        self.evictions = 0
        self.current_bytes = 0
        self.peak_bytes = 0
        REGISTRY.register_collector(self, _collect_cache)

    # -- demand path ---------------------------------------------------------

    def get(self, idx: int) -> bytes:
        """Demand read of one block through the cache.

        The miss path claims the block in `_inflight` before reading, so a
        racing prefetch of the same block becomes a no-op — each block
        crosses the flash interface exactly once per residency."""
        while True:
            with self._lock:
                data = self._lru.get(idx)
                if data is not None:
                    self._lru.move_to_end(idx)
                    self.hits += 1
                    return data
                ev = self._inflight.get(idx)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[idx] = ev
                    break                      # we own this read
            # a prefetch (or another reader) owns it: wait, then re-check
            ev.wait()
            with self._lock:
                data = self._lru.get(idx)
                if data is not None:
                    self._lru.move_to_end(idx)
                    self.hits += 1
                    self.prefetch_hits += 1
                    return data
                # evicted before we woke (tiny cache): retry and own it
        try:
            data = self.blockfile.read_block(idx)
            with self._lock:
                self.misses += 1
                self._insert(idx, data)
        finally:
            with self._lock:
                self._inflight.pop(idx, None)
            ev.set()
        return data

    def get_many(self, idxs) -> dict[int, bytes]:
        """Demand-read a set of blocks; deduplicates within the request."""
        return {i: self.get(i) for i in dict.fromkeys(idxs)}

    # -- prefetch path (called from the Prefetcher worker) -------------------

    def prefetch(self, idx: int) -> None:
        """Pull one block into the cache ahead of demand; no-op if resident
        or already in flight."""
        with self._lock:
            if idx in self._lru or idx in self._inflight:
                return
            ev = threading.Event()
            self._inflight[idx] = ev
        try:
            data = self.blockfile.read_block(idx)
            with self._lock:
                self.prefetch_reads += 1
                self._insert(idx, data)
        finally:
            with self._lock:
                self._inflight.pop(idx, None)
            ev.set()

    def prefetch_get(self, idx: int) -> bytes:
        """Worker-side read: returns the block, counting any flash traffic
        as prefetch — never as a demand hit/miss (the chained prefetcher
        decodes neighbor rows without skewing the demand hit rate). Waits
        on in-flight reads like `get` does, preserving once-per-residency."""
        for _ in range(4):               # bounded retries under eviction races
            with self._lock:
                data = self._lru.get(idx)
                if data is not None:
                    return data
                ev = self._inflight.get(idx)
            if ev is not None:
                ev.wait()                # someone else is reading it
                continue
            self.prefetch(idx)           # claims _inflight or no-ops
            with self._lock:
                data = self._lru.get(idx)
                if data is not None:
                    return data
            # inserted and immediately evicted (tiny cache): try again
        with self._lock:                 # pathological thrash: counted read
            self.prefetch_reads += 1
        return self.blockfile.read_block(idx)

    # -- internals / stats ---------------------------------------------------

    def _insert(self, idx: int, data: bytes) -> None:
        # lock held. Evict before inserting so residency never exceeds the
        # configured capacity — the out-of-core memory bound.
        if idx in self._lru:
            return
        while self._lru and self.current_bytes + len(data) > self.capacity_bytes:
            _, old = self._lru.popitem(last=False)
            self.current_bytes -= len(old)
            self.evictions += 1
        self._lru[idx] = data
        self.current_bytes += len(data)
        self.peak_bytes = max(self.peak_bytes, self.current_bytes)

    def resize(self, capacity_bytes: int) -> None:
        """Shrink/grow the capacity in place, evicting LRU blocks down to
        the new bound. The ingest layer re-splits one `cache_bytes` budget
        across segment readers as segments appear, so the TOTAL resident
        cache stays bounded no matter how many segments are live. Clamped
        to one block (a cache that cannot hold a single read is useless)."""
        with self._lock:
            self.capacity_bytes = max(int(capacity_bytes), self.block_size)
            while self._lru and self.current_bytes > self.capacity_bytes:
                _, old = self._lru.popitem(last=False)
                self.current_bytes -= len(old)
                self.evictions += 1

    @property
    def block_reads(self) -> int:
        return self.misses + self.prefetch_reads

    @property
    def bytes_read(self) -> int:
        return self.block_reads * self.block_size

    @property
    def hit_rate(self) -> float:
        demand = self.hits + self.misses
        return self.hits / demand if demand else 0.0

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits, "misses": self.misses,
                "prefetch_reads": self.prefetch_reads,
                "prefetch_hits": self.prefetch_hits,
                "evictions": self.evictions,
                "block_reads": self.block_reads,
                "bytes_read": self.bytes_read,
                "current_bytes": self.current_bytes,
                "peak_bytes": self.peak_bytes,
            }
