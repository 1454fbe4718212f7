"""Async next-hop prefetcher (paper §5.2: overlap flash reads with compute).

While the device evaluates hop t, the worker thread pulls the blocks hop
t+1 will touch: the layer-0 neighbor-list rows of the next candidates, and
— chained — the vector blocks of the neighbors those rows name. Blocks land
in the shared PageCache; the demand path then hits (or waits on the
in-flight read instead of issuing a second one), so every block still
crosses the "flash" interface exactly once per residency.

Best-effort by design: a failed or late prefetch degrades to a demand miss,
never to a wrong result.
"""

from __future__ import annotations

import queue
import threading

from repro_torch.store.cache import PageCache

__all__ = ["Prefetcher"]

_STOP = object()


class Prefetcher:
    def __init__(self, cache: PageCache):
        self.cache = cache
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is _STOP:
                return
            try:
                task()
            except Exception:
                pass  # best-effort: the demand path re-reads on miss

    def submit(self, fn) -> None:
        """Queue an arbitrary prefetch task (used for chained next-hop
        fetches that must parse a neighbor row before knowing its blocks)."""
        self._q.put(fn)

    def prefetch_blocks(self, idxs) -> None:
        cache = self.cache
        blocks = list(dict.fromkeys(idxs))

        def task():
            for i in blocks:
                cache.prefetch(i)

        self._q.put(task)

    def drain(self) -> None:
        """Block until every queued task has run (tests / deterministic
        accounting)."""
        done = threading.Event()
        self._q.put(done.set)
        done.wait()

    def close(self) -> None:
        self._q.put(_STOP)
        self._thread.join(timeout=5)
