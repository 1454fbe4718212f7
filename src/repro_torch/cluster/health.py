"""Shard health: heartbeat probing with timeouts, detection, and revival.

`ShardClient.request` already handles the *reactive* path (a fault during
a query fails over immediately). `HealthMonitor` adds the *proactive*
path: a background loop pings every replica of every shard and flips
health flags from the outcome, so

  * a replica that died while idle is discovered before a query hits it,
  * a replica that recovered (`ShardWorker.revive`) is brought back into
    the dispatch rotation without operator action,
  * a replica whose heartbeat is stale past `timeout_s` is treated as
    down even if its executor still accepts work (hung-node semantics).

`probe_now()` runs one synchronous sweep — tests drive it directly
instead of sleeping on the background thread.
"""

from __future__ import annotations

import threading
import time

from repro_torch.obs.metrics import REGISTRY

__all__ = ["HealthMonitor"]


class HealthMonitor:
    """Periodic health sweep over a `ClusterRouter`'s shards."""

    def __init__(self, router, *, interval_s: float = 1.0,
                 timeout_s: float = 5.0):
        self.router = router
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.sweeps = 0
        router._monitor = self

    def probe_now(self) -> dict:
        """One synchronous sweep: ping every replica, apply heartbeat
        timeouts, return {shard: [replica healthy flags]}."""
        now = time.monotonic()
        states = {}
        down = 0
        for client in self.router.shards:
            flags = client.probe()
            for i, rep in enumerate(client.replicas):
                if flags[i] and now - rep.last_beat > self.timeout_s:
                    client.mark(i, False)      # heartbeat stale: hung node
                    flags[i] = False
            down += flags.count(False)
            states[client.name] = flags
        self.sweeps += 1
        REGISTRY.counter("cluster_health_sweeps_total").inc()
        REGISTRY.gauge("cluster_replicas_down").set(down)
        return states

    def start(self) -> "HealthMonitor":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cluster-health")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.probe_now()
            except Exception:                  # a dying shard must not
                pass                           # take the monitor with it

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
