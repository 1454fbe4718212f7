"""Exporters: Prometheus text exposition, JSON snapshots, periodic files.

    from repro_torch.obs import REGISTRY, export
    print(export.to_prometheus(REGISTRY.snapshot()))   # scrape format
    export.write_snapshot("metrics.json")              # one-shot file
    with export.PeriodicExporter("metrics.prom", interval_s=5.0):
        serve_forever()                                # file refreshes

The periodic emitter is the scrape story for a process with no HTTP
server: it rewrites the target file atomically (tmp + rename) every
interval, so node-exporter-style textfile collectors (or a `watch cat`)
always see a complete exposition. Format follows the extension: `.json`
emits the structured snapshot, anything else Prometheus text. When a
tracer is attached (`trace_path`), the Chrome/Perfetto trace JSON is
re-emitted on the same cadence.
"""

from __future__ import annotations

import json
import os
import threading
import time

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry

__all__ = ["to_prometheus", "to_json", "write_snapshot", "PeriodicExporter"]


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _labels(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _num(v) -> str:
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_prometheus(snapshot: dict) -> str:
    """Registry snapshot -> Prometheus text exposition format v0.0.4."""
    lines: list[str] = []
    typed: set[str] = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for s in snapshot.get("counters", []):
        _type(s["name"], "counter")
        lines.append(f"{s['name']}{_labels(s['labels'])} {_num(s['value'])}")
    for s in snapshot.get("gauges", []):
        _type(s["name"], "gauge")
        lines.append(f"{s['name']}{_labels(s['labels'])} {_num(s['value'])}")
    for s in snapshot.get("histograms", []):
        _type(s["name"], "histogram")
        for le, cum in s["buckets"]:
            lab = _labels(s["labels"], {"le": _num(le)})
            lines.append(f"{s['name']}_bucket{lab} {cum}")
        lab = _labels(s["labels"])
        lines.append(f"{s['name']}_sum{lab} {_num(s['sum'])}")
        lines.append(f"{s['name']}_count{lab} {s['count']}")
    return "\n".join(lines) + "\n"


def to_json(snapshot: dict) -> str:
    """Registry snapshot -> stable JSON text (timestamped)."""
    return json.dumps({"ts_unix": time.time(), **snapshot}, indent=1,
                      sort_keys=True)


def _render(path: str, registry: MetricsRegistry) -> str:
    snap = registry.snapshot()
    return (to_json(snap) if path.endswith(".json")
            else to_prometheus(snap))


def _atomic_write(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def write_snapshot(path: str, registry: MetricsRegistry = REGISTRY) -> str:
    """One-shot snapshot file (format by extension, atomic)."""
    _atomic_write(path, _render(path, registry))
    return path


class PeriodicExporter:
    """Background thread re-emitting the snapshot file every interval."""

    def __init__(self, path: str, interval_s: float = 5.0, *,
                 registry: MetricsRegistry = REGISTRY, tracer=None,
                 trace_path: str | None = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.path = path
        self.interval_s = float(interval_s)
        self.registry = registry
        self.tracer = tracer
        self.trace_path = trace_path
        self.emits = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._final_emitted = False

    def emit(self) -> None:
        _atomic_write(self.path, _render(self.path, self.registry))
        if self.tracer is not None and self.trace_path is not None:
            _atomic_write(self.trace_path,
                          json.dumps(self.tracer.export()))
        self.emits += 1

    def start(self) -> "PeriodicExporter":
        if self._thread is None:
            self._stop.clear()              # restartable after stop()
            self._final_emitted = False
            self.emit()                     # a scrape target exists at once
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="obs-exporter")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.emit()
            except Exception:               # a bad disk must not kill the
                pass                        # serving process

    def stop(self) -> None:
        """Idempotent shutdown with EXACTLY ONE final emission.

        The final emit happens after the thread has joined, so metrics
        recorded between the last periodic tick and stop() always land in
        the file; a second stop() (or stop() without start()) must not
        emit again — callers treat the file as complete at first return.
        """
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if not self._final_emitted:
            self._final_emitted = True
            self.emit()                     # final, complete snapshot

    def __enter__(self) -> "PeriodicExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
