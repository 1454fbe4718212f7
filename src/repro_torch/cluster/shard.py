"""Shard worker: one self-contained search engine behind a wire boundary.

A `ShardWorker` is the *server* side of one shard replica: it owns a
normal `SearchService` over the shard's rows, a local->global id map, and
a single-threaded executor standing in for the remote node's request
loop. Every request and reply crosses a real serialization boundary —
`to_wire` / `from_wire` encode messages as one JSON header plus raw
little-endian array payloads, byte for byte the reference's codec — so a
reference router and a port worker (or the other way round) exchange
messages, and the in-process loopback transport can be swapped for a
socket without touching the router.

Ops (all wire-encoded dicts with an "op" key):

  search     : queries/k/ef/rerank/with_stats -> global ids/dists + stats
  candidates : stage-1 unmerged candidate pool (global ids) — what the
               router's global rerank consumes (graph backends only)
  fetch_rows : float32 rows for global ids this shard owns (stage-2 data)
  ping       : heartbeat — name/replica/row count, refreshes last_beat
  stats      : per-replica counters (queries, latency, cache, failures)

Results cross the wire as host numpy arrays (int64 global ids, float32
distances); device tensors never do. On CUDA each worker binds its
thread to its service's card and searches on its own stream, so the
device-to-host copy of its results waits for its own kernels only.

Fault injection (`inject_faults`) and hard kill (`kill`) make every
failover path testable: a faulted request raises on the worker thread and
surfaces to the router as a transport error, exactly like a dead node.
"""

from __future__ import annotations

import contextlib
import json
import struct
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.api.types import SearchRequest
from repro_torch.obs.stats import latency_summary
from repro_torch.obs.trace import SpanCtx, TRACER
from repro_torch.serve.batcher import _host

__all__ = ["ShardFault", "to_wire", "from_wire", "ShardWorker"]

_MAGIC = b"RWP1"                   # repro wire protocol v1


class ShardFault(RuntimeError):
    """A shard replica failed to serve a request (fault or kill)."""


# ---------------------------------------------------------------------------
# Wire codec: one JSON header + contiguous array payloads
# ---------------------------------------------------------------------------


def to_wire(msg: dict) -> bytes:
    """Serialize a flat message dict. Values are either JSON-encodable
    (str/int/float/bool/None/lists of those) or numpy arrays; arrays ride
    after the header as raw bytes, described by dtype + shape."""
    plain, arrays = {}, []
    for key, val in msg.items():
        if isinstance(val, np.ndarray):
            arr = np.ascontiguousarray(val)
            arrays.append((key, arr))
        else:
            plain[key] = val
    header = {"plain": plain,
              "arrays": [{"key": k, "dtype": str(a.dtype),
                          "shape": list(a.shape)} for k, a in arrays]}
    hb = json.dumps(header).encode("utf-8")
    parts = [_MAGIC, struct.pack("<I", len(hb)), hb]
    parts += [a.tobytes() for _, a in arrays]
    return b"".join(parts)


def from_wire(buf: bytes) -> dict:
    """Decode a `to_wire` message back into its dict."""
    if buf[:4] != _MAGIC:
        raise ValueError(f"bad wire magic {buf[:4]!r}")
    (hlen,) = struct.unpack("<I", buf[4:8])
    header = json.loads(buf[8: 8 + hlen].decode("utf-8"))
    msg = dict(header["plain"])
    off = 8 + hlen
    for ent in header["arrays"]:
        dt = np.dtype(ent["dtype"])
        count = int(np.prod(ent["shape"], dtype=np.int64))
        nbytes = count * dt.itemsize
        msg[ent["key"]] = np.frombuffer(
            buf[off: off + nbytes], dtype=dt).reshape(ent["shape"]).copy()
        off += nbytes
    return msg


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


class ShardWorker:
    """One shard replica: service + gid map + serial request thread."""

    def __init__(self, name: str, service, gid_map, *, rid: int = 0,
                 owns_backend: bool = False):
        self.name = name
        self.rid = rid
        self.service = service
        self.gid_map = np.asarray(gid_map, np.int64)
        if self.gid_map.ndim != 1 or (self.gid_map.size > 1 and
                                      not (np.diff(self.gid_map) > 0).all()):
            raise ValueError("gid_map must be a strictly-ascending 1-D "
                             "array of global ids")
        self.owns_backend = owns_backend
        self.last_beat = time.monotonic()
        self._lock = threading.Lock()
        self._fail_next = 0
        self._dead = False
        self.queries = 0
        self.batches = 0
        self.failures = 0
        self.busy_s = 0.0
        self._lat_ms: deque = deque(maxlen=512)
        # the card this replica's service lives on ("cuda" without an
        # index placed its tensors on the building thread's current card)
        dev = torch.device(service.device)
        self._stream = None
        if dev.type == "cuda":
            self._card = (dev.index if dev.index is not None
                          else torch.cuda.current_device())
            self._stream = torch.cuda.Stream(device=self._card)
            # the service's tables were uploaded on the default stream
            self._stream.wait_stream(torch.cuda.current_stream(self._card))
        self._ex = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"shard-{name}-r{rid}")

    @property
    def n(self) -> int:
        return int(self.gid_map.size)

    # -- fault injection / lifecycle ----------------------------------------

    def inject_faults(self, n: int = 1) -> None:
        """The next `n` requests raise ShardFault (transient fault)."""
        with self._lock:
            self._fail_next += int(n)

    def kill(self) -> None:
        """Permanent failure: every request from now on raises — the
        in-process stand-in for a crashed node."""
        self._dead = True

    def revive(self) -> None:
        self._dead = False

    def close(self) -> None:
        self._ex.shutdown(wait=True)
        if self.owns_backend:
            reader = getattr(self.service.backend, "reader", None)
            if reader is not None:
                reader.close()

    # -- request path --------------------------------------------------------

    def submit(self, payload: bytes) -> "Future[bytes]":
        """Enqueue one wire-encoded request on this replica's thread."""
        return self._ex.submit(self._handle, payload)

    def _check_fault(self) -> None:
        if self._dead:
            raise ShardFault(f"shard {self.name!r} replica {self.rid} "
                             f"is down")
        with self._lock:
            if self._fail_next > 0:
                self._fail_next -= 1
                raise ShardFault(f"shard {self.name!r} replica {self.rid} "
                                 f"injected fault")

    def _on_card(self):
        """This thread on the service's card and this replica's stream
        (the CPU: nothing to bind)."""
        if self._stream is None:
            return contextlib.nullcontext()
        torch.cuda.set_device(self._card)
        return torch.cuda.stream(self._stream)

    def _handle(self, payload: bytes) -> bytes:
        t0 = time.perf_counter()
        msg = from_wire(payload)
        try:
            self._check_fault()
            # the trace ctx crosses the wire in the JSON header: enter a
            # worker-side span only when the caller sent one (pings and
            # health probes stay span-free)
            w = msg.pop("trace", None)
            with self._on_card():
                if w is not None:
                    with TRACER.span("shard-exec",
                                     parent=SpanCtx.from_wire(w),
                                     shard=self.name, replica=self.rid,
                                     op=msg.get("op")):
                        out = self._dispatch(msg)
                else:
                    out = self._dispatch(msg)
            out["ok"] = True
        except Exception as exc:          # serialize the failure — a real
            self.failures += 1            # transport cannot raise across it
            out = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        self.last_beat = time.monotonic()
        dt = time.perf_counter() - t0
        self.busy_s += dt
        if msg.get("op") in ("search", "candidates"):
            self.batches += 1
            self._lat_ms.append(dt * 1e3)
        return to_wire(out)

    def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "search":
            return self._op_search(msg)
        if op == "candidates":
            return self._op_candidates(msg)
        if op == "fetch_rows":
            return self._op_fetch_rows(msg)
        if op == "ping":
            return {"name": self.name, "rid": self.rid, "n": self.n}
        if op == "stats":
            return self.stats()
        raise ValueError(f"unknown shard op {op!r}")

    def _global(self, ids: np.ndarray) -> np.ndarray:
        return np.where(ids >= 0, self.gid_map[np.maximum(ids, 0)],
                        np.int64(-1))

    def _op_search(self, msg: dict) -> dict:
        queries = msg["queries"]
        self.queries += int(queries.shape[0])
        resp = self.service.search(SearchRequest(
            queries=queries, k=int(msg["k"]), ef=int(msg["ef"]),
            rerank=bool(msg.get("rerank", False)),
            with_stats=bool(msg.get("with_stats", False))))
        out = {"ids": self._global(_host(resp.ids)),
               "dists": _host(resp.dists).astype(np.float32, copy=False)}
        if resp.stats is not None:
            out.update(_wire_stats(resp.stats))
        return out

    def _op_candidates(self, msg: dict) -> dict:
        """Stage-1 unmerged candidate pool in partition-major order — the
        router's global stage-2 rerank consumes this (global ids)."""
        queries = msg["queries"]
        self.queries += int(queries.shape[0])
        cand, stats = _stage1_candidates(
            self.service, queries, int(msg["k"]), int(msg["ef"]))
        out = {"ids": self._global(cand)}
        if stats:
            out.update(stats)
        return out

    def _op_fetch_rows(self, msg: dict) -> dict:
        """Float32 rows for global ids this shard owns (ascending order is
        the caller's job — the compact-id rerank contract)."""
        gids = np.asarray(msg["ids"], np.int64)
        pos = np.searchsorted(self.gid_map, gids)
        pos = np.minimum(pos, max(self.gid_map.size - 1, 0))
        if self.gid_map.size == 0 or not (self.gid_map[pos] == gids).all():
            missing = gids[self.gid_map[pos] != gids] if self.gid_map.size \
                else gids
            raise ValueError(
                f"shard {self.name!r} does not own ids {missing[:4]}...")
        return {"rows": _rows_f32(self.service, pos)}

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        lat = latency_summary(self._lat_ms)
        d = {"shard": self.name, "replica": self.rid, "n": self.n,
             "queries": self.queries, "batches": self.batches,
             "failures": self.failures, "busy_s": self.busy_s,
             "p50_ms": lat["p50"], "p99_ms": lat["p99"],
             "p999_ms": lat["p999"]}
        reader = getattr(self.service.backend, "reader", None)
        if reader is not None:             # csd: this replica's own cache
            snap = reader.cache.snapshot()
            demand = snap["hits"] + snap["misses"]
            d.update(block_reads=snap["block_reads"],
                     bytes_read=snap["bytes_read"],
                     cache_hits=snap["hits"],
                     cache_misses=snap["misses"],
                     cache_hit_rate=(snap["hits"] / demand if demand
                                     else 0.0))
        return d


# ---------------------------------------------------------------------------
# Backend adapters (stage-1 candidates / stage-2 row gather)
# ---------------------------------------------------------------------------


def _wire_stats(stats) -> dict:
    """QueryStats -> wire-encodable per-request scalars/arrays."""
    out = {}
    for f in ("hops", "dist_calcs"):
        v = getattr(stats, f)
        if v is not None:
            out[f] = _host(v).astype(np.int64)
    for f in ("block_reads", "cache_hits", "cache_misses", "bytes_read"):
        v = getattr(stats, f)
        if v is not None:
            out[f] = int(v)
    return out


def _stage1_candidates(service, queries, k: int, ef: int):
    """The unmerged [B, P*k] local-id candidate pool of one shard, on the
    host. Queries are metric-prepared here, as `SearchService.search`
    prepares them (cosine: unit norm), so the router's rerank scores the
    candidates a single index would score."""
    backend = service.backend
    queries = service.metric.prepare_queries(np.asarray(queries))
    if hasattr(backend, "reader"):                       # csd
        from repro_torch.store.csd import store_search
        cand, _, hops, calcs, _ = store_search(
            backend.reader, queries, backend.params(k, ef), merge=False,
            pq_quant=backend.quant if backend.is_pq else None,
            device=backend.device)
        return (np.asarray(cand),
                {"hops": np.asarray(hops, np.int64),
                 "dist_calcs": np.asarray(calcs, np.int64)})
    if hasattr(backend, "stage1"):                       # graph backends
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=backend.device)
        cand, _, st = backend.stage1(q, backend.params(k, ef), merge=False)
        stats = backend.query_stats(st)
        return (_host(cand),
                {f: _host(v).astype(np.int64)
                 for f in ("hops", "dist_calcs")
                 if (v := getattr(stats, f)) is not None})
    raise ValueError(
        f"backend {service.spec.backend!r} has no stage-1 candidate pool "
        f"(exact search is already exact — rerank at the router is a no-op)")


def _rows_f32(service, local_ids: np.ndarray) -> np.ndarray:
    """Gather float32 rows by local id — the shard side of the router's
    compact-table stage-2 rerank (mirrors CSDBackend._rerank_from_store)."""
    backend = service.backend
    if hasattr(backend, "reader"):                       # csd: store reads
        r = backend.reader
        if r.partition_starts is None:
            raise ValueError("store partition ids are not contiguous; "
                             "rerank over this shard is unsupported")
        part = np.searchsorted(r.partition_starts, local_ids,
                               side="right") - 1
        local = local_ids - r.partition_starts[part]
        rows = part * r.n_pad + local
        if service.spec.dtype == "pq":
            # TRUE float32 rows for the router's global stage 2 — the
            # code rows would just reproduce the ADC distances
            return r.read_rows("rerank_vectors", rows).astype(np.float32)
        return r.read_rows("vectors", rows)[:, : r.dim].astype(np.float32)
    if getattr(backend, "dev_vectors", None) is not None:  # keep_vectors
        # the host copy of the device table (float32 and pq keep the raw
        # rows; clusters refuse the scalar-quantized dtypes)
        return np.asarray(backend.raw, np.float32)[local_ids]
    if getattr(backend, "raw", None) is not None and not backend.uses_graph:
        return np.asarray(backend.raw, np.float32)[local_ids]   # exact
    raise ValueError(
        "rerank=True needs the raw vectors on every shard: build the "
        "cluster with IndexSpec(keep_vectors=True) (csd shards read them "
        "back from their block stores instead)")
