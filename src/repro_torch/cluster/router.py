"""Cluster router: scatter-gather search over shard replicas.

`ClusterRouter` presents the `SearchService` interface (`.spec`,
`.search(SearchRequest) -> SearchResponse`) over N shards, each fronted by
a `ShardClient` that owns the shard's replica set. One request flows:

    router.search ──scatter──> shard 0 client ──> replica (least in-flight)
                 ├──────────> shard 1 client ──> ...
                 └──────────> shard N-1 client
    gather: per-shard sorted top-k, concatenated shard-major,
    reduced by `core.merge.rank_merge` (stable argsort) ──> global top-k

Because shards hold the SAME row split and construction seeds as the
partitions of one big index (`topology.shard_spec`), the gathered merge is
bit-identical to single-index search. With `rerank=True` the router runs
stage 2 itself: it gathers every shard's *unmerged* stage-1 candidate
pool, fetches the unique candidate rows back from their owning shards,
and reranks the union in one `batched_rerank` call over a compact id
space — the same global reduction a single index performs, which is what
keeps rerank bit-identical too (per-shard rerank would not be: a [B, k]
and a [B, P*K] reduction may round differently). The compact table's
squared norms come from the partitioned backend's own `_device_vectors`
on the router's device, so the router scores exactly as the single index
does. Results are host tensors: int64 global ids and float32 distances
(-1 / +inf padded), as the mutable index returns them.

Failover lives in `ShardClient.request`: a replica that faults is marked
unhealthy and the request is retried verbatim on the next live replica —
the caller never sees the fault unless every replica of a shard is down.

Elastic changes (`add_shard` / `remove_shard` / `add_replica` /
`remove_replica`) swap the shard list under a lock and publish a new
versioned `cluster.json`; in-flight searches keep the snapshot they
started with.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.metrics import get_metric
from repro_torch.api.types import QueryStats, SearchRequest, SearchResponse
from repro_torch.core.merge import rank_merge
from repro_torch.cluster.shard import (ShardFault, ShardWorker, from_wire,
                                       to_wire)
from repro_torch.cluster.topology import (ClusterTopology, ShardInfo,
                                          write_topology)
from repro_torch.obs.metrics import REGISTRY, next_uid
from repro_torch.obs.slo import SLOTracker
from repro_torch.obs.trace import TRACER

__all__ = ["ShardClient", "ClusterRouter", "ClusterStats"]


class ShardClient:
    """The router's handle to one shard: a replica set with least-in-flight
    dispatch and transparent failover."""

    def __init__(self, name: str, replicas):
        if not replicas:
            raise ValueError(f"shard {name!r} needs at least one replica")
        self.name = name
        self.replicas: list[ShardWorker] = list(replicas)
        self._healthy = [True] * len(self.replicas)
        self._inflight = [0] * len(self.replicas)
        self._rr = 0
        self._lock = threading.Lock()
        self.failovers = 0

    @property
    def n(self) -> int:
        return self.replicas[0].n

    @property
    def gid_lo(self) -> int:
        return int(self.replicas[0].gid_map[0]) if self.n else 0

    def live(self) -> int:
        with self._lock:
            return sum(self._healthy)

    def mark(self, rid_index: int, healthy: bool) -> None:
        with self._lock:
            self._healthy[rid_index] = healthy

    def _pick(self, exclude: set) -> int | None:
        """Least-in-flight among healthy replicas, round-robin tiebreak."""
        with self._lock:
            best, best_load = None, None
            order = range(self._rr, self._rr + len(self.replicas))
            for j in order:
                i = j % len(self.replicas)
                if i in exclude or not self._healthy[i]:
                    continue
                if best_load is None or self._inflight[i] < best_load:
                    best, best_load = i, self._inflight[i]
            if best is not None:
                self._rr = (best + 1) % len(self.replicas)
                self._inflight[best] += 1
            return best

    def request(self, msg: dict) -> dict:
        """Send one request, failing over across replicas. Each attempt
        goes to exactly one replica; a faulted attempt is marked unhealthy
        and retried on the next live one, so no request is ever lost or
        served twice."""
        payload = to_wire(msg)
        tried: set = set()
        while True:
            i = self._pick(tried)
            if i is None:
                raise ShardFault(
                    f"shard {self.name!r}: no live replicas "
                    f"({len(self.replicas)} configured, all down)")
            try:
                resp = from_wire(self.replicas[i].submit(payload).result())
            except Exception as exc:       # transport-level death
                resp = {"ok": False, "error": f"ShardFault: {exc}"}
            finally:
                with self._lock:
                    self._inflight[i] -= 1
            if resp.get("ok"):
                return resp
            err = resp.get("error", "")
            if err.startswith("ShardFault"):
                self.mark(i, False)
                tried.add(i)
                self.failovers += 1
                continue                   # fail over, request intact
            raise RuntimeError(f"shard {self.name!r}: {err}")

    def probe(self) -> list[bool]:
        """Ping every replica directly (no failover); refresh health flags
        from the outcome — a revived replica comes back on success."""
        payload = to_wire({"op": "ping"})
        states = []
        for i, rep in enumerate(self.replicas):
            try:
                ok = from_wire(rep.submit(payload).result()).get("ok", False)
            except Exception:
                ok = False
            self.mark(i, bool(ok))
            states.append(bool(ok))
        return states

    def close(self) -> None:
        for rep in self.replicas:
            rep.close()


@dataclasses.dataclass(frozen=True)
class ClusterStats:
    """Rolled-up cluster health: per-shard load, latency, storage traffic,
    and how skewed the row/query distribution is."""

    n_shards: int
    n_replicas: int                 # total live replicas
    queries: int                    # sum over shards (each query hits all)
    failovers: int
    shards: tuple                   # per-replica stat dicts
    qps: dict                       # shard -> queries / busy_s
    p50_ms: dict                    # shard -> max over replicas
    p99_ms: dict
    block_reads: int
    bytes_read: int
    cache_hit_rate: float | None    # weighted over csd replicas
    row_skew: float                 # max/mean shard rows (1.0 == balanced)
    query_skew: float               # max/mean replica queries
    # per-shard SLO status rows (slo-enabled routers only): each entry is
    # {"shard": name, "slo": [per-objective status dicts]}
    slo: tuple = ()
    slo_breaching: tuple = ()       # names of shards currently breaching


def _collect_router(router: "ClusterRouter"):
    """Snapshot-time metric samples for the whole cluster (repro_torch.obs)."""
    shards = router.shards
    labels = {"router": router.uid}
    out = [("gauge", "cluster_shards", labels, len(shards)),
           ("gauge", "cluster_replicas_live", labels,
            sum(c.live() for c in shards)),
           ("counter", "cluster_failovers_total", labels,
            sum(c.failovers for c in shards))]
    for c in shards:
        sl = {"router": router.uid, "shard": c.name}
        out.append(("counter", "cluster_shard_queries_total", sl,
                    sum(rep.queries for rep in c.replicas)))
        out.append(("counter", "cluster_shard_failures_total", sl,
                    sum(rep.failures for rep in c.replicas)))
    return out


class ClusterRouter:
    """One logical index over N shards. Quacks like a `SearchService`
    (`.spec` / `.search` / `.device`) so `repro_torch.serve.SearchServer`
    can front it. `device` is where the router's stage-2 rerank runs:
    default, the first shard's card (or CPU)."""

    backend = None                  # no single-box backend behind this

    def __init__(self, spec, shards, *, path: str | None = None,
                 version: int = 0, publish: bool = True, slo=None,
                 device=None):
        dtype = getattr(spec, "dtype", "float32")
        if dtype == "pq":
            # PQ is the one quantized dtype clusters support: the fitted
            # codebooks ride the IndexSpec (build_cluster fits them ONCE
            # over the union), so every shard shares a single code space
            # and the gathered merge stays comparable — and bit-identical
            # to the equivalent single index, whose deterministic fit over
            # the same rows/seed yields the same codebooks.
            if getattr(spec, "pq_codebooks", None) is None:
                raise ValueError(
                    "a pq cluster needs pre-fitted codebooks riding the "
                    "spec (build_cluster fits them over the union); "
                    "per-shard fits would not share one code space")
        elif dtype != "float32":
            raise ValueError(
                "clusters are float32 or pq only: scalar quantizer scales "
                "are fit per build, so per-shard quantized code spaces "
                "would not be comparable across shards")
        self.spec = spec
        self.path = path
        self._shards: list[ShardClient] = list(shards)
        if device is None and self._shards:
            device = self._shards[0].replicas[0].service.device
        self.device = resolve_device(device)
        self._version = version
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="cluster-router")
        self._monitor = None        # HealthMonitor attaches here
        self.uid = next_uid()
        # optional per-shard SLO tracking: `slo` is an iterable of
        # obs.slo.SLO objects; each shard gets its OWN tracker (labeled
        # {router, shard}) fed from the scatter path, so a breaching shard
        # is attributable in ClusterStats and the slo_* series
        self._slo_spec = None if slo is None else tuple(slo)
        self._slo_trackers: dict[str, SLOTracker] = {}
        REGISTRY.register_collector(self, _collect_router)
        if publish and path is not None:
            self._publish()

    # -- topology ------------------------------------------------------------

    @property
    def shards(self) -> list[ShardClient]:
        with self._lock:
            return list(self._shards)

    @property
    def version(self) -> int:
        return self._version

    def topology(self) -> ClusterTopology:
        with self._lock:
            return ClusterTopology(
                shards=tuple(ShardInfo(name=c.name, replicas=c.live(),
                                       rows=c.n) for c in self._shards),
                version=self._version)

    def _publish(self) -> None:
        with self._lock:
            self._version += 1
        if self.path is not None:
            write_topology(self.path, self.topology())

    def add_shard(self, client: ShardClient) -> None:
        """Attach a shard under live traffic. In-flight searches keep the
        snapshot they scattered over; new searches see the new shard."""
        with self._lock:
            if any(c.name == client.name for c in self._shards):
                raise ValueError(f"shard {client.name!r} already attached")
            self._shards.append(client)
        self._publish()

    def remove_shard(self, name: str) -> ShardClient:
        with self._lock:
            for i, c in enumerate(self._shards):
                if c.name == name:
                    if len(self._shards) == 1:
                        raise ValueError("cannot remove the last shard")
                    client = self._shards.pop(i)
                    break
            else:
                raise KeyError(f"no shard named {name!r}")
        self._publish()
        return client

    def add_replica(self, name: str, worker: ShardWorker) -> None:
        client = self._client(name)
        with client._lock:
            client.replicas.append(worker)
            client._healthy.append(True)
            client._inflight.append(0)
        self._publish()

    def remove_replica(self, name: str, rid_index: int) -> ShardWorker:
        client = self._client(name)
        with client._lock:
            if len(client.replicas) == 1:
                raise ValueError(
                    f"cannot remove the last replica of shard {name!r}")
            worker = client.replicas.pop(rid_index)
            client._healthy.pop(rid_index)
            client._inflight.pop(rid_index)
        self._publish()
        return worker

    def _client(self, name: str) -> ShardClient:
        with self._lock:
            for c in self._shards:
                if c.name == name:
                    return c
        raise KeyError(f"no shard named {name!r}")

    # -- search --------------------------------------------------------------

    def search(self, request: SearchRequest) -> SearchResponse:
        q = request.queries
        if isinstance(q, torch.Tensor):
            q = q.cpu().numpy()
        queries = np.ascontiguousarray(np.asarray(q, np.float32))
        shards = self.shards             # snapshot: elastic-change safe
        rerank = bool(request.rerank) and self.spec.backend != "exact"
        # same span contract as SearchService.search: ambient nesting wins
        # (replica dispatch span); batcher ctx only on a cold thread
        if request.trace is not None and TRACER.current_ctx() is None:
            span = TRACER.span("search", parent=request.trace,
                               backend="cluster", shards=len(shards))
        else:
            span = TRACER.span("search", backend="cluster",
                               shards=len(shards))
        with span:
            if rerank:
                return self._search_rerank(shards, queries, request)
            msg = {"op": "search", "queries": queries, "k": int(request.k),
                   "ef": int(request.ef), "rerank": False,
                   "with_stats": bool(request.with_stats)}
            resps = self._scatter(shards, msg)
            ids, dists = rank_merge(
                [r["ids"] for r in resps],
                [r["dists"] for r in resps], int(request.k))
            stats = self._roll_stats(resps) if request.with_stats else None
            return SearchResponse(ids=torch.from_numpy(ids),
                                  dists=torch.from_numpy(dists), stats=stats)

    def _search_rerank(self, shards, queries, request) -> SearchResponse:
        """Global stage 2: gather every shard's stage-1 candidate pool,
        fetch the unique rows from their owners, rerank the union exactly
        as a single index would (compact monotone id space, one call)."""
        from repro_torch.api.backends import _device_vectors
        from repro_torch.api.rerank import batched_rerank

        k = int(request.k)
        msg = {"op": "candidates", "queries": queries, "k": k,
               "ef": int(request.ef)}
        resps = self._scatter(shards, msg)
        pools = [r["ids"] for r in resps]          # [B, P_i*K] global ids
        cand = np.concatenate(pools, axis=1)       # shard-major == global
        valid = cand >= 0                          # partition-major order

        per_shard_uniq = [np.unique(p[p >= 0]) for p in pools]
        uniq = np.unique(cand[valid])              # sorted union (disjoint)
        futs = [self._pool.submit(c.request,
                                  {"op": "fetch_rows", "ids": su})
                for c, su in zip(shards, per_shard_uniq) if su.size]
        table = None
        for (c, su), fut in zip(
                [(c, su) for c, su in zip(shards, per_shard_uniq)
                 if su.size], futs):
            rows = fut.result()["rows"]
            if table is None:
                table = np.empty((uniq.size, rows.shape[1]), np.float32)
            table[np.searchsorted(uniq, su)] = rows
        if table is None:                          # no candidates at all
            b = queries.shape[0]
            return SearchResponse(
                ids=torch.full((b, k), -1, dtype=torch.int64),
                dists=torch.full((b, k), float("inf")))

        dev = self.device
        vt, sqs = _device_vectors(table, dev)
        compact = np.where(
            valid, np.searchsorted(uniq, np.where(valid, cand, 0)),
            -1).astype(np.int32)
        # the queries the shards searched with (cosine: unit norm)
        rq = get_metric(self.spec.metric).prepare_queries(queries)
        ids_c, dists = batched_rerank(
            vt, sqs, torch.as_tensor(rq, dtype=torch.float32, device=dev),
            torch.as_tensor(compact, device=dev), k, self.spec.metric)
        ids_c = ids_c.cpu().numpy()
        ids = np.where(ids_c >= 0, uniq[np.maximum(ids_c, 0)], -1)
        stats = self._roll_stats(resps) if request.with_stats else None
        return SearchResponse(ids=torch.from_numpy(ids), dists=dists.cpu(),
                              stats=stats)

    def _slo_for(self, name: str) -> SLOTracker:
        tr = self._slo_trackers.get(name)
        if tr is None:
            tr = self._slo_trackers.setdefault(
                name, SLOTracker(self._slo_spec,
                                 labels={"router": self.uid, "shard": name}))
        return tr

    def _scatter(self, shards, msg: dict) -> list:
        # the fan-out crosses onto the router pool threads: capture the
        # caller's ctx here and parent each per-shard span on it explicitly
        ctx = TRACER.current_ctx()

        def _one(c):
            slo = (self._slo_for(c.name) if self._slo_spec is not None
                   else None)
            t0 = time.perf_counter()
            try:
                if ctx is None:
                    r = c.request(msg)
                else:
                    with TRACER.span("shard", parent=ctx,
                                     shard=c.name) as sp:
                        m = dict(msg)
                        m["trace"] = sp.ctx.wire()   # JSON wire header
                        r = c.request(m)
            except Exception:
                # failover already exhausted inside ShardClient.request —
                # what escapes here is a real per-shard failure
                if slo is not None:
                    slo.record_error()
                raise
            if slo is not None:
                slo.record_latency((time.perf_counter() - t0) * 1e3)
            return r

        futs = [self._pool.submit(_one, c) for c in shards]
        return [f.result() for f in futs]          # shard order preserved

    def _roll_stats(self, resps) -> QueryStats:
        def _sum(key, scalar=False):
            vals = [r[key] for r in resps if key in r]
            if not vals:
                return None
            return (int(sum(vals)) if scalar
                    else torch.from_numpy(np.sum(np.stack(vals), axis=0)))
        hits = _sum("cache_hits", scalar=True)
        misses = _sum("cache_misses", scalar=True)
        # demand-weighted over shards: one rate from the summed counters,
        # identical in form to a single cache's hits / (hits + misses)
        demand = (hits or 0) + (misses or 0)
        hit_rate = (((hits or 0) / demand) if demand else 0.0) \
            if (hits is not None or misses is not None) else None
        return QueryStats(hops=_sum("hops"), dist_calcs=_sum("dist_calcs"),
                          block_reads=_sum("block_reads", scalar=True),
                          cache_hits=hits, cache_misses=misses,
                          cache_hit_rate=hit_rate,
                          bytes_read=_sum("bytes_read", scalar=True))

    # -- introspection -------------------------------------------------------

    def stats(self) -> ClusterStats:
        shards = self.shards
        per_rep = [rep.stats() for c in shards for rep in c.replicas]
        qps, p50, p99 = {}, {}, {}
        for c in shards:
            reps = [r for r in per_rep if r["shard"] == c.name]
            busy = sum(r["busy_s"] for r in reps)
            qs = sum(r["queries"] for r in reps)
            qps[c.name] = qs / busy if busy > 0 else 0.0
            p50[c.name] = max(r["p50_ms"] for r in reps)
            p99[c.name] = max(r["p99_ms"] for r in reps)
        rows = np.asarray([c.n for c in shards], np.float64)
        rep_q = np.asarray([r["queries"] for r in per_rep], np.float64)
        csd = [r for r in per_rep if "cache_hit_rate" in r]
        # exact demand-weighting from the summed counters (the per-replica
        # stats now carry cache_hits/cache_misses), not an average of rates
        dh = sum(r.get("cache_hits", 0) for r in csd)
        dm = sum(r.get("cache_misses", 0) for r in csd)
        hit = ((dh / (dh + dm) if (dh + dm) else 0.0) if csd else None)
        slo_rows: list = []
        breaching: list = []
        if self._slo_spec is not None:
            for name in sorted(self._slo_trackers):
                status = self._slo_trackers[name].evaluate()
                slo_rows.append({"shard": name, "slo": status})
                if any(row["breaching"] for row in status):
                    breaching.append(name)
        return ClusterStats(
            n_shards=len(shards),
            n_replicas=sum(c.live() for c in shards),
            queries=int(rep_q.sum()),
            failovers=sum(c.failovers for c in shards),
            shards=tuple(per_rep),
            qps=qps, p50_ms=p50, p99_ms=p99,
            block_reads=sum(r.get("block_reads", 0) for r in per_rep),
            bytes_read=sum(r.get("bytes_read", 0) for r in per_rep),
            cache_hit_rate=hit,
            row_skew=float(rows.max() / rows.mean()) if rows.size and
            rows.mean() > 0 else 1.0,
            query_skew=float(rep_q.max() / rep_q.mean()) if rep_q.size and
            rep_q.mean() > 0 else 1.0,
            slo=tuple(slo_rows),
            slo_breaching=tuple(breaching))

    def close(self) -> None:
        if self._monitor is not None:
            self._monitor.stop()
        for c in self.shards:
            c.close()
        self._pool.shutdown(wait=True)
