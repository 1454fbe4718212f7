"""Distributed two-stage search: graph parallelism + query parallelism
(paper Fig. 10/11) over a mesh of device slots, from one controller.

Graph parallelism (the paper's winning strategy — 3.67x at 4 devices):
partitions shard over the `model` axis in contiguous blocks; each slot
searches only its resident sub-graphs; the per-slot top-K pools are
gathered onto the first slot's device in slot order and rank-merged
(stage 2). The merge is O(P*K).

Query parallelism: the query batch splits into contiguous chunks over
`data` (and `pod`). Partitions stay resident, so sharding queries across
the rows of the graph-sharded engine is free.

The reference expresses both as `shard_map` collectives; the port runs
them from one process: every (query chunk, partition block) pair is one
slot's `search_lanes` call, each slot on its own thread and, on CUDA, its
own stream, and the all-gather is a concatenation in slot order after
each slot's event. That order is partition-major, so the stable sort
that merges the pool is `core.partitioned.merge_topk`'s, bit for bit.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hnsw_graph as hg
from repro_torch.core.partitioned import PartitionedDB
from repro_torch.core.search import SearchParams, search_lanes

__all__ = ["ShardedDB", "shard_db", "make_distributed_search"]


class ShardedDB(NamedTuple):
    """A PartitionedDB placed over a mesh. `slots` maps each slot's index
    (a tuple) to (its block number, the DeviceDB of that contiguous
    partition block on the slot's device); slots on one device holding
    one block share its tensors."""

    slots: dict
    num_partitions: int
    dim: int
    graph_axes: tuple

    def host_db(self) -> hg.DeviceDB:
        """The whole partition-stacked DB as numpy arrays, in order."""
        blocks = {}
        for g, db in self.slots.values():
            blocks.setdefault(g, db)
        return hg.DeviceDB(*(
            np.concatenate([blocks[g][f].cpu().numpy()
                            for g in sorted(blocks)])
            for f in range(len(hg.DeviceDB._fields))))


def _coords(mesh, axes) -> tuple[dict, int]:
    """Each slot's coordinate along `axes` (row-major over them, in the
    order given) and the number of coordinates."""
    axes = tuple(axes)
    sizes = [mesh.shape[a] for a in axes]
    out = {}
    for idx in np.ndindex(mesh.devices.shape):
        c = 0
        for a, s in zip(axes, sizes):
            c = c * s + idx[mesh.axis_names.index(a)]
        out[idx] = c
    return out, int(np.prod(sizes, dtype=np.int64))


def shard_db(pdb: PartitionedDB, mesh,
             graph_axes=("model",)) -> ShardedDB:
    """Place contiguous blocks of partitions on the slots of `graph_axes`
    (P must divide over them); the copy is shared across the other axes,
    and a block is copied once a device (a slice of tensors already on
    that device is a view, not a copy)."""
    graph_axes = tuple(graph_axes)
    coord, n_g = _coords(mesh, graph_axes)
    P = pdb.num_partitions
    if P % n_g:
        raise ValueError(f"num_partitions={P} must divide over the mesh "
                         f"axes {graph_axes} ({n_g})")
    per = P // n_g
    placed, slots = {}, {}
    for idx, g in coord.items():
        dev = mesh.devices[idx]
        if (g, dev) not in placed:
            block = hg.DeviceDB(*(a[g * per:(g + 1) * per] for a in pdb.db))
            placed[g, dev] = hg.device_db(block, dev)
        slots[idx] = (g, placed[g, dev])
    return ShardedDB(slots=slots, num_partitions=P, dim=pdb.dim,
                     graph_axes=graph_axes)


class DistributedSearch:
    """The two-stage search over one mesh at fixed SearchParams; call it
    as `fn(sdb, queries, lut=None)` -> (ids, dists, calcs [B, 1]).

    One slot searches each (query chunk, partition block) pair: the first
    slot in row-major order with those coordinates (slots that differ
    only along other axes would compute the same)."""

    def __init__(self, mesh, p: SearchParams, graph_axes, query_axes,
                 merge: bool):
        self.mesh = mesh
        self.p = p
        self.graph_axes = tuple(graph_axes)
        self.merge = merge
        g_of, self.n_graph = _coords(mesh, self.graph_axes)
        q_of, self.n_query = _coords(mesh, query_axes)
        work = {}
        for idx in np.ndindex(mesh.devices.shape):
            work.setdefault((q_of[idx], g_of[idx]), idx)
        self.work = sorted(work.items())          # query chunk, then block
        self.out_device = mesh.devices.flat[0]
        self._streams: dict = {}

    def _stream(self, idx):
        dev = self.mesh.devices[idx]
        if dev.type != "cuda":
            return None
        if idx not in self._streams:
            self._streams[idx] = torch.cuda.Stream(device=dev)
        return self._streams[idx]

    def __call__(self, sdb: ShardedDB, queries, lut=None):
        if sdb.graph_axes != self.graph_axes:
            raise ValueError(f"the DB is sharded over {sdb.graph_axes}; this "
                             f"search gathers over {self.graph_axes}")
        B = int(queries.shape[0])
        if B % self.n_query:
            raise ValueError(f"batch {B} must divide over the mesh's "
                             f"{self.n_query} query slots")
        bl = B // self.n_query
        queries = torch.as_tensor(queries, dtype=torch.float32)
        jobs = []
        for (q, _), idx in self.work:
            # each slot's rows moved from this thread, so the copies are
            # ordered after the caller's stream; the slot's stream then
            # waits for them
            dev = self.mesh.devices[idx]
            rows = slice(q * bl, (q + 1) * bl)
            qs = queries[rows].to(dev)
            lq = None if lut is None else lut[rows].to(dev)
            ready = None
            if dev.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
            jobs.append((idx, qs, lq, self._stream(idx), ready))

        def run(idx, qs, lq, stream, ready):
            ctx = contextlib.ExitStack()
            if stream is not None:
                ctx.enter_context(torch.cuda.device(stream.device))
                ctx.enter_context(torch.cuda.stream(stream))
                stream.wait_event(ready)
            with ctx:
                ids, ds, st = search_lanes(sdb.slots[idx][1], qs, self.p, lq)
                ids = ids.transpose(0, 1).reshape(bl, -1)    # [bl, P_loc*k]
                ds = ds.transpose(0, 1).reshape(bl, -1)
                calcs = st.dist_calcs.sum(0, dtype=torch.int32)
                done = None
                if stream is not None:
                    done = torch.cuda.Event()
                    done.record(stream)
            return ids, ds, calcs, done

        if len(jobs) == 1:
            outs = [run(*jobs[0])]
        else:
            with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
                futs = [ex.submit(run, *j) for j in jobs]
                outs = [f.result() for f in futs]
        # the all-gather: slot order on the first slot's device
        gathered = [[self._collect(t, done) for t in (ids, ds, calcs)]
                    for ids, ds, calcs, done in outs]
        per_q = [gathered[i * self.n_graph:(i + 1) * self.n_graph]
                 for i in range(self.n_query)]
        all_ids = torch.cat([torch.cat([g[0] for g in row], 1)
                             for row in per_q], 0)
        all_ds = torch.cat([torch.cat([g[1] for g in row], 1)
                            for row in per_q], 0)
        calcs = torch.cat([torch.stack([g[2] for g in row]).sum(
            0, dtype=torch.int32) for row in per_q], 0)
        if self.merge:
            order = torch.sort(all_ds, dim=1, stable=True).indices[
                :, :self.p.k]
            all_ids = all_ids.gather(1, order)
            all_ds = all_ds.gather(1, order)
        return all_ids, all_ds, calcs[:, None]

    def _collect(self, t, done):
        """A slot's result on the first slot's device, ordered after the
        slot's stream (and kept alive for the caller's)."""
        if done is not None:
            cur = torch.cuda.current_stream(t.device)
            cur.wait_event(done)
            t.record_stream(cur)
        return t.to(self.out_device)


def make_distributed_search(mesh, p: SearchParams, maxM0: int,
                            graph_axes=("model",), query_axes=None,
                            merge: bool = True):
    """The two-stage distributed search for a mesh (the reference's
    signature).

    graph_axes : mesh axes the partitions shard over (`shard_db` must
        have placed the DB over the same axes).
    query_axes : mesh axes the query batch splits over (e.g. ("data",));
        None -> every slot sees the whole batch. B must divide over them.
    merge : True -> (ids[B, k], dists[B, k], calcs[B, 1]) after the stage-2
        rank merge. False -> the gathered unmerged candidate pool
        (ids[B, P*k], dists[B, P*k], calcs[B, 1]) for an external rerank.
    For dtype="pq" the returned function takes a third argument, the
    per-query [B, M, 256] ADC LUT, split like the queries.
    calcs is the per-query distance-evaluation count summed over every
    partition on every slot (the Fig. 9 "vector reads")."""
    return DistributedSearch(mesh, p.resolve(maxM0), graph_axes,
                             query_axes or (), merge)
