"""Memtable: the small mutable head of a segmented index.

Absorbs `insert()` calls two ways at once, both below a seal threshold:

  * the vectors land in a growable host array that is **exact-scanned** at
    query time with the same chunked brute-force scan the `exact` backend
    uses (`core.bruteforce.bruteforce_topk`, identical CHUNK padding),
    on the service's device — so a memtable answer is bit-identical to an
    `exact`-backend segment over the same rows;
  * every insert is also fed through `core.hnsw_graph.GraphBuilder.
    insert_point` — the insertion routine factored out of `build_hnsw` —
    so by the time the memtable seals, its HNSW graph already exists and
    sealing is a pure `restructure()` (no O(n²·log n) rebuild pause).

Deletes are NOT applied here (tombstones filter at merge time); sealing
drops dead rows, so a tombstoned memtable row never reaches a segment.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hnsw_graph as hg
from repro_torch.core.bruteforce import bruteforce_topk

__all__ = ["Memtable"]

_CHUNK = 512        # ExactBackend.CHUNK — keep the scan bit-identical


class Memtable:
    """Growable (vectors, global-ids) buffer + incremental HNSW graph."""

    def __init__(self, dim: int, cfg: hg.HNSWConfig, build_graph: bool = True):
        self.dim = int(dim)
        self.cfg = cfg
        self.build_graph = build_graph
        self._gids = np.full(64, -1, np.int64)
        self.n = 0
        # graph memtables read their vectors out of the builder's own
        # table — one resident copy, not two (the memory bound counts it)
        self._builder = (hg.GraphBuilder(self.dim, cfg) if build_graph
                         else None)
        self._vectors = (None if build_graph
                         else np.zeros((64, self.dim), np.float32))

    def __len__(self) -> int:
        return self.n

    @property
    def nbytes(self) -> int:
        """Resident bytes (vector table + id map + builder link tables)."""
        total = self._gids.nbytes
        if self._builder is not None:
            b = self._builder
            total += (b._vectors.nbytes + b._levels.nbytes + b._l0.nbytes
                      + b._up_ptr.nbytes + b._up.nbytes)
        else:
            total += self._vectors.nbytes
        return total

    # -- writes --------------------------------------------------------------

    def insert(self, vectors: np.ndarray, gids: np.ndarray) -> None:
        vectors = np.ascontiguousarray(vectors, np.float32)
        gids = np.asarray(gids, np.int64)
        assert vectors.shape == (len(gids), self.dim)
        need = self.n + len(gids)
        if need > self._gids.shape[0]:
            cap = max(need, 2 * self._gids.shape[0])
            gg = np.full(cap, -1, np.int64)
            gg[: self.n] = self._gids[: self.n]
            self._gids = gg
        if self._vectors is not None and need > self._vectors.shape[0]:
            cap = max(need, 2 * self._vectors.shape[0])
            vg = np.zeros((cap, self.dim), np.float32)
            vg[: self.n] = self._vectors[: self.n]
            self._vectors = vg
        if self._vectors is not None:
            self._vectors[self.n: need] = vectors
        self._gids[self.n: need] = gids
        self.n = need
        if self._builder is not None:
            for row in vectors:
                self._builder.insert_point(row)

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """(vectors[n, D], gids[n]) copies — the search-time view."""
        vecs = (self._builder._vectors if self._builder is not None
                else self._vectors)
        return (vecs[: self.n].copy(), self._gids[: self.n].copy())

    @staticmethod
    def scan(vectors: np.ndarray, gids: np.ndarray, queries: np.ndarray,
             k: int, metric: str, device) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k over a (vectors, gids) snapshot on `device`; ids are
        GLOBAL, returned on the host. Pads to the same CHUNK multiples as
        the exact backend so a sealed exact segment answers bit-identically
        to the memtable it came from. Static so searches run on lock-free
        snapshots."""
        b = np.asarray(queries, np.float32).shape[0]
        n = vectors.shape[0]
        if n == 0:
            return (np.full((b, k), -1, np.int64),
                    np.full((b, k), np.inf, np.float32))
        n_pad = ((n + _CHUNK - 1) // _CHUNK) * _CHUNK
        vp = np.zeros((n_pad, vectors.shape[1]), np.float32)
        vp[:n] = vectors
        sq = np.full(n_pad, np.inf, np.float32)
        sq[:n] = np.einsum("nd,nd->n", vectors, vectors)
        k_eff = min(k, n, _CHUNK)
        on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        ids, dists = bruteforce_topk(on(vp), on(sq),
                                     on(np.asarray(queries, np.float32)),
                                     k=k_eff, chunk=_CHUNK, metric=metric)
        ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
        out_i = np.full((b, k), -1, np.int64)
        out_d = np.full((b, k), np.inf, np.float32)
        valid = ids >= 0
        out_i[:, :k_eff] = np.where(valid, np.asarray(gids, np.int64)[
            np.maximum(ids, 0)], -1)
        out_d[:, :k_eff] = dists
        return out_i, out_d

    def search(self, queries: np.ndarray, k: int, metric: str, device
               ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k over the current rows (convenience wrapper)."""
        vecs, gids = self.snapshot()
        return self.scan(vecs, gids, queries, k, metric, device)

    def graph(self) -> hg.HostGraph:
        """The incrementally-built HNSW graph over the current rows."""
        if self._builder is None:
            raise ValueError("memtable was created with build_graph=False")
        return self._builder.graph()
