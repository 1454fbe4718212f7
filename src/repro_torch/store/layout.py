"""On-disk layout of the restructured DB (paper Fig. 5) + the row reader.

`write_store` persists a PartitionedDB as fixed-stride row tables inside
one block-aligned data file, byte for byte the reference's layout
(src/repro/store/README.md has the byte-level diagram), so either package
opens the other's store; `StoreReader` is the serving-side object:
manifest + BlockFile + PageCache + optional Prefetcher, exposing
`read_rows(table, rows)` — the only way the search engine touches data, so
all traffic is block-granular and accounted.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hnsw_graph as hg
from repro_torch.core.partitioned import PartitionedDB
from repro_torch.obs.trace import TRACER
from repro_torch.store.blockfile import BlockFile, BlockFileWriter
from repro_torch.store.cache import PageCache
from repro_torch.store.prefetch import Prefetcher

__all__ = ["write_store", "StoreReader", "open_store"]


def _partition_starts(db: hg.DeviceDB) -> list[int] | None:
    """First global id of each partition, when ids are contiguous ranges
    (build_partitioned_db always produces these). Enables the O(1)
    global-id -> (partition, local-row) mapping stage-2 rerank needs;
    None disables store-side rerank for exotic id layouts."""
    gids = np.asarray(db.gids)
    if gids.ndim == 1:
        gids = gids[None]
    n_valid = np.atleast_1d(np.asarray(db.n_valid))
    starts = []
    for p in range(gids.shape[0]):
        n = int(n_valid[p])
        g = gids[p, :n]
        if n == 0 or not np.array_equal(g, np.arange(g[0], g[0] + n)):
            return None
        starts.append(int(g[0]))
    return starts


def write_store(path: str, pdb: PartitionedDB, block_size: int = 4096,
                extra_tables: dict | None = None) -> None:
    """Persist the stacked DeviceDB as a committed block store.

    `extra_tables` appends additional fixed-stride row tables after the
    canonical set (e.g. the PQ store's `rerank_vectors` float32 table).
    `load_db` ignores them; they are only reachable through
    `StoreReader.read_rows`. The DB's leaves may be numpy arrays or
    tensors on any device."""
    db = to_host(pdb.db)
    tables, meta = hg.db_to_tables(db)
    meta.update({
        "dim": int(pdb.dim),
        "partition_starts": _partition_starts(db),
    })
    w = BlockFileWriter(path, block_size=block_size)
    try:
        for name in hg.TABLE_ORDER:
            w.add_table(name, tables[name])
        for name, rows in (extra_tables or {}).items():
            w.add_table(name, np.ascontiguousarray(rows))
    except BaseException:
        w.abort()
        raise
    w.finalize(meta)


def to_host(db: hg.DeviceDB) -> hg.DeviceDB:
    """The DB with every leaf a host numpy array."""
    return hg.DeviceDB(*(x.cpu().numpy() if isinstance(x, torch.Tensor)
                         else np.asarray(x) for x in db))


class StoreReader:
    """Row-granular reads over the block store, through the page cache.

    n_pad/d_pad/... mirror the DeviceDB geometry; `read_rows` returns host
    arrays assembled from cached blocks. All counters live on `self.cache`.
    """

    def __init__(self, path: str, cache_bytes: int, prefetch: bool = True):
        self.path = path
        self.blockfile = BlockFile(path)
        self.cache = PageCache(self.blockfile, cache_bytes)
        self.prefetcher = Prefetcher(self.cache) if prefetch else None
        self.meta = self.blockfile.meta
        self.block_size = self.blockfile.block_size
        for k in ("num_partitions", "n_pad", "d_pad", "m0_pad", "n_layers",
                  "up_pad", "m_pad", "dim"):
            setattr(self, k, int(self.meta[k]))
        self.entry = np.asarray(self.meta["entry"], np.int32)
        self.max_level = np.asarray(self.meta["max_level"], np.int32)
        self.n_valid = np.asarray(self.meta["n_valid"], np.int32)
        ps = self.meta.get("partition_starts")
        self.partition_starts = None if ps is None else np.asarray(ps, np.int64)

    # -- row addressing ------------------------------------------------------

    def row(self, table: str, p: int, i) -> np.ndarray:
        """Row index of point(s) i of partition p in a per-point table."""
        return np.asarray(i, np.int64) + p * self.n_pad

    def up_row(self, p: int, layer: int, r) -> np.ndarray:
        """Row index into the upper-list table for (partition, layer, slot)."""
        return np.asarray(r, np.int64) + (p * self.n_layers + layer) * self.up_pad

    def blocks_of_rows(self, table: str, rows) -> list[int]:
        """The blocks the rows span, each once, in first-touch order (the
        reference's order: row by row, each row's blocks ascending).
        Vectorized over the rows; the row spans are `BlockFile.row_span`'s
        arithmetic."""
        t = self.blockfile.tables[table]
        bs, rb = self.block_size, t["row_bytes"]
        start = t["offset"] + np.asarray(rows, np.int64).ravel() * rb
        b0 = start // bs
        span = (start + rb - 1) // bs - b0 + 1
        blocks = np.repeat(b0, span) + (np.arange(int(span.sum()))
                                        - np.repeat(np.cumsum(span) - span,
                                                    span))
        _, first = np.unique(blocks, return_index=True)
        return blocks[np.sort(first)].tolist()

    # -- reads ---------------------------------------------------------------

    def read_rows(self, table: str, rows, _get=None) -> np.ndarray:
        """Gather rows (any shape of indices) -> array [..., cols].

        Duplicate rows inside one request are fetched once (the engine
        batches a whole hop's gathers into one call — the paper's wide
        block read). The blocks are read in the reference's order and the
        rows cut from them with one vectorized gather: the rows are sorted
        and unique, so their blocks arrive ascending and a row's blocks
        sit side by side in the joined buffer."""
        t = self.blockfile.tables[table]
        idx = np.asarray(rows, np.int64)
        flat = idx.ravel()
        dtype = np.dtype(t["dtype"])
        cols, bs = t["cols"], self.block_size
        uniq, inv = np.unique(flat, return_inverse=True)
        need = self.blocks_of_rows(table, uniq)
        # child_span: only records under an already-sampled span on this
        # thread — prefetcher-worker calls (and untraced callers) stay free.
        with TRACER.child_span("store-read", table=table, rows=len(uniq),
                               blocks=len(need)):
            if _get is None:
                blocks = self.cache.get_many(need)
            else:
                blocks = {b: _get(b) for b in need}
        rb = t["row_bytes"]
        if len(uniq) == 0:
            out = np.empty((0, cols), dtype)
        else:
            buf = np.frombuffer(b"".join(blocks[b] for b in need), np.uint8)
            start = t["offset"] + uniq * rb
            b0 = start // bs
            pos = (np.searchsorted(np.asarray(need, np.int64), b0) * bs
                   + start - b0 * bs)
            out = buf[pos[:, None] + np.arange(rb)].view(dtype).reshape(
                len(uniq), cols)
        return out[inv].reshape(idx.shape + (cols,))

    # -- prefetch hooks ------------------------------------------------------

    def prefetch_rows(self, table: str, rows) -> None:
        if self.prefetcher is not None:
            self.prefetcher.prefetch_blocks(self.blocks_of_rows(table, rows))

    def prefetch_next_hop(self, p: int, cand_ids: np.ndarray) -> None:
        """Chained next-hop prefetch: pull the l0 neighbor-list rows of the
        likely next pops, parse them on the worker, then pull the vector
        blocks those neighbors live in — all overlapped with device compute."""
        if self.prefetcher is None:
            return
        cand = [int(c) for c in np.asarray(cand_ids).ravel() if c >= 0]
        if not cand:
            return
        l0_blocks = self.blocks_of_rows("l0_nbrs", self.row("l0_nbrs", p, cand))

        def task():
            for b in l0_blocks:
                self.cache.prefetch(b)
            nbrs = self._parse_l0_rows(p, cand)
            if len(nbrs):
                vec_rows = self.row("vectors", p, nbrs)
                for b in self.blocks_of_rows("vectors", vec_rows):
                    self.cache.prefetch(b)

        self.prefetcher.submit(task)

    def _parse_l0_rows(self, p: int, ids) -> np.ndarray:
        """Worker-side decode of the just-prefetched l0 rows; traffic counts
        as prefetch, never as demand."""
        rows = self.read_rows("l0_nbrs", self.row("l0_nbrs", p, ids),
                              _get=self.cache.prefetch_get)
        flat = rows.ravel()
        return np.unique(flat[flat >= 0])

    # -- lifecycle / debug ---------------------------------------------------

    def load_db(self) -> hg.DeviceDB:
        """Materialize the full DeviceDB in host memory (tests and small
        stores only — this defeats the out-of-core purpose by design)."""
        tables = {}
        for name, t in self.blockfile.tables.items():
            tables[name] = self.read_rows(name, np.arange(t["rows"]))
        return hg.db_from_tables(tables, self.meta)

    def close(self) -> None:
        if self.prefetcher is not None:
            self.prefetcher.close()
            self.prefetcher = None


def open_store(path: str, cache_bytes: int, prefetch: bool = True) -> StoreReader:
    return StoreReader(path, cache_bytes, prefetch=prefetch)
