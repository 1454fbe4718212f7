"""Block-aligned storage file: the repo's stand-in for SmartSSD flash.

One store = one directory:

    <dir>/blocks.bin            all tables, each region block-aligned
    <dir>/store_manifest.json   block size, table directory, engine meta
    <dir>/_COMMITTED            written last — a partial write is never
                                readable (same contract as repro.checkpoint)

The unit of I/O is the *block* (default 4 KiB — the paper's flash page):
`BlockFile.read_block` returns exactly one block and is the only way data
leaves the file, so counting calls == counting flash reads / P2P-DMA
transfers. Tables are fixed-stride row arrays (paper Fig. 5); each table
region starts on a block boundary so a row's blocks are computable from its
index alone — the "one access per point" property carried to storage.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

__all__ = ["BlockFileWriter", "BlockFile", "StoreFormatError",
           "DATA_NAME", "MANIFEST_NAME", "COMMIT_NAME", "FORMAT"]

DATA_NAME = "blocks.bin"
MANIFEST_NAME = "store_manifest.json"
COMMIT_NAME = "_COMMITTED"
FORMAT = "repro-block-store-v1"


class StoreFormatError(RuntimeError):
    """Raised when a store directory is missing, uncommitted, or corrupt."""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BlockFileWriter:
    """Writes tables into a block-aligned data file, then commits.

    Usage:
        w = BlockFileWriter(path, block_size=4096)
        w.add_table("vectors", arr2d)          # row-major [R, C]
        w.finalize(meta)                       # manifest + commit marker
    """

    def __init__(self, path: str, block_size: int = 4096):
        if block_size <= 0 or block_size % 512:
            raise ValueError(f"block_size must be a positive multiple of "
                             f"512, got {block_size}")
        self.path = path
        self.block_size = block_size
        self._tables: dict[str, dict] = {}
        os.makedirs(path, exist_ok=True)
        # a re-written store must never look committed mid-write
        for name in (COMMIT_NAME, MANIFEST_NAME):
            p = os.path.join(path, name)
            if os.path.exists(p):
                os.remove(p)
        self._f = open(os.path.join(path, DATA_NAME), "wb")
        self._offset = 0

    def add_table(self, name: str, rows: np.ndarray) -> None:
        """Append one fixed-stride row table, padded to a block boundary."""
        if name in self._tables:
            raise ValueError(f"duplicate table {name!r}")
        rows = np.ascontiguousarray(rows)
        if rows.ndim != 2:
            raise ValueError(f"table {name!r} must be 2-D [rows, cols], "
                             f"got shape {rows.shape}")
        raw = rows.tobytes()
        self._tables[name] = {
            "offset": self._offset,
            "rows": int(rows.shape[0]),
            "cols": int(rows.shape[1]),
            "row_bytes": int(rows.strides[0]) if rows.shape[0] else
                         int(rows.shape[1] * rows.itemsize),
            "dtype": str(rows.dtype),
            "nbytes": len(raw),
        }
        self._f.write(raw)
        padded = _round_up(len(raw), self.block_size)
        self._f.write(b"\0" * (padded - len(raw)))
        self._offset += padded

    def finalize(self, meta: dict | None = None) -> None:
        """Flush data, write the manifest, then the commit marker (last)."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        manifest = {
            "format": FORMAT,
            "block_size": self.block_size,
            "num_blocks": self._offset // self.block_size,
            "tables": self._tables,
            "meta": meta or {},
        }
        with open(os.path.join(self.path, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(self.path, COMMIT_NAME), "w") as f:
            f.write("ok")

    def abort(self) -> None:
        self._f.close()
        shutil.rmtree(self.path, ignore_errors=True)


class BlockFile:
    """Read side: memory-mapped, strictly block-granular access.

    `read_block(i)` is one emulated flash read. Nothing else reads the data
    file, so callers (the PageCache) fully account the storage traffic.
    """

    def __init__(self, path: str):
        if not os.path.exists(os.path.join(path, COMMIT_NAME)):
            raise StoreFormatError(
                f"store at {path!r} has no commit marker — refusing to read "
                f"a partial or crashed write")
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise StoreFormatError(
                f"store at {path!r} has format "
                f"{self.manifest.get('format')!r}; this build reads {FORMAT!r}")
        self.path = path
        self.block_size = int(self.manifest["block_size"])
        self.num_blocks = int(self.manifest["num_blocks"])
        self.tables = self.manifest["tables"]
        self.meta = self.manifest["meta"]
        data = os.path.join(path, DATA_NAME)
        expect = self.num_blocks * self.block_size
        if os.path.getsize(data) < expect:
            raise StoreFormatError(
                f"store at {path!r}: data file is "
                f"{os.path.getsize(data)} bytes, manifest expects {expect}")
        self._mm = np.memmap(data, dtype=np.uint8, mode="r")

    def read_block(self, idx: int) -> bytes:
        """One flash read: returns exactly one block."""
        if not 0 <= idx < self.num_blocks:
            raise IndexError(f"block {idx} out of range [0, {self.num_blocks})")
        lo = idx * self.block_size
        return self._mm[lo:lo + self.block_size].tobytes()

    def row_span(self, table: str, row: int) -> tuple[int, int]:
        """[start, end) byte span of one table row — the single source of
        row-addressing truth; every reader derives blocks and slices from
        it so layout changes cannot desynchronize fetch and decode."""
        t = self.tables[table]
        start = t["offset"] + row * t["row_bytes"]
        return start, start + t["row_bytes"]

    def blocks_of_row(self, table: str, row: int) -> range:
        """Block indices a given table row spans."""
        start, end = self.row_span(table, row)
        return range(start // self.block_size,
                     (end - 1) // self.block_size + 1)
