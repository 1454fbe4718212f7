"""repro_torch.store — the block-aligned storage-resident vector/graph
store and the out-of-core `csd` backend, ported from `repro.store`.

The paper's database lives on SmartSSD flash and reaches the accelerator
as block-granular reads; this package models that tier so datasets
larger than host memory are a supported scenario:

  blockfile : block-aligned data file + manifest + commit marker
  cache     : LRU PageCache with hit/miss/bytes-read counters (Fig. 9's
              "number of vector reads" for the storage tier)
  prefetch  : async next-hop prefetcher overlapping flash reads with compute
  layout    : paper Fig. 5 table layout + the row-granular StoreReader
  csd       : the out-of-core two-stage engine, registered as the `csd`
              backend of repro_torch.api; its hop functions run on the
              index's device
  segments  : segment directory of a mutable store: one committed block
              store per sealed segment + an atomically swapped
              segments.json

The on-disk formats are the reference's byte for byte: either package
opens a store the other wrote.
"""

from repro_torch.store.blockfile import (
    BlockFile,
    BlockFileWriter,
    StoreFormatError,
)
from repro_torch.store.cache import PageCache
from repro_torch.store.csd import CSDBackend, store_search
from repro_torch.store.layout import StoreReader, open_store, write_store
from repro_torch.store.prefetch import Prefetcher
from repro_torch.store.segments import (
    append_segment,
    list_segments,
    replace_segments,
    segment_dir,
)

__all__ = [
    "append_segment",
    "list_segments",
    "replace_segments",
    "segment_dir",
    "BlockFile",
    "BlockFileWriter",
    "StoreFormatError",
    "PageCache",
    "Prefetcher",
    "StoreReader",
    "open_store",
    "write_store",
    "CSDBackend",
    "store_search",
]
