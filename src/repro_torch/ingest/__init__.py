"""repro_torch.ingest — mutable segmented index over the immutable engines,
the port of the reference's `repro.ingest`.

The paper serves a static SIFT1B index; this package opens the dynamic-
workload scenario class (databases that grow and churn while serving) as
an LSM-style composition of the pieces the port already has:

  memtable   : small mutable head — exact-scanned, incrementally graphed
               via the `insert_point` routine factored out of `build_hnsw`
  segments   : sealed immutable segments — each one a normal SearchService
               ("a segment is just one more partition"); csd segments are
               appended to the block store, never rewriting existing blocks
  tombstones : deletes as a packed bitmap consulted at result-merge time
  compactor  : merge small segments + tombstones into one rebuilt segment
  service    : MutableSearchService — insert/delete/flush/compact/search,
               manifest v2 save/load, byte-compatible with the reference's
               (also exported from repro_torch.api)

The reference's `src/repro/ingest/README.md` describes the segment
lifecycle.
"""

from repro_torch.ingest.compactor import compact_segments, merge_survivors
from repro_torch.ingest.memtable import Memtable
from repro_torch.ingest.segments import Segment, build_segment, seal_memtable
from repro_torch.ingest.service import (
    MUTABLE_FORMAT_VERSION,
    MutableSearchService,
)
from repro_torch.ingest.tombstones import TombstoneSet

__all__ = [
    "MUTABLE_FORMAT_VERSION",
    "MutableSearchService",
    "Memtable",
    "Segment",
    "TombstoneSet",
    "build_segment",
    "seal_memtable",
    "compact_segments",
    "merge_survivors",
]
