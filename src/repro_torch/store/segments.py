"""Segment directory of a *mutable* block store (repro.ingest's flash side).

An immutable store is one block file (`store/blockfile.py`). A mutable
index instead owns a directory of them — one committed block store per
sealed segment — plus one `segments.json` naming the live set:

    <dir>/segments.json         {"format": ..., "version": N,
                                 "segments": ["seg_00000000", ...]}
    <dir>/seg_00000000/         a normal committed block store
    <dir>/seg_00000001/         ...

Append-only by construction: sealing a memtable writes a NEW segment store
(its own data file, manifest, and commit marker — existing segment blocks
are never rewritten) and then atomically swaps `segments.json` to include
it. Compaction writes the merged segment the same way and swaps the old
names out in one manifest update; only after the swap are the dead
segment directories deleted. A crash at any point leaves either the old
or the new manifest, both of which name only fully-committed stores.
"""

from __future__ import annotations

import json
import os
import shutil

from repro_torch.store.blockfile import COMMIT_NAME, StoreFormatError

__all__ = ["SEGMENTS_MANIFEST", "SEGMENTS_FORMAT", "segment_dir",
           "list_segments", "append_segment", "replace_segments"]

SEGMENTS_MANIFEST = "segments.json"
SEGMENTS_FORMAT = "repro-segmented-store-v1"


def segment_dir(path: str, name: str) -> str:
    """The on-disk directory of one named segment store."""
    return os.path.join(path, name)


def _read(path: str) -> dict:
    mf = os.path.join(path, SEGMENTS_MANIFEST)
    if not os.path.exists(mf):
        return {"format": SEGMENTS_FORMAT, "version": 0, "segments": []}
    with open(mf) as f:
        manifest = json.load(f)
    if manifest.get("format") != SEGMENTS_FORMAT:
        raise StoreFormatError(
            f"segmented store at {path!r} has format "
            f"{manifest.get('format')!r}; this build reads "
            f"{SEGMENTS_FORMAT!r}")
    return manifest


def _write(path: str, manifest: dict) -> None:
    """Atomic manifest swap: full tmp write + fsync + rename."""
    os.makedirs(path, exist_ok=True)
    mf = os.path.join(path, SEGMENTS_MANIFEST)
    tmp = mf + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, mf)


def list_segments(path: str) -> list[str]:
    """Live segment names, in append order (oldest first)."""
    return list(_read(path)["segments"])


def _check_committed(path: str, name: str) -> None:
    if not os.path.exists(os.path.join(segment_dir(path, name), COMMIT_NAME)):
        raise StoreFormatError(
            f"segment {name!r} under {path!r} has no commit marker — "
            f"refusing to publish a partial write")


def append_segment(path: str, name: str) -> list[str]:
    """Publish one newly-written (committed) segment store; returns the
    live set. Existing segment blocks are untouched — this is the
    append-friendly grow path of the mutable index."""
    manifest = _read(path)
    if name in manifest["segments"]:
        raise ValueError(f"segment {name!r} already published")
    _check_committed(path, name)
    manifest["segments"].append(name)
    manifest["version"] += 1
    _write(path, manifest)
    return list(manifest["segments"])


def replace_segments(path: str, old: list[str], new: list[str]) -> list[str]:
    """Compaction commit: atomically swap `old` names for `new` ones, then
    reclaim the dead segment directories. The manifest swap is the commit
    point — a crash before it keeps the old set, after it the new one."""
    manifest = _read(path)
    live = manifest["segments"]
    missing = [s for s in old if s not in live]
    if missing:
        raise ValueError(f"cannot replace unpublished segments {missing}")
    for name in new:
        _check_committed(path, name)
    manifest["segments"] = [s for s in live if s not in old] + list(new)
    manifest["version"] += 1
    _write(path, manifest)
    for name in old:                       # space reclaim, post-commit
        shutil.rmtree(segment_dir(path, name), ignore_errors=True)
    return list(manifest["segments"])
