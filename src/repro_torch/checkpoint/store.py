"""Versioned checkpoint steps, in the reference package's on-disk format.

Layout:   <dir>/step_<N>/            (N zero-padded to 8 digits)
            manifest.json          {step, leaves: [{path, file, shape, dtype}]}
            <sha1(path)[:16]>.npy  one file per leaf of the state tree
            _COMMITTED             written last — a crash mid-save never
                                   yields a step that a loader will read

Leaf paths are the '/'-joined keys of the nested state dict in sorted key
order, exactly as the reference names them, so each package opens the
other's saved steps.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

__all__ = ["save_checkpoint", "latest_step", "step_dir", "list_steps"]


def step_dir(ckpt_dir: str, step: int) -> str:
    """The canonical on-disk directory of one checkpoint step."""
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def list_steps(ckpt_dir: str) -> list[int]:
    """Ascending numbers of the committed steps under `ckpt_dir`."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(
                os.path.join(ckpt_dir, name, "_COMMITTED")):
            continue
        steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _leaf_name(path: str) -> str:
    return hashlib.sha1(path.encode()).hexdigest()[:16]


def _flatten(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Blocking save of a nested dict of arrays / tensors. Returns the
    step directory."""
    d = step_dir(ckpt_dir, step)
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for key, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        fname = _leaf_name(key)
        manifest["leaves"].append(
            {"path": key, "file": fname, "shape": list(arr.shape),
             "dtype": str(arr.dtype)})
        np.save(os.path.join(tmp, fname + ".npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.replace(tmp, d)
    return d
