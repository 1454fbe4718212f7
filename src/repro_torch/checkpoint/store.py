"""Versioned checkpoint steps, in the reference package's on-disk format.

Layout:   <dir>/step_<N>/            (N zero-padded to 8 digits)
            manifest.json          {step, leaves: [{path, file, shape, dtype}]}
            <sha1(path)[:16]>.npy  one file per leaf of the state tree
            _COMMITTED             written last — a crash mid-save never
                                   yields a step that a loader will read

Leaf paths are the '/'-joined keys of the nested state dict in sorted key
order, exactly as the reference names them, so each package opens the
other's saved steps. A bf16 leaf is widened to float32 on disk (exact,
and .npy-portable) with "bfloat16" in the manifest, as the reference
writes its bf16 leaves; a restore narrows it back to the leaf it fills.
A train state is saved in the reference's tree layout
(`models.params.train_state_to_reference`).

`AsyncCheckpointer` overlaps the writes with training: the copy to the
host runs on the caller's thread (ordered, and taken before the next
step changes the state), the save and the garbage collection of old
steps on a worker thread; a worker's error is raised by the next
`wait()` (or `save()`).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

__all__ = ["AsyncCheckpointer", "latest_step", "list_steps",
           "restore_checkpoint", "save_checkpoint", "step_dir"]


def step_dir(ckpt_dir: str, step: int) -> str:
    """The canonical on-disk directory of one checkpoint step."""
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def list_steps(ckpt_dir: str, committed_only: bool = True) -> list[int]:
    """Ascending numbers of the steps under `ckpt_dir`: the committed ones,
    or with committed_only=False every step directory (the GC's view)."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if committed_only and not os.path.exists(
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


def _host(leaf):
    """(numpy array as saved, the manifest's dtype name): bf16 (a tensor,
    or a numpy extension dtype) widened to float32 under its own name."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.float().numpy(), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub":
        return arr.astype(np.float32), str(arr.dtype)
    return arr, str(arr.dtype)


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
        arr, dtype = _host(leaf)
        fname = _leaf_name(key)
        manifest["leaves"].append(
            {"path": key, "file": fname, "shape": list(arr.shape),
             "dtype": dtype})
        np.save(os.path.join(tmp, fname + ".npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.replace(tmp, d)
    return d


def _torch_dtype(like) -> torch.dtype:
    if isinstance(like, torch.Tensor):
        return like.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(like).dtype)).dtype


def restore_checkpoint(ckpt_dir: str, step: int, like_tree, *, device=None):
    """The saved step as a tree of tensors shaped as `like_tree` (nested
    dicts of tensors or arrays): each leaf in its `like` leaf's dtype
    (narrowed back where it was widened on disk, exactly), on `device`, or
    where the `like` leaf lives (the CPU for an array). A leaf missing or
    of another shape raises."""
    d = step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}

    def load(tree, prefix: str):
        if isinstance(tree, dict):
            return {k: load(v, f"{prefix}{k}/") for k, v in tree.items()}
        key = prefix[:-1]
        if key not in by_path:
            raise KeyError(f"checkpoint step {step} has no leaf {key!r}")
        arr = np.load(os.path.join(d, by_path[key]["file"] + ".npy"))
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"{key}: saved shape {arr.shape}, expected "
                             f"{tuple(tree.shape)}")
        dev = device if device is not None else (
            tree.device if isinstance(tree, torch.Tensor) else "cpu")
        return torch.from_numpy(arr).to(device=dev,
                                        dtype=_torch_dtype(tree))

    return load(like_tree, "")


class AsyncCheckpointer:
    """Checkpoint writes overlapped with training (see the module's
    docstring); `keep` is how many of the newest steps the GC keeps."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._err: Exception | None = None

    def save(self, step: int, tree):
        self.wait()
        host_tree = _copy_to_host(tree)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree)
                self._gc()
            except Exception as e:  # raised by the next wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _gc(self):
        steps = list_steps(self.ckpt_dir, committed_only=False)
        for s in steps[: -self.keep]:
            shutil.rmtree(step_dir(self.ckpt_dir, s), ignore_errors=True)


def _copy_to_host(tree):
    """A copy of the tree on the host that later in-place updates of the
    live tensors cannot reach."""
    if isinstance(tree, dict):
        return {k: _copy_to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)
