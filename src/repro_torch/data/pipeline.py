"""Deterministic synthetic data pipelines (numpy).

A copy of the reference's data pipeline: the output is byte-identical for
the same arguments, so both packages index, and train on, the same data.

Determinism contract: a batch is a pure function of (seed, step),
independent of worker count or restart point. This is what makes a
checkpoint restart bit-exact (`runtime/trainloop.py`): a restarted job
replays the exact token stream.

Vectors mirror SIFT's statistics (128-dim uint8-range features,
clustered) so recall numbers are meaningful without the dataset download.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading

import numpy as np
import torch

__all__ = ["Prefetcher", "TokenDataset", "VectorDataset", "batch_to_device",
           "clustered_vectors", "make_batch", "sift_like_vectors"]


@dataclasses.dataclass
class TokenDataset:
    """Synthetic LM token stream with Zipfian unigram statistics plus a
    repeated-ngram structure so the loss actually decreases."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_output_heads: int = 1

    def batch(self, step: int, shard: int = 0, num_shards: int = 1):
        """Per-step batch; `shard` selects this host's slice."""
        assert self.global_batch % num_shards == 0
        b = self.global_batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        # Zipf over vocab, clipped.
        raw = rng.zipf(1.3, size=(b, self.seq_len + 1, self.num_output_heads))
        toks = (raw % self.vocab_size).astype(np.int32)
        # inject copy structure: second half repeats the first half shifted.
        half = self.seq_len // 2
        toks[:, half: 2 * half] = toks[:, :half]
        if self.num_output_heads == 1:
            toks = toks[..., 0]
            return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        return {"inputs": toks[:, :-1, 0], "labels": toks[:, 1:, :]}


@dataclasses.dataclass
class VectorDataset:
    """Clustered feature vectors (SIFT-like)."""

    n: int
    dim: int = 128
    n_clusters: int = 64
    seed: int = 0

    def vectors(self) -> np.ndarray:
        return clustered_vectors(self.n, self.dim, self.n_clusters, self.seed)

    def queries(self, n_q: int, seed: int = 1) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, seed]))
        centers = _centers(self.n_clusters, self.dim, self.seed)
        idx = rng.integers(0, self.n_clusters, n_q)
        return (centers[idx] + rng.normal(scale=12.0, size=(n_q, self.dim))
                ).astype(np.float32)


def _centers(k: int, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC]))
    return rng.uniform(0, 218, size=(k, dim)).astype(np.float32)


def clustered_vectors(n: int, dim: int = 128, k: int = 64, seed: int = 0):
    """SIFT-like: non-negative, bounded [0, 255], clustered."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    centers = _centers(k, dim, seed)
    idx = rng.integers(0, k, n)
    out = centers[idx] + rng.normal(scale=12.0, size=(n, dim))
    return np.clip(out, 0, 255).astype(np.float32)


def sift_like_vectors(n: int, seed: int = 0) -> np.ndarray:
    return clustered_vectors(n, 128, max(8, n // 2000), seed)


def make_batch(cfg, shape_kind: str, seq: int, batch: int, step: int = 0,
               seed: int = 0):
    """Concrete numpy batch for a ModelConfig (embeddings for a config
    without embed_inputs)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.embed_inputs:
        ds = TokenDataset(cfg.vocab_size, seq, batch, seed,
                          cfg.num_output_heads)
        return ds.batch(step)
    emb = rng.normal(scale=0.02, size=(batch, seq, cfg.d_model)).astype(
        np.float32)
    if cfg.num_output_heads == 1:
        labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    else:
        labels = rng.integers(0, cfg.vocab_size,
                              (batch, seq, cfg.num_output_heads)).astype(
                                  np.int32)
    out = {"inputs": emb, "labels": labels}
    if cfg.prefix_lm:
        out["prefix_len"] = np.int32(min(256, seq // 4))
    return out


def batch_to_device(batch: dict, device) -> dict:
    """A `make_batch` dict as tensors on `device`: arrays become tensors,
    a 0-d entry (`prefix_len`) a Python int."""
    out = {}
    for name, value in batch.items():
        if np.ndim(value) == 0:
            out[name] = int(value)
            continue
        t = value if torch.is_tensor(value) else torch.as_tensor(value)
        out[name] = t.to(device)
    return out


class Prefetcher:
    """Background-thread batch prefetch (depth-bounded queue)."""

    def __init__(self, fn, depth: int = 2, start_step: int = 0):
        self._fn = fn
        self._q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                self._q.put(self._fn(self._step), timeout=0.5)
                self._step += 1
            except _queue.Full:
                continue

    def get(self):
        return self._q.get()

    def close(self):
        self._stop.set()
