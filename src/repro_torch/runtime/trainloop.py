"""Fault-tolerant training loop: resume, async checkpoints, straggler
watch (the reference's `runtime/trainloop.py`).

Restart discipline: data is a pure function of step (`data/pipeline.py`),
checkpoints carry the full {params, opt} state (in the reference's
layout, so either package resumes the other's), and no random state
leaks across steps, so a run killed at any point resumes bit-exactly
from its last committed checkpoint (tests/test_torch_train.py holds it
equal to an uninterrupted run).

Straggler mitigation: each step's wall time (to `torch.cuda.synchronize()`
on the card) is tracked with an EMA; a step slower than
`straggler_factor` x EMA is logged with its index and passed to
`on_straggler`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.data import batch_to_device
from repro_torch.models.model import make_train_state, train_step
from repro_torch.models.params import (
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["TrainLoop", "TrainLoopConfig"]


@dataclasses.dataclass
class TrainLoopConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


class TrainLoop:
    """`batch_fn(step)` gives the step's batch (numpy arrays or tensors,
    moved to the device here); the state starts from
    `make_train_state(cfg)` drawn from seed `seed` on `device` (default:
    the card; raises without one), or from the newest committed
    checkpoint under `loop_cfg.ckpt_dir`."""

    def __init__(self, cfg, opt_cfg: AdamWConfig, loop_cfg: TrainLoopConfig,
                 batch_fn: Callable[[int], dict], seed: int = 0,
                 on_straggler=None, log=print, device=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.loop = loop_cfg
        self.batch_fn = batch_fn
        self.device = resolve_device(device)
        self.ckpt = AsyncCheckpointer(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
        self.on_straggler = on_straggler or (lambda step, dt, ema: None)
        self.log = log
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.state = make_train_state(cfg, opt_cfg, device=self.device,
                                      generator=g)
        self.step = 0
        last = latest_step(loop_cfg.ckpt_dir)
        if last is not None:
            tree = restore_checkpoint(
                loop_cfg.ckpt_dir, last,
                train_state_to_reference(self.state, cfg))
            self.state = train_state_from_reference(tree, cfg,
                                                    device=self.device)
            self.step = last
            self.log(f"[resume] restored step {last} from "
                     f"{loop_cfg.ckpt_dir}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_steps: int, die_at_step: int | None = None):
        """Run until self.step == num_steps. `die_at_step` simulates a node
        failure (raises once that step's checkpoint is written)."""
        ema = None
        metrics = {}
        while self.step < num_steps:
            batch = batch_to_device(self.batch_fn(self.step), self.device)
            t0 = time.perf_counter()
            self.state, metrics = train_step(self.state, batch, self.cfg,
                                             self.opt_cfg)
            self._sync()
            dt = time.perf_counter() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > self.loop.straggler_factor * ema and self.step > 3:
                self.log(f"[straggler] step {self.step}: {dt:.3f}s "
                         f"(ema {ema:.3f}s)")
                self.on_straggler(self.step, dt, ema)
            self.step += 1
            if self.step % self.loop.log_every == 0:
                self.log(f"[train] step {self.step} "
                         f"loss {float(metrics['loss']):.4f} {dt * 1e3:.0f}ms")
            if self.step % self.loop.ckpt_every == 0 or \
                    self.step == num_steps:
                self.ckpt.save(self.step, train_state_to_reference(
                    self.state, self.cfg))
            if die_at_step is not None and self.step == die_at_step:
                self.ckpt.wait()
                raise RuntimeError(
                    f"simulated node failure at step {self.step}")
        self.ckpt.wait()
        return self.state, metrics
