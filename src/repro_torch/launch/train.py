"""End-to-end training launcher (the reference's `launch/train.py`): a
REDUCED or full architecture on deterministic data, AdamW, per-period
remat, async checkpoints, resume after a failure.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
      --reduced --steps 200 --ckpt-dir <dir> [--device cpu]

Runs on the card unless `--device cpu` is given. A second call with the
same --ckpt-dir resumes from its newest committed step.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, reduced_config
from repro_torch.data import make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import TrainLoop, TrainLoopConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--die-at-step", type=int, default=None,
                    help="simulate a node failure (for FT demos)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1))
    loop_cfg = TrainLoopConfig(ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every)

    def batch_fn(step: int):
        return make_batch(cfg, "train", args.seq, args.batch, step=step,
                          seed=args.seed)

    loop = TrainLoop(cfg, opt, loop_cfg, batch_fn, seed=args.seed,
                     device=args.device)
    state, metrics = loop.run(args.steps, die_at_step=args.die_at_step)
    print(f"final step {loop.step} loss {float(metrics['loss']):.4f}")
    return state


if __name__ == "__main__":
    main()
