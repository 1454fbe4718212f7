"""Fault-tolerance demo on the PyTorch port: train, die, resume —
bit-exact continuation.

Trains REDUCED qwen3-14b, simulates a node failure at step 40, restarts
from the last committed checkpoint, and asserts the final parameters
bitwise equal to an uninterrupted run's.

  PYTHONPATH=src python examples/torch_train_resume.py [--device cpu]
"""

import argparse
import shutil
import tempfile

import torch

from repro_torch.configs import reduced_config
from repro_torch.data import make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import TrainLoop, TrainLoopConfig

STEPS, DIE_AT = 60, 40
CFG = reduced_config("qwen3_14b")
OPT = AdamWConfig(lr=1e-3, total_steps=STEPS, warmup_steps=3)


def batch_fn(step):
    return make_batch(CFG, "train", 32, 2, step=step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = ap.parse_args(argv).device
    root = tempfile.mkdtemp(prefix="repro_torch_ft_")

    def loop(ckpt_dir):
        return TrainLoop(CFG, OPT, TrainLoopConfig(
            ckpt_dir=ckpt_dir, ckpt_every=20, log_every=20), batch_fn,
            device=device)

    try:
        print("== uninterrupted run ==")
        ref_state, m = loop(f"{root}/ref").run(STEPS)
        print(f"   final loss {float(m['loss']):.4f}")

        print(f"== run that dies at step {DIE_AT} ==")
        try:
            loop(f"{root}/victim").run(STEPS, die_at_step=DIE_AT)
        except RuntimeError as e:
            print(f"   {e}")

        print("== restarted process resumes ==")
        resumed = loop(f"{root}/victim")
        print(f"   resumed at step {resumed.step}")
        res_state, m = resumed.run(STEPS)

        for (name, a), b in zip(ref_state["params"].named_parameters(),
                                res_state["params"].parameters()):
            assert torch.equal(a, b), name
        print("bit-exact match with the uninterrupted run — OK")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
