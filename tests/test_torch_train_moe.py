"""One train step of each MoE and embedding-input REDUCED architecture
(deepseek-v2-lite-16b, dbrx-132b; paligemma-3b's bidirectional prefix,
musicgen-large's embedded inputs and four output heads) through the port
and the reference on the CPU (`torch_train_ref.check_train_step`: the
loss, aux and every gradient within the reference's 2e-3, and the state
after one `train_step`), and the router's gradient through the topk
kernel's route.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.data import batch_to_device, make_batch
from repro_torch.models import model as M
from repro_torch.models.params import train_state_from_reference
from torch_train_ref import B, TT, check_train_step, reference_state

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "dbrx_132b",
                                  "paligemma_3b", "musicgen_large"])
def test_train_step_matches_reference(arch):
    check_train_step(arch)


def test_router_kernel_gates_carry_gradients():
    """With router_use_kernel the gates are the selected probabilities:
    the router's gradient equals the plain route's, bitwise."""
    cfg = reduced_config("deepseek_v2_lite_16b")
    kcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_use_kernel=True))
    _, ref = reference_state("deepseek_v2_lite_16b", seed=1)
    batch = batch_to_device(make_batch(cfg, "train", TT, B, step=2), "cpu")
    out = []
    for c in (cfg, kcfg):
        state = train_state_from_reference(jax.tree.map(np.asarray, ref), c,
                                           device="cpu")
        loss, _ = M.loss_fn(state["params"], c, batch)
        router = state["params"]["periods"]["0"]["0"]["moe"]["router"]
        out.append(torch.autograd.grad(loss, router)[0])
    assert out[0].abs().sum() > 0
    assert torch.equal(out[0], out[1])
