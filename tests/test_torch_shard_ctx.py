"""The activation-sharding context (`models/shard_ctx.py`, `launch/mesh.py
enter_mesh`) and the two readers of it that change results: the MoE
dispatch's group factors (`models/moe.py _factor_groups`) and the train
step's microbatch count (`models/model.py train_step`).

The reference reads its ambient mesh from JAX; this CPU has one JAX
device, so the reference's `shard_ctx._mesh_shape` is patched to the
mesh's sizes and its `constrain` (a GSPMD hint) to identity. Group
factors are compared exactly; a REDUCED DeepSeek-V2-Lite MoE layer (with
a capacity that drops tokens, so the grouping shows) and train step
within the reference's 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as RMo
from repro.models import model as RM
from repro.models import shard_ctx as ref_ctx
from repro_torch.configs import reduced_config
from repro_torch.data import batch_to_device, make_batch
from repro_torch.launch.mesh import enter_mesh, make_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import moe as Mo
from repro_torch.models import shard_ctx
from repro_torch.models.params import (train_state_from_reference,
                                       train_state_to_reference)
from torch_train_ref import OPT, REF_OPT, close, close_trees, reference_state

torch.set_num_threads(1)

TOL = 2e-3
ARCH = "deepseek_v2_lite_16b"


def meta_mesh(dp: int, tp: int):
    return make_mesh((dp, tp), ("data", "model"), devices="meta")


@pytest.fixture
def ref_context(monkeypatch):
    """A context manager putting the reference under a (dp, tp) context:
    its mesh shape patched in, its `constrain` the identity."""
    monkeypatch.setattr(ref_ctx, "constrain", lambda x, dims: x)

    def enter(dp: int, tp: int):
        monkeypatch.setattr(ref_ctx, "_mesh_shape",
                            lambda: {"data": dp, "model": tp})
        return ref_ctx.activation_sharding(("data",))

    return enter


def test_constrain_returns_its_input():
    x = torch.randn(4, 6)
    assert shard_ctx.constrain(x, ("dp", None)) is x
    with enter_mesh(meta_mesh(2, 2)), shard_ctx.activation_sharding(
            ("data",)):
        assert shard_ctx.constrain(x, ("dp", "tp")) is x
        assert shard_ctx.constrain(x, ("dpt", None)) is x


def test_sizes_under_enter_mesh():
    assert (shard_ctx.dp_size(), shard_ctx.tp_size()) == (1, 1)
    assert shard_ctx.dp() is None and shard_ctx.tp() is None
    mesh = make_production_mesh(multi_pod=True)
    with enter_mesh(mesh) as m, shard_ctx.activation_sharding(
            ("pod", "data")):
        assert m is mesh and shard_ctx._mesh_shape() == mesh.shape
        assert (shard_ctx.dp_size(), shard_ctx.tp_size()) == (32, 16)
        assert shard_ctx.dp() == ("pod", "data") and shard_ctx.tp() == "model"
        with enter_mesh(meta_mesh(4, 2)), shard_ctx.activation_sharding(
                ("data",)):
            assert (shard_ctx.dp_size(), shard_ctx.tp_size()) == (4, 2)
        assert shard_ctx.dp_size() == 32
    with pytest.raises(RuntimeError, match="enter_mesh"):
        shard_ctx._mesh_shape()
    assert (shard_ctx.dp_size(), shard_ctx.tp_size()) == (1, 1)
    with shard_ctx.activation_sharding(("data",)):
        with pytest.raises(RuntimeError, match="enter_mesh"):
            shard_ctx.dp_size()


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (1, 4), (2, 2), (4, 2),
                                   (8, 16), (32, 16), (3, 5)])
def test_factor_groups_equal_the_reference(dp, tp, ref_context):
    grid = [(b, t) for b in (1, 2, 3, 4, 6, 8, 12, 32, 64)
            for t in (1, 2, 3, 8, 12, 16, 24, 48, 64, 128, 4096)]
    with ref_context(dp, tp):
        want = [RMo._factor_groups(b, t) for b, t in grid]
    with enter_mesh(meta_mesh(dp, tp)), shard_ctx.activation_sharding(
            ("data",)):
        got = [Mo._factor_groups(b, t) for b, t in grid]
    assert got == want
    if (dp, tp) == (1, 1):       # a (1, 1) context is no context
        assert [Mo._factor_groups(b, t) for b, t in grid] == want


def test_moe_layer_under_a_context_equals_the_reference(ref_context):
    cfg = reduced_config(ARCH)
    pmc = dataclasses.replace(cfg.moe, capacity_factor=1.0)
    rmc = RMo.MoEConfig(**dataclasses.asdict(pmc))
    ref = jax.tree.map(np.asarray, RMo.moe_init(jax.random.PRNGKey(5),
                                                cfg.d_model, rmc))
    port = Mo.moe_init(cfg.d_model, pmc, device="cpu")
    with torch.no_grad():
        for name, value in ref.items():
            port[name].copy_(torch.from_numpy(np.array(value, np.float32)))
    x = np.random.default_rng(7).normal(size=(4, 16, cfg.d_model)).astype(
        np.float32)
    with ref_context(2, 2):
        ry, raux = RMo.moe_apply(ref, jnp.asarray(x), rmc, train=True)
    with enter_mesh(meta_mesh(2, 2)), shard_ctx.activation_sharding(
            ("data",)):
        assert Mo._factor_groups(4, 16) == (2, 16)
        py, paux = Mo.moe_apply(port, torch.from_numpy(x), pmc, train=True)
    close(py.detach(), ry, TOL, "y")
    close(paux.detach(), raux, TOL, "aux")
    alone = Mo.moe_apply(port, torch.from_numpy(x), pmc)[0]
    assert not torch.allclose(alone, py)   # other groups drop other tokens


def test_train_step_under_a_context_equals_the_reference(ref_context,
                                                         monkeypatch):
    """B = 4, grad_accum 4: M = 4 without a context; with dp = 2 a
    microbatch of one row does not split over the data axis, so M halves
    to 2, in both packages."""
    cfg = dataclasses.replace(reduced_config(ARCH), grad_accum=4)
    cfg_r, ref = reference_state(ARCH)
    cfg_r = dataclasses.replace(cfg_r, grad_accum=4)
    batch = make_batch(cfg, "train", 32, 4, step=3)
    state = train_state_from_reference(jax.tree.map(np.asarray, ref), cfg,
                                       device="cpu")
    with ref_context(2, 2):
        new_ref, rm = RM.train_step(jax.tree.map(jnp.array, ref),
                                    jax.tree.map(jnp.asarray, batch), cfg_r,
                                    REF_OPT)
    calls = []
    real = M._loss_and_grads
    monkeypatch.setattr(M, "_loss_and_grads",
                        lambda *a: calls.append(1) or real(*a))
    with enter_mesh(meta_mesh(2, 2)), shard_ctx.activation_sharding(
            ("data",)):
        state, pm = M.train_step(state, batch_to_device(batch, "cpu"), cfg,
                                 OPT)
    assert len(calls) == 2
    for key in ("loss", "grad_norm", "lr"):
        close(pm[key], rm[key], TOL, key)
    got = train_state_to_reference(state, cfg)
    new_ref = jax.tree.map(np.asarray, new_ref)
    close_trees(got["params"], new_ref["params"], TOL, "params")
    close_trees(got["opt"]["m"], new_ref["opt"]["m"], TOL, "m")
    calls.clear()
    M.train_step(state, batch_to_device(batch, "cpu"), cfg, OPT)
    assert len(calls) == 4                  # no context: gcd(4, 4)
