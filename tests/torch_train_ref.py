"""Shared by the port's train-step tests (tests/test_torch_train_*.py):
one train step of a REDUCED architecture through both packages.

`check_train_step(arch)` copies the reference's `init_params` (seed 0)
and `adamw_init` into the port (`train_state_from_reference`), takes the
reference's `make_batch` (B = 2, T = 32, the sizes of
tests/test_models.py), and holds the port to the reference: the loss,
aux and every gradient leaf within `tol` (the reference's 2e-3) of
`jax.value_and_grad` of its `loss_fn`, then the loss, grad_norm, lr,
parameters, m and v after one `train_step` of each package within `tol`.
`check_layer_train_gradients(kind)` holds one recurrent layer's
train-mode output and gradients to jax.grad through the reference's
layer (float32, its chunked scan rematerialized) within LAYER_TOL: 1e-5,
and 1e-4 for mLSTM, whose read-out C q / max(|n q|, exp(-m)) amplifies
rounding (measured 3.0e-5 absolute on in_proj's gradient, of magnitude
~5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as ref_reduced
from repro.models import model as RM
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.configs import reduced_config
from repro_torch.data import batch_to_device, make_batch
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.params import (
    train_state_from_reference,
    train_state_to_reference,
    tree_to_reference,
)
from repro_torch.optim.adamw import AdamWConfig

B, TT = 2, 32
OPT = AdamWConfig(total_steps=50, warmup_steps=2)
REF_OPT = RefAdamW(total_steps=50, warmup_steps=2)
STEP_TOL = 2e-3
LAYER_TOL = {"mamba": 1e-5, "slstm": 1e-5, "mlstm": 1e-4}


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def close_trees(got, want, tol, what):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want), what
    for path, g in got.items():
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        close(g, want[path], tol, f"{what} {path}")


def reference_state(arch: str, seed: int = 0):
    cfg_r = ref_reduced(arch)
    params = RT.init_params(jax.random.PRNGKey(seed), cfg_r)
    return cfg_r, {"params": params, "opt": ref_adamw_init(params)}


def check_train_step(arch: str, tol: float = STEP_TOL, grad_tol=None):
    """Loss, aux and gradients against jax.value_and_grad of the
    reference's loss_fn; then one train_step of each package from the
    same state on the same batch."""
    cfg = reduced_config(arch)
    cfg_r, ref = reference_state(arch)
    batch = make_batch(cfg, "train", TT, B, step=0)
    jb = jax.tree.map(jnp.asarray, batch)
    (rloss, rmet), rgrads = jax.jit(
        jax.value_and_grad(RM.loss_fn, has_aux=True), static_argnums=1)(
            ref["params"], cfg_r, jb)
    host = jax.tree.map(np.asarray, ref)
    state = train_state_from_reference(host, cfg, device="cpu")
    tb = batch_to_device(batch, "cpu")
    loss, met = M.loss_fn(state["params"], cfg, tb)
    names, ps = zip(*state["params"].named_parameters())
    grads = torch.autograd.grad(loss, ps)
    close(loss.detach(), rloss, tol, "loss")
    close(met["aux"].detach(), rmet["aux"], tol, "aux")
    close_trees(tree_to_reference(dict(zip(names, grads)), cfg),
                 jax.tree.map(np.asarray, rgrads), grad_tol or tol, "grad")

    new_ref, rm = RM.train_step(jax.tree.map(jnp.array, ref), jb, cfg_r,
                                REF_OPT)
    state, pm = M.train_step(state, tb, cfg, OPT)
    for key in ("loss", "grad_norm", "lr"):
        close(pm[key], rm[key], tol, key)
    got = train_state_to_reference(state, cfg)
    new_ref = jax.tree.map(np.asarray, new_ref)
    close_trees(got["params"], new_ref["params"], tol, "params")
    close_trees(got["opt"]["m"], new_ref["opt"]["m"], tol, "m")
    close_trees(got["opt"]["v"], new_ref["opt"]["v"], tol, "v")
    assert int(got["opt"]["step"]) == int(new_ref["opt"]["step"]) == 1
    before = dict(leaves(host["params"]))
    moved = sum(float(np.abs(np.asarray(g, np.float32) - before[p]).sum())
                for p, g in leaves(got["params"]))
    assert np.isfinite(float(pm["loss"])) and float(pm["grad_norm"]) > 0
    assert moved > 0


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def check_layer_train_gradients(kind):
    """mode "train": the output and the gradients of every parameter and
    of the input against jax.grad through the reference's layer, T = 20
    over chunks of 8 (the reference's gcd rule gives 4)."""
    d, Bn, Tn = 32, 2, 20
    key = jax.random.PRNGKey(3)
    if kind == "mamba":
        mc = RS.MambaConfig(d_state=4, d_conv=4, expand=2, chunk=8)
        ref = RS.mamba_init(key, d, mc)
        port = S.mamba_init(d, S.MambaConfig(d_state=4, d_conv=4, expand=2,
                                             chunk=8))
        rapply = lambda p, x: RS.mamba_apply(  # noqa: E731
            p, x, mode="train", mc=mc)
        papply = lambda p, x: S.mamba_apply(  # noqa: E731
            p, x, mode="train", mc=S.MambaConfig(d_state=4, d_conv=4,
                                                  expand=2, chunk=8))
    else:
        xc = RS.XLSTMConfig(n_heads=2, chunk=8)
        pxc = S.XLSTMConfig(n_heads=2, chunk=8)
        ref = getattr(RS, f"{kind}_init")(key, d, xc)
        port = getattr(S, f"{kind}_init")(d, pxc)
        rapply = lambda p, x: getattr(RS, f"{kind}_apply")(  # noqa: E731
            p, x, mode="train", xc=xc)
        papply = lambda p, x: getattr(S, f"{kind}_apply")(  # noqa: E731
            p, x, mode="train", xc=pxc)
    ref = jax.tree.map(np.asarray, ref)
    with torch.no_grad():
        for name, value in ref.items():
            port[name].copy_(torch.from_numpy(np.array(value, np.float32)))
    port.requires_grad_(True)
    x, w = _np((Bn, Tn, d), 5), _np((Bn, Tn, d), 6)

    def ref_loss(p, x):
        return jnp.sum(rapply(p, x)[0] * w)

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(ref, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, cache = papply(port, xt)
    assert cache is None
    tol = LAYER_TOL[kind]
    close(out.detach(), rapply(ref, jnp.asarray(x))[0], tol, "out")
    names, ps = zip(*port.named_parameters())
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              ps + (xt,))
    for name, g in zip(names, got):
        close(g, want_p[name], tol, name)
    close(got[-1], want_x, tol, "x")
