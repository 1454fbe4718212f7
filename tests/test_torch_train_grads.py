"""The port's training path (`repro_torch.models.model.train_step` and
what it runs) against the reference's on the CPU: the differentiable
flash op, the custom VJPs, the chunked loss, and one train step of each
dense GQA architecture. (The MoE and embedding-input ones are in
tests/test_torch_train_moe.py, the recurrent ones in
tests/test_torch_train_ssm.py, the optimizer, data, checkpoints and the
train loop in tests/test_torch_train.py; the files split to keep each
under ~90 s on one worker.)

Inputs come from a seed through numpy; parameters are the reference's
`init_params`, copied into the port by `train_state_from_reference`.

Tolerances, float32:
- the flash op's dq, dk, dv against `jax.grad` through the reference's
  `blockwise_attn` (its query blocks under `jax.checkpoint`): 2e-5
  (measured <= 3e-6; sums over the rows of other blocks in another
  order);
- `rms_norm`'s and `embed_lookup`'s backwards against the reference's
  VJPs: 1e-6 (the same per-token formulas; the one-hot products are
  exact sums of one term here);
- a train step: the loss, aux and every gradient leaf within the
  reference's 2e-3 (tests/test_models.py) of `jax.value_and_grad` of
  its `loss_fn`, and the parameters, m and v after `train_step` within
  2e-3 of the reference's `train_step` on the same state and batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import reduced_config as ref_reduced
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.configs import reduced_config
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import train_state_from_reference
from torch_train_ref import check_train_step

torch.set_num_threads(1)

FLASH_GRAD_TOL = 2e-5
DENSE_ARCHS = ["h2o_danube3_4b", "qwen3_14b", "minitron_8b", "granite_3_8b"]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# the differentiable flash op
# ---------------------------------------------------------------------------

# (H, KV, hd, v_dim, mask): MLA's padded V (v_dim < hd, zero columns),
# grouped KV heads (G = 3), a sliding window, a bidirectional prefix
FLASH_CASES = {
    "mla_padded_v": (4, 4, 24, 16, {}),
    "gqa_g3": (6, 2, 16, 16, {}),
    "window": (4, 2, 16, 16, {"window": 37}),
    "prefix": (4, 4, 16, 16, {"prefix_len": 40}),
    "offset_window": (2, 1, 16, 16, {"window": 50, "q_offset": 20}),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_op_gradients_match_reference(case):
    """dq, dk, dv of the port's blockwise_attn (the differentiable flash
    op, query blocks of 128 over T = 300: not a multiple of the block
    nor of 256) against jax.grad through the reference's blockwise_attn
    (blocks 64 x 128), on the same cotangent."""
    H, KV, hd, vd, mask = FLASH_CASES[case]
    Tn = 300
    q, k = _np((2, Tn, H, hd), 1), _np((2, Tn, KV, hd), 2)
    v = _np((2, Tn, KV, vd), 3)
    w = _np((2, Tn, H, vd), 4)
    vpad = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, hd - vd)))
    ref_mask = dict(mask)
    q_offset = ref_mask.pop("q_offset", 0)

    def ref_loss(q, k, v):
        vp = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, hd - vd)))
        out = RL.blockwise_attn(q, k, vp, q_offset=q_offset, block_q=64,
                                block_k=128, **ref_mask)[..., :vd]
        return jnp.sum(out * w)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                       (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = L.blockwise_attn(qt, kt, F.pad(vt, (0, hd - vd)), block_q=128,
                           **mask)[..., :vd]
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (qt, kt, vt))
    for name, g, r in zip("qkv", got, want):
        _close(g, r, FLASH_GRAD_TOL, f"d{name}")
    assert not np.allclose(np.asarray(want[1]), 0.0)
    del vpad


def test_flash_op_forward_is_the_serving_call():
    """Without autograd recording, blockwise_attn calls ops.flash_attention
    (the serving path); with it, the differentiable op, whose forward is
    the same call and gives the same values."""
    q, k, v = (torch.from_numpy(_np((1, 40, 2, 8), s)) for s in (5, 6, 7))
    calls = []
    orig = ops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    ops.flash_attention = counting
    try:
        plain = L.blockwise_attn(q, k, v)
        assert len(calls) == 1
        qg = q.clone().requires_grad_()
        diff = L.blockwise_attn(qg, k, v)
        assert len(calls) == 2 and diff.requires_grad
        with torch.no_grad():
            L.blockwise_attn(qg, k, v)
        assert len(calls) == 3
    finally:
        ops.flash_attention = orig
    assert torch.equal(plain, diff.detach())


def test_flash_op_rows_with_no_live_key_have_zero_gradient():
    """A window that leaves every row of a block without a live key: the
    block's gradients are 0, as the reference's -inf guards give them."""
    q, k, v = (torch.from_numpy(_np((2, 16, 8), s)).requires_grad_()
               for s in (8, 9, 10))
    out = ops.flash_attention_differentiable(q, k, v, window=4,
                                             q_offset=40, block_q=8)
    assert not bool(out.detach().any())
    out.sum().backward()
    for t in (q, k, v):
        assert not bool(t.grad.any())


# ---------------------------------------------------------------------------
# the custom VJPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 48), (3, 128)])
def test_rms_norm_backward_matches_reference_vjp(shape):
    x, s, dy = _np(shape, 11, 3.0), _np(shape[-1:], 12), _np(shape, 13)
    _, vjp = jax.vjp(lambda a, b: RL.rms_norm(a, b, 1e-5), jnp.asarray(x),
                     jnp.asarray(s))
    want = vjp(jnp.asarray(dy))
    xt, st = (torch.from_numpy(a).requires_grad_() for a in (x, s))
    got = torch.autograd.grad(L.rms_norm(xt, st, 1e-5), (xt, st),
                              torch.from_numpy(dy))
    for g, r in zip(got, want):
        _close(g, r, 1e-6)


def test_rms_norm_backward_keeps_dtypes():
    x = torch.from_numpy(_np((4, 64), 14)).bfloat16().requires_grad_()
    s = torch.ones(64, dtype=torch.bfloat16, requires_grad=True)
    dx, ds = torch.autograd.grad(L.rms_norm(x, s).float().sum(), (x, s))
    assert dx.dtype == ds.dtype == torch.bfloat16


@pytest.mark.parametrize("Tn", [40, 600])
def test_embed_lookup_backward_matches_reference_vjp(Tn):
    """T = 600 takes two one-hot chunks of 300 (the largest divisor of T
    not above 512), T = 40 one."""
    V, d = 64, 8
    table = _np((V, d), 15)
    toks = np.random.default_rng(16).integers(0, V, (2, Tn)).astype(np.int32)
    g = _np((2, Tn, d), 17)
    _, vjp = jax.vjp(lambda t: RT.embed_lookup(t, jnp.asarray(toks)),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_()
    out = T.embed_lookup(tt, torch.from_numpy(toks).long())
    _close(out.detach(), table[toks], 0.0)
    (got,) = torch.autograd.grad(out, tt, torch.from_numpy(g))
    _close(got, want, 1e-6)


def test_chunked_xent_matches_reference():
    cfg = reduced_config("granite_3_8b")        # vocab padded 49155 -> ...
    rcfg = ref_reduced("granite_3_8b")
    params = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(3),
                                                     rcfg))
    state = train_state_from_reference(
        {"params": params, "opt": ref_adamw_init(params)}, cfg, device="cpu")
    hidden = _np((2, 24, cfg.d_model), 18)
    labels = np.random.default_rng(19).integers(0, cfg.vocab_size, (2, 24))
    mask = (np.arange(24)[None] < np.array([[20], [11]])).astype(np.float32)
    want = RT.chunked_xent(params, rcfg, jnp.asarray(hidden),
                           jnp.asarray(labels), jnp.asarray(mask))
    got = T.chunked_xent(state["params"], cfg, torch.from_numpy(hidden),
                         torch.from_numpy(labels), torch.from_numpy(mask))
    _close(got.detach(), want, 1e-6)


# ---------------------------------------------------------------------------
# one train step an architecture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)
