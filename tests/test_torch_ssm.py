"""The port's recurrent layers (Mamba-1, mLSTM, sLSTM) and the two
architectures built on them, jamba-v0.1-52b and xlstm-350m, against the
reference on the same seeded numpy inputs and parameters, on the CPU,
where the port runs its plain versions.

Tolerances, all float32 unless stated:
- each layer's apply in prefill and in decode from the prefilled cache,
  at REDUCED widths: outputs and every cache leaf within 1e-5 (the same
  arithmetic step for step; the matmuls sum in other orders);
- `_causal_conv` and the prefill's conv state: 1e-6 (the same products
  summed in the same order);
- the init constants exactly, but A_log = log(1..d_state) in float32,
  where XLA's log is one ulp from the correctly rounded value at log 7:
  the port's is the correctly rounded one, within one ulp of the
  reference's; drawn leaves by mean and std over a large draw;
- REDUCED jamba and xlstm whole, through `params_from_reference`, at 1
  and 2 periods: prefill and three decode steps, logits and caches within
  2e-3, the reference's own (tests/test_models.py), and the port's own
  prefill/decode consistency, as tests/test_models.py checks it;
- a bf16 layer decoding from a float32 cache (the conv in the wider
  dtype), fresh or after a prefill (where the reference's conv state
  turns bf16 and the port's stays float32, by design): within 2e-2 of
  the reference on the same dtypes.

Tests marked `cuda` run only where there is a card, float32 on the card
against the reference on the CPU: one jamba period at full layer widths
(d 4,096, GQA 32:8, Mamba di 8,192, the experts' d_ff 14,336) with the
vocabulary cut to 4,096 and the experts to 4 of 16 (top-2 kept), so that
the reference's CPU run holds 4.2 B parameters, not 12.8 B, within 2e-3;
one xlstm-350m mLSTM layer and one sLSTM layer alone within 2e-3; and
xlstm-350m whole, its logits within XLSTM_WHOLE_TOL (its read-out
amplifies rounding; see that test).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get
from repro.configs import reduced_config as ref_reduced
from repro.models import model as RM
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.params import params_from_reference

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

SSM_ARCHS = ["jamba_v01_52b", "xlstm_350m"]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _close(got, want, tol):
    got = got.float() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _load(module, tree, dtype=torch.float32):
    for name, value in tree.items():
        if isinstance(value, dict):
            _load(module[name], value, dtype)
        else:
            module[name].copy_(_t(value, dtype))
    return module


def _close_cache(got: dict, want: dict, tol):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        fin = np.isfinite(w)
        assert (np.isfinite(g) == fin).all() and (g[~fin] == w[~fin]).all(), \
            name                                   # m and sm start at -inf
        np.testing.assert_allclose(g[fin], w[fin], rtol=tol, atol=tol,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the three layers against the reference's
# ---------------------------------------------------------------------------

D_MODEL = 48
MC = RS.MambaConfig(d_state=8, d_conv=4, expand=2, chunk=8)
XC = RS.XLSTMConfig(n_heads=2, m_proj_factor=2.0, d_conv=4, chunk=8)
PMC = S.MambaConfig(d_state=8, d_conv=4, expand=2, chunk=8)
PXC = S.XLSTMConfig(n_heads=2, m_proj_factor=2.0, d_conv=4, chunk=8)
KINDS = {
    "mamba": (RS.mamba_init, RS.mamba_apply, RS.mamba_cache_init, MC,
              S.mamba_init, S.mamba_apply, S.mamba_cache_init, PMC, "mc"),
    "mlstm": (RS.mlstm_init, RS.mlstm_apply, RS.mlstm_cache_init, XC,
              S.mlstm_init, S.mlstm_apply, S.mlstm_cache_init, PXC, "xc"),
    "slstm": (RS.slstm_init, RS.slstm_apply, RS.slstm_cache_init, XC,
              S.slstm_init, S.slstm_apply, S.slstm_cache_init, PXC, "xc"),
}


@functools.lru_cache(maxsize=None)
def _ref_init(kind, d, dtype=jnp.float32):
    """The reference's init of `kind`, jitted: one compile a shape."""
    r_init, rc = KINDS[kind][0], KINDS[kind][3]
    return jax.jit(lambda key: r_init(key, d, rc, dtype=dtype))


def _layer_pair(kind, dtype=torch.float32, seed=0):
    """The reference's params of `kind` at D_MODEL and the port's module
    holding the same values."""
    _, _, _, _, p_init, _, _, pc, _ = KINDS[kind]
    tree = jax.tree.map(np.asarray, _ref_init(kind, D_MODEL)(
        jax.random.PRNGKey(seed)))
    return tree, _load(p_init(D_MODEL, pc, dtype=dtype, device="cpu"), tree,
                       dtype)


@functools.lru_cache(maxsize=None)
def _ref_apply(kind, mode):
    """The reference's apply of `kind` in `mode`, jitted (as its
    prefill_step and decode_step are), so that the tests' calls of one
    shape compile once."""
    _, r_apply, _, rc, _, _, _, _, cname = KINDS[kind]
    return jax.jit(functools.partial(r_apply, mode=mode, **{cname: rc}))


def _run_layer(kind, tree, module, x, t_pre, steps, cache_dtype=None,
               dtype=torch.float32):
    """prefill(t_pre) then `steps` decode steps of one layer through both
    packages; returns the (port, reference) outputs and final caches."""
    _, _, r_cache, rc, _, p_apply, p_cache, pc, cname = KINDS[kind]
    B = x.shape[0]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rtree = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    c_dt = cache_dtype or dtype
    r_c = r_cache(B, D_MODEL, rc, dtype=jnp.float32 if c_dt == torch.float32
                  else jdt)
    p_c = p_cache(B, D_MODEL, pc, dtype=c_dt, device="cpu")
    outs = []
    for i, (lo, hi) in enumerate([(0, t_pre)] + [
            (t, t + 1) for t in range(t_pre, t_pre + steps)]):
        mode = "prefill" if i == 0 else "decode"
        xr = jnp.asarray(x[:, lo:hi], jdt)
        ry, r_c = _ref_apply(kind, mode)(rtree, xr, cache=r_c)
        py, p_c = p_apply(module, _t(x[:, lo:hi], dtype), mode=mode,
                          cache=p_c, pos=lo, **{cname: pc})
        outs.append((py, ry))
    return outs, p_c, r_c


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("t_pre", [1, 5, 21])
def test_layer_prefill_and_decode_match_reference(kind, t_pre):
    """Prefill, then three decode steps from its cache: every output and
    every cache leaf within 1e-5. t_pre = 1 leaves the conv state two
    zero rows in front; 21 runs two scan blocks (16 + 5)."""
    tree, module = _layer_pair(kind)
    x = _np((2, t_pre + 3, D_MODEL), seed=3)
    outs, p_c, r_c = _run_layer(kind, tree, module, x, t_pre, 3)
    for got, want in outs:
        assert got.dtype == torch.float32
        _close(got, want, 1e-5)
    _close_cache(p_c, r_c, 1e-5)


@pytest.mark.parametrize("kind", list(KINDS))
def test_layer_without_a_cache_matches_reference(kind):
    """No cache: prefill from the zero state, nothing written; decode
    without a cache starts from zeros too."""
    tree, module = _layer_pair(kind, seed=1)
    _, _, _, _, _, p_apply, _, pc, cname = KINDS[kind]
    x = _np((2, 9, D_MODEL), seed=4)
    for mode in ("prefill", "decode"):
        ry, r_new = _ref_apply(kind, mode)(tree, jnp.asarray(x))
        py, p_new = p_apply(module, _t(x), mode=mode, **{cname: pc})
        assert p_new is None and r_new is None
        _close(py, ry, 1e-5)


def test_scan_block_does_not_change_the_result(monkeypatch):
    """The state-free terms are computed a block of steps at a time; one
    step or 7 a block give the default's outputs and state within 1e-5
    (the read-out's matmul over a block sums in another order)."""
    for kind in ("mamba", "mlstm"):
        tree, module = _layer_pair(kind, seed=2)
        x = _np((2, 20, D_MODEL), seed=5)
        got = {}
        for block in (S.SCAN_BLOCK, 1, 7):
            monkeypatch.setattr(S, "SCAN_BLOCK", block)
            outs, p_c, _ = _run_layer(kind, tree, module, x, 17, 3)
            got[block] = ([o for o, _ in outs], p_c)
        base = got.pop(S.SCAN_BLOCK)
        for outs, p_c in got.values():
            for a, b in zip(outs, base[0]):
                _close(a, b, 1e-5)
            _close_cache(p_c, base[1], 1e-5)


@pytest.mark.parametrize("kind", list(KINDS))
def test_bf16_layer_decodes_from_a_float32_cache(kind):
    """bf16 parameters over a float32 cache: decode concatenates the
    float32 conv state with bf16 rows, so the conv runs in float32, as
    the reference's concatenate promotes (fresh cache, no prefill). The
    state stays float32; the outputs within 2e-2 of the reference's on
    the same dtypes."""
    tree, module = _layer_pair(kind, dtype=torch.bfloat16, seed=4)
    x = _np((2, 3, D_MODEL), seed=6)
    _, _, r_cache, rc, _, p_apply, p_cache, pc, cname = KINDS[kind]
    rtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    r_c = r_cache(2, D_MODEL, rc, dtype=jnp.float32)
    p_c = p_cache(2, D_MODEL, pc, dtype=torch.float32, device="cpu")
    for t in range(3):
        ry, r_c = _ref_apply(kind, "decode")(
            rtree, jnp.asarray(x[:, t:t + 1], jnp.bfloat16), cache=r_c)
        py, p_c = p_apply(module, _t(x[:, t:t + 1], torch.bfloat16),
                          mode="decode", cache=p_c, pos=t, **{cname: pc})
        assert str(py.dtype).split(".")[-1] == jnp.dtype(ry.dtype).name
        _close(py, ry, 2e-2)
    for name, leaf in p_c.items():
        assert leaf.dtype == torch.float32, name


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_bf16_layer_prefill_then_decode_over_a_float32_cache(kind):
    """bf16 parameters, prefill of 3 positions then 3 decode steps over a
    float32 cache: by design the two packages keep the conv state in
    different dtypes. The reference's prefill returns its conv leaf in
    the activations' dtype (bf16), so its decodes convolve in bf16; the
    port writes the state into the float32 cache in place, so its
    decodes convolve in float32 (`models/ssm.py`'s docstring). The leaf
    dtypes are pinned, and the outputs stay within this file's 2e-2 of
    the reference's."""
    tree, module = _layer_pair(kind, dtype=torch.bfloat16, seed=4)
    x = _np((2, 6, D_MODEL), seed=6)
    _, _, r_cache, rc, _, p_apply, p_cache, pc, cname = KINDS[kind]
    rtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    r_c = r_cache(2, D_MODEL, rc, dtype=jnp.float32)
    p_c = p_cache(2, D_MODEL, pc, dtype=torch.float32, device="cpu")
    ry, r_c = _ref_apply(kind, "prefill")(
        rtree, jnp.asarray(x[:, :3], jnp.bfloat16), cache=r_c)
    py, p_c = p_apply(module, _t(x[:, :3], torch.bfloat16), mode="prefill",
                      cache=p_c, pos=0, **{cname: pc})
    _close(py, ry, 2e-2)
    assert r_c["conv"].dtype == jnp.bfloat16
    assert p_c["conv"].dtype == torch.float32
    for t in range(3, 6):
        ry, r_c = _ref_apply(kind, "decode")(
            rtree, jnp.asarray(x[:, t:t + 1], jnp.bfloat16), cache=r_c)
        py, p_c = p_apply(module, _t(x[:, t:t + 1], torch.bfloat16),
                          mode="decode", cache=p_c, pos=t, **{cname: pc})
        _close(py, ry, 2e-2)
    assert r_c["conv"].dtype == jnp.bfloat16
    for name, leaf in p_c.items():
        assert leaf.dtype == torch.float32, name


@pytest.mark.parametrize("t", [1, 2, 3, 8])
def test_causal_conv_and_the_prefill_conv_state(t):
    """`_causal_conv` against the reference's at T = 1, 2 (below K - 1 =
    3), 3 and 8, without and with a state; and mamba's prefill leaves the
    last K - 1 rows of the zero-padded pre-conv input in its cache: for T
    < 3, zero rows in front."""
    x, w, b = _np((2, t, 6), 7), _np((4, 6), 8), _np((6,), 9)
    state = _np((2, 3, 6), 10)
    for st in (None, state):
        want = RS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
        got = S._causal_conv(_t(x), _t(w), _t(b),
                             None if st is None else _t(st))
        _close(got[0], want[0], 1e-6)
        _close(got[1], want[1], 1e-6)
    tree, module = _layer_pair("mamba", seed=5)
    xs = _np((2, t, D_MODEL), 11)
    _, p_c, r_c = _run_layer("mamba", tree, module, xs, t, 0)
    _close(p_c["conv"], r_c["conv"], 1e-6)
    xb = torch.einsum("btd,dge->btge", _t(xs), module["in_proj"])[:, :, 0]
    want = torch.cat([torch.zeros(2, max(3 - t, 0), xb.shape[-1]),
                      xb[:, -3:]], 1)
    _close(p_c["conv"], want, 1e-6)
    assert not bool(p_c["conv"][:, :max(3 - t, 0)].any())


def test_slstm_state_leaves_are_separate_tensors():
    """The reference's initial sLSTM state aliases one zeros array three
    times; here each leaf is its own storage, so writing one in place
    leaves the others."""
    cache = S.slstm_cache_init(2, 16, PXC, device="cpu")
    ptrs = {name: leaf.data_ptr() for name, leaf in cache.items()}
    assert len(set(ptrs.values())) == 4
    cache["sc"].fill_(1.0)
    assert not cache["sn"].any() and not cache["sh"].any()
    assert bool(torch.isinf(cache["sm"]).all())


# ---------------------------------------------------------------------------
# init: the reference's constants and scales
# ---------------------------------------------------------------------------


INIT_D = 512


@functools.lru_cache(maxsize=None)
def _drawn(kind, dtype=torch.float32):
    """(port, reference) leaves of `kind`'s init at d_model = INIT_D, as
    float32 numpy: the port's drawn from a torch generator, the
    reference's from a PRNG key."""
    p_init, pc = KINDS[kind][4], KINDS[kind][7]
    port = p_init(INIT_D, pc, dtype=dtype, device="cpu").draw_(
        torch.Generator().manual_seed(0))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       _ref_init(kind, INIT_D, jdt)(jax.random.PRNGKey(0)))
    return {k: port[k].float().numpy() for k in ref}, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_constants_match_reference(dtype):
    port, ref = _drawn("mamba", dtype)
    for name in ("conv_b", "dt_bias", "D"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
    if dtype == torch.float32:
        # XLA's float32 log(7) is one ulp above the correctly rounded value
        np.testing.assert_array_max_ulp(port["A_log"], ref["A_log"], maxulp=1)
        rounded = np.array([math.log(i) for i in range(1, 9)], np.float32)
        np.testing.assert_array_equal(port["A_log"], np.broadcast_to(
            rounded, port["A_log"].shape))
    else:
        np.testing.assert_array_equal(port["A_log"], ref["A_log"])
    port, ref = _drawn("mlstm", dtype)
    for name in ("conv_b", "gn_scale", "skip"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
    port, ref = _drawn("slstm", dtype)
    for name in ("b_gates", "gn_scale"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
    assert (port["b_gates"][1] == 3.0).all() and not port["b_gates"][0].any()


@pytest.mark.parametrize("kind", list(KINDS))
def test_init_draws_match_reference_moments(kind):
    """Every drawn leaf: mean and std within a few standard errors of the
    reference's, at d_model = INIT_D (mLSTM's w_f: N(0, 1/di) + 3.0, the
    open forget gate)."""
    port, ref = _drawn(kind)
    for name, want in ref.items():
        got = port[name]
        assert got.shape == want.shape, name
        if want.std() == 0:
            continue                                   # the constants
        n = want.size
        assert abs(got.std() / want.std() - 1) < 8 / math.sqrt(n) + 0.01, \
            name
        assert abs(got.mean() - want.mean()) < 8 * want.std() / math.sqrt(
            n), name
    if kind == "mlstm":
        w_f, n = port["w_f"], port["w_f"].size
        assert abs(w_f.mean() - 3.0) < 8 / math.sqrt(2 * INIT_D * n)
        assert abs(w_f.std() * math.sqrt(2 * INIT_D) - 1) < 8 / math.sqrt(n)


# ---------------------------------------------------------------------------
# jamba and xlstm whole
# ---------------------------------------------------------------------------


def _fields_equal(port_cfg, ref_cfg):
    a, b = dataclasses.asdict(port_cfg), dataclasses.asdict(ref_cfg)
    assert a.keys() == b.keys()
    for key in a:
        if key == "param_dtype":
            assert str(a[key]).split(".")[-1] == jnp.dtype(b[key]).name
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_configs_are_the_reference_field_for_field(arch):
    _fields_equal(get_config(arch), ref_get(arch))
    _fields_equal(reduced_config(arch), ref_reduced(arch))
    assert get_config(arch.replace("_", "-")) == get_config(arch)


def test_registry_holds_the_reference_ten_and_every_kind_builds():
    assert ARCHS == REF_ARCHS
    assert get_config("jamba-v0.1-52b") is get_config("jamba_v01_52b")
    for arch in SSM_ARCHS:
        cfg = reduced_config(arch)
        for spec in cfg.pattern:
            T._check(spec, cfg)
    with pytest.raises(ValueError, match="layer kind"):
        T._check(T.LayerSpec("rwkv"), reduced_config("xlstm_350m"))


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    """The reference's REDUCED params of `arch` at 2 periods, as numpy
    (a 1-period model is its first period)."""
    rcfg = dataclasses.replace(ref_reduced(arch), num_periods=2)
    init = jax.jit(RT.init_params, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(1), rcfg))


def _tree(arch, periods):
    tree = _ref_tree(arch)
    return {k: jax.tree.map(lambda a: a[:periods], v) if k == "periods"
            else v for k, v in tree.items()}


def _pair(arch, periods):
    rcfg = dataclasses.replace(ref_reduced(arch), num_periods=periods)
    pcfg = dataclasses.replace(reduced_config(arch), num_periods=periods)
    tree = _tree(arch, periods)
    return rcfg, pcfg, tree, params_from_reference(tree, pcfg, device="cpu")


@pytest.mark.parametrize("periods", [1, 2])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_reduced_model_prefill_and_decode_match_reference(arch, periods):
    """prefill(24) and three decode steps through both packages, logits
    and every cache leaf of every period within 2e-3. Two periods run the
    per-period slices of the stacked recurrent caches."""
    rcfg, pcfg, tree, model = _pair(arch, periods)
    B, Tn = 2, 24
    x = np.random.default_rng(6).integers(0, rcfg.vocab_size,
                                          (B, Tn + 3)).astype(np.int32)
    params = jax.tree.map(jnp.asarray, tree)
    rc = RT.init_cache(rcfg, B, Tn + 3)
    pc = T.init_cache(pcfg, B, Tn + 3, device="cpu")
    rl, rc = RM.prefill_step(params, {"inputs": jnp.asarray(x[:, :Tn])}, rc,
                             rcfg)
    pl, pc = M.prefill_step(model, {"inputs": torch.from_numpy(
        x[:, :Tn]).long()}, pc, pcfg)
    pairs = [(pl, rl)]
    for t in range(Tn, Tn + 3):
        rl, rc = RM.decode_step(params, jnp.asarray(x[:, t:t + 1]), rc,
                                jnp.int32(t), rcfg)
        pl, pc = M.decode_step(model, torch.from_numpy(x[:, t:t + 1]).long(),
                               pc, t, pcfg)
        pairs.append((pl, rl))
    for got, want in pairs:
        assert tuple(got.shape) == (B, 1, pcfg.padded_vocab)
        _close(got, want, 2e-3)
    assert set(pc["periods"]) == set(rc["periods"])
    for i, layer in rc["periods"].items():
        assert pc["periods"][i][next(iter(layer))].shape[0] == periods
        _close_cache(pc["periods"][i], layer, 2e-3)


@pytest.mark.parametrize("periods", [1, 2])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_reduced_prefill_decode_consistency(arch, periods):
    """The reference's invariant (tests/test_models.py) on the port:
    prefill(T) then decode(T..T+2) gives the logits of one forward over
    T+3 tokens at those positions, within 2e-3."""
    _, cfg, _, model = _pair(arch, periods)
    B, Tn = 2, 19
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, Tn + 3))).long()
    hidden, _, _ = T.forward(model, cfg, toks, mode="prefill")
    full = T.compute_logits(model, cfg, hidden)
    cache = T.init_cache(cfg, B, Tn + 3, device="cpu")
    logits, cache = M.prefill_step(model, {"inputs": toks[:, :Tn]}, cache, cfg)
    _close(logits[:, 0], full[:, Tn - 1], 2e-3)
    for t in range(Tn, Tn + 3):
        logits, cache = M.decode_step(model, toks[:, t:t + 1], cache, t, cfg)
        _close(logits[:, 0], full[:, t], 2e-3)


def test_decode_reads_the_state_prefill_wrote():
    """The stack discards each layer's returned cache and relies on the
    in-place writes: after prefill every recurrent leaf of both periods
    differs from its initial value, and decoding from a fresh cache gives
    other logits."""
    _, cfg, _, model = _pair("xlstm_350m", 2)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 10))).long()
    cache = T.init_cache(cfg, 2, 10, device="cpu")
    fresh = T.init_cache(cfg, 2, 10, device="cpu")
    M.prefill_step(model, {"inputs": toks[:, :9]}, cache, cfg)
    for i, layer in cache["periods"].items():
        for name, leaf in layer.items():
            for per in range(2):
                assert not torch.equal(leaf[per], fresh["periods"][i][name][
                    per]), (i, name, per)
    warm, _ = M.decode_step(model, toks[:, 9:], cache, 9, cfg)
    cold, _ = M.decode_step(model, toks[:, 9:], fresh, 9, cfg)
    assert not torch.allclose(warm, cold, atol=1e-3)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _ref_steps(params, rcfg, toks, n):
    """The reference's prefill(n) and two decode steps: (logits of each,
    the final cache), as numpy."""
    rc = RT.init_cache(rcfg, toks.shape[0], n + 2)
    rl, rc = RM.prefill_step(params, {"inputs": jnp.asarray(toks[:, :n])},
                             rc, rcfg)
    out = [np.asarray(rl)]
    for t in (n, n + 1):
        rl, rc = RM.decode_step(params, jnp.asarray(toks[:, t:t + 1]), rc,
                                jnp.int32(t), rcfg)
        out.append(np.asarray(rl))
    return out, jax.tree.map(np.asarray, rc)


# the whole xlstm-350m on the card against the reference on the CPU, float32
# logits: chip_smoke.py's card-against-CPU limit (XLSTM_F32_TOL), twice
# the largest least tol of |d| <= tol + tol |want| over seeds 0-7 without
# a fault (0.0207; 2.37 at least with a stale or shifted state; PERF.md §6)
XLSTM_WHOLE_TOL = 0.042


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cut,n,tol", [
    ("jamba_v01_52b", {"num_periods": 1, "vocab_size": 4096,
                       "moe_experts": 4}, 32, 2e-3),
    ("xlstm_350m", {"layer": "mlstm"}, 24, 2e-3),
    ("xlstm_350m", {"layer": "slstm"}, 24, 2e-3),
    ("xlstm_350m", {}, 24, XLSTM_WHOLE_TOL),
])
def test_cuda_full_width_matches_reference(arch, cut, n, tol):
    """Full layer widths, float32, B = 1: the port on the card against the
    reference on the CPU, prefill of n tokens and two decode steps, the
    logits within `tol` and, but for the whole xlstm, every cache leaf
    within 2e-3 too. jamba: one period, the vocabulary cut to 4,096 and
    the experts to 4 of 16 (d_ff 14,336 and top-2 kept; the router
    through the topk kernel, the capacity raised so that no token is
    dropped), so that the reference's CPU run holds 4.2 B parameters.
    xlstm: one mLSTM layer and one sLSTM layer alone at 2e-3, leaves
    included; then the whole model (0.48 B), whose mLSTM read-out C q /
    max(|n q|, exp(-m)) divides by n q near 0 at random init and so
    amplifies rounding through its 21 mLSTM layers: its logits within
    XLSTM_WHOLE_TOL."""
    dev = _cuda()
    cut = dict(cut)
    experts = cut.pop("moe_experts", None)
    layer = cut.pop("layer", None)
    rcfg = dataclasses.replace(ref_get(arch), param_dtype=jnp.float32, **cut)
    pcfg = dataclasses.replace(get_config(arch), param_dtype=torch.float32,
                               **cut)
    if experts:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, num_experts=experts, capacity_factor=experts / 2))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, num_experts=experts, capacity_factor=experts / 2,
            router_use_kernel=True))
    if layer:
        rcfg = dataclasses.replace(
            rcfg, pattern=(RT.LayerSpec(layer, "none"),), num_periods=1)
        pcfg = dataclasses.replace(
            pcfg, pattern=(T.LayerSpec(layer, "none"),), num_periods=1)
    params = RT.init_params(jax.random.PRNGKey(2), rcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                  device=dev)
    toks = np.random.default_rng(8).integers(0, rcfg.vocab_size,
                                             (1, n + 2)).astype(np.int32)
    want, rc = _ref_steps(params, rcfg, toks, n)
    pc = T.init_cache(pcfg, 1, n + 2, device=dev)
    pl, pc = M.prefill_step(model, {"inputs": torch.from_numpy(
        toks[:, :n]).long().to(dev)}, pc, pcfg)
    got = [pl.cpu()]
    for t in (n, n + 1):
        pl, pc = M.decode_step(model, torch.from_numpy(
            toks[:, t:t + 1]).long().to(dev), pc, t, pcfg)
        got.append(pl.cpu())
    for g, w in zip(got, want):
        _close(g, w, tol)
    if arch == "xlstm_350m" and not layer:
        return
    for i, leaves in rc["periods"].items():
        _close_cache({name: pc["periods"][i][name].cpu() for name in leaves},
                     leaves, 2e-3)
