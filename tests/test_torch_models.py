"""The port's LM substrate (`repro_torch.models`) against the reference's
(`repro.models`) on the same seeded numpy inputs and parameters, on the
CPU, where the port runs its plain versions (the reference's Pallas
`topk` runs in interpret mode when `router_use_kernel` is set).

Tolerances, all float32:
- rms_norm, apply_rope: 1e-6 (elementwise; cos / sin and rsqrt of two
  libraries differ in the last bit).
- blockwise_attn, mla_apply, moe_apply: 1e-5 (einsums summed in other
  orders; the same online softmax over other key blocks).
- the whole REDUCED model through `params_from_reference`: logits and
  caches after `prefill_step` and three `decode_step`s within 2e-3, the
  reference's own tolerance for prefill / decode logits
  (`tests/test_models.py`).

Near-tie routing: router probabilities of two frameworks differ in the
last bits, so a token whose k-th and (k+1)-th probabilities lie within
that could go to another expert in one of them. The MoE and whole-model
tests record the smallest such gap over every routing of the run and
require it to exceed 1e-5, so a flip would fail as a stated
precondition rather than pass unnoticed. `_dispatch_plan` and the
router's choices are compared bitwise.

Tests marked `cuda` run only where there is a card: the attention path
through the flash kernel, and the model at full width and depth 1 + 1
(the prefix layer and one MoE period), float32, B = 1, T = 64, on the
card against the reference on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import moe as RMo
from repro.models import transformer as RT
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import attention as port_attention
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as Mo
from repro_torch.models import transformer as T
from repro_torch.models.params import params_from_reference

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

ARCH = "deepseek_v2_lite_16b"
TIE_GAP = 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load(module, tree):
    """Copy a reference sub-tree of arrays into a port Params module."""
    for name, value in tree.items():
        if isinstance(value, dict):
            _load(module[name], value)
        else:
            module[name].copy_(_t(value))
    return module


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


class GapRecorder:
    """Wraps the port's `moe._route` and records the smallest gap between
    the k-th and (k+1)-th router probability of any token."""

    def __init__(self, monkeypatch):
        self.gap = float("inf")
        orig = Mo._route

        def route(logits, k, use_kernel):
            out = orig(logits, k, use_kernel)
            p = torch.sort(out[2], dim=-1, descending=True).values
            self.gap = min(self.gap, float((p[:, k - 1] - p[:, k]).min()))
            return out

        monkeypatch.setattr(Mo, "_route", route)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 48), (3, 128)])
def test_rms_norm_matches_reference(shape):
    x, s = _np(shape, 1, 3.0), _np(shape[-1:], 2)
    _close(L.rms_norm(_t(x), _t(s), 1e-5),
           RL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5), 1e-6)


def test_rms_norm_keeps_bf16():
    x = _t(_np((4, 64), 3)).bfloat16()
    y = L.rms_norm(x, torch.ones(64))
    assert y.dtype == torch.bfloat16
    want = RL.rms_norm(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                       jnp.ones(64))
    _close(y.float(), np.asarray(want, np.float32), 2.0 ** -7)


@pytest.mark.parametrize("batched_pos", [False, True])
def test_apply_rope_matches_reference(batched_pos):
    x = _np((2, 9, 3, 16), 4)
    pos = np.arange(5, 14)
    if batched_pos:
        pos = np.stack([pos, pos + 100])
    _close(L.apply_rope(_t(x), torch.from_numpy(pos), 1e4),
           RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-6)


@pytest.mark.parametrize("kw", [
    {}, {"causal": False}, {"window": 7}, {"prefix_len": 11},
    {"q_offset": 5}, {"skip_masked_blocks": True},
])
@pytest.mark.parametrize("kv", [4, 2])
def test_blockwise_attn_matches_reference(kw, kv):
    """Causal and full masks, windows, prefixes and offsets, with KV == H
    (MLA's) and grouped heads, match the reference, whose block sizes and
    block skipping change no result (tests/test_torch_gqa.py covers the
    masks in full)."""
    q, k, v = _np((2, 37, 4, 16), 5), _np((2, 37, kv, 16), 6), \
        _np((2, 37, kv, 16), 7)
    port_kw = {n: x for n, x in kw.items() if n != "skip_masked_blocks"}
    got = L.blockwise_attn(_t(q), _t(k), _t(v), **port_kw)
    want = RL.blockwise_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             block_q=16, block_k=8, **kw)
    _close(got, want, 1e-5)


def test_blockwise_attn_equals_the_flash_plain_version():
    """The model's attention is the kernel's plain version over flattened
    heads on the CPU (the card path launches the kernel there)."""
    q, k, v = (_t(_np((2, 50, 3, 24), s)) for s in (8, 9, 10))
    got = L.blockwise_attn(q, k, v)
    flat = [t.transpose(1, 2).reshape(6, 50, 24) for t in (q, k, v)]
    want = port_attention.flash_attention_ref(*flat).reshape(
        2, 3, 50, 24).transpose(1, 2)
    _close(got, want, 1e-5)


def _mla_pair(d=64, h=4, seed=0):
    mla = L.MLAConfig(kv_lora=32, qk_nope=16, qk_rope=8, v_dim=16)
    ref = RL.mla_init(jax.random.PRNGKey(seed), d, h,
                      RL.MLAConfig(**dataclasses.asdict(mla)))
    ref = jax.tree.map(np.asarray, ref)
    port = _load(L.mla_init(d, h, mla), ref)
    return mla, ref, port


def test_mla_prefill_then_decode_match_reference():
    mla, ref, port = _mla_pair()
    rmla = RL.MLAConfig(**dataclasses.asdict(mla))
    B, Tn, S = 2, 12, 16
    x = _np((B, Tn + 2, 64), 11)
    rc = RL.mla_cache_init(B, S, rmla)
    pc = L.mla_cache_init(B, S, mla)
    ry, rc = RL.mla_apply(ref, jnp.asarray(x[:, :Tn]), mode="prefill",
                          cache=rc, pos=0, mla=rmla, block_q=8, block_k=4)
    py, pc = L.mla_apply(port, _t(x[:, :Tn]), mode="prefill", cache=pc,
                         pos=0, mla=mla)
    _close(py, ry, 1e-5)
    for key in ("c", "kr"):
        _close(pc[key], rc[key], 1e-5)
    for t in (Tn, Tn + 1):
        ry, rc = RL.mla_apply(ref, jnp.asarray(x[:, t:t + 1]), mode="decode",
                              cache=rc, pos=jnp.int32(t), mla=rmla)
        py, pc = L.mla_apply(port, _t(x[:, t:t + 1]), mode="decode",
                             cache=pc, pos=t, mla=mla)
        _close(py, ry, 1e-5)
        _close(pc["c"], rc["c"], 1e-5)


def test_mla_multi_token_decode_masks_as_the_reference():
    """A decode of T > 1 tokens at pos: every query row sees keys [0, pos]
    only, as the reference masks them (s_valid = pos + 1)."""
    mla, ref, port = _mla_pair()
    rmla = RL.MLAConfig(**dataclasses.asdict(mla))
    B, Tn, S = 2, 9, 16
    x = _np((B, Tn + 3, 64), 13)
    rc = RL.mla_cache_init(B, S, rmla)
    pc = L.mla_cache_init(B, S, mla)
    _, rc = RL.mla_apply(ref, jnp.asarray(x[:, :Tn]), mode="prefill",
                         cache=rc, pos=0, mla=rmla)
    _, pc = L.mla_apply(port, _t(x[:, :Tn]), mode="prefill", cache=pc,
                        pos=0, mla=mla)
    ry, rc = RL.mla_apply(ref, jnp.asarray(x[:, Tn:]), mode="decode",
                          cache=rc, pos=jnp.int32(Tn), mla=rmla)
    py, pc = L.mla_apply(port, _t(x[:, Tn:]), mode="decode", cache=pc,
                         pos=Tn, mla=mla)
    _close(py, ry, 1e-5)
    for key in ("c", "kr"):
        _close(pc[key], rc[key], 1e-5)


def test_mla_cache_overrun_raises():
    mla, _, port = _mla_pair()
    cache = L.mla_cache_init(1, 4, mla)
    with pytest.raises(ValueError, match="overruns"):
        L.mla_apply(port, _t(_np((1, 1, 64), 1)), mode="decode", cache=cache,
                    pos=4, mla=mla)


def test_mlp_matches_reference():
    ref = jax.tree.map(np.asarray, RL.mlp_init(jax.random.PRNGKey(3), 32, 48))
    port = _load(L.mlp_init(32, 48), ref)
    x = _np((2, 5, 32), 12)
    _close(L.mlp_apply(port, _t(x)), RL.mlp_apply(ref, jnp.asarray(x)), 1e-5)


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Tn", [(2, 32), (8, 1), (3, 6), (1, 7)])
def test_factor_groups_match_reference(B, Tn):
    assert Mo._factor_groups(B, Tn) == RMo._factor_groups(B, Tn)


def test_dispatch_plan_matches_reference_bitwise():
    rng = np.random.default_rng(4)
    idx = np.stack([rng.permutation(8)[:2] for _ in range(3 * 24)]).reshape(
        3, 24, 2)
    gate = rng.random((3, 24, 2)).astype(np.float32)
    want = RMo._dispatch_plan(jnp.asarray(idx, jnp.int32), jnp.asarray(gate),
                              8, 5)
    got = Mo._dispatch_plan(torch.from_numpy(idx).long(), _t(gate), 8, 5)
    for g, w in zip(got[:4], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((~got[3]).any())                       # capacity 5 drops


def test_router_kernel_route_equals_plain_route():
    logits = _t(_np((40, 8), 13))
    logits[3, :2] = 0.5                                # an exact tie
    a, b = Mo._route(logits, 2, True), Mo._route(logits, 2, False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_apply_matches_reference(use_kernel, capacity_factor,
                                     monkeypatch):
    """capacity_factor 1.0 drops tokens (8.0, REDUCED's, drops none)."""
    kw = {"num_experts": 8, "top_k": 2, "d_ff": 32, "n_shared": 1,
          "shared_d_ff": 32, "capacity_factor": capacity_factor,
          "router_use_kernel": use_kernel}
    rmc, pmc = RMo.MoEConfig(**kw), Mo.MoEConfig(**kw)
    ref = jax.tree.map(np.asarray, RMo.moe_init(jax.random.PRNGKey(5), 48,
                                                rmc))
    port = _load(Mo.moe_init(48, pmc), ref)
    x = _np((2, 64, 48), 14)
    gaps = GapRecorder(monkeypatch)
    py, paux = Mo.moe_apply(port, _t(x), pmc, train=True)
    ry, raux = RMo.moe_apply(ref, jnp.asarray(x), rmc, train=True)
    assert gaps.gap > TIE_GAP
    _close(py, ry, 1e-5)
    _close(paux, raux, 1e-6)
    if capacity_factor == 1.0:
        # some token lost an expert: the output differs from cf = 8.0's
        wide = Mo.moe_apply(port, _t(x), dataclasses.replace(
            pmc, capacity_factor=8.0))[0]
        assert not torch.allclose(py, wide)


# ---------------------------------------------------------------------------
# the whole REDUCED model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reduced_pair():
    rcfg = ref_reduced(ARCH)
    params = RT.init_params(jax.random.PRNGKey(1), rcfg)
    tree = jax.tree.map(np.asarray, params)
    return rcfg, params, tree


def test_configs_are_the_reference_field_for_field():
    from repro.configs import get_config as ref_get
    for port_cfg, ref_cfg in ((get_config(ARCH), ref_get(ARCH)),
                              (reduced_config(ARCH), ref_reduced(ARCH))):
        a, b = dataclasses.asdict(port_cfg), dataclasses.asdict(ref_cfg)
        assert a.keys() == b.keys()
        for key in a:
            if key == "param_dtype":
                assert str(a[key]).split(".")[-1] == jnp.dtype(b[key]).name
            else:
                assert a[key] == b[key], key


@pytest.mark.parametrize("use_kernel", [False, True])
def test_reduced_model_prefill_and_decode_match_reference(
        reduced_pair, use_kernel, monkeypatch):
    rcfg, params, tree = reduced_pair
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, router_use_kernel=use_kernel))
    pcfg = reduced_config(ARCH)
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, router_use_kernel=use_kernel))
    model = params_from_reference(tree, pcfg, device="cpu")
    B, Tn = 2, 32
    toks = np.random.default_rng(6).integers(0, rcfg.vocab_size,
                                             (B, Tn + 3)).astype(np.int32)
    gaps = GapRecorder(monkeypatch)
    rc = RT.init_cache(rcfg, B, Tn + 3)
    pc = T.init_cache(pcfg, B, Tn + 3, device="cpu")
    rl, rc = RM.prefill_step(params, {"inputs": jnp.asarray(toks[:, :Tn])},
                             rc, rcfg)
    pl, pc = M.prefill_step(model, {"inputs": torch.from_numpy(
        toks[:, :Tn]).long()}, pc, pcfg)
    assert pl.shape == (B, 1, pcfg.padded_vocab) and pl.dtype == torch.float32
    _close(pl, rl, 2e-3)
    for part in ("prefix", "periods"):
        for key in ("c", "kr"):
            _close(pc[part]["0"][key], rc[part]["0"][key], 2e-3)
    for t in range(Tn, Tn + 3):
        rl, rc = RM.decode_step(params, jnp.asarray(toks[:, t:t + 1]), rc,
                                jnp.int32(t), rcfg)
        pl, pc = M.decode_step(model, torch.from_numpy(
            toks[:, t:t + 1]).long(), pc, t, pcfg)
        _close(pl, rl, 2e-3)
    _close(pc["periods"]["0"]["c"], rc["periods"]["0"]["c"], 2e-3)
    assert gaps.gap > TIE_GAP


def test_reduced_prefill_decode_consistency(reduced_pair):
    """The reference's invariant (`tests/test_models.py`), on the port
    alone: prefill(T) then decode(T..T+2) equals a prefill over T+3 at
    those positions."""
    _, _, tree = reduced_pair
    cfg = reduced_config(ARCH)
    model = params_from_reference(tree, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 35))).long()
    hidden, _, _ = T.forward(model, cfg, toks, mode="prefill")
    full = T.compute_logits(model, cfg, hidden)
    cache = T.init_cache(cfg, 2, 35, device="cpu")
    logits, cache = M.prefill_step(model, {"inputs": toks[:, :32]}, cache,
                                   cfg)
    _close(logits[:, 0], full[:, 31], 2e-3)
    for t in range(32, 35):
        logits, cache = M.decode_step(model, toks[:, t:t + 1], cache,
                                      torch.tensor(t), cfg)
        _close(logits[:, 0], full[:, t], 2e-3)


def test_init_params_draws_at_the_reference_scales():
    cfg = reduced_config(ARCH)
    a = T.init_params(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    b = T.init_params(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
        assert x.dtype == cfg.param_dtype and not x.requires_grad
    moe = a["periods"]["0"]["0"]["moe"]
    assert abs(float(moe["w_in"].std()) * np.sqrt(cfg.d_model) - 1) < 0.05
    assert abs(float(moe["w_out"].std()) * np.sqrt(cfg.moe.d_ff) - 1) < 0.05
    assert abs(float(a["embed"].std()) / 0.02 - 1) < 0.05
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
    names = {n for n, _ in a.named_parameters()}
    assert {"embed", "head", "prefix.0.ffn.w_in", "periods.1.0.moe.router",
            "periods.0.0.attn.w_uk"} <= names


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduced_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_cache(cfg, 1, 4)


def test_unported_branches_raise():
    """Training runs (train_step gives a finite loss); a layer kind the
    reference lacks raises as the reference's does; the recurrent kinds,
    their architectures, the GQA layer and the int8 KV cache build."""
    cfg = reduced_config(ARCH)
    with pytest.raises(ValueError, match="layer kind"):
        T.init_params(dataclasses.replace(
            cfg, pattern=(T.LayerSpec("rwkv"),)), device="cpu")
    mamba = T.init_params(dataclasses.replace(
        reduced_config("jamba_v01_52b"), pattern=(T.LayerSpec("mamba"),)),
        device="cpu")
    assert "mixer" in mamba["periods"]["0"]["0"]
    for arch in ("jamba_v01_52b", "xlstm_350m"):
        assert get_config(arch).num_layers in (24, 32)
    from repro_torch.data import batch_to_device, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    state = M.make_train_state(cfg, device="cpu")
    batch = batch_to_device(make_batch(cfg, "train", 16, 2), "cpu")
    _, metrics = M.train_step(state, batch, cfg, AdamWConfig())
    assert np.isfinite(float(metrics["loss"]))
    gqa = dataclasses.replace(cfg, pattern=(T.LayerSpec("attn", "glu"),),
                              n_kv_heads=2, head_dim=32, kv_quant=True)
    T.init_params(gqa, device="cpu")
    cache = T.init_cache(gqa, 1, 4, device="cpu")
    assert cache["periods"]["0"]["k"].dtype == torch.int8
    assert cache["periods"]["0"]["ks"].dtype == torch.bfloat16
    assert get_config("qwen3_14b").n_kv_heads == 8


def test_params_from_reference_checks_keys_and_shapes(reduced_pair):
    _, _, tree = reduced_pair
    cfg = reduced_config(ARCH)
    with pytest.raises(ValueError, match="keys"):
        params_from_reference({k: v for k, v in tree.items()
                               if k != "head"}, cfg, device="cpu")
    bad = dict(tree, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(bad, cfg, device="cpu")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_blockwise_attn_launches_the_kernel():
    dev = _cuda()
    q, k, v = (_t(_np((2, 70, 3, 48), s)) for s in (1, 2, 3))
    before = port_attention.FMA_LAUNCHES       # float32: the FMA kernel
    got = L.blockwise_attn(q.to(dev), k.to(dev), v.to(dev))
    assert port_attention.FMA_LAUNCHES == before + 1
    _close(got.cpu(), L.blockwise_attn(q, k, v), 1e-5)
    # a window and grouped heads (one KV head for three) on the same kernel
    for kw, kk, vv in (({"window": 8}, k, v),
                       ({"q_offset": 9}, k[:, :, :1], v[:, :, :1])):
        got = L.blockwise_attn(q.to(dev), kk.to(dev), vv.to(dev), **kw)
        _close(got.cpu(), L.blockwise_attn(q, kk, vv, **kw), 1e-5)
    assert port_attention.FMA_LAUNCHES == before + 3


@pytest.mark.cuda
def test_cuda_full_width_depth_1_plus_1_matches_reference():
    """Full width, the prefix layer and one MoE period, float32, B = 1,
    T = 64, router through the kernel: the port on the card against the
    reference on the CPU, prefill and two decode steps."""
    dev = _cuda()
    from repro.configs import get_config as ref_get
    rcfg = ref_get(ARCH)
    rcfg = dataclasses.replace(
        rcfg, num_periods=1, param_dtype=jnp.float32,
        moe=dataclasses.replace(rcfg.moe, router_use_kernel=True))
    pcfg = get_config(ARCH)
    pcfg = dataclasses.replace(
        pcfg, num_periods=1, param_dtype=torch.float32,
        moe=dataclasses.replace(pcfg.moe, router_use_kernel=True))
    params = RT.init_params(jax.random.PRNGKey(2), rcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                  device=dev)
    toks = np.random.default_rng(8).integers(0, rcfg.vocab_size,
                                             (1, 66)).astype(np.int32)
    rc = RT.init_cache(rcfg, 1, 66)
    pc = T.init_cache(pcfg, 1, 66, device=dev)
    rl, rc = RM.prefill_step(params, {"inputs": jnp.asarray(toks[:, :64])},
                             rc, rcfg)
    pl, pc = M.prefill_step(model, {"inputs": torch.from_numpy(
        toks[:, :64]).long().to(dev)}, pc, pcfg)
    _close(pl.cpu(), rl, 2e-3)
    for t in (64, 65):
        rl, rc = RM.decode_step(params, jnp.asarray(toks[:, t:t + 1]), rc,
                                jnp.int32(t), rcfg)
        pl, pc = M.decode_step(model, torch.from_numpy(
            toks[:, t:t + 1]).long().to(dev), pc, t, pcfg)
        _close(pl.cpu(), rl, 2e-3)
