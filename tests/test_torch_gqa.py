"""The port's GQA attention layer, its masks in the flash kernels, and the
seven attention architectures, against the reference on the same seeded
numpy inputs and parameters, on the CPU, where the port runs its plain
versions.

Tolerances, all float32:
- `ops.flash_attention`'s plain version (through `blockwise_attn`)
  against the reference's `blockwise_attn`: 1e-5 (the same online
  softmax over other key blocks, sums in other orders). A row with no
  live key is exactly 0 in both.
- `attn_apply`, prefill and decode, and its caches: 1e-5; the int8
  cache's values within one step of 127 (the reference's and the port's
  k differ in the last bits, and a value next to a rounding boundary may
  round the other way), their scales within one bf16 spacing.
- `quant_kv` on the same inputs: bitwise (int8 values and bf16 scales).
- the whole REDUCED model through `params_from_reference`: logits and
  caches after `prefill_step` and three `decode_step`s within 2e-3, the
  reference's own tolerance (`tests/test_models.py`); the ring buffer
  compared slot for slot.

Tests marked `cuda` run only where there is a card: qwen3-14b and
h2o-danube3-4b at full layer widths, depth 1, float32, on the card
against the reference on the CPU. Two cuts keep the reference's CPU run
small, and both are stated there: the vocabulary is cut to 4,096, and
danube's window to 32 with T = 96 (so the window still cuts every row
past 32 and the ring wraps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get
from repro.configs import reduced_config as ref_reduced
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as Mo
from repro_torch.models import transformer as T
from repro_torch.models.params import params_from_reference

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

DENSE = ["qwen3_14b", "granite_3_8b", "minitron_8b", "h2o_danube3_4b",
         "dbrx_132b", "musicgen_large", "paligemma_3b"]
TIE_GAP = 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _load(module, tree):
    for name, value in tree.items():
        if isinstance(value, dict):
            _load(module[name], value)
        else:
            module[name].copy_(_t(value))
    return module


# ---------------------------------------------------------------------------
# the flash kernels' mask: the plain version against blockwise_attn
# ---------------------------------------------------------------------------

MASKS = [
    {}, {"window": 1}, {"window": 5}, {"window": 7, "q_offset": 7},
    {"window": 40}, {"window": 40, "q_offset": 40}, {"prefix_len": 1},
    {"prefix_len": 9}, {"prefix_len": 35, "q_offset": 7},
    {"q_offset": 40}, {"window": 5, "prefix_len": 9, "q_offset": 7},
    {"causal": False}, {"causal": False, "window": 7, "q_offset": 40},
]


@pytest.mark.parametrize("kw", MASKS)
@pytest.mark.parametrize("h,kv,t,s", [
    (4, 4, 37, 37), (4, 2, 20, 45), (4, 1, 45, 20), (10, 2, 37, 300),
])
def test_flash_plain_version_matches_blockwise_attn(kw, h, kv, t, s):
    """windows, prefixes and query offsets, KV heads 1, 2 and H and G = 5,
    T != S (300 keys: two of the plain version's 256-key steps)."""
    q, k, v = _np((2, t, h, 16), 1), _np((2, s, kv, 16), 2), \
        _np((2, s, kv, 16), 3)
    want = RL.blockwise_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             block_q=16, block_k=8, **kw)
    got = L.blockwise_attn(_t(q), _t(k), _t(v), **kw)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_rows_with_no_live_key_are_zero(causal):
    """window 4 at q_offset 40 over 16 keys masks every row: zeros, as the
    reference's -inf guards give (the kernels' old -1e30 quirk gave the
    mean of V); with a window of 60 the rows past position 74 see none."""
    q, k, v = _np((1, 16, 4, 8), 4), _np((1, 16, 2, 8), 5), _np((1, 16, 2, 8),
                                                                   6)
    for window, q_len in ((4, 16), (60, 16)):
        want = RL.blockwise_attn(jnp.asarray(q[:, :q_len]), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, q_offset=40)
        got = L.blockwise_attn(_t(q[:, :q_len]), _t(k), _t(v), causal=causal,
                               window=window, q_offset=40)
        _close(got, want, 1e-5)
        if window == 4:
            assert bool((got == 0).all()) and not np.asarray(want).any()
    flat = ops.flash_attention(_t(q[0]).transpose(0, 1).contiguous(),
                               _t(k[0]).transpose(0, 1).contiguous(),
                               _t(v[0]).transpose(0, 1).contiguous(),
                               causal=causal, window=60, q_offset=60)
    assert bool((flat[:, 15:] == 0).all()) and bool(flat[:, :15].any())


def test_grouped_heads_read_kv_head_h_over_g():
    """Query head h reads KV head h // G, not h % KV: both agree when KV
    is 1 or H, so G = 2 and 5 are held to a naive per-head softmax."""
    for h, kv in ((4, 2), (10, 2)):
        q, k, v = _np((2, 9, h, 8), 7), _np((2, 9, kv, 8), 8), \
            _np((2, 9, kv, 8), 9)
        got = L.blockwise_attn(_t(q), _t(k), _t(v), causal=False)
        g = h // kv
        for head in range(h):
            sc = np.einsum("btd,bsd->bts", q[:, :, head], k[:, :, head // g])
            p = np.exp(sc / np.sqrt(8) - (sc / np.sqrt(8)).max(-1,
                                                              keepdims=True))
            want = np.einsum("bts,bsd->btd", p / p.sum(-1, keepdims=True),
                             v[:, :, head // g])
            _close(got[:, :, head], want, 1e-5)


def test_mla_prefill_at_an_offset_matches_reference():
    """MLA prefill of a second chunk at pos = 5 (q_offset = 5 over that
    chunk's own keys, the reference's convention) into the same cache."""
    mla = L.MLAConfig(kv_lora=32, qk_nope=16, qk_rope=8, v_dim=16)
    rmla = RL.MLAConfig(**dataclasses.asdict(mla))
    ref = jax.tree.map(np.asarray, RL.mla_init(jax.random.PRNGKey(4), 64, 4,
                                               rmla))
    port = _load(L.mla_init(64, 4, mla), ref)
    x = _np((2, 12, 64), 10)
    rc, pc = RL.mla_cache_init(2, 16, rmla), L.mla_cache_init(2, 16, mla)
    for lo, hi in ((0, 5), (5, 12)):
        ry, rc = RL.mla_apply(ref, jnp.asarray(x[:, lo:hi]), mode="prefill",
                              cache=rc, pos=lo, mla=rmla, block_q=4,
                              block_k=4)
        py, pc = L.mla_apply(port, _t(x[:, lo:hi]), mode="prefill",
                             cache=pc, pos=lo, mla=mla)
        _close(py, ry, 1e-5)
    for key in ("c", "kr"):
        _close(pc[key], rc[key], 1e-5)


# ---------------------------------------------------------------------------
# quant_kv and the GQA layer
# ---------------------------------------------------------------------------


def test_quant_kv_matches_reference_bitwise():
    """Gaussian rows, a zero row (the 1e-6 floor), and rows built so that
    x / scale lands on .5 (round half to even in both)."""
    x = _np((3, 40, 2, 16), 11, 2.0)
    x[0, 0, 0] = 0.0
    x[1, 1, 1] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 64.5] * 2,
                          np.float32)
    wq, ws = RL.quant_kv(jnp.asarray(x))
    gq, gs = L.quant_kv(_t(x))
    assert gq.dtype == torch.int8 and gs.dtype == torch.bfloat16
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.view(torch.int16).numpy(),
                                  np.asarray(ws).view(np.int16))
    np.testing.assert_array_equal(
        L.dequant_kv(gq, gs, torch.float32).numpy(),
        np.asarray(RL.dequant_kv(wq, ws, jnp.float32)))
    assert int(gq[1, 1, 1, 2]) == 2 and int(gq[1, 1, 1, 3]) == 2


def _attn_pair(h=4, kv=2, hd=16, d=48, qk_norm=False, seed=0):
    ref = jax.tree.map(np.asarray, RL.attn_init(
        jax.random.PRNGKey(seed), d, h, kv, hd, qk_norm=qk_norm))
    port = _load(L.attn_init(d, h, kv, hd, qk_norm=qk_norm), ref)
    return ref, port


def _close_cache(pc, rc, tol=1e-5):
    for key, want in rc.items():
        got = pc[key]
        if got.dtype == torch.int8:                # one rounding step
            assert int((got.int() - torch.from_numpy(np.asarray(
                want, np.int32))).abs().max()) <= 1, key
        elif key in ("ks", "vs"):                  # one bf16 spacing
            _close(got.float(), np.asarray(want, np.float32), 2.0 ** -7)
        else:
            _close(got, want, tol)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("kind,t_pre,steps", [
    ("full", 12, 3), ("ring", 5, 10), ("ring", 8, 3), ("ring", 13, 10),
    ("int8", 12, 3),
])
def test_attn_apply_prefill_and_decode_match_reference(kind, t_pre, steps,
                                                       qk_norm):
    """The full cache; the ring buffer of W = 8 with a prompt shorter than,
    equal to and longer than the window, then decode past the wrap; the
    int8 cache. The caches are compared slot for slot."""
    ref, port = _attn_pair(qk_norm=qk_norm)
    window = 8 if kind == "ring" else 0
    quant = kind == "int8"
    B, s_max = 2, t_pre + steps
    x = _np((B, s_max, 48), 12)
    rc = RL.attn_cache_init(B, s_max, 2, 16, window=window, quant=quant)
    pc = L.attn_cache_init(B, s_max, 2, 16, window=window, quant=quant)
    assert {k: tuple(v.shape) for k, v in pc.items()} == \
        {k: v.shape for k, v in rc.items()}
    ry, rc = RL.attn_apply(ref, jnp.asarray(x[:, :t_pre]), mode="prefill",
                           cache=rc, pos=0, window=window, block_q=4,
                           block_k=4)
    py, pc = L.attn_apply(port, _t(x[:, :t_pre]), mode="prefill", cache=pc,
                          pos=0, window=window)
    _close(py, ry, 1e-5)
    _close_cache(pc, rc)
    for t in range(t_pre, s_max):
        ry, rc = RL.attn_apply(ref, jnp.asarray(x[:, t:t + 1]), mode="decode",
                               cache=rc, pos=jnp.int32(t), window=window)
        py, pc = L.attn_apply(port, _t(x[:, t:t + 1]), mode="decode",
                              cache=pc, pos=t, window=window)
        _close(py, ry, 1e-5 if not quant else 1e-4)
        _close_cache(pc, rc)


def test_attn_apply_without_a_cache_and_overrun():
    ref, port = _attn_pair(h=4, kv=4)
    x = _np((1, 9, 48), 13)
    ry, _ = RL.attn_apply(ref, jnp.asarray(x), mode="train")
    py, pc = L.attn_apply(port, _t(x), mode="train")
    _close(py, ry, 1e-5)
    assert pc is None
    cache = L.attn_cache_init(1, 4, 4, 16)
    with pytest.raises(ValueError, match="overruns"):
        L.attn_apply(port, _t(x[:, :1]), mode="decode", cache=cache, pos=4)


# ---------------------------------------------------------------------------
# the seven REDUCED configs through the whole stack
# ---------------------------------------------------------------------------


class GapRecorder:
    """The smallest gap between the k-th and (k+1)-th router probability
    of any token (`tests/test_torch_models.py`'s): a near-tie the two
    frameworks could break differently fails as a stated precondition."""

    def __init__(self, monkeypatch):
        self.gap = float("inf")
        orig = Mo._route

        def route(logits, k, use_kernel):
            out = orig(logits, k, use_kernel)
            p = torch.sort(out[2], dim=-1, descending=True).values
            self.gap = min(self.gap, float((p[:, k - 1] - p[:, k]).min()))
            return out

        monkeypatch.setattr(Mo, "_route", route)


def _fields_equal(port_cfg, ref_cfg):
    a, b = dataclasses.asdict(port_cfg), dataclasses.asdict(ref_cfg)
    assert a.keys() == b.keys()
    for key in a:
        if key == "param_dtype":
            assert str(a[key]).split(".")[-1] == jnp.dtype(b[key]).name
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("arch", DENSE)
def test_configs_are_the_reference_field_for_field(arch):
    _fields_equal(get_config(arch), ref_get(arch))
    _fields_equal(reduced_config(arch), ref_reduced(arch))
    assert get_config(arch.replace("_", "-")) == get_config(arch)


def test_registry_order_and_the_queued_architectures():
    """All ten of the reference's architectures, in its order (the
    recurrent ones, once queued, are ported); an unknown name raises."""
    from repro.configs import ARCHS as REF_ARCHS
    assert ARCHS == REF_ARCHS
    for name in ("jamba_v01_52b", "jamba-v0.1-52b", "xlstm_350m"):
        assert get_config(name).name == ref_get(name).name
        assert reduced_config(name).d_model == ref_reduced(name).d_model
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("rwkv_7b")


def _inputs(cfg, B, n, seed):
    """Tokens [B, n] or embeddings [B, n, d] (numpy), as the config takes."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    return rng.normal(scale=0.5, size=(B, n, cfg.d_model)).astype(np.float32)


def _port_in(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else t


def _run_pair(arch, monkeypatch, B=2, Tn=24, prefix=9, **replace):
    """prefill(Tn) and three decode steps through both packages; returns
    the logits pairs and the final caches."""
    rcfg = dataclasses.replace(ref_reduced(arch), **replace)
    pcfg = dataclasses.replace(reduced_config(arch), **replace)
    params = RT.init_params(jax.random.PRNGKey(1), rcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                  device="cpu")
    x = _inputs(rcfg, B, Tn + 3, seed=6)
    rb, pb = {"inputs": jnp.asarray(x[:, :Tn])}, {"inputs": _port_in(
        x[:, :Tn])}
    if rcfg.prefix_lm:
        rb["prefix_len"] = jnp.int32(prefix)
        pb["prefix_len"] = torch.tensor(prefix)
    gaps = GapRecorder(monkeypatch)
    rc = RT.init_cache(rcfg, B, Tn + 3)
    pc = T.init_cache(pcfg, B, Tn + 3, device="cpu")
    rl, rc = RM.prefill_step(params, rb, rc, rcfg)
    pl, pc = M.prefill_step(model, pb, pc, pcfg)
    pairs = [(pl, rl)]
    for t in range(Tn, Tn + 3):
        rl, rc = RM.decode_step(params, jnp.asarray(x[:, t:t + 1]), rc,
                                jnp.int32(t), rcfg)
        pl, pc = M.decode_step(model, _port_in(x[:, t:t + 1]), pc, t, pcfg)
        pairs.append((pl, rl))
    if rcfg.moe is not None:
        assert gaps.gap > TIE_GAP
    return pcfg, pairs, pc, rc


@pytest.mark.parametrize("arch", DENSE)
def test_reduced_model_prefill_and_decode_match_reference(arch,
                                                          monkeypatch):
    """dbrx routes with the near-tie recorder; musicgen takes embeddings
    and gives four heads; paligemma takes a prefix of 9; danube's window
    of 8 cuts the 24-token prompt and its ring wraps."""
    cfg, pairs, pc, rc = _run_pair(arch, monkeypatch)
    heads = () if cfg.num_output_heads == 1 else (cfg.num_output_heads,)
    for got, want in pairs:
        assert tuple(got.shape) == (2, 1, *heads, cfg.padded_vocab)
        assert got.dtype == torch.float32
        _close(got, want, 2e-3)
    for key in ("k", "v"):
        _close(pc["periods"]["0"][key], rc["periods"]["0"][key], 2e-3)


def test_musicgen_int8_cache_matches_reference(monkeypatch):
    """musicgen as configured, kv_quant on, through both packages: logits
    within 2e-3, the int8 caches within one rounding step."""
    _, pairs, pc, rc = _run_pair("musicgen_large", monkeypatch,
                                 kv_quant=True)
    for got, want in pairs:
        _close(got, want, 2e-3)
    _close_cache(pc["periods"]["0"], rc["periods"]["0"], 2e-3)


def test_paligemma_prefix_changes_the_prefill(monkeypatch):
    """The bidirectional prefix reaches the layers: prefixes 0 and 24 give
    other logits than 9, and each matches the reference."""
    logits = []
    for prefix in (0, 9, 24):
        _, pairs, _, _ = _run_pair("paligemma_3b", monkeypatch, prefix=prefix)
        _close(pairs[0][0], pairs[0][1], 2e-3)
        logits.append(pairs[0][0])
    assert not torch.allclose(logits[0], logits[1])
    assert not torch.allclose(logits[1], logits[2])


def _port_model(arch, seed=2, **replace):
    cfg = dataclasses.replace(reduced_config(arch), **replace)
    rcfg = dataclasses.replace(ref_reduced(arch), **replace)
    tree = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(seed),
                                                   rcfg))
    return cfg, params_from_reference(tree, cfg, device="cpu")


def test_ring_buffer_equals_a_full_window_cache():
    """The reference's invariant (`tests/test_models.py`), on the port:
    danube's ring buffer (S = window = 8) decoding positions 8..11 gives
    the logits of one prefill over 12 tokens."""
    cfg, model = _port_model("h2o_danube3_4b")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 12))).long()
    hidden, _, _ = T.forward(model, cfg, toks, mode="prefill")
    full = T.compute_logits(model, cfg, hidden)
    cache = T.init_cache(cfg, 1, 12, device="cpu")
    assert cache["periods"]["0"]["k"].shape[2] == 8     # [periods, B, S, ..]
    _, cache = M.prefill_step(model, {"inputs": toks[:, :8]}, cache, cfg)
    for t in range(8, 12):
        logits, cache = M.decode_step(model, toks[:, t:t + 1], cache, t, cfg)
        _close(logits[:, 0], full[:, t], 2e-3)


def test_kv_quant_decode_close_to_exact():
    """The reference's bar (`tests/test_models.py`): musicgen's int8-cache
    decode within 0.05 x max |logit| + 0.1 of the exact cache's."""
    cfg, model = _port_model("musicgen_large", seed=3)
    emb = torch.from_numpy(_inputs(cfg, 2, 32, seed=5) * 0.04)
    outs = {}
    for name, c in (("exact", cfg), ("quant", dataclasses.replace(
            cfg, kv_quant=True))):
        cache = T.init_cache(c, 2, 34, device="cpu")
        _, cache = M.prefill_step(model, {"inputs": emb}, cache, c)
        outs[name], _ = M.decode_step(model, emb[:, -1:], cache, 32, c)
    assert outs["quant"].shape == (2, 1, 4, cfg.padded_vocab)
    err = float((outs["exact"] - outs["quant"]).abs().max())
    scale = float(outs["exact"].abs().max())
    assert 0 < err < 0.05 * scale + 0.1, (err, scale)


def test_init_params_draws_attention_at_the_reference_scales():
    cfg = dataclasses.replace(reduced_config("qwen3_14b"), d_model=256,
                              n_heads=8, head_dim=64)
    model = T.init_params(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    attn = model["periods"]["0"]["0"]["attn"]
    for name, fan_in in (("wq", cfg.d_model), ("wk", cfg.d_model),
                         ("wv", cfg.d_model),
                         ("wo", cfg.n_heads * cfg.head_dim)):
        assert abs(float(attn[name].std()) * np.sqrt(fan_in) - 1) < 0.05, name
    assert tuple(attn["wk"].shape) == (256, cfg.n_kv_heads, 64)
    assert torch.equal(attn["q_norm"], torch.ones(64))
    assert torch.equal(attn["k_norm"], torch.ones(64))
    ffn = T.init_params(reduced_config("minitron_8b"), device="cpu")[
        "periods"]["0"]["0"]["ffn"]
    assert ffn["w_in"].dim() == 2                      # non-gated "dense"


@pytest.mark.parametrize("arch,embed,head", [
    ("musicgen_large", False, (128, 4, 512)),
    ("paligemma_3b", False, (128, 1, 512)),
    ("granite_3_8b", True, None),
    ("qwen3_14b", True, (128, 1, 512)),
])
def test_skeleton_embed_and_head(arch, embed, head):
    """"embed" only for token inputs; "head" unless tied to the embedding
    (granite's logits read the embedding's transpose)."""
    cfg = reduced_config(arch)
    model = T.model_skeleton(cfg, "cpu")
    assert ("embed" in model) is embed
    assert (tuple(model["head"].shape) if "head" in model else None) == head
    if head is None:
        model = T.init_params(cfg, device="cpu")
        hidden = torch.randn(1, 2, cfg.d_model)
        want = hidden @ model["embed"].T
        _close(T.compute_logits(model, cfg, hidden)[..., :cfg.vocab_size],
               want[..., :cfg.vocab_size], 1e-5)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n,window", [("qwen3_14b", 64, 0),
                                           ("h2o_danube3_4b", 96, 32)])
def test_cuda_full_width_depth_1_matches_reference(arch, n, window):
    """Full layer widths (d_model, heads, KV heads, head_dim, d_ff), one
    layer, float32, B = 1: the port on the card against the reference on
    the CPU, prefill of n tokens and two decode steps. Cut so that the
    reference's CPU run stays small: the vocabulary to 4,096 and, for
    danube, the window to 32 (so a prompt of 96 crosses it three times
    and the decode steps wrap the ring)."""
    dev = _cuda()
    cut = {"num_periods": 1, "vocab_size": 4096}
    rcfg = dataclasses.replace(ref_get(arch), param_dtype=jnp.float32, **cut)
    pcfg = dataclasses.replace(get_config(arch), param_dtype=torch.float32,
                               **cut)
    if window:
        rcfg = dataclasses.replace(rcfg, pattern=tuple(
            dataclasses.replace(s, window=window) for s in rcfg.pattern))
        pcfg = dataclasses.replace(pcfg, pattern=tuple(
            dataclasses.replace(s, window=window) for s in pcfg.pattern))
    params = RT.init_params(jax.random.PRNGKey(2), rcfg)
    model = params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                  device=dev)
    toks = _inputs(rcfg, 1, n + 2, seed=8)
    rc = RT.init_cache(rcfg, 1, n + 2)
    pc = T.init_cache(pcfg, 1, n + 2, device=dev)
    rl, rc = RM.prefill_step(params, {"inputs": jnp.asarray(toks[:, :n])},
                             rc, rcfg)
    pl, pc = M.prefill_step(model, {"inputs": _port_in(toks[:, :n]).to(dev)},
                            pc, pcfg)
    _close(pl.cpu(), rl, 2e-3)
    for t in (n, n + 1):
        rl, rc = RM.decode_step(params, jnp.asarray(toks[:, t:t + 1]), rc,
                                jnp.int32(t), rcfg)
        pl, pc = M.decode_step(model, _port_in(toks[:, t:t + 1]).to(dev), pc,
                               t, pcfg)
        _close(pl.cpu(), rl, 2e-3)
    for key in ("k", "v"):
        _close(pc["periods"]["0"][key].cpu(), rc["periods"]["0"][key], 2e-3)
