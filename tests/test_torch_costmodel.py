"""The port's cost model (`repro_torch.launch.costmodel`, `roofline`)
against the reference's on the same inputs, on the CPU.

The arithmetic is the reference's line for line, so every float must be
bitwise equal: `cell_costs` and `_count_params` for all ten reference
architectures (each reference config converted field by field into the
port's `ModelConfig`), at every reference shape and at two mesh settings;
the storage, dispatch, compaction and fan-out terms over a grid of
inputs, raising the same `ValueError`s. Then the model against the port
itself: `_count_params` within 2 % of the reduced DeepSeek-V2-Lite's
`init_params` (the reference's bar), and `FlopCounterMode` over its
prefill on the CPU inside the reference's band for that architecture,
0.55 < measured / analytic < 1.9 (`tests/test_costmodel.py`, tol 0.45).
The ratio found when this test was written: 0.99996 (every counted op an
`aten.bmm`: the einsums of MLA, the plain attention and the experts).
"""

import dataclasses
import itertools

import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS, SHAPES, get_config as ref_config
from repro.launch import costmodel as RC
from repro.launch import roofline as RR
from repro.models import layers as RL
from repro.models import moe as RMo
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch.configs import reduced_config
from repro_torch.launch import costmodel as C
from repro_torch.launch.roofline import HW, model_flops, roofline_terms
from repro_torch.models import layers as L
from repro_torch.models import moe as Mo
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.model import prefill_step

torch.set_num_threads(1)

_NESTED = {"mla": L.MLAConfig, "moe": Mo.MoEConfig, "mamba": S.MambaConfig,
           "xlstm": S.XLSTMConfig}
MESHES = {"default": {},
          "one-device": dict(n_devices=1, model_ax=1, dp_ax=1, fsdp=False)}


def to_port(ref) -> T.ModelConfig:
    """A reference ModelConfig as the port's, field by field."""
    kw = {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.name in _NESTED and v is not None:
            v = _NESTED[f.name](**dataclasses.asdict(v))
        elif f.name in ("pattern", "prefix_pattern"):
            v = tuple(T.LayerSpec(**dataclasses.asdict(s)) for s in v)
        elif f.name == "param_dtype":
            v = getattr(torch, jnp.dtype(v).name)
        kw[f.name] = v
    return T.ModelConfig(**kw)


@pytest.mark.parametrize("ref,port", [
    (RT.ModelConfig, T.ModelConfig), (RT.LayerSpec, T.LayerSpec),
    (RL.MLAConfig, L.MLAConfig), (RMo.MoEConfig, Mo.MoEConfig),
    (RS.MambaConfig, S.MambaConfig), (RS.XLSTMConfig, S.XLSTMConfig)])
def test_config_fields_match_reference(ref, port):
    """The conversion is field by field: same names, same defaults (but
    the dtype, a jnp one against a torch one)."""
    rf = {f.name: f.default for f in dataclasses.fields(ref)}
    pf = {f.name: f.default for f in dataclasses.fields(port)}
    assert list(rf) == list(pf)
    rf.pop("param_dtype", None), pf.pop("param_dtype", None)
    assert rf == pf


def test_mamba_config_methods():
    for mc in (S.MambaConfig(), S.MambaConfig(expand=3, dt_rank=7)):
        rmc = RS.MambaConfig(**dataclasses.asdict(mc))
        for d in (100, 128, 4096):
            assert mc.inner(d) == rmc.inner(d)
            assert mc.rank(d) == rmc.rank(d)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_costs_equal_reference(arch, shape, mesh):
    ref = ref_config(arch)
    cfg = to_port(ref)
    s = SHAPES[shape]
    want = RC.cell_costs(ref, s.kind, s.seq, s.batch, **MESHES[mesh])
    got = C.cell_costs(cfg, s.kind, s.seq, s.batch, **MESHES[mesh])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.flops_per_dev > 0 and got.bytes_per_dev > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_helpers_equal_reference(arch):
    ref = ref_config(arch)
    cfg = to_port(ref)
    assert C._count_params(cfg) == RC._count_params(ref)
    for kind, seq, batch in (("train", 4096, 256), ("prefill", 32768, 32),
                             ("decode", 32768, 128)):
        tokens = batch if kind == "decode" else batch * seq
        assert C._act_bytes(cfg, tokens, seq, kind) == \
            RC._act_bytes(ref, tokens, seq, kind)
        assert C._cache_bytes(cfg, batch, seq) == \
            RC._cache_bytes(ref, batch, seq)


def test_cell_costs_ignore_param_dtype():
    """Weights are priced at 2 bytes whatever the dtype, as the
    reference's are."""
    cfg = to_port(ref_config("deepseek_v2_lite_16b"))
    f32 = dataclasses.replace(cfg, param_dtype=torch.float32)
    assert dataclasses.asdict(C.cell_costs(cfg, "decode", 32768, 128)) == \
        dataclasses.asdict(C.cell_costs(f32, "decode", 32768, 128))


def _same_result(port_fn, ref_fn, *args, **kwargs):
    try:
        want = ref_fn(*args, **kwargs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_fn(*args, **kwargs)
        assert str(got.value) == str(e)
        return None
    got = port_fn(*args, **kwargs)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    return got


SSD = (3.0e9, 1.7e9, 123456789.0)


@pytest.mark.parametrize("ssd_bw", SSD)
def test_storage_cost_equals_reference(ssd_bw):
    n = 0
    for blocks, bs, hit in itertools.product(
            (0, 1, 231.2, 1000, 704.0), (512, 4096, 65536),
            (0.0, 0.3521, 0.5, 0.9, 1.0, -0.1, 1.5)):
        n += _same_result(C.storage_cost, RC.storage_cost, blocks, bs,
                          cache_hit_rate=hit, ssd_bw=ssd_bw) is not None
    assert n == 5 * 3 * 5


def test_default_ssd_bw_is_the_papers():
    """The defaults price with HW.ssd_bw, the paper's SmartSSD 3 GB/s, as
    the reference's do."""
    assert HW().ssd_bw == RR.HW().ssd_bw == 3.0e9
    _same_result(C.storage_cost, RC.storage_cost, 1000, 4096)
    _same_result(C.compaction_cost, RC.compaction_cost, 10_000, 400, 100, 10)
    _same_result(C.cluster_fanout_cost, RC.cluster_fanout_cost, 2, 2,
                 dim=128, k=10, blocks_per_query=100, block_size=4096)


def test_dispatch_cost_equals_reference():
    for steps, over in itertools.product((0.0, 1.25, 4.0, 50, -1.0),
                                         (0.0, 0.002, 2.5e-5, -0.002)):
        _same_result(C.dispatch_cost, RC.dispatch_cost, steps, over)


@pytest.mark.parametrize("ssd_bw", SSD)
def test_compaction_cost_equals_reference(ssd_bw):
    for n, row, seal, every, frac in itertools.product(
            (0, 10_000, 10_000_000), (8, 128, 512), (100, 1_000_000, 0),
            (1, 8, 10**9, 0), (0.0, 0.05, 0.3, 1.0)):
        _same_result(C.compaction_cost, RC.compaction_cost, n, row, seal,
                     every, delete_frac=frac, ssd_bw=ssd_bw)


@pytest.mark.parametrize("ssd_bw", SSD)
def test_cluster_fanout_cost_equals_reference(ssd_bw):
    for n, r, hit, link in itertools.product(
            (0, 1, 2, 4, 64), (0, 1, 2, 8), (0.0, 0.5, 0.99, -0.1),
            (10e9, 1e6)):
        _same_result(C.cluster_fanout_cost, RC.cluster_fanout_cost, n, r,
                     dim=128, k=10, blocks_per_query=704.0, block_size=4096,
                     cache_hit_rate=hit, ssd_bw=ssd_bw, link_bw=link)
    # no flash traffic: an unbounded storage side, as the reference's
    _same_result(C.cluster_fanout_cost, RC.cluster_fanout_cost, 2, 1,
                 dim=128, k=10, blocks_per_query=0, block_size=4096)


def test_vector_row_bytes_equals_reference():
    for dim, dtype, lane, m in itertools.product(
            (1, 100, 128, 129, 960), ("float32", "uint8", "int8", "pq",
                                      "fp16"), (1, 128), (0, 8, 16)):
        kw = dict(lane=lane, pq_m=m)
        try:
            want = RC.vector_row_bytes(dim, dtype, **kw)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                C.vector_row_bytes(dim, dtype, **kw)
            assert str(got.value) == str(e)
            continue
        assert C.vector_row_bytes(dim, dtype, **kw) == want
    assert C.VECTOR_DTYPE_BYTES == RC.VECTOR_DTYPE_BYTES
    assert C.__all__ == RC.__all__


def test_count_params_matches_init():
    """The reference's bar: the analytic count within 2 % of the reduced
    DeepSeek-V2-Lite's parameters as the port's init_params builds them."""
    cfg = reduced_config("deepseek_v2_lite_16b")
    actual = sum(p.numel() for p in T.init_params(cfg, device="cpu")
                 .parameters())
    analytic = C._count_params(cfg)
    assert abs(actual - analytic) / actual < 0.02, (actual, analytic)


def test_prefill_flops_match_flop_counter():
    """FlopCounterMode over the reduced DeepSeek-V2-Lite prefill on the CPU
    against the analytic count, loops run once as in the reference's
    calibration (one period, no prefix, blocks and loss chunks = T). The
    reference's band for this architecture: 0.55 < ratio < 1.9."""
    T_, B = 64, 4
    cfg = dataclasses.replace(
        reduced_config("deepseek_v2_lite_16b"), num_periods=1,
        prefix_pattern=(), block_q=T_, block_k=T_, loss_chunk=T_,
        param_dtype=torch.float32)
    model = T.init_params(cfg, device="cpu")
    cache = T.init_cache(cfg, B, T_, device="cpu")
    inputs = torch.zeros((B, T_), dtype=torch.int64)
    with FlopCounterMode(display=False) as fc:
        prefill_step(model, {"inputs": inputs}, cache, cfg)
    got = fc.get_total_flops()
    want = C.cell_costs(cfg, "prefill", T_, B, n_devices=1, model_ax=1,
                        dp_ax=1, fsdp=False).flops_per_dev
    ratio = got / want
    assert 0.55 < ratio < 1.9, (
        f"FlopCounterMode {got / 1e6:.1f}MF vs analytic {want / 1e6:.1f}MF "
        f"(ratio {ratio:.5f})")


def test_hw_is_the_h100():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == \
        (989e12, 3.35e12, 450e9, 80e9)
    assert (hw.tf32_flops, hw.fp32_flops, hw.int8_ops) == \
        (495e12, 67e12, 1979e12)
    assert hw.smem_lookups == 32 * 132 * 1.98e9
    assert not hasattr(hw, "ici_bw")


def test_roofline_terms_known_answers():
    hw = HW()
    # one bf16 second of compute, half an HBM second, a quarter link second
    r = roofline_terms(989e12, 3.35e12 / 2, 450e9 / 4)
    assert r == {"compute_s": 1.0, "memory_s": 0.5, "collective_s": 0.25,
                 "dominant": "compute_s", "compute_fraction": 1.0}
    r = roofline_terms(989e12 / 4, 3.35e12, 0.0, hw)
    assert r["dominant"] == "memory_s" and r["compute_fraction"] == 0.25
    r = roofline_terms(0.0, 0.0, 900e9)
    assert r["dominant"] == "collective_s" and r["collective_s"] == 2.0
    assert r["compute_fraction"] == 0.0
    assert roofline_terms(0, 0, 0)["compute_fraction"] == 0.0
    # the same formulas as the reference's, at the reference's constants
    # mapped onto the port's names
    ref = RR.HW()
    mine = HW(peak_flops=ref.peak_flops, hbm_bw=ref.hbm_bw,
              link_bw=ref.ici_bw)
    for args in ((1e15, 2e12, 3e9), (0.0, 5e9, 0.0), (7e10, 0.0, 1e12)):
        assert roofline_terms(*args, mine) == RR.roofline_terms(*args, ref)
    for kind in ("train", "prefill", "decode"):
        assert model_flops(15.7e9, 16384, kind) == \
            RR.model_flops(15.7e9, 16384, kind)
