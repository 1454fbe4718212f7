"""The port's LM dry run (`configs/shapes.py`, `launch/sharding.py`,
`launch/dryrun.py`, `reterm.py`, `report.py`) against the reference's.

Exact throughout (integers and the same float formulas):
  * `SHAPES` and `shape_runnable`; `input_specs` and `cache_spec` shapes
    and dtypes for the ten architectures x four shapes;
  * `param_specs` (FSDP on and off), `state_specs` ("fsdp", "zero1"),
    `batch_specs` and `cache_specs` leaf for leaf, for the ten full-size
    architectures on both production meshes. The reference's functions
    read only `mesh.axis_names` and `mesh.devices.shape`, so a stand-in
    with those two attributes drives them. A period's parameter in the
    port is one leaf a period; its spec is the reference's stacked spec
    without the leading None;
  * the sweep's 80 records: the skips, `count_params`, `count_bytes`, and
    the analytic terms (`cell_costs`, `model_flops`);
  * the reference CLI's XLA memory analysis on xlstm-350m decode_32k
    (multi-pod): alias bytes equal, argument bytes 4 more in the port
    (see `test_argument_bytes_match_xla`).
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import input_specs as ref_input_specs
from repro.configs.shapes import cache_spec as ref_cache_spec
from repro.configs.shapes import shape_runnable as ref_runnable
from repro.launch import sharding as RS
from repro.launch.costmodel import cell_costs as ref_cell_costs
from repro.launch.roofline import model_flops as ref_model_flops
from repro.models.model import make_train_state as ref_train_state
from repro.models.transformer import init_params as ref_init_params
from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs
from repro_torch.configs.shapes import ShapeCfg, cache_spec, shape_runnable
from repro_torch.launch import dryrun, report, reterm
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.params import _reference_path
from repro_torch.models.transformer import model_skeleton
from repro_torch.optim.adamw import adamw_init

# the reference's dryrun module forces 512 host devices through XLA_FLAGS
# when imported; keep that out of this process's environment
with mock.patch.dict(os.environ):
    from repro.launch.dryrun import count_params as ref_count_params

ROOT = Path(__file__).resolve().parents[1]
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def ref_mesh(multi: bool):
    shape, axes = MESHES[multi]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def ref_leaves(tree) -> dict:
    """"a/b/c" -> leaf of a reference pytree (specs as leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def port_leaves(tree) -> dict:
    return {path[1:]: leaf for path, leaf in S.leaves(tree)}


def assert_specs_equal(port: dict, ref: dict) -> None:
    """Nested port specs against the reference's, path for path."""
    got, want = port_leaves(port), ref_leaves(ref)
    assert set(got) == set(want)
    for path, spec in got.items():
        assert tuple(spec) == tuple(want[path]), path


def assert_param_specs_equal(port: dict, ref) -> None:
    """name -> spec of the port's leaves against the reference's tree: a
    period's leaf takes its stacked leaf's spec without the stack axis."""
    want = ref_leaves(ref)
    seen = set()
    for name, spec in port.items():
        path, period = _reference_path(name)
        key = "/".join(path)
        seen.add(key)
        ref_spec = tuple(want[key])
        if period is not None:
            assert ref_spec[0] is None, key
            ref_spec = ref_spec[1:]
        assert tuple(spec) == ref_spec, name
    assert seen == set(want)


_REF = {}


def reference(arch: str):
    """The reference's (config, params shapes, train-state shapes)."""
    if arch not in _REF:
        cfg = ref_config(arch)
        key = jax.random.PRNGKey(0)
        _REF[arch] = (cfg, jax.eval_shape(lambda: ref_init_params(key, cfg)),
                      jax.eval_shape(lambda: ref_train_state(key, cfg)))
    return _REF[arch]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The port CLI's full sweep: --arch all --shape all --mesh both."""
    out = tmp_path_factory.mktemp("dryrun") / "all.jsonl"
    assert dryrun.main(["--arch", "all", "--shape", "all", "--mesh", "both",
                        "--out", str(out), "--quiet"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    return out, {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


def test_shapes_are_the_reference():
    assert SHAPES.keys() == REF_SHAPES.keys()
    for name, s in SHAPES.items():
        r = REF_SHAPES[name]
        assert (s.name, s.kind, s.seq, s.batch) == (r.name, r.kind, r.seq,
                                                    r.batch)
    for arch in ARCHS:
        for name in SHAPES:
            assert shape_runnable(get_config(arch), SHAPES[name]) == \
                ref_runnable(ref_config(arch), REF_SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_are_the_reference(arch):
    cfg, cfg_r = get_config(arch), ref_config(arch)
    for name in SHAPES:
        got = port_leaves(input_specs(cfg, SHAPES[name]))
        want = ref_leaves(ref_input_specs(cfg_r, REF_SHAPES[name]))
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert dtype_name(t.dtype) == str(want[k].dtype), (name, k)
        got = port_leaves(cache_spec(cfg, SHAPES[name]))
        want = ref_leaves(ref_cache_spec(cfg_r, REF_SHAPES[name]))
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert dtype_name(t.dtype) == str(want[k].dtype), (name, k)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_are_the_reference_leaf_for_leaf(arch, multi):
    cfg_r, ref_params, ref_state = reference(arch)
    cfg = get_config(arch)
    mesh, rmesh = make_production_mesh(multi_pod=multi), ref_mesh(multi)
    params = model_skeleton(cfg, "meta")
    for fsdp in (True, False):
        assert_param_specs_equal(
            S.param_specs(params, mesh, fsdp=fsdp),
            RS.param_specs(ref_params, rmesh, fsdp=fsdp))
    state = {"params": params, "opt": adamw_init(params)}
    for mode in ("fsdp", "zero1"):
        got = S.state_specs(state, mesh, mode=mode)
        want = RS.state_specs(ref_state, rmesh, mode=mode)
        assert_param_specs_equal(got["params"], want["params"])
        for k in ("m", "v"):
            assert_param_specs_equal(got["opt"][k], want["opt"][k])
        assert tuple(got["opt"]["step"]) == tuple(want["opt"]["step"]) == ()
    for name in SHAPES:
        got = S.batch_specs(input_specs(cfg, SHAPES[name]), mesh)
        want = RS.batch_specs(ref_input_specs(cfg_r, REF_SHAPES[name]), rmesh)
        assert_specs_equal(got, want)
        got = S.cache_specs(cache_spec(cfg, SHAPES[name]), mesh)
        want = RS.cache_specs(ref_cache_spec(cfg_r, REF_SHAPES[name]), rmesh)
        assert_specs_equal(got, want)


def test_named_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_production_mesh(multi_pod=True)
    spec = S.P(("pod", "data"), None, "model")
    pl = S.named({"x": spec}, mesh)["x"]
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert S.named(S.P(), mesh) == (Replicate(),) * 3
    assert S.local_shape((64, 3, 48), pl, mesh) == (2, 3, 3)
    with pytest.raises(ValueError):
        S.local_shape((16, 3, 48), pl, mesh)


def test_sweep_skips_are_the_reference(sweep):
    _, recs = sweep
    assert len(recs) == len(ARCHS) * len(SHAPES) * 2
    assert not [k for k, r in recs.items() if r["status"] == "error"]
    skipped = {k for k, r in recs.items() if r["status"] == "skipped"}
    want = {(a, s, m) for a in ARCHS for s in SHAPES for m in
            ("single", "multi")
            if not ref_runnable(ref_config(a), REF_SHAPES[s])[0]}
    assert skipped == want


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_analytic_terms_are_the_reference(arch, sweep):
    _, recs = sweep
    cfg_r, ref_params, _ = reference(arch)
    total, active = ref_count_params(cfg_r, ref_params)
    params = model_skeleton(get_config(arch), "meta")
    assert dryrun.count_params(get_config(arch), params) == (total, active)
    assert S.count_bytes(params) == RS.count_bytes(ref_params)
    serve_fsdp = total * 2 / 16 > 6e9
    for (a, name, mesh), rec in recs.items():
        if a != arch or rec["status"] != "ok":
            continue
        shape = REF_SHAPES[name]
        n_dev = 512 if mesh == "multi" else 256
        assert rec["devices"] == n_dev
        assert (rec["params_total"], rec["params_active"]) == (total, active)
        cost = ref_cell_costs(cfg_r, shape.kind, shape.seq, shape.batch,
                              n_devices=n_dev, model_ax=16,
                              dp_ax=n_dev // 16,
                              fsdp=(shape.kind == "train" or serve_fsdp))
        assert rec["flops_per_dev"] == cost.flops_per_dev
        assert rec["bytes_per_dev"] == cost.bytes_per_dev
        assert rec["coll_bytes_analytic"] == cost.coll_bytes_per_dev
        tokens = shape.batch * (1 if shape.kind == "decode" else shape.seq)
        mf = ref_model_flops(active, tokens, shape.kind)
        assert rec["model_flops_total"] == mf
        assert rec["model_flops_per_dev"] == mf / n_dev
        assert rec["useful_flops_ratio"] == mf / n_dev / cost.flops_per_dev
        assert rec["mem"]["fits_hbm"] == (rec["mem"]["argument_bytes"]
                                          < 80e9)
        for key in ("compile_s", "flops_hlo_raw", "collectives_hlo_raw",
                    "hlo_bytes"):
            assert key not in rec


def test_argument_bytes_match_xla(tmp_path):
    """The reference CLI compiles xlstm-350m decode_32k on 512 forced host
    devices. Its alias bytes (the donated cache) equal the port's. Its
    argument bytes are the port's less the 4 bytes of the 0-d int32
    `pos`: jax.jit drops the arguments a step never reads (keep_unused
    False), and xlstm's decode reads no position (no attention layer).
    The port's own bytes of params + tokens + cache are XLA's figure."""
    out = tmp_path / "ref.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", "xlstm-350m",
         "--shape", "decode_32k", "--mesh", "multi", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    xla = json.loads(out.read_text().splitlines()[-1])["mem"]
    rec = dryrun.lower_cell("xlstm-350m", "decode_32k", True)
    assert rec["mem"]["alias_bytes"] == xla["alias_bytes"]
    assert rec["mem"]["argument_bytes"] == xla["argument_bytes"] + 4

    mesh = make_production_mesh(multi_pod=True)
    cfg = get_config("xlstm-350m")
    params = dict(model_skeleton(cfg, "meta").named_parameters())
    fsdp = dryrun.serve_fsdp_rule(rec["params_total"])      # False here
    tokens = {"tokens": input_specs(cfg, SHAPES["decode_32k"])["tokens"]}
    cache = cache_spec(cfg, SHAPES["decode_32k"])
    without_pos = (
        dryrun.shard_bytes(params, S.param_specs(params, mesh, fsdp=fsdp),
                           mesh)
        + dryrun.shard_bytes(tokens, S.batch_specs(tokens, mesh), mesh)
        + dryrun.shard_bytes(cache, S.cache_specs(cache, mesh), mesh))
    assert without_pos == xla["argument_bytes"]
    # an unread 0-d int32 argument is not in XLA's argument bytes
    lowered = jax.jit(lambda x, pos: x + 1).lower(
        jax.ShapeDtypeStruct((8,), jnp.int32),
        jax.ShapeDtypeStruct((), jnp.int32))
    assert lowered.compile().memory_analysis().argument_size_in_bytes == 32


def test_cli_one_cell_prints_ok(capsys):
    assert dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k",
                        "--mesh", "single"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["status"] == "ok"


@pytest.mark.parametrize("variant,shape", [
    ("skip", "prefill_32k"), ("kvq", "decode_32k"), ("zero1", "train_4k"),
    ("accum4", "train_4k"), ("skip,kvq", "decode_32k")])
def test_every_variant_parses(variant, shape):
    base = dryrun.lower_cell("qwen3-14b", shape, False)
    rec = dryrun.lower_cell("qwen3-14b", shape, False, variant=variant)
    assert rec["status"] == "ok" and rec["variant"] == variant
    if variant == "skip":     # half the attention FLOPs
        assert rec["flops_per_dev"] < base["flops_per_dev"]
    if "kvq" in variant:      # an int8 cache and its scales
        assert rec["mem"]["alias_bytes"] < base["mem"]["alias_bytes"]
    if variant == "zero1":    # params replicated on data, grads all-reduced
        assert rec["mem"]["argument_bytes"] > base["mem"]["argument_bytes"]
        assert rec["coll_bytes_analytic"] != base["coll_bytes_analytic"]


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.lower_cell("qwen3-14b", "train_4k", False, variant="bogus")


def test_long_context_of_full_attention_is_skipped():
    rec = dryrun.lower_cell("qwen3-14b", "long_500k", True)
    assert rec["status"] == "skipped"
    assert rec["reason"] == ref_runnable(ref_config("qwen3-14b"),
                                         REF_SHAPES["long_500k"])[1]


def test_one_slot_mesh_holds_every_leaf_whole():
    """The card check's cell (chip_smoke.py tools (b)): on a one-slot mesh
    each leaf is whole, so the argument bytes are the tensors' nbytes."""
    from repro_torch.launch.mesh import make_mesh

    cfg = get_config("deepseek-v2-lite-16b")
    card = ShapeCfg("card", "decode", 2080, 8)
    mesh = make_mesh((1, 1), ("data", "model"), devices="meta")
    rec = dryrun.lower_cell("deepseek-v2-lite-16b", card, mesh=mesh)
    params = model_skeleton(cfg, "meta")
    cache = cache_spec(cfg, card)
    want = (S.count_bytes(params) + S.count_bytes(cache) + 8 * 4 + 4)
    assert rec["mem"]["argument_bytes"] == want
    assert rec["mem"]["alias_bytes"] == S.count_bytes(cache)
    assert (rec["devices"], rec["mesh"], rec["status"]) == (1, "1x1", "ok")


def test_reterm_and_report(sweep, tmp_path, capsys):
    path, recs = sweep
    before = path.read_text()
    copy = tmp_path / "d.jsonl"
    lines = before.splitlines()
    stale = json.loads(lines[0])
    assert stale["status"] == "ok"
    stale["flops_per_dev"] = 0.0
    copy.write_text("\n".join([json.dumps(stale)] + lines[1:]) + "\n")
    reterm.main([str(copy)])
    assert copy.read_text() == before        # refreshed back, rest unchanged
    report.main([str(copy)])
    out = capsys.readouterr().out
    ok = sum(r["status"] == "ok" for r in recs.values())
    skip = sum(r["status"] == "skipped" for r in recs.values())
    assert f"{ok} ok / {skip} skipped / 0 error" in out
    assert "fit 80GB HBM" in out
    assert "| xlstm_350m | decode_32k | multi | ok | - | 0.08GB | - |" in out
    assert "## Roofline (multi-pod 2x16x16)" in out
