"""The port's training substrate around the step, on the CPU, against the
reference: AdamW and its schedule (`repro_torch.optim.adamw`), gradient
compression, the token data pipeline, the checkpoint store (restore,
async saves with GC, bf16, and train states in both directions), the
train loop (bit-exact restart, the straggler hook), the CLI and the
example.

Tolerances: AdamW's leaves against the reference's `adamw_update` on the
same inputs within 1e-6 relative (float32 elementwise; pow and cos of two
libraries may differ in the last bit); compression, data and
checkpoints bitwise; a train step from a restored state within the
reference's 2e-3.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.data import pipeline as RP
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.optim import compression as RC
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import reduced_config
from repro_torch.data import (
    Prefetcher,
    TokenDataset,
    batch_to_device,
    make_batch,
)
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.models.params import (
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.optim import adamw as A
from repro_torch.optim.compression import compress_grads, decompress_grads
from repro_torch.runtime import TrainLoop, TrainLoopConfig
from repro_torch.runtime import trainloop
from torch_train_ref import close_trees, reference_state

torch.set_num_threads(1)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_adamw_matches_reference_formulas():
    """The reference's own test (tests/test_optim.py) held within the port."""
    cfg = A.AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.1,
                        clip_norm=1e9, warmup_steps=0, total_steps=1,
                        min_lr_frac=1.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    new_p, new_opt, _ = A.adamw_update(cfg, p, g, A.adamw_init(p))
    m = 0.1 * np.array([0.5, 0.25])
    v = 0.01 * np.array([0.25, 0.0625])
    mh, vh = m / (1 - 0.9), v / (1 - 0.99)
    want = np.array([1.0, -2.0]) - 1e-2 * (
        mh / (np.sqrt(vh) + 1e-8) + 0.1 * np.array([1.0, -2.0]))
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-6)
    assert int(new_opt["step"]) == 1 and new_opt["step"].dtype == torch.int32
    assert new_p["w"] is p["w"]                  # written in place


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_adamw_update_matches_reference(clip):
    """Three steps over float32 and bf16 leaves, clipping on (norm ~30)
    and off: parameters (in their dtype), m, v, step, grad_norm and lr
    against the reference's on the same inputs."""
    cfg = dict(lr=3e-3, clip_norm=clip, warmup_steps=2, total_steps=6)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 2, 4)}
    p = {k: _np(s, i) for i, (k, s) in enumerate(shapes.items())}
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    rp["c"] = rp["c"].astype(jnp.bfloat16)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tp["c"] = tp["c"].bfloat16()
    ropt, topt = RA.adamw_init(rp), A.adamw_init(tp)
    assert topt["m"]["c"].dtype == torch.float32
    for step in range(3):
        g = {k: _np(s, 10 + 3 * step + i, 10.0)
             for i, (k, s) in enumerate(shapes.items())}
        rp, ropt, rmet = RA.adamw_update(RA.AdamWConfig(**cfg), rp,
                                         {k: jnp.asarray(v)
                                          for k, v in g.items()}, ropt)
        tp, topt, tmet = A.adamw_update(A.AdamWConfig(**cfg), tp,
                                        {k: torch.from_numpy(v)
                                         for k, v in g.items()}, topt)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(rmet[key]),
                                       rtol=1e-6)
        assert int(topt["step"]) == int(ropt["step"]) == step + 1
        for k in shapes:
            assert tp[k].dtype == (torch.bfloat16 if k == "c"
                                   else torch.float32)
            for got, want in ((tp[k], rp[k]), (topt["m"][k], ropt["m"][k]),
                              (topt["v"][k], ropt["v"][k])):
                want = np.asarray(want, np.float32)
                np.testing.assert_allclose(got.float().numpy(), want,
                                           rtol=1e-6, atol=1e-6 * np.abs(
                                               want).max())


def test_grad_clipping_bounds_update():
    cfg = A.AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=0, total_steps=1,
                        weight_decay=0.0, min_lr_frac=1.0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}                   # norm 200 >> 1
    _, opt, metrics = A.adamw_update(cfg, p, g, A.adamw_init(p))
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    # the clipped gradient (norm 1) is what m sees
    np.testing.assert_allclose(opt["m"]["w"].numpy(), 0.1 * 0.5, rtol=1e-6)
    assert float(A.global_norm([torch.ones(4), torch.full((2,), 2.0)])) == \
        pytest.approx(np.sqrt(12.0))


def test_cosine_schedule_matches_reference():
    cfg = A.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                        min_lr_frac=0.1)
    rcfg = RA.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                          min_lr_frac=0.1)
    lrs = [float(A.cosine_lr(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 120, 5)]
    want = [float(RA.cosine_lr(rcfg, jnp.asarray(s)))
            for s in range(0, 120, 5)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=1e-7)
    assert lrs[0] == 0.0
    assert abs(max(lrs) - 1.0) < 0.05
    assert abs(lrs[-1] - 0.1) < 0.02
    assert all(b <= a + 1e-6 for a, b in zip(lrs[2:], lrs[3:]))


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def test_compression_matches_reference_bitwise():
    """int8 values, scales, error feedback over two rounds and the
    decompressed gradients bitwise equal to the reference's (round half
    to even, one float32 scale a leaf)."""
    rng = np.random.default_rng(0)
    g = {"a": rng.normal(size=64).astype(np.float32),
         "b": {"c": (rng.normal(size=(8, 8)) * 100).astype(np.float32),
               "d": np.array([0.5, -1.5, 2.5, 127.0], np.float32)}}
    rerr = terr = None
    for _ in range(2):
        rq, rs, rerr = RC.compress_grads(jax.tree.map(jnp.asarray, g), rerr)
        tq, ts, terr = compress_grads(jax.tree.map(torch.from_numpy, g), terr)
        for got, want in ((tq, rq), (ts, rs), (terr, rerr),
                          (decompress_grads(tq, ts, 4.0),
                           RC.decompress_grads(rq, rs, 4.0))):
            for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert jax.tree.leaves(tq)[0].dtype == torch.int8
    back = decompress_grads(tq, ts)
    np.testing.assert_allclose(back["b"]["c"].numpy(), g["b"]["c"],
                               atol=np.abs(g["b"]["c"]).max() / 100)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3_14b", "musicgen_large",
                                  "paligemma_3b"])
def test_make_batch_is_byte_identical_to_reference(arch):
    cfg = reduced_config(arch)
    from repro.configs import reduced_config as ref_reduced
    for step, seed in ((0, 0), (7, 3)):
        got = make_batch(cfg, "train", 32, 3, step=step, seed=seed)
        want = RP.make_batch(ref_reduced(arch), "train", 32, 3, step=step,
                             seed=seed)
        assert set(got) == set(want)
        for k in got:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_token_dataset_shards_match_reference():
    for heads in (1, 4):
        a = TokenDataset(500, 24, 4, seed=5, num_output_heads=heads)
        b = RP.TokenDataset(500, 24, 4, seed=5, num_output_heads=heads)
        for shard in (0, 1):
            x, y = a.batch(3, shard, 2), b.batch(3, shard, 2)
            for k in x:
                assert x[k].tobytes() == y[k].tobytes()


def test_prefetcher_yields_steps_in_order():
    ds = TokenDataset(100, 8, 2, seed=1)
    pf = Prefetcher(ds.batch, depth=2, start_step=3)
    try:
        for step in (3, 4, 5):
            got = pf.get()
            want = ds.batch(step)["inputs"]
            assert got["inputs"].tobytes() == want.tobytes()
    finally:
        pf.close()


def test_batch_to_device():
    cfg = reduced_config("paligemma_3b")
    b = batch_to_device(make_batch(cfg, "train", 16, 2), "cpu")
    assert b["inputs"].dtype == torch.float32
    assert b["labels"].dtype == torch.int32
    assert b["prefix_len"] == 4 and isinstance(b["prefix_len"], int)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture
def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.tensor([1.0, 2.5, -3.0, 1 / 3]).bfloat16()},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip_with_bf16(tmp_path, tree):
    """A bf16 leaf is saved as float32 with "bfloat16" in the manifest (the
    reference's format) and narrowed back exactly."""
    d = save_checkpoint(str(tmp_path), 7, tree)
    import json
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {e["path"]: e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes == {"opt/step": "int32", "params/b": "bfloat16",
                      "params/w": "float32"}
    like = jax.tree.map(torch.zeros_like, tree)
    back = restore_checkpoint(str(tmp_path), 7, like)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference reads the port's step, bf16 included
    rlike = {"params": {"w": jnp.zeros((3, 4)),
                        "b": jnp.zeros(4, jnp.bfloat16)},
             "opt": {"step": jnp.int32(0)}}
    rback = ref_restore(str(tmp_path), 7, rlike)
    assert rback["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(rback["params"]["b"], np.float32),
        tree["params"]["b"].float().numpy())


def test_restores_the_reference_bf16_step(tmp_path):
    ref_save(str(tmp_path), 2, {"b": jnp.asarray([1.5, -2.25],
                                                 jnp.bfloat16)})
    back = restore_checkpoint(str(tmp_path), 2,
                              {"b": torch.zeros(2, dtype=torch.bfloat16)})
    assert torch.equal(back["b"], torch.tensor([1.5, -2.25]).bfloat16())


def test_uncommitted_checkpoints_ignored(tmp_path, tree):
    save_checkpoint(str(tmp_path), 3, tree)
    save_checkpoint(str(tmp_path), 5, tree)
    os.remove(os.path.join(str(tmp_path), "step_00000005", "_COMMITTED"))
    assert latest_step(str(tmp_path)) == 3
    assert list_steps(str(tmp_path)) == [3]
    assert list_steps(str(tmp_path), committed_only=False) == [3, 5]
    assert latest_step(str(tmp_path / "none")) is None


def test_restore_checks_leaves(tmp_path, tree):
    save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(KeyError, match="extra"):
        restore_checkpoint(str(tmp_path), 1, {"extra": torch.zeros(1)})
    bad = jax.tree.map(torch.zeros_like, tree)
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, bad)


def test_async_checkpointer_and_gc(tmp_path, tree):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
        tree["params"]["w"].add_(1.0)      # the saved copy must not see it
    ck.wait()
    steps = sorted(n for n in os.listdir(str(tmp_path))
                   if n.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert latest_step(str(tmp_path)) == 4
    back = restore_checkpoint(str(tmp_path), 3, tree)
    assert torch.equal(back["params"]["w"],
                       torch.arange(12.0).reshape(3, 4) + 2.0)


def test_async_checkpointer_raises_on_wait(tmp_path, tree):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker), keep=2)
    ck.save(1, tree)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                   # raised once


def test_reference_train_state_restores_and_steps_as_the_reference(
        tmp_path):
    """A train state the reference saved restores in the port (the
    reference's layout, periods stacked) and the port's next step equals
    the reference's; a state the port saved restores in the reference."""
    arch = "deepseek_v2_lite_16b"
    cfg = reduced_config(arch)
    cfg_r, ref = reference_state(arch, seed=2)
    opt = A.AdamWConfig(total_steps=20, warmup_steps=1)
    ropt = RA.AdamWConfig(total_steps=20, warmup_steps=1)
    batch = make_batch(cfg, "train", 16, 2, step=4)
    jb = jax.tree.map(jnp.asarray, batch)
    ref, _ = RM.train_step(ref, jb, cfg_r, ropt)       # a state with m, v
    ref_save(str(tmp_path / "r"), 1, ref)
    like = train_state_to_reference(M.make_train_state(cfg, device="cpu"),
                                    cfg)
    state = train_state_from_reference(
        restore_checkpoint(str(tmp_path / "r"), 1, like), cfg, device="cpu")
    assert int(state["opt"]["step"]) == 1
    close_trees(train_state_to_reference(state, cfg),
                jax.tree.map(np.asarray, ref), 0.0, "restored")
    batch2 = make_batch(cfg, "train", 16, 2, step=5)
    want, _ = RM.train_step(ref, jax.tree.map(jnp.asarray, batch2), cfg_r,
                            ropt)
    state, _ = M.train_step(state, batch_to_device(batch2, "cpu"), cfg, opt)
    got = train_state_to_reference(state, cfg)
    close_trees(got, jax.tree.map(np.asarray, want), 2e-3, "next step")
    # and back: the port's save restores in the reference
    save_checkpoint(str(tmp_path / "p"), 2, got)
    back = ref_restore(str(tmp_path / "p"), 2, want)
    close_trees(got, jax.tree.map(np.asarray, back), 0.0, "port -> ref")


# ---------------------------------------------------------------------------
# the train loop, the CLI and the example
# ---------------------------------------------------------------------------

LOOP_CFG = reduced_config("granite_3_8b")
LOOP_OPT = A.AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=1)


def _batch_fn(step):
    return make_batch(LOOP_CFG, "train", 16, 2, step=step)


def _loop(ckpt_dir, **kw):
    return TrainLoop(LOOP_CFG, LOOP_OPT, TrainLoopConfig(
        ckpt_dir=str(ckpt_dir), ckpt_every=4, log_every=100, **kw),
        _batch_fn, log=lambda *a: None, device="cpu")


def test_restart_is_bit_exact(tmp_path):
    """The reference's tests/test_runtime.py held within the port: a run
    killed at step 4 and resumed equals an uninterrupted run bitwise
    (parameters, m, v and step)."""
    state_a, _ = _loop(tmp_path / "a").run(8)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        _loop(tmp_path / "b").run(8, die_at_step=4)
    loop_c = _loop(tmp_path / "b")
    assert loop_c.step == 4, "did not resume from the committed step"
    state_c, _ = loop_c.run(8)
    a = train_state_to_reference(state_a, LOOP_CFG)
    c = train_state_to_reference(state_c, LOOP_CFG)
    close_trees(a, {k: v for k, v in jax.tree.map(
        lambda t: t.float().numpy(), c).items()}, 0.0, "restart")
    assert list_steps(str(tmp_path / "b")) == [4, 8]


def test_straggler_hook_fires(tmp_path, monkeypatch):
    """A step made slow (its train_step sleeps 2 s) fires on_straggler with
    its index and its time. It is step 24 of 26, so that the EMA, which
    starts at the first step's time (~2.5 s with the first call's
    set-up, ~0.06 s after) and decays by 0.9 a step, has settled on the
    fast steps; a noisy fast step may fire too (the hook is the
    mechanism, the policy the caller's)."""
    import time
    events = []
    real = trainloop.train_step

    def slow(state, batch, cfg, opt):
        out = real(state, batch, cfg, opt)
        if int(state["opt"]["step"]) == 25:     # the 25th step: index 24
            time.sleep(2.0)
        return out

    monkeypatch.setattr(trainloop, "train_step", slow)
    loop = TrainLoop(LOOP_CFG, LOOP_OPT, TrainLoopConfig(
        ckpt_dir=str(tmp_path), ckpt_every=100, log_every=100,
        straggler_factor=2.5), _batch_fn,
        on_straggler=lambda s, dt, ema: events.append((s, dt, ema)),
        log=lambda *a: None, device="cpu")
    loop.run(26)
    slow_events = [e for e in events if e[0] == 24]
    assert len(slow_events) == 1 and slow_events[0][1] >= 2.0, events
    assert slow_events[0][1] > 2.5 * slow_events[0][2]


def test_loss_decreases_on_tiny_run():
    """The reference's tests/test_models.py run: 12 steps overfitting one
    batch at lr 1e-2 lower the loss by more than 0.5."""
    cfg = LOOP_CFG
    state = M.make_train_state(cfg, device="cpu")
    opt = A.AdamWConfig(lr=1e-2, total_steps=30, warmup_steps=1,
                        weight_decay=0.0)
    batch = batch_to_device(make_batch(cfg, "train", 32, 2, step=0), "cpu")
    losses = []
    for _ in range(12):
        state, m = M.train_step(state, batch, cfg, opt)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_train_state(LOOP_CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        _ = TrainLoop(LOOP_CFG, LOOP_OPT, TrainLoopConfig(ckpt_dir="x"),
                      _batch_fn)


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "qwen3-14b", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    launch_train.main(argv)
    out = capsys.readouterr().out
    assert "final step 4" in out and "[resume]" not in out
    launch_train.main(argv[:-4] + ["--steps", "6", "--ckpt-every", "2",
                                   "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[resume] restored step 4" in out and "final step 6" in out
    assert list_steps(str(tmp_path)) == [2, 4, 6]


def test_train_resume_example_passes(capsys):
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "torch_train_resume.py")
    spec = importlib.util.spec_from_file_location("torch_train_resume", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    assert "bit-exact match" in capsys.readouterr().out


def test_compression_config_fields():
    from repro_torch.optim import CompressionConfig
    assert dataclasses.asdict(CompressionConfig()) == dataclasses.asdict(
        RC.CompressionConfig())
