"""The port's two examples on the CPU.

`examples/torch_knn_lm_decode.py` against the reference's
`examples/knn_lm_decode.py` on the same weights (the reference's
`init_params`, seed 0, copied into the port): the reference's example is
one `main`, so its steps are replayed here with its own
`build_datastore` and the reference's functions. Gates, every step:
the LM log-probabilities within 2e-3 (the float32 tolerance the LM is
held to elsewhere); the retrieved ids overlapping >= 0.9 (the two
packages' float32 sums differ in order, so a near-tie in the graph walk
may go either way); the decoded tokens equal wherever the mixed
distribution's top-2 margin exceeds 1e-3.

`examples/torch_quickstart.py --n 2000 --dim 64 --partitions 2 --device
cpu` (the README's tiny-data command) runs in a subprocess and passes its
own recall asserts.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.api import IndexSpec as RIndexSpec
from repro.api import SearchRequest as RSearchRequest
from repro.api import SearchService as RSearchService
from repro.configs import reduced_config as ref_reduced
from repro.core.hnsw_graph import HNSWConfig as RHNSWConfig
from repro.data.pipeline import make_batch as ref_make_batch
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch.configs import reduced_config
from repro_torch.models.params import params_from_reference

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LM_TOL, ID_OVERLAP, MARGIN = 2e-3, 0.9, 1e-3


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_run(knn, params, cfg) -> dict:
    """The reference example's `main`, step for step, returning what the
    port's `run` returns."""
    ds_keys, ds_vals = knn.build_datastore(params, cfg)
    engine = RSearchService.build(
        ds_keys.astype(np.float32),
        RIndexSpec(backend="partitioned", num_partitions=2,
                   hnsw=RHNSWConfig(M=12, ef_construction=60)))
    B, T0 = 2, 24
    toks = jnp.asarray(ref_make_batch(cfg, "train", T0, B, step=999)["inputs"])
    cache = RT.init_cache(cfg, B, T0 + 16)
    logits, cache = RM.prefill_step(params, {"inputs": toks}, cache, cfg)
    out = {"tokens": [], "lm_logp": [], "mixed": [], "ids": []}
    for t in range(T0, T0 + 12):
        lm_logp = jax.nn.log_softmax(logits[:, 0, : cfg.vocab_size], -1)
        hid_key = np.asarray(lm_logp @ params["embed"][: cfg.vocab_size])
        resp = engine.search(RSearchRequest(
            queries=hid_key.astype(np.float32), k=8, ef=32))
        ids, dists = np.asarray(resp.ids), np.asarray(resp.dists)
        knn_logp = np.full((B, cfg.vocab_size), -30.0, np.float32)
        for b in range(B):
            w = np.exp(-dists[b] / 10.0)
            w = w / w.sum()
            for j, gid in enumerate(ids[b]):
                if gid >= 0:
                    v = int(ds_vals[gid])
                    knn_logp[b, v] = np.logaddexp(knn_logp[b, v],
                                                  np.log(w[j] + 1e-9))
        mixed = np.logaddexp(np.log1p(-knn.LAMBDA) + np.asarray(lm_logp),
                             np.log(knn.LAMBDA) + knn_logp)
        nxt = mixed.argmax(-1).astype(np.int32)
        for key, val in (("tokens", nxt), ("lm_logp", np.asarray(lm_logp)),
                         ("mixed", mixed), ("ids", ids)):
            out[key].append(val)
        logits, cache = RM.decode_step(params, jnp.asarray(nxt)[:, None],
                                       cache, jnp.int32(t), cfg)
    out["tokens"] = np.stack(out["tokens"], 1)
    for key in ("lm_logp", "mixed", "ids"):
        out[key] = np.stack(out[key])
    return out


def top2_margin(mixed: np.ndarray) -> np.ndarray:
    """[..., V] -> the gap between the two largest entries of each row."""
    top = np.sort(mixed, -1)
    return top[..., -1] - top[..., -2]


def check_knn_runs(got: dict, want: dict) -> None:
    """The gates of the module docstring, step by step."""
    assert np.isfinite(got["mixed"]).all()
    for t in range(want["lm_logp"].shape[0]):
        np.testing.assert_allclose(got["lm_logp"][t], want["lm_logp"][t],
                                   rtol=LM_TOL, atol=LM_TOL,
                                   err_msg=f"step {t}")
        for b in range(want["ids"].shape[1]):
            shared = len(set(got["ids"][t, b]) & set(want["ids"][t, b]))
            assert shared / want["ids"].shape[2] >= ID_OVERLAP, (t, b)
        sure = top2_margin(want["mixed"][t]) > MARGIN
        assert np.array_equal(got["tokens"][sure, t],
                              want["tokens"][sure, t]), t


def test_knn_lm_decode_matches_reference_example():
    knn_ref = _load("knn_lm_decode")
    knn = _load("torch_knn_lm_decode")
    cfg_r = ref_reduced(knn.ARCH)
    params = RT.init_params(jax.random.PRNGKey(0), cfg_r)
    want = reference_run(knn_ref, params, cfg_r)
    port = params_from_reference(jax.tree.map(np.asarray, params),
                                 reduced_config(knn.ARCH), device="cpu")
    got = knn.run("cpu", params=port)
    assert got["tokens"].shape == (knn.B, knn.STEPS)
    assert got["memories"] == 24 * 47 * 2
    check_knn_runs(got, want)


def test_knn_posterior_where_the_reference_underflows():
    """The port's kNN weights are relative to the nearest memory: equal to
    the reference example's formula (replayed in `reference_run`) where
    that is finite, and finite where its weights all underflow."""
    knn = _load("torch_knn_lm_decode")
    ids = np.array([[0, 1, 2], [3, 4, -1]])
    vals = np.array([5, 6, 5, 7, 8])
    near = np.array([[1.0, 2.0, 40.0], [0.5, 0.5, np.inf]], np.float32)
    want = np.full((2, 10), -30.0, np.float32)
    for b in range(2):
        w = np.exp(-near[b] / 10.0)
        w = w / w.sum()
        for j, gid in enumerate(ids[b]):
            if gid >= 0:
                want[b, vals[gid]] = np.logaddexp(want[b, vals[gid]],
                                                  np.log(w[j] + 1e-9))
    got = knn.knn_log_posterior(ids, near, vals, 10)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    far = near + np.float32(2000.0)      # exp(-200) underflows in float32
    with np.errstate(invalid="ignore"):
        assert not np.isfinite(np.exp(-far[0] / 10.0) /
                               np.exp(-far[0] / 10.0).sum()).all()
    np.testing.assert_allclose(knn.knn_log_posterior(ids, far, vals, 10),
                               got, rtol=1e-6, atol=1e-6)


def test_quickstart_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--n", "2000", "--dim", "64", "--partitions", "2",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    for metric in ("l2 ", "cosine", "uint8"):
        assert any(ln.startswith(metric) and "recall@10" in ln
                   for ln in lines), metric
    assert lines[-1] == "OK"

