"""The port's service surface against the reference, end to end.

An index saved by the reference loads into the port (device="cpu") and
answers bitwise the same on integer-valued data, rerank off and on; the
port's save loads back into the reference. Also: exact-backend parity,
no silent CPU fallback, the once-unported distributed backend builds
(quantized or not), csd refuses a spec without a block-store path, the
package imports no JAX and nothing of the reference, and the serve CLI
runs on the CPU.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import IndexSpec as RefSpec
from repro.api import SearchRequest as RefRequest
from repro.api import SearchService as RefService
from repro.core.hnsw_graph import HNSWConfig as RefHNSW
from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.data import VectorDataset
from repro_torch.launch import serve

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

K, EF = 10, 40
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def data():
    ds = VectorDataset(800, 32, 12, seed=1)
    return np.rint(ds.vectors()), np.rint(np.clip(ds.queries(16), 0, 255))


@pytest.fixture(scope="module")
def ref_saved(data, tmp_path_factory):
    """A partitioned index (P=2, keep_vectors) built and saved by the
    reference."""
    v, _ = data
    spec = RefSpec(backend="partitioned", num_partitions=2,
                   hnsw=RefHNSW(M=8, ef_construction=40), keep_vectors=True)
    svc = RefService.build(v, spec)
    path = str(tmp_path_factory.mktemp("ref-index"))
    svc.save(path)
    return svc, path


def _ref_answer(svc, q, rerank):
    r = svc.search(RefRequest(queries=q, k=K, ef=EF, rerank=rerank,
                              with_stats=True))
    return [np.asarray(a) for a in (r.ids, r.dists, r.stats.hops,
                                    r.stats.dist_calcs)]


def _port_answer(svc, q, rerank):
    r = svc.search(SearchRequest(queries=q, k=K, ef=EF, rerank=rerank,
                                 with_stats=True))
    assert r.ids.dtype == torch.int32 and r.ids.device == svc.device
    return [t.numpy() for t in (r.ids, r.dists, r.stats.hops,
                                r.stats.dist_calcs)]


def _assert_same(got, want):
    for name, a, b in zip(("ids", "dists", "hops", "dist_calcs"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("rerank", [False, True])
def test_reference_index_loads_into_port(data, ref_saved, rerank):
    _, q = data
    ref, path = ref_saved
    port = SearchService.load(path, device="cpu")
    assert port.spec.to_json() == ref.spec.to_json()
    _assert_same(_port_answer(port, q, rerank), _ref_answer(ref, q, rerank))


def test_port_save_loads_into_reference(data, ref_saved, tmp_path):
    _, q = data
    ref, path = ref_saved
    port = SearchService.load(path, device="cpu")
    port.save(str(tmp_path))
    back = RefService.load(str(tmp_path))
    for rerank in (False, True):
        _assert_same(_ref_answer(back, q, rerank), _ref_answer(ref, q, rerank))
    # saving again advances the step; the port reopens the latest one
    port.save(str(tmp_path))
    again = SearchService.load(str(tmp_path), device="cpu")
    _assert_same(_port_answer(again, q, False), _ref_answer(ref, q, False))
    assert sorted(os.listdir(tmp_path)) == ["index_manifest.json",
                                            "step_00000000", "step_00000001"]


def test_port_build_matches_reference_build(data, ref_saved):
    """Same vectors, same spec: the port's own build answers identically,
    here at fused_hops=4 (the reference served at fused_hops=1)."""
    v, q = data
    ref, _ = ref_saved
    spec = IndexSpec(backend="partitioned", num_partitions=2,
                     hnsw=HNSWConfig(M=8, ef_construction=40),
                     keep_vectors=True, fused_hops=4)
    port = SearchService.build(v, spec, device="cpu")
    _assert_same(_port_answer(port, q, True), _ref_answer(ref, q, True))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_backend_parity(data, metric):
    v, q = data
    ref = RefService.build(v, RefSpec(backend="exact", metric=metric))
    port = SearchService.build(v, IndexSpec(backend="exact", metric=metric),
                               device="cpu")
    want = ref.search(RefRequest(queries=q, k=K, with_stats=True))
    got = port.search(SearchRequest(queries=q, k=K, with_stats=True))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    np.testing.assert_array_equal(got.stats.dist_calcs.numpy(),
                                  np.asarray(want.stats.dist_calcs))


def test_hnsw_backend_cosine_recall(data):
    """Cosine normalizes at the edge (float data): recall vs exact."""
    v, q = data
    hnsw = SearchService.build(v, IndexSpec(backend="hnsw", metric="cosine",
                                            hnsw=HNSWConfig(M=8)),
                               device="cpu")
    exact = SearchService.build(v, IndexSpec(backend="exact",
                                             metric="cosine"), device="cpu")
    got = hnsw.search(SearchRequest(queries=q, k=K, ef=EF)).ids.numpy()
    gt = exact.search(SearchRequest(queries=q, k=K)).ids.numpy()
    recall = np.mean([len(set(a) & set(b)) / K for a, b in zip(got, gt)])
    assert recall >= 0.90, recall


def test_entry_points_need_cuda_unless_cpu_is_asked(data, ref_saved,
                                                    monkeypatch):
    v, _ = data
    _, path = ref_saved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchService.build(v, IndexSpec(backend="exact"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchService.load(path)
    with pytest.raises(RuntimeError):
        SearchService.build(v, IndexSpec(backend="exact"), device="cuda")


@pytest.mark.parametrize("change", [
    {"dtype": "pq", "backend": "distributed"}, {"backend": "distributed"}])
def test_unported_branches_raise(data, change):
    """No backend is left unported: the branches that raised
    NotImplementedError until the distributed backend was ported
    (quantized or not) now build on the CPU's default mesh and answer as
    the partitioned backend over the same rows."""
    from repro_torch.api import backends

    v, q = data
    assert backends._UNPORTED == ()
    spec = dataclasses.replace(IndexSpec(hnsw=HNSWConfig(M=8)), **change)
    got = SearchService.build(v, spec, device="cpu")
    want = SearchService.build(v, dataclasses.replace(
        spec, backend="partitioned", pq_codebooks=got.spec.pq_codebooks),
        device="cpu")
    assert type(got.backend).__name__ == "DistributedBackend"
    a, b = (svc.search(SearchRequest(queries=q, k=K, ef=EF))
            for svc in (got, want))
    np.testing.assert_array_equal(a.ids.numpy(), b.ids.numpy())
    np.testing.assert_array_equal(a.dists.numpy(), b.dists.numpy())


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_csd_needs_a_storage_path(data, dtype):
    """As the reference's: the csd backend writes its database to a block
    store, so a spec without `storage_path` is refused."""
    v, _ = data
    spec = IndexSpec(backend="csd", dtype=dtype)
    with pytest.raises(ValueError, match="storage_path"):
        SearchService.build(v, spec, device="cpu")


def test_rerank_needs_kept_vectors(data):
    v, q = data
    svc = SearchService.build(v[:200], IndexSpec(hnsw=HNSWConfig(M=4)),
                              device="cpu")
    with pytest.raises(ValueError, match="keep_vectors"):
        svc.search(SearchRequest(queries=q, k=K, rerank=True))


def test_package_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib',"
        " 'repro')]\n"
        "assert not bad, bad\n"
        "print(sum(k.startswith('repro_torch') for k in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 77


def test_chip_smoke_imports_no_jax_and_no_reference():
    src = (SRC.parent / "chip_smoke.py").read_text()
    for bad in ("import jax", "from jax", "import repro\n", "from repro.",
                "import repro."):
        assert bad not in src, bad


@pytest.mark.parametrize("backend", ["partitioned", "exact", "csd"])
def test_serve_cli_on_cpu(backend, capsys):
    stats = serve.main(["--n", "300", "--dim", "16", "--partitions", "2",
                        "--batch", "8", "--num-batches", "2", "--M", "4",
                        "--backend", backend, "--rerank", "--device", "cpu"])
    assert stats["batches"] == 2 and stats["qps"] > 0
    assert "[serve] 16 queries" in capsys.readouterr().out
