"""The port's graph-parallel `distributed` backend against the reference.

The port's counterpart of `tests/helpers/dist_check.py`, in process: a
mesh of repeated `cpu` slots stands in for XLA's forced host devices, so
no subprocess is needed. On integer-valued rows (every sum exact): a
(2, 4) ("data", "model") mesh with P=4 answers with the ids, dists and
per-query dist_calcs of the port's partitioned backend and of the
reference's partitioned backend, rerank off and on; a doubled batch gives
identical halves; every mesh shape agrees; a P that does not divide over
`model`, or a batch that does not divide over `data`, raises. A
distributed index saved by either package loads in the other and answers
identically. Also the mesh and the block placement themselves, and the
shared-graph backends (partitioned, distributed, csd) answering
identically per metric — the counterpart of
`tests/test_parity_matrix.py::test_shared_graph_backends_answer_identically`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.api import IndexSpec as RefSpec
from repro.api import SearchRequest as RefRequest
from repro.api import SearchService as RefService
from repro.core.hnsw_graph import HNSWConfig as RefHNSW
from repro_torch.api import IndexSpec, SearchRequest, SearchService
from repro_torch.api.backends import DistributedBackend, get_backend
from repro_torch.core.distributed import shard_db
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.core.partitioned import build_partitioned_db
from repro_torch.data import clustered_vectors
from repro_torch.launch.mesh import dp_axes, make_mesh, mesh_shape
from repro_torch.store import CSDBackend

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

K, EF, P = 8, 32, 4
HNSW = dict(M=8, ef_construction=60)


@pytest.fixture(scope="module")
def data():
    """dist_check's shapes, integer-valued: 1,600 32-d rows in 16
    clusters, 8 noisy queries."""
    v = np.rint(clustered_vectors(1600, 32, k=16, seed=0)).astype(np.float32)
    rng = np.random.default_rng(1)
    q = v[rng.integers(0, 1600, 8)] + rng.normal(scale=1.0, size=(8, 32))
    return v, np.rint(np.clip(q, 0, 255)).astype(np.float32)


def _spec(backend, **kw):
    return IndexSpec(backend=backend, num_partitions=P,
                     hnsw=HNSWConfig(**HNSW), keep_vectors=True, **kw)


def _leaves(svc):
    """A service's state as the flat {leaf-path: array} dict `load` reads."""
    return {f"{top}/{k}": np.asarray(v)
            for top, sub in svc.backend.state_tree().items()
            for k, v in sub.items()}


def _mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes[-len(shape):], devices="cpu")


@pytest.fixture(scope="module")
def part(data):
    return SearchService.build(data[0], _spec("partitioned", fused_hops=4),
                               device="cpu")


@pytest.fixture(scope="module")
def ref_part(data):
    v, _ = data
    return RefService.build(v, RefSpec(backend="partitioned", num_partitions=P,
                                       hnsw=RefHNSW(**HNSW),
                                       keep_vectors=True))


@pytest.fixture(scope="module")
def dist(data):
    """Built through the entry point on the (2, 4) mesh of dist_check."""
    return SearchService.build(data[0], _spec("distributed", fused_hops=4),
                               device="cpu", mesh=_mesh((2, 4)))


def _on_mesh(part, mesh, spec=None):
    """The partitioned service's own graph as a distributed index on
    `mesh` (as `SearchService.load` makes it)."""
    spec = spec or dataclasses.replace(part.spec, backend="distributed")
    return SearchService(spec, DistributedBackend.from_state(
        spec, _leaves(part), "cpu", mesh=mesh))


def _answer(svc, q, rerank, ref=False):
    if ref:
        r = svc.search(RefRequest(queries=q, k=K, ef=EF, rerank=rerank,
                                  with_stats=True))
    else:
        r = svc.search(SearchRequest(q, k=K, ef=EF, rerank=rerank,
                                     with_stats=True))
    return [np.asarray(a) for a in (r.ids, r.dists, r.stats.dist_calcs)]


def _assert_same(got, want):
    for name, a, b in zip(("ids", "dists", "dist_calcs"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# dist_check: graph parallelism == partitioned, query parallelism
# ---------------------------------------------------------------------------


def test_backend_is_ported():
    from repro_torch.api import backends
    assert get_backend("distributed") is DistributedBackend
    assert backends._UNPORTED == ()


@pytest.mark.parametrize("rerank", [False, True])
def test_mesh_2x4_matches_partitioned_and_reference(data, part, ref_part,
                                                    dist, rerank):
    _, q = data
    got = _answer(dist, q, rerank)
    assert dist.search(SearchRequest(q, k=K, ef=EF,
                                     with_stats=True)).stats.hops is None
    _assert_same(got, _answer(part, q, rerank))
    _assert_same(got, _answer(ref_part, q, rerank, ref=True))


@pytest.mark.parametrize("rerank", [False, True])
def test_doubled_batch_gives_identical_halves(data, dist, rerank):
    _, q = data
    ids, dists, calcs = _answer(dist, np.concatenate([q, q]), rerank)
    b = len(q)
    for a in (ids, dists, calcs):
        np.testing.assert_array_equal(a[:b], a[b:])
    _assert_same([ids[:b], dists[:b], calcs[:b]], _answer(dist, q, rerank))


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2), (8, 1), (4,)])
def test_every_mesh_gives_the_same_answer(data, part, shape):
    _, q = data
    svc = _on_mesh(part, _mesh(shape))
    for rerank in (False, True):
        _assert_same(_answer(svc, q, rerank), _answer(part, q, rerank))


def test_partitions_must_divide_over_model(data):
    v, _ = data
    spec = dataclasses.replace(_spec("distributed"), num_partitions=3)
    with pytest.raises(ValueError, match="must divide over the mesh model"):
        SearchService.build(v[:200], spec, device="cpu", mesh=_mesh((1, 2)))


def test_batch_must_divide_over_data(data, dist):
    _, q = data
    with pytest.raises(ValueError, match="must divide over"):
        dist.search(SearchRequest(q[:7], k=K, ef=EF))


def test_mesh_kind_must_match_the_device(data, part):
    """A mesh of CPU slots for an index asked for on the card raises, and
    the default mesh needs CUDA unless device='cpu' is passed."""
    with pytest.raises(ValueError, match="slots are on"):
        DistributedBackend.from_state(part.spec, _leaves(part), "cuda",
                                      mesh=_mesh((1, 2)))


def test_entry_points_need_cuda_unless_cpu_is_asked(data, monkeypatch):
    v, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchService.build(v[:100], _spec("distributed"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1,), ("model",))


# ---------------------------------------------------------------------------
# save / load across packages
# ---------------------------------------------------------------------------


def test_port_save_loads_into_reference(data, dist, tmp_path):
    _, q = data
    dist.save(str(tmp_path))
    back = RefService.load(str(tmp_path))
    assert back.spec.backend == "distributed"
    for rerank in (False, True):
        _assert_same(_answer(back, q, rerank, ref=True),
                     _answer(dist, q, rerank))


def test_reference_save_loads_into_port(data, tmp_path):
    v, q = data
    ref = RefService.build(v, RefSpec(backend="distributed", num_partitions=P,
                                      hnsw=RefHNSW(**HNSW),
                                      keep_vectors=True))
    ref.save(str(tmp_path))
    port = SearchService.load(str(tmp_path), device="cpu",
                              mesh=_mesh((2, 2)))
    assert isinstance(port.backend, DistributedBackend)
    assert port.spec.to_json() == ref.spec.to_json()
    for rerank in (False, True):
        _assert_same(_answer(port, q, rerank),
                     _answer(ref, q, rerank, ref=True))


# ---------------------------------------------------------------------------
# the mesh and the placement
# ---------------------------------------------------------------------------


def test_make_mesh_repeats_slots():
    m = make_mesh((2, 4), ("data", "model"), devices="cpu")
    assert m.shape == {"data": 2, "model": 4} == mesh_shape(m)
    assert m.size == 8 and dp_axes(m) == ("data",)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    m = make_mesh((2,), ("model",), devices=["cpu", "cpu"])
    assert m.devices.shape == (2,) and dp_axes(m) == ()
    with pytest.raises(ValueError, match="slots"):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)


def test_shard_db_places_contiguous_blocks_shared_across_data(data):
    v, _ = data
    pdb = build_partitioned_db(v[:400], P, HNSWConfig(**HNSW))
    sdb = shard_db(pdb, _mesh((2, 2)))
    for (row, col), (g, db) in sdb.slots.items():
        assert g == col
        np.testing.assert_array_equal(db.gids.numpy(),
                                      pdb.db.gids[2 * col:2 * col + 2])
        # the data rows share one copy of their block
        assert db.vectors is sdb.slots[0, col][1].vectors
    for got, want in zip(sdb.host_db(), pdb.db):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the shared-graph backends (test_parity_matrix.py's counterpart)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared(data, tmp_path_factory):
    """One graph per metric: partitioned, the same graph on a (2, 2) mesh,
    and the same graph out of core."""
    out = {}
    for metric in ("l2", "cosine"):
        p = SearchService.build(data[0], _spec("partitioned", metric=metric,
                                               fused_hops=4), device="cpu")
        store = str(tmp_path_factory.mktemp(f"shared-{metric}") / "store")
        cspec = dataclasses.replace(p.spec, backend="csd", keep_vectors=False,
                                    storage_path=store, prefetch=False)
        out[metric] = {
            "partitioned": p,
            "distributed": _on_mesh(p, _mesh((2, 2))),
            "csd": SearchService(cspec, CSDBackend.from_partitioned(
                p.backend.pdb, cspec, device="cpu"))}
    return out


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("backend", ["partitioned", "distributed", "csd"])
def test_shared_graph_backends_answer_identically(data, shared, backend,
                                                  metric):
    _, q = data
    svcs = shared[metric]
    for rerank in (False, True):
        want = svcs["partitioned"].search(SearchRequest(q, k=K, ef=EF,
                                                        rerank=rerank))
        got = svcs[backend].search(SearchRequest(q, k=K, ef=EF,
                                                 rerank=rerank))
        np.testing.assert_array_equal(got.ids.numpy(), want.ids.numpy())
        np.testing.assert_array_equal(got.dists.numpy(), want.dists.numpy())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_meshes_match_partitioned(data):
    """The default mesh (every card over `model`) and a (2, 2) mesh of
    cuda:0 slots, each slot on its own stream: partitioned's answers,
    bitwise, rerank off and on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    v, q = data
    part = SearchService.build(v, _spec("partitioned", fused_hops=4),
                               device="cuda")
    spec = dataclasses.replace(part.spec, backend="distributed")
    meshes = [None, make_mesh((2, 2), ("data", "model"), devices="cuda:0")]
    for mesh in meshes:
        svc = SearchService(spec, DistributedBackend.from_state(
            spec, _leaves(part), "cuda", mesh=mesh))
        for rerank in (False, True):
            got = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                   for a in _answer_t(svc, q, rerank)]
            want = [a.cpu().numpy() for a in _answer_t(part, q, rerank)]
            _assert_same(got, want)


def _answer_t(svc, q, rerank):
    r = svc.search(SearchRequest(q, k=K, ef=EF, rerank=rerank,
                                 with_stats=True))
    return r.ids, r.dists, r.stats.dist_calcs
