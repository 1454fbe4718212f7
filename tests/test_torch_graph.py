"""The port's numpy graph build and data pipeline against the reference.

Both packages must emit byte-identical tables for the same vectors and
seed (every DeviceDB field, dtype included), so an index built by either
one searches identically in both.
"""

import numpy as np
import pytest
import torch

from repro.core import hnsw_graph as rhg
from repro.core.partitioned import build_partitioned_db as ref_build_partitioned
from repro.data import pipeline as rpipe
from repro_torch import resolve_device
from repro_torch.core import hnsw_graph as thg
from repro_torch.core.partitioned import build_partitioned_db
from repro_torch.data import pipeline as tpipe

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

CFG = dict(M=8, ef_construction=40, seed=0)


@pytest.fixture(scope="module")
def vectors():
    return np.rint(tpipe.clustered_vectors(600, 32, 12, seed=3))


def _assert_db_equal(ref, port):
    for f in rhg.DeviceDB._fields:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(port, f))
        assert a.dtype == b.dtype, f
        assert a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


def test_build_hnsw_and_restructure_byte_equal(vectors):
    rg = rhg.build_hnsw(vectors, rhg.HNSWConfig(**CFG))
    tg = thg.build_hnsw(vectors, thg.HNSWConfig(**CFG))
    for f in ("vectors", "levels", "l0_nbrs", "up_nbrs", "up_ptr"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(rg, f))
    assert (tg.entry, tg.max_level) == (rg.entry, rg.max_level)
    _assert_db_equal(rhg.restructure(rg), thg.restructure(tg))
    _assert_db_equal(rhg.restructure(rg, n_pad=2040),
                     thg.restructure(tg, n_pad=2040))


def test_build_partitioned_db_byte_equal(vectors):
    ref = ref_build_partitioned(vectors, 2, rhg.HNSWConfig(**CFG))
    port = build_partitioned_db(vectors, 2, thg.HNSWConfig(**CFG))
    assert (port.num_partitions, port.dim) == (ref.num_partitions, ref.dim)
    _assert_db_equal(ref.db, port.db)


@pytest.fixture(scope="module")
def port_pdb(vectors):
    return build_partitioned_db(vectors, 2, thg.HNSWConfig(**CFG))


def test_tables_round_trip(port_pdb):
    tables, meta = thg.db_to_tables(port_pdb.db)
    _assert_db_equal(port_pdb.db, thg.db_from_tables(tables, meta))
    rtables, rmeta = rhg.db_to_tables(port_pdb.db)
    assert meta == rmeta
    for name in rtables:
        np.testing.assert_array_equal(tables[name], rtables[name])


def test_device_db_keeps_dtypes_and_values(port_pdb):
    dev = thg.device_db(port_pdb.db, "cpu")
    for f in thg.DeviceDB._fields:
        a, t = np.asarray(getattr(port_pdb.db, f)), getattr(dev, f)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert t.numpy().dtype == a.dtype, f
        np.testing.assert_array_equal(t.numpy(), a)


def test_db_size_bytes_matches_reference(port_pdb):
    assert thg.db_size_bytes(port_pdb.db) == rhg.db_size_bytes(port_pdb.db)


@pytest.mark.parametrize("case", ["vectors", "queries", "clustered", "sift"])
def test_pipeline_byte_equal(case):
    if case == "vectors":
        a = rpipe.VectorDataset(500, 24, 8, seed=2).vectors()
        b = tpipe.VectorDataset(500, 24, 8, seed=2).vectors()
    elif case == "queries":
        a = rpipe.VectorDataset(500, 24, 8, seed=2).queries(33, seed=5)
        b = tpipe.VectorDataset(500, 24, 8, seed=2).queries(33, seed=5)
    elif case == "clustered":
        a = rpipe.clustered_vectors(300, 16, 5, seed=7)
        b = tpipe.clustered_vectors(300, 16, 5, seed=7)
    else:
        a = rpipe.sift_like_vectors(4000, seed=1)
        b = tpipe.sift_like_vectors(4000, seed=1)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    # "meta" (the dry run's abstract state) only when asked for by name
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(ValueError):
        resolve_device("mps")
