"""The comparison fails the control and every fault a cell can have, and
passes the program, on whole runs of the harness at a small size on the
CPU (the check for a card is skipped; everything after it runs)."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import control, generator, harness  # noqa: E402
from repro_torch.api import backends  # noqa: E402

SEED = 2**31 + 77
SIZES = {"flat-u8-q10k": (3_000, 48)}


def _small(name):
    rows, q = SIZES[name]
    cell = harness.load_cell(name)
    cell.config = {**cell.config, "rows": rows}
    cell.traffic = {**cell.traffic, "queries_per_request": q}
    return cell


@pytest.fixture(scope="module")
def services():
    torch.set_num_threads(1)
    out = {}
    for name in SIZES:
        cell = _small(name)
        base = generator.base_rows(cell.config["rows"], SEED)
        out[name] = harness.build_service(base, cell.config, "cpu")
    return out


def _run(name, services, build=None):
    cell = _small(name)
    build = build or (lambda base, cfg, dev: services[name])
    return harness.run(cell, SEED, 1.0, False, "cpu", time.perf_counter(),
                       build=build)


@pytest.mark.parametrize("name", list(SIZES))
def test_program_is_correct(name, services):
    out = _run(name, services)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", list(SIZES))
def test_control_is_not_correct(name, services):
    out = _run(name, services, build=control.build_control)
    assert not out["correct"], out["checks"]


def _alter(ids):
    ids = ids.clone()
    ids[0, 0] = (ids[0, 0] + 1) % 1_000
    return ids


def _half(fn, lead):
    """fn answering the first half of the batch, its answers repeated for
    the rest."""
    def wrapped(*args, **kw):
        args = list(args)
        q = args[lead]
        h = (q.shape[0] + 1) // 2
        args[lead] = q[:h]
        out = fn(*args, **kw)
        rep = torch.arange(q.shape[0]) % h
        return tuple(o[rep] for o in out)
    return wrapped


FLAT_FAULTS = {
    "state_unchanged": (backends, "bruteforce_topk", lambda orig: (
        lambda v, s, q, k=10, **kw: (
            torch.full((q.shape[0], k), -1, dtype=torch.int32),
            torch.full((q.shape[0], k), float("inf"))))),
    "half_batch": (backends, "bruteforce_topk", lambda orig: _half(orig, 2)),
    "answer_altered": (backends, "bruteforce_topk",
                       lambda orig: lambda *a, **kw: (
                           _alter(orig(*a, **kw)[0]), orig(*a, **kw)[1])),
}


@pytest.mark.parametrize("fault", list(FLAT_FAULTS))
def test_flat_fault_is_not_correct(fault, services, monkeypatch):
    mod, attr, make = FLAT_FAULTS[fault]
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    out = _run("flat-u8-q10k", services)
    assert not out["correct"], (fault, out["checks"])


def test_a_failing_request_is_not_correct(services, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("planted")

    monkeypatch.setattr(backends, "bruteforce_topk", boom)
    out = _run("flat-u8-q10k", services)
    assert not out["correct"] and out["failed"] > 0

