"""The port's SIFT1B dry-run (`python -m repro_torch.launch.ann_dryrun`)
against the reference's arithmetic, on the CPU.

  * The CLI runs as a subprocess, loads no `jax*` or `repro*` module, and
    prints one JSON record with the reference's keys (read from the
    reference's source, `src/repro/launch/ann_dryrun.py`).
  * Its csd_storage_bound, ingest_write_amplification and cluster_fanout
    sections equal the reference's loops over the reference's `costmodel`
    functions; --calibrated with the reference's synthetic snapshot gives
    the reference's calibration section.
  * db_bytes_per_device is the hand count of the SIFT1B tables (float32),
    2,781,265,676 B; the working set is what `core.search._initial_beam`
    allocates; the gather bytes are the `nbytes` `_collect` moves on a
    (2, 4) ("data", "model") CPU mesh.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import costmodel as RC
from repro.launch.roofline import HW as RefHW
from repro.obs import calibrate as ref_calibrate
from repro.obs import compare_terms as ref_compare_terms
from repro_torch.core import distributed as D
from repro_torch.core.hnsw_graph import HNSWConfig
from repro_torch.core.partitioned import build_partitioned_db
from repro_torch.core.search import SearchParams, _initial_beam
from repro_torch.launch import ann_dryrun as A
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import HW

# tiny CPU shapes: torch's thread pool costs more than the work itself
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
N_PAD = 3_906_272                    # ceil(1e9 / 256 / 32) * 32


def reference_keys() -> tuple[set, set]:
    """The keys of the reference's record (`rec = {...}`) and of the keys
    it assigns afterwards (`rec["calibration"]`), from its source."""
    tree = ast.parse((SRC / "repro" / "launch" / "ann_dryrun.py").read_text())
    keys, late = set(), set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "rec"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys if k is not None}
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "rec"):
            late.add(node.targets[0].slice.value)
    return keys, late


def run_cli(*args) -> tuple[dict, list]:
    """The CLI in a fresh interpreter: its record (the last line of its
    output) and the jax / repro modules it loaded."""
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = ['ann_dryrun'] + {list(args)!r}\n"
        "runpy.run_module('repro_torch.launch.ann_dryrun', "
        "run_name='__main__')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', "
        "'jaxlib', 'repro')]\n"
        "print(json.dumps(bad), file=sys.stderr)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    return rec, json.loads(out.stderr.strip().splitlines()[-1])


def synthetic_snapshot():
    """The reference's synthetic snapshot (`tests/test_calibrate.py`)."""
    return {
        "counters": [
            {"name": "store_cache_hits_total", "labels": {}, "value": 800},
            {"name": "store_cache_misses_total", "labels": {}, "value": 200},
            {"name": "store_bytes_read_total", "labels": {},
             "value": 200 * 4096},
            {"name": "csd_queries_total", "labels": {}, "value": 100},
            {"name": "csd_hops_total", "labels": {}, "value": 500},
            {"name": "csd_supersteps_total", "labels": {}, "value": 125},
        ],
        "gauges": [
            {"name": "csd_graph_degree", "labels": {}, "value": 24},
            {"name": "csd_vector_row_bytes", "labels": {}, "value": 512},
            {"name": "csd_block_size", "labels": {}, "value": 4096},
        ],
        "histograms": [
            {"name": "profile_stage_ms", "labels": {"stage": "store-read"},
             "buckets": [], "sum": 800.0, "count": 400},
            {"name": "profile_stage_ms",
             "labels": {"stage": "hop_superstep"},
             "buckets": [], "sum": 375.0, "count": 125},
            {"name": "profile_stage_ms", "labels": {"stage": "hop-kernel"},
             "buckets": [], "sum": 125.0, "count": 125},
        ],
    }


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "metrics.json"
    path.write_text(json.dumps(synthetic_snapshot()))
    return run_cli("--calibrated", str(path)), str(path)


def test_cli_loads_no_jax_and_has_the_reference_keys(cli):
    (rec, bad), _ = cli
    assert bad == []
    keys, late = reference_keys()
    assert late == {"calibration"}
    assert set(rec) == keys | late
    assert rec["mesh"] == "single" and rec["devices"] == 256
    assert rec["partitions"] == 256 and rec["vectors_per_partition"] == N_PAD
    assert rec["fits_hbm"] is True


def test_multi_pod_cli():
    rec, bad = run_cli("--multi-pod", "--batch", "2048")
    assert bad == []
    keys, _ = reference_keys()
    assert set(rec) == keys
    assert rec["mesh"] == "multi" and rec["devices"] == 512
    # 2,048 queries split over the two pods: 1,024 lanes on a device
    assert rec["resident_bytes"] == rec["db_bytes_per_device"] + \
        A.batch_working_set(1024, N_PAD, 72, 40)


def reference_sections(hw) -> dict:
    """The reference's three cost sections, by its own loops over its own
    costmodel functions, at the SIFT1B point (ef 40, degree 32, d 128)."""
    reads_per_query, m0p, block_size = 4 * 40 + 16, 32, 4096
    storage = {}
    for dtype in ("float32", "uint8", "pq"):
        row_b = RC.vector_row_bytes(128, dtype)
        bpq = reads_per_query * m0p * row_b / block_size
        per_hit = {}
        for hit in (0.0, 0.5, 0.9):
            sc = RC.storage_cost(bpq, block_size, cache_hit_rate=hit,
                                 ssd_bw=hw.ssd_bw)
            per_hit[f"hit_{hit:.1f}"] = {
                "bytes_from_flash_per_query": sc.bytes_from_flash,
                "modeled_qps_per_device": round(1.0 / sc.storage_s, 2)}
        storage[dtype] = {"vector_row_bytes": row_b,
                          "blocks_per_query": round(bpq, 1), **per_hit}
    bpq = storage["float32"]["blocks_per_query"]
    ingest = {}
    for dtype in ("float32", "uint8", "pq"):
        cc = RC.compaction_cost(10_000_000, RC.vector_row_bytes(128, dtype),
                                1_000_000, 8, delete_frac=0.05,
                                ssd_bw=hw.ssd_bw)
        ingest[dtype] = {
            "bytes_ingested": cc.bytes_ingested,
            "bytes_rewritten": cc.bytes_rewritten,
            "write_amplification": round(cc.write_amp, 2),
            "seals": cc.seals, "compactions": cc.compactions,
            "rewrite_s_on_ssd_link": round(cc.rewrite_s, 1)}
    cluster = {}
    for n in (1, 2, 4):
        for r in (1, 2):
            fc = RC.cluster_fanout_cost(n, r, dim=128, k=10,
                                        blocks_per_query=bpq,
                                        block_size=block_size,
                                        cache_hit_rate=0.5, ssd_bw=hw.ssd_bw)
            cluster[f"shards_{n}x{r}"] = {
                "router_bytes_per_query": fc.router_bytes_q,
                "flash_bytes_per_query": fc.flash_bytes_q,
                "aggregate_ssd_bw": fc.aggregate_ssd_bw,
                "modeled_qps": round(fc.modeled_qps, 1), "bound": fc.bound}
    return {"csd_storage_bound": {"block_size": block_size,
                                  "blocks_per_query": bpq,
                                  "ssd_bw": hw.ssd_bw, **storage},
            "ingest_write_amplification": ingest, "cluster_fanout": cluster}


def _no_notes(section: dict) -> dict:
    return {k: v for k, v in section.items() if k != "note"}


def test_cost_sections_equal_reference_arithmetic(cli):
    (rec, _), _ = cli
    want = reference_sections(RefHW())
    for name, section in want.items():
        assert _no_notes(rec[name]) == section, name
    # the port's own HW keeps the paper's ssd_bw, so the same numbers
    # come from dryrun() in process, and another ssd_bw moves them alike
    slow = A.dryrun(hw=HW(ssd_bw=1.5e9))
    for name, section in reference_sections(RefHW(ssd_bw=1.5e9)).items():
        assert _no_notes(slow[name]) == section, name


def test_db_bytes_hand_count(cli):
    (rec, _), _ = cli
    up_rows = -(-N_PAD // 16) * 2                          # 488,284
    hand = (N_PAD * 128 * 4          # vectors, float32
            + N_PAD * 4              # sqnorms
            + N_PAD * 32 * 4         # l0_nbrs, degree 2M = 32
            + 7 * up_rows * 16 * 4   # up_nbrs, 7 levels x M = 16
            + 3 * N_PAD * 4          # up_ptr, levels, gids
            + 3 * 4)                 # entry, max_level, n_valid
    assert hand == rec["db_bytes_per_device"] == 2_781_265_676
    lanes_bitmap = 4096 * 4 * ((N_PAD + 31) // 32)
    assert rec["resident_bytes"] == hand + A.batch_working_set(
        4096, N_PAD, 72, 40)
    assert rec["resident_bytes"] - hand > lanes_bitmap      # mostly bitmap
    assert rec["fits_hbm"] == (rec["resident_bytes"] < 80e9)
    # the memory-bound roofline at the card's 3.35 TB/s
    assert rec["modeled_worstcase_qps_per_chip"] == round(
        3.35e12 / ((4 * 40 + 16) * 32 * (128 * 4 + 4)), 1)
    assert rec["collectives"] == {"gather": 4096 * (256 * 10 * 8 + 256 * 4),
                                  "total": 4096 * (256 * 10 * 8 + 256 * 4)}


def test_calibrated_section_is_the_reference_arithmetic(cli):
    (rec, _), path = cli
    cal = ref_calibrate(synthetic_snapshot())
    sc = RC.storage_cost(cal.blocks_per_query, cal.block_size,
                         cache_hit_rate=cal.cache_hit_rate,
                         ssd_bw=cal.effective_ssd_bw)
    dc = RC.dispatch_cost(cal.supersteps_per_query, cal.dispatch_overhead_s)
    total = sc.storage_s + dc.dispatch_s
    assert rec["calibration"] == json.loads(json.dumps({
        "source": path,
        "fitted": cal.asdict(),
        "terms": ref_compare_terms(cal, hw=RefHW()),
        "measured_workload": {
            "storage_s_per_query": sc.storage_s,
            "dispatch_s_per_query": dc.dispatch_s,
            "calibrated_qps_per_device": round(1.0 / total, 2)}}))


@pytest.mark.parametrize("lanes,n_pad", [(1, 32), (12, 8192), (7, 1000)])
def test_working_set_is_the_beams_allocation(lanes, n_pad):
    p = SearchParams(ef=40, k=10).resolve(32)
    ep = torch.zeros(lanes, dtype=torch.int32)
    state = _initial_beam(n_pad, ep, torch.zeros(lanes), p)
    assert sum(t.nbytes for t in state) == A.batch_working_set(
        lanes, n_pad, p.cand_size, p.ef)


@pytest.mark.parametrize("query_axes", [("data",), None])
def test_gather_bytes_equal_what_collect_moves(query_axes, monkeypatch):
    rng = np.random.default_rng(0)
    v = np.rint(rng.uniform(0, 255, (400, 16))).astype(np.float32)
    q = np.rint(rng.uniform(0, 255, (8, 16))).astype(np.float32)
    pdb = build_partitioned_db(v, 4, HNSWConfig(M=4, ef_construction=20))
    mesh = make_mesh((2, 4), ("data", "model"), devices="cpu")
    sdb = D.shard_db(pdb, mesh, graph_axes=("model",))
    search = D.make_distributed_search(mesh, SearchParams(ef=16, k=5),
                                       pdb.db.l0_nbrs.shape[-1],
                                       query_axes=query_axes)
    moved = []
    collect = D.DistributedSearch._collect

    def counting(self, t, done):
        moved.append(t.nbytes)
        return collect(self, t, done)

    monkeypatch.setattr(D.DistributedSearch, "_collect", counting)
    search(sdb, torch.as_tensor(q))
    assert len(moved) == 3 * len(search.work)
    assert sum(moved) == search.gather_bytes(len(q), 4)
