"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program: checked in fresh interpreters,
by the top-level name of every loaded module, compared whole (the port,
`repro_torch`, begins with the JAX package's name `repro`)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}

# import bench/run.py as the command does, then drive a whole small run
# of each cell on the CPU, so that what the port imports lazily loads too
RUN = r"""
import importlib.util, json, sys, time
spec = importlib.util.spec_from_file_location("bench_run", "bench/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
run._environment()
import torch
torch.set_num_threads(1)
from bench import control, harness
for name, rows, q in (("flat-u8-q10k", 700, 8),):
    cell = harness.load_cell(name)
    cell.config = {**cell.config, "rows": rows}
    cell.traffic = {**cell.traffic, "queries_per_request": q}
    for m in cell.end_to_end + cell.per_layer:
        harness.reader(m["name"])
    out = harness.run(cell, 5, 0.05, False, "cpu", time.perf_counter())
    assert out["attempted"] >= 1, out
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = r"""
import json, sys
sys.path.insert(0, ".")
from bench import compare, generator, roofline
from bench.reference import exact
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = _modules(RUN)
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = {m.split(".")[0] for m in _modules(REFERENCE)}
    assert not tops & (FORBIDDEN | {"repro_torch"})
