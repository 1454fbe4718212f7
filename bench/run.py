"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic
and its metrics are read from BENCHMARK.json and the files under bench/
(see bench/harness.py). The system under test is the PyTorch port under
src/ (`repro_torch`). The last line of standard output is one JSON
object: correct, attempted, failed, metrics, device, with --trace 1 a
breakdown, and last the numbers compared beside their limits, which are
also the last lines of standard error.

Exits with a code other than 0, and prints no result, when there is no
CUDA device or fewer than the cell asks for, when the port cannot be
imported from src/, and when the process has loaded JAX or the JAX
package (`repro`) by the time the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _environment() -> None:
    """Kernel caches at fixed paths inside the checkout; the port's own
    nvcc builds already go to <checkout>/build/repro_torch."""
    cache = ROOT / "build" / "bench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _forbidden_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA device is available; no result")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"the cell asks for {cell.chips} CUDA devices, "
                    f"{torch.cuda.device_count()} are visible; no result")
        return 2
    import repro_torch

    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        harness.log(f"repro_torch was imported from {repro_torch.__file__}, "
                    f"not from this checkout's src/; no result")
        return 2
    harness.log(f"card: {_power_limit()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    found = _forbidden_modules()
    if found:
        harness.log(f"JAX or the JAX package is loaded: {found}; no result")
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
