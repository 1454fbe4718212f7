"""Build the CUDA sources under `csrc/` with nvcc and load them via ctypes.

Each `csrc/<name>.cu` is compiled on first use into a shared library with
a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

The file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. `build_all()` starts one nvcc per
source at once and waits for them all. A failed build raises; nothing falls
back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

__all__ = ["build_all", "count_launch", "load", "BUILD_LOG", "BUILD_DIR",
           "SOURCES"]

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/repro_torch (the repo root is three levels above the package)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("traversal", "traversal_async", "descent", "qdist",
           "pq_topk_smem", "pq_adc_smem", "l2dist", "l2dist_tc",
           "l2dist_q_tc", "l2topk", "l2topk_tc", "l2topk_q_tc", "select_k",
           "select_k_short", "flash_attention", "flash_attention_tc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> nvcc's output (ptxas register / shared-memory report) per build
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
# one build or load at a time: replica threads may reach a kernel at once
_LOAD_LOCK = threading.Lock()
# the launch counters of every kernels module are bumped under one lock
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh") and (f.stem == name
                                            or f.suffix == ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every stale source in parallel; returns name -> library."""
    out = {n: _target(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if stale.

    `signatures` maps each C function to (restype, argtypes); pointers and
    the stream are `c_void_p` so ctypes never truncates them to 32 bits."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build_all((name,))[name]))
                for fn, (restype, argtypes) in signatures.items():
                    getattr(lib, fn).restype = restype
                    getattr(lib, fn).argtypes = argtypes
                _LIBS[name] = lib
    return lib


def count_launch(module: str, counter: str) -> None:
    """Add one to the launch counter `counter` (a module attribute, read
    and reset by callers) of the kernels module named `module`. The
    read-modify-write holds one lock, so the counts stay exact when
    replica threads launch at once."""
    mod = sys.modules[module]
    with _COUNT_LOCK:
        setattr(mod, counter, getattr(mod, counter) + 1)
