"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface under ``build/bsyolo_tpu_torch/`` beside the package,
named by a hash of its source and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bsyolo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per-source build record: library path, seconds spent in nvcc (0 when reused), ptxas report
BUILD_LOG: Dict[str, dict] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_all(names: Iterable[str]) -> None:
    """Compile the named sources that have no current library yet, one nvcc per
    source, all started together; raise with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            BUILD_LOG.setdefault(name, {"library": str(out), "seconds": 0.0, "ptxas": "(reused)"})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter(), cmd)
    failed = []
    for name, (proc, tmp, out, t0, cmd) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = {"library": str(out), "seconds": time.perf_counter() - t0, "ptxas": log.strip(),
                           "command": " ".join(cmd)}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            compile_all([name])
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib
