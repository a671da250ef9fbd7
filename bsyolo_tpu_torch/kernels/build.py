"""Build the port's native code and load it with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel) compiles on first use with nvcc, and
each ``csrc/<name>.cpp`` (host code: the JPEG codec, the polygon fill, the
mask border follower) and the repository's ``native/bsyolo_native.cpp`` with the host C++ compiler, into a shared library with a plain C interface under
``build/bsyolo_tpu_torch/`` beside the package, named by a hash of its source
and flags, so an edited source rebuilds and an unchanged one loads at once
(loading runs no compiler; the build records which compiler made it). The host route takes no ``-march=native`` and no ``-ffast-math``: the
library computes the same bytes on every x86-64 machine. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO / "build" / "bsyolo_tpu_torch"
# host sources outside csrc/: the repository's framework-free runtime support library (utils/native.py)
HOST_SOURCES = {"bsyolo_native": REPO / "native" / "bsyolo_native.cpp"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per-source build record: library path, seconds spent in the compiler (0 when reused), its report, and
# for host code the compiler's version line
BUILD_LOG: Dict[str, dict] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA kernels cannot be built")
    return path


def cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found (looked for $CXX, g++ and c++ on PATH); the host code "
                       "(JPEG codec, polygon fill, contours) cannot be built")


@functools.lru_cache(maxsize=None)
def cxx_version(path: str) -> str:
    """The first line of the compiler's ``--version``, recorded in ``BUILD_LOG`` by a host build."""
    out = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=60)
    return (out.stdout.splitlines() or [""])[0]


def source(name: str) -> Path:
    """``csrc/<name>.cu`` where it exists, else ``csrc/<name>.cpp`` (or the ``HOST_SOURCES`` entry)."""
    if name in HOST_SOURCES:
        return HOST_SOURCES[name]
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _command(name: str, out: Path) -> list:
    src = source(name)
    if src.suffix == ".cu":
        return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [cxx(), *CXX_FLAGS, "-o", str(out), str(src)]


def _target(name: str) -> Path:
    src = source(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _reuse(name: str) -> bool:
    """Whether ``name``'s current library exists (recorded as reused)."""
    out = _target(name)
    if out.exists():
        BUILD_LOG.setdefault(name, {"library": str(out), "seconds": 0.0, "ptxas": "(reused)"})
    return out.exists()


def compile_all(names: Iterable[str]) -> None:
    """Compile the named sources that have no current library yet, one compiler per
    source, all started together; raise with the compiler's output on failure. One
    process builds at a time (a lock file in the build directory): processes that
    need the same library at once wait for the first one's build and reuse it."""
    missing = [name for name in names if not _reuse(name)]
    if not missing:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for name in missing:
            if _reuse(name):  # built by the process that held the lock before
                continue
            out = _target(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = _command(name, tmp)
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
                               "command": " ".join(cmd),
                               **({"compiler": cxx_version(cmd[0])} if source(name).suffix == ".cpp" else {})}
    if failed:
        raise RuntimeError("the compiler failed:\n" + "\n\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``csrc/<name>.cpp``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            compile_all([name])
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib
