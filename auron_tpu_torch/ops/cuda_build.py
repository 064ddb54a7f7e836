"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source in ``csrc/`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``build/auron_tpu_torch/lib<name>-<sha>.so`` beside the package (a
directory git ignores). The file name carries a hash of the source and the
flags, so a changed source rebuilds and an unchanged one loads as is.
Sources build at first use, or all at once (one nvcc each, started
together) through ``build_all``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "auron_tpu_torch")

SOURCES = {"bitonic": "bitonic.cu", "partition": "partition.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")


def lib_path(name: str) -> str:
    with open(os.path.join(SRC_DIR, SOURCES[name]), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{h}.so")


def _start(name: str):
    """Popen of the nvcc build of ``name`` or None when already built."""
    out = lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        BUILD_SECONDS.setdefault(name, 0.0)
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all() -> dict[str, float]:
    """Build every kernel source in parallel; returns seconds per source."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        for n, s in started.items():
            _finish(n, s)
    return dict(BUILD_SECONDS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
        return lib
