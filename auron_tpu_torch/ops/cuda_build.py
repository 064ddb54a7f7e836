"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source in ``csrc/`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``build/auron_tpu_torch/lib<name>-<sha>.so`` beside the package (a
directory git ignores). The file name carries a hash of the source and the
flags, so a changed source rebuilds and an unchanged one loads as is.
Sources build at first use, or all at once (one nvcc each, started
together) through ``build_all``. Nothing here runs at import time. Each
nvcc build counts as one ``compiles`` of ``utils/profiling.EngineCounters``
(its seconds from the build's start, so parallel builds overlap).

``build_bridge`` builds the C ABI (``csrc/auron_bridge.cpp`` with ``g++``
into ``libauron_bridge-<sha>.so``) and its stand-in host
(``csrc/bridge_harness.c`` with ``cc`` into ``bridge_harness-<sha>``)
with the flags ``python3-config --includes`` and ``--ldflags --embed``
give, the hash over the three sources and the flags. The library leaves
CPython's symbols to its host: the harness links libpython (its rpath
names the directory), a Python process that loads the library with
``ctypes`` lends its own interpreter. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
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
    from auron_tpu_torch.utils.profiling import note_compile

    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    # a build is one compile of the engine counters (utils/profiling.py)
    note_compile(BUILD_SECONDS[name], "nvcc_build")


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


BRIDGE_SOURCES = ("auron_bridge.cpp", "auron_bridge.h", "bridge_harness.c")


def _python_config(*args: str) -> list[str]:
    """``python3-config`` of the running interpreter (the one beside its
    executable, else the one on PATH), split into flags."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    exe_dir = os.path.dirname(os.path.realpath(sys.executable))
    for cand in (os.path.join(os.path.dirname(sys.executable), f"python{ver}-config"),
                 os.path.join(exe_dir, f"python{ver}-config"),
                 shutil.which(f"python{ver}-config"), shutil.which("python3-config")):
        if cand and os.path.exists(cand):
            out = subprocess.run([cand, *args], capture_output=True, text=True, check=True)
            return out.stdout.split()
    raise RuntimeError(f"python{ver}-config not found beside {sys.executable} or on PATH")


def _bridge_commands(so: str, harness: str, soname: str) -> list[list[str]]:
    includes = _python_config("--includes")
    ldflags = _python_config("--ldflags", "--embed")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    cxx = [shutil.which("g++") or "g++", "-O2", "-fPIC", "-std=c++17", "-Wall", "-shared",
           f"-Wl,-soname,{soname}", *includes, "-o", so, os.path.join(SRC_DIR, "auron_bridge.cpp")]
    cc = [shutil.which("cc") or "cc", "-O2", "-Wall", f"-I{SRC_DIR}", "-o", harness,
          os.path.join(SRC_DIR, "bridge_harness.c"), so, "-Wl,--no-as-needed", *ldflags,
          f"-Wl,-rpath,{libdir}", "-Wl,-rpath,$ORIGIN"]
    return [cxx, cc]


def bridge_paths() -> tuple[str, str]:
    """(library, harness) paths of the C ABI build for these sources."""
    h = hashlib.sha256()
    for name in BRIDGE_SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(" ".join(c[1:]) for c in _bridge_commands("so", "exe", "lib")).encode())
    sha = h.hexdigest()[:16]
    return (os.path.join(BUILD_DIR, f"libauron_bridge-{sha}.so"),
            os.path.join(BUILD_DIR, f"bridge_harness-{sha}"))


def build_bridge() -> tuple[str, str]:
    """Build (once) the C ABI library and the harness; returns their paths."""
    with _lock:
        so, harness = bridge_paths()
        if os.path.exists(so) and os.path.exists(harness):
            BUILD_SECONDS.setdefault("bridge", 0.0)
            return so, harness
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        tmp_so, tmp_h = f"{so}.{os.getpid()}.tmp.so", f"{harness}.{os.getpid()}.tmp"
        logs = []
        try:
            for cmd in _bridge_commands(tmp_so, tmp_h, os.path.basename(so)):
                r = subprocess.run(cmd, capture_output=True, text=True)
                logs.append(f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}")
                if r.returncode != 0:
                    raise RuntimeError("C ABI build failed:\n" + "\n".join(logs))
            os.replace(tmp_so, so)
            os.replace(tmp_h, harness)
        finally:
            for t in (tmp_so, tmp_h):
                if os.path.exists(t):
                    os.remove(t)
        BUILD_LOG["bridge"] = "\n".join(logs)
        BUILD_SECONDS["bridge"] = time.perf_counter() - t0
        return so, harness
