"""Build the native sources in ``csrc/`` and load them with ctypes.

Route: a shared library with a plain C interface (no PyTorch headers, so
a build takes seconds, not minutes). CUDA sources (``<name>.cu``) go
through nvcc for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -fmad=false -shared -Xcompiler -fPIC -o <lib>.so csrc/<name>.cu

``-fmad=false`` keeps every a*b+c a rounded multiply and a rounded add,
as the plain torch version computes them; no fast math, so divisions
and square roots stay IEEE. Host sources (``<name>.cpp``, the SAH BVH
builder) go through g++. A library lands in ``build/tpurt_torch/`` at
the repository root, named by a hash of its source, the ``.cuh``
headers beside it, for a CUDA source the other ``.cu`` files too (one
may include another: ``megakernel_jitter.cu`` is ``megakernel.cu`` with
jitter), and the flags, so an edited source rebuilds and an unchanged
one loads at once. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tpurt_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIBS: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _source(name: str) -> str:
    cu = os.path.join(CSRC, name + ".cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC, name + ".cpp")


def _flags(src: str):
    return NVCC_FLAGS if src.endswith(".cu") else GXX_FLAGS


def lib_path(name: str) -> str:
    """The library path for ``csrc/<name>.cu`` (or ``.cpp``) at its
    current hash."""
    src = _source(name)
    digest = hashlib.sha256(" ".join(_flags(src)).encode())
    beside = glob.glob(os.path.join(CSRC, "*.cuh"))
    if src.endswith(".cu"):
        beside += glob.glob(os.path.join(CSRC, "*.cu"))
    for path in [src] + sorted(beside):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>`` unless its hash is already built; returns
    the library path. The compiler's output (for nvcc, ptxas's register
    and spill report) is kept beside it as ``<lib>.log``."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    src = _source(name)
    compiler = nvcc_path() if src.endswith(".cu") else "g++"
    cmd = [compiler, *_flags(src), "-o", tmp, src]
    from tpurt_torch.utils.profiling import count

    count("kernel_builds")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(out + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{compiler} failed ({proc.returncode}) building {name}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all(names) -> dict:
    """Build several sources at once — one compiler process each, all
    started together — and return {name: seconds until its build ended}."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.time()

    def one(name):
        from tpurt_torch.utils.profiling import span

        with span("tpurt.kernels.load", lib=name):
            build(name)
        return time.time() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(one, names)))


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>`` (once per process)."""
    with _LOCK:
        if name not in _LIBS:
            from tpurt_torch.utils.profiling import span

            with span("tpurt.kernels.load", lib=name):
                _LIBS[name] = ctypes.CDLL(build(name))
        return _LIBS[name]


def build_log(name: str) -> str:
    path = lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
