"""Build the package's CUDA sources into shared libraries with nvcc.

Each library is compiled for Hopper (`sm_90a`) from the sources under
csrc/ into fvens_tpu_torch/_build/ (listed in .gitignore), named by a hash
of its sources and flags, so a rebuild happens only when a source changes.
The libraries expose a plain C interface and are loaded with ctypes: no
PyTorch headers are compiled, which keeps a build to seconds.

A missing nvcc or a failed compile raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str          # the shared library
    seconds: float     # nvcc wall time (0.0 when the library was current)
    log: str           # nvcc's output (ptxas registers/spills per kernel)


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "of fvens_tpu_torch are built from source at first "
                       "use and need the CUDA toolkit")


def build_cuda_library(name: str, sources: list) -> tuple:
    """Compile `sources` (paths under csrc/) into lib<name>-<hash>.so and
    load it. Returns (ctypes.CDLL, BuildInfo). The hash covers the sources
    and every header under csrc/, which a source may include."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cuh"))
    for src in [*sources, *headers]:
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(so):
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}:\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(so), BuildInfo(path=so, seconds=seconds, log=log)
