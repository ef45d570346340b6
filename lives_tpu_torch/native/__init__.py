"""Native CUDA kernels: build on first use, bind with ctypes.

Counterpart of `lives_tpu/native/__init__.py` (host C++ built with g++ on
first use, bound with ctypes), for the port's hand-written CUDA sources in
`lives_tpu_torch/csrc/`. A source is compiled with nvcc for the H100
(`sm_90a`) into a shared library with a plain C interface, under `build/`
at the root of the checkout, named by a hash of the source and the flags,
so an edited kernel is rebuilt and an unchanged one is reused. A build
that fails raises with nvcc's stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lives_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class Built:
    """A loaded kernel library, with what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str,
                 seconds: float):
        self.lib = lib
        self.path = path
        self.log = log          # nvcc/ptxas stderr ("" when reused)
        self.seconds = seconds  # build time (0.0 when reused)


_LOADED: dict[str, Built] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def load(name: str) -> Built:
    """Build (if needed) and load `csrc/<name>.cu`."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    log, seconds = "", 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                           capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
        log = r.stderr
    built = Built(ctypes.CDLL(str(so)), so, log, seconds)
    _LOADED[name] = built
    return built
