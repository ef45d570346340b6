"""Native CUDA kernels: build on first use, bind with ctypes.

Counterpart of `lives_tpu/native/__init__.py` (host C++ built with g++ on
first use, bound with ctypes), for the port's hand-written CUDA sources in
`lives_tpu_torch/csrc/`. A source is compiled with nvcc for the H100
(`sm_90a`) into a shared library with a plain C interface, under `build/`
at the root of the checkout, named by a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited kernel is rebuilt and an
unchanged one is reused. A build that fails raises with nvcc's stderr;
nothing falls back. `EXTRA_FLAGS` adds a library's own flags; `SOURCE_OF`
names the source of a library built from another one's source with other
flags.
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
#: per-source flags: these kernels round every multiply and add on its own,
#: as PyTorch's eager ops do (each source's note, "Numerics"); fused_sweep
#: and fma_chain keep nvcc's contraction (K6 exists to count FFMAs)
EXTRA_FLAGS = {name: ("-fmad=false",)
               for name in ("stateful_sweep", "yuv420", "composite")}
#: fused_sweep's exact build: the whole vocabulary, every multiply and add
#: rounded on its own (csrc/fused_sweep.cu's note)
EXTRA_FLAGS["fused_sweep_exact"] = ("-DLIVES_SWEEP_EXACT", "-fmad=false")
#: library -> the source it is built from, where the names differ
SOURCE_OF = {"fused_sweep_exact": "fused_sweep"}


class Built:
    """A loaded kernel library, with what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str,
                 seconds: float):
        self.lib = lib
        self.path = path
        self.log = log          # nvcc/ptxas stderr, kept beside the library
        self.seconds = seconds  # build time (0.0 when reused)


_LOADED: dict[str, Built] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def load(name: str) -> Built:
    """Build (if needed) and load library `name`, from `csrc/<name>.cu`
    (or its `SOURCE_OF` source)."""
    return load_all([name])[name]


def load_all(names) -> dict[str, Built]:
    """Build (if needed) and load several sources, one nvcc process each,
    all started together."""
    todo = {}
    for name in names:
        if name in _LOADED or name in todo:
            continue
        src = CSRC / f"{SOURCE_OF.get(name, name)}.cu"
        flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
        text = src.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            text + " ".join(flags).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        proc = tmp = None
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        todo[name] = (src, so, tmp, proc, time.perf_counter())
    done = {}  # wait for every build before any failure raises
    for name, (src, so, tmp, proc, t0) in todo.items():
        log = proc.communicate()[1] if proc is not None else ""
        done[name] = (log, time.perf_counter() - t0 if proc else 0.0)
    for name, (src, so, tmp, proc, t0) in todo.items():
        log, seconds = done[name]
        if proc is not None:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
        elif so.with_suffix(".log").exists():  # reused: its build's report
            log = so.with_suffix(".log").read_text()
        _LOADED[name] = Built(ctypes.CDLL(str(so)), so, log, seconds)
    return {name: _LOADED[name] for name in names}
