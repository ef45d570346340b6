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

`load_jpegcoef` builds the host C++ entropy coder the JPEG lanes share
with the JAX package, `native/jpegcoef.cpp` at the root of the checkout
(counterpart `lives_tpu/io/jpeg_ingest.py:45-100`), with g++ into the same
directory, under its own name: the JAX loader writes `native/jpegcoef.so`
in place, and two packages must not race on one file. It compiles and
links against the system's libjpeg where g++ finds its headers and
library; a host without them (a host may carry Pillow's copy of the
library and nothing else) builds against the jpeg62 API headers kept in
`native/jpeg62/` and the jpeg62 libjpeg-turbo that Pillow's wheel carries,
after checking that library's versions against the headers'. Either way
the loaded library must read a JPEG before it is handed out.

`load_avbridge` builds the in-process libav bridge the JAX package's
`lives_tpu/io/av.py:46-107` builds, `native/avbridge.cpp` at the root of
the checkout, with g++ into `build/lives_tpu_torch/libavbridge-<hash>.so`
(a hash of the source, the flags, the preprocessed libav headers and the
libraries' bytes). A host without libavformat, or without the libav
headers, has no libav lane: it returns None and `AVBRIDGE_ABSENT` says
why. Where both are there, a failed build raises with g++'s stderr.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lives_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: per-source flags: these kernels round every multiply and add on its own,
#: as PyTorch's eager ops do (each source's note, "Numerics"); fused_sweep
#: and fma_chain keep nvcc's contraction (K6 exists to count FFMAs)
EXTRA_FLAGS = {name: ("-fmad=false",)
               for name in ("stateful_sweep", "yuv420", "composite",
                            "live_sweep")}
#: fused_sweep's exact build: the whole vocabulary, every multiply and add
#: rounded on its own (csrc/fused_sweep.cu's note)
EXTRA_FLAGS["fused_sweep_exact"] = ("-DLIVES_SWEEP_EXACT", "-fmad=false")
#: library -> the source it is built from, where the names differ
SOURCE_OF = {"fused_sweep_exact": "fused_sweep"}


class Built:
    """A loaded kernel library, with what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str,
                 seconds: float, libjpeg: str = ""):
        self.lib = lib
        self.path = path
        self.libjpeg = libjpeg  # jpegcoef's libjpeg route, else ""
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


JPEGCOEF_SRC = Path(__file__).resolve().parents[2] / "native" / "jpegcoef.cpp"
#: libjpeg's jpeg62 API headers (libjpeg-turbo 2.1.5; `jpeg62/COPYRIGHT`),
#: for a host that holds no libjpeg headers of its own
JPEG62_INCLUDE = Path(__file__).resolve().parent / "jpeg62"
#: -march=native turns on the AVX-512 pack of jc_read_packed
JPEGCOEF_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def _cpu_tag() -> str:
    """The host's CPU identity (`jpeg_ingest.py:54-63`): a -march=native
    library copied to another host must rebuild, not fault on its first
    call."""
    try:
        with open("/proc/cpuinfo") as fh:
            cpu = [ln for ln in fh
                   if ln.startswith(("flags", "model name"))][:2]
    except OSError:
        return "unknown"
    return hashlib.sha1("".join(cpu).encode()).hexdigest()[:16]


class JpegRoute(NamedTuple):
    """The libjpeg a build of jpegcoef compiles and links against: g++'s
    extra arguments before and after the source, the library file, and
    the bytes that identify headers and library in the build's hash."""

    name: str
    cflags: list[str]
    link: list[str]
    library: Path
    identity: bytes


def system_libjpeg() -> JpegRoute | None:
    """The system's libjpeg where g++ finds both its headers and
    `libjpeg.so`; else None."""
    pre = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                         input="#include <cstdio>\n#include <jpeglib.h>\n",
                         capture_output=True, text=True, timeout=60)
    lib = subprocess.run(["g++", "-print-file-name=libjpeg.so"],
                         capture_output=True, text=True,
                         timeout=60).stdout.strip()
    if pre.returncode != 0 or not os.path.isabs(lib):
        return None
    library = Path(lib).resolve()
    return JpegRoute("system", [], ["-ljpeg"], library,
                     pre.stdout.encode() + library.read_bytes())


def _header_versions() -> tuple[int, int]:
    """(JPEG_LIB_VERSION, LIBJPEG_TURBO_VERSION_NUMBER) of the kept
    headers."""
    defs = dict(ln.split()[1:3] for ln in
                (JPEG62_INCLUDE / "jconfig.h").read_text().splitlines()
                if ln.startswith("#define ") and len(ln.split()) >= 3)
    return int(defs["JPEG_LIB_VERSION"]), \
        int(defs["LIBJPEG_TURBO_VERSION_NUMBER"])


def pillow_libjpeg() -> JpegRoute:
    """The headers kept in `jpeg62/` with the jpeg62 libjpeg-turbo that
    Pillow's wheel carries (`pillow.libs/libjpeg-*.so.62*`, linked by path
    with an rpath), for a host with no libjpeg headers. The library must
    be the only one there, serve the headers' JPEG_LIB_VERSION (62, the
    ABI its soname names), and be a libjpeg-turbo no older than the
    headers' (the jpeg62 ABI only grows), as Pillow reports them;
    anything else raises."""
    import PIL
    from PIL import features
    libs = Path(PIL.__file__).resolve().parents[1] / "pillow.libs"
    found = sorted(libs.glob("libjpeg-*.so.62*"))
    if len(found) != 1:
        raise RuntimeError(
            "jpegcoef: g++ finds no libjpeg headers and library on this "
            f"host, and {libs} holds {len(found)} jpeg62 libjpeg files "
            f"({[f.name for f in found]}), where one is needed")
    want_lib, want_turbo = _header_versions()
    jpg, turbo = features.version("jpg"), features.version("libjpeg_turbo")
    have_lib = int(str(jpg).replace(".", "")) if jpg else None
    parts = [int(x) for x in str(turbo).split(".")[:3]] if turbo else []
    have_turbo = (parts[0] * 1000000 + parts[1] * 1000 + parts[2]
                  if len(parts) == 3 else None)
    if have_lib != want_lib or have_turbo is None \
            or have_turbo < want_turbo:
        raise RuntimeError(
            f"jpegcoef: {found[0]} is libjpeg {jpg} (libjpeg-turbo "
            f"{turbo}), but the headers in {JPEG62_INCLUDE} are for "
            f"libjpeg {want_lib / 10:.1f} from libjpeg-turbo "
            f"{want_turbo}: the library must serve the same "
            "JPEG_LIB_VERSION and be no older")
    return JpegRoute(
        f"pillow libjpeg-turbo {turbo}", [f"-I{JPEG62_INCLUDE}"],
        [str(found[0]), f"-Wl,-rpath,{libs}"], found[0],
        b"".join(h.read_bytes() for h in sorted(JPEG62_INCLUDE.glob("*.h")))
        + found[0].read_bytes())


def _bind_jpegcoef(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    u16_p, i16_p = (ctypes.POINTER(ctypes.c_uint16),
                    ctypes.POINTER(ctypes.c_int16))
    u8_p, i8_p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int8)
    i32_p, ll = ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong
    lib.jc_read.restype = ll
    lib.jc_read.argtypes = [ctypes.c_char_p, ll, c_int_p, u16_p, i16_p, ll]
    lib.jc_read_packed.restype = ll
    lib.jc_read_packed.argtypes = [
        ctypes.c_char_p, ll, c_int_p, u16_p, i16_p, u8_p, u8_p, i8_p, ll,
        i32_p, i16_p, ctypes.c_int, c_int_p, ll]
    lib.jc_write_packed.restype = ll
    lib.jc_write_packed.argtypes = [
        c_int_p, u16_p, i16_p, u8_p, u8_p, i8_p, ll, i32_p, i16_p,
        ctypes.c_int, u8_p, ll]
    return lib


def _check_jpegcoef(lib: ctypes.CDLL, route: JpegRoute):
    """Read a JPEG that Pillow writes: libjpeg refuses, at its create
    call, a caller built for another JPEG_LIB_VERSION or struct size, and
    jc_read then returns -1."""
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.new("RGB", (16, 16), (200, 30, 90)).save(buf, "JPEG")
    data = buf.getvalue()
    n = lib.jc_read(data, len(data), (ctypes.c_int * 32)(),
                    (ctypes.c_uint16 * 256)(), (ctypes.c_int16 * 1024)(),
                    1024)
    if n <= 0:
        raise RuntimeError(
            f"jpegcoef: linked against {route.library} ({route.name}), it "
            f"cannot read a 16x16 JPEG (jc_read returned {n}): the library "
            "does not serve the ABI of the headers it was built with")


def build_jpegcoef(route: JpegRoute) -> Built:
    """Build (if needed), load, bind and check jpegcoef against `route`'s
    libjpeg. The library is named by a hash of the source, the flags, the
    route's headers and library and the CPU tag, and written through a
    temporary file (concurrent test workers build it together). A failed
    build raises with g++'s stderr."""
    digest = hashlib.sha256(
        JPEGCOEF_SRC.read_bytes() + route.identity
        + " ".join(JPEGCOEF_FLAGS + tuple(route.cflags + route.link))
        .encode() + _cpu_tag().encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libjpegcoef-{digest}.so"
    t0, log, seconds = time.perf_counter(), "", 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        r = subprocess.run(["g++", *JPEGCOEF_FLAGS, *route.cflags,
                            "-o", str(tmp), str(JPEGCOEF_SRC), *route.link],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {JPEGCOEF_SRC}:\n{r.stderr}")
        log, seconds = r.stderr, time.perf_counter() - t0
        os.replace(tmp, so)
    lib = _bind_jpegcoef(ctypes.CDLL(str(so)))
    _check_jpegcoef(lib, route)
    return Built(lib, so, log, seconds, route.name)


def load_jpegcoef() -> ctypes.CDLL:
    """The libjpeg entropy coder, with the signatures of `jc_read`,
    `jc_read_packed` and `jc_write_packed` bound: built against the
    system's libjpeg where g++ finds its headers and library, else
    against Pillow's (`pillow_libjpeg`)."""
    if "jpegcoef" not in _LOADED:
        _LOADED["jpegcoef"] = build_jpegcoef(system_libjpeg()
                                             or pillow_libjpeg())
    return _LOADED["jpegcoef"].lib


AVBRIDGE_SRC = Path(__file__).resolve().parents[2] / "native" / "avbridge.cpp"
AVBRIDGE_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
AVBRIDGE_LIBS = ("avformat", "avcodec", "avutil", "swscale", "swresample")
#: why the libav lane is absent on this host ("" while it is not)
AVBRIDGE_ABSENT = ""
_AVBRIDGE_HEADERS = "".join(
    f"#include <{h}>\n" for h in (
        "libavcodec/avcodec.h", "libavformat/avformat.h",
        "libavutil/imgutils.h", "libavutil/opt.h",
        "libswresample/swresample.h", "libswscale/swscale.h"))


def load_avbridge() -> ctypes.CDLL | None:
    """The libav bridge, built (if needed) and loaded, or None where the
    host has no libavformat or no libav headers (`AVBRIDGE_ABSENT` then
    names what is missing). A failed build raises with g++'s stderr."""
    global AVBRIDGE_ABSENT
    if "avbridge" in _LOADED:
        return _LOADED["avbridge"].lib
    if AVBRIDGE_ABSENT:
        return None
    if ctypes.util.find_library("avformat") is None:
        AVBRIDGE_ABSENT = "no libavformat on this host"
        return None
    pre = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                         input='extern "C" {\n' + _AVBRIDGE_HEADERS + "}\n",
                         capture_output=True, text=True, timeout=60)
    if pre.returncode != 0:
        first = (pre.stderr.strip().splitlines() or ["?"])[0]
        AVBRIDGE_ABSENT = f"no libav headers on this host ({first})"
        return None
    libs = [subprocess.run(["g++", f"-print-file-name=lib{n}.so"],
                           capture_output=True, text=True,
                           timeout=60).stdout.strip() for n in AVBRIDGE_LIBS]
    identity = pre.stdout.encode() + b"".join(
        Path(p).resolve().read_bytes() for p in libs if os.path.isabs(p))
    link = tuple(f"-l{n}" for n in AVBRIDGE_LIBS)
    digest = hashlib.sha256(
        AVBRIDGE_SRC.read_bytes() + identity
        + " ".join(AVBRIDGE_FLAGS + link).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libavbridge-{digest}.so"
    t0, log, seconds = time.perf_counter(), "", 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        r = subprocess.run(["g++", *AVBRIDGE_FLAGS, "-o", str(tmp),
                            str(AVBRIDGE_SRC), *link],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {AVBRIDGE_SRC}:\n{r.stderr}")
        log, seconds = r.stderr, time.perf_counter() - t0
        os.replace(tmp, so)
    AVBRIDGE_ABSENT = ""
    _LOADED["avbridge"] = Built(ctypes.CDLL(str(so)), so, log, seconds)
    return _LOADED["avbridge"].lib
