"""The export driver: an editor's multi-camera MJPEG export,
`lives_tpu_torch.transcode.render_to_encoder` over an
`MJPEGMultiClipSource` of MJPEG AVI clips into the "mjpeg" encoder's AVI,
pass after pass.

Set-up writes the clips into a temporary directory (removed by
`release`): each track's clip frame is the reference's clip frame
(`reference/mjpeg.clip_frames`, the synthetic gradient plus seeded noise),
put through the reference's forward transform, and its quantised
coefficients are written by libjpeg's `jpeg_write_coefficients`, a
lossless Huffman encode, into a RIFF/AVI-1.0 MJPG container this driver
writes itself (frames and `idx1`), so the port's `AVIDecoder` reads a file
the port did not write. After the window the output file's coefficients
are read back by libjpeg's `jpeg_read_coefficients`. Both libjpeg calls go
through the repository's `native/jpegcoef.cpp` bridge
(`lives_tpu_torch.native.load_jpegcoef`, `jc_write_packed` and
`jc_read`): a departure from "nothing of the program", for lossless
library code that is not the lane under test.

The window is whole passes: it ends when the pass that crosses
`seconds` has written its file and the card is synchronised, and counts
the frames of every finished pass. A pass in which the lane decoded a
frame on the host (`MJPEGMultiClipSource.host_decoded`, `.fallbacks`) or
the encoder cut a frame's ACs (`jpeg_encode.CUT_FRAMES`, where the
program has the counter) is not this deployment: the run raises.

`correct` is two comparisons, each with limits of its own in the
configuration's `limits`:

- the rendered frames: every `sample_stride`-th chunk of the window,
  `sample_per_chunk` frames of it from the seed (`harness.Sampler`, tapped
  between `render_events` and the encoder), against the reference
  timeline over the reference's decode of the clips' coefficients
  (`max_lsb`, `differing_share`: `harness.check` and `harness.judge`);
- the output file: `file_frames` frames of the last pass's file, drawn
  from the seed, their quantised coefficients against the reference's
  forward transform of the reference frame (`file` limits: the largest
  difference in quantisation steps and the share of coefficients that
  differ, a `harness.Readings` of their own judged by `harness.judge`,
  their numbers printed on standard error as `check file.<name>`).
  `run.py` judges the frames alone, so the file's verdict enters it
  through the sample: a run whose file fails its limits keeps no frames,
  and `frames_compared` reads 0.

The traffic mix (`traffic/<name>.json`): `sample_stride`,
`sample_per_chunk`, `sample_slots`, `file_frames`, `min_compared`.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import struct
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

from cardbench import harness, spans, trace, work_mjpeg
from cardbench.drivers.render import event_list
from cardbench.reference import mjpeg as ref
from cardbench.reference.render import Schedule

#: clip frames a group of the set-up's forward transform
GROUP = 16


def _draw(rng, spec):
    lo, hi = spec
    return float(lo) if lo == hi else float(rng.uniform(lo, hi))


def schedule(cfg: dict, seed: int) -> Schedule:
    """The timeline: track t plays clip t + 1 from its frame 0 in one
    segment; parameter values and the animated crossfade's ends drawn from
    the seed in the configuration's ranges."""
    rng = np.random.default_rng(seed)
    F, T = int(cfg["frames"]), int(cfg["tracks"])
    values = {name: {k: _draw(rng, spec) for k, spec in params.items()}
              for name, params in cfg["params"].items()}
    anim = cfg["animate"]
    a, b = _draw(rng, anim["from"]), _draw(rng, anim["to"])
    clips = np.broadcast_to(np.arange(1, T + 1), (F, T)).copy()
    fnums = np.broadcast_to(np.arange(F)[:, None], (F, T)).copy()
    return Schedule(width=int(cfg["width"]), height=int(cfg["height"]),
                    fps=float(cfg["fps"]),
                    transitions=list(cfg["transitions"]),
                    effects=[list(e) for e in cfg["effects"]], values=values,
                    animate=(anim["filter"], anim["param"]), clips=clips,
                    fnums=fnums, segments=[(0, F, 0, a, b)],
                    segment_of=np.zeros(F, np.int64))


# -- the reference ----------------------------------------------------------

def reference_frames(sched: Schedule, cfg: dict, seed: int, js,
                     dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(N, 3, H, W) u8: timeline frames `js` over the reference's decode of
    the clips' coefficients, the timeline in `dtype`."""
    h, w, q = sched.height, sched.width, int(cfg["quality"])
    sigma = float(cfg["noise_sigma"])

    def track(t, js):
        rgb = ref.clip_frames(seed, [t + 1] * len(js), js, h, w, sigma,
                              device)
        return ref.decoded(ref.forward(rgb, q), q, h, w)
    return ref.timeline(sched, js, track, dtype)


def reference_coefficients(sched: Schedule, cfg: dict, seed: int, js,
                           dtype=torch.float32, device="cpu"):
    """The quantised coefficients (Y, Cb, Cr, each (N, blocks, 64) int32)
    of the reference's export of timeline frames `js`: the forward
    transform in float64 of the float32 reference frame, or all in
    `dtype` where that is another."""
    fwd = torch.float64 if dtype == torch.float32 else dtype
    return ref.forward(reference_frames(sched, cfg, seed, js, dtype, device),
                       int(cfg["quality"]), fwd)


def coefficient_frame(coefs, k: int) -> torch.Tensor:
    """Frame k of per-plane coefficients as one (blocks * 64,) int16
    vector, Y then Cb then Cr."""
    return torch.cat([c[k].reshape(-1) for c in coefs]).to(torch.int16)


# -- libjpeg through the bridge, and the AVI container ------------------------

def _jpegcoef():
    from lives_tpu_torch.native import load_jpegcoef
    return load_jpegcoef()


def _packed(coefs: list[torch.Tensor]):
    """The blocks of N frames (per plane (N, nb, 64) int32, on any device)
    as `jc_write_packed`'s arrays, on the host, a tuple a frame: dc (NB,)
    i16, counts (NB,) u8, positions and values of the nonzero ACs in
    (block, position) order (values clamped to +-127), and the escapes
    (block * 64 + position, true value) of the ACs past 127."""
    co = torch.cat(coefs, 1)                         # (N, NB, 64)
    ac = co[..., 1:]
    nz = ac != 0
    counts = nz.sum(2).to(torch.uint8).cpu().numpy()
    dc = co[..., 0].to(torch.int16).cpu().numpy()
    out = []
    for k in range(co.shape[0]):
        blk, col = torch.nonzero(nz[k], as_tuple=True)
        v = ac[k][blk, col]
        pos = (col + 1).to(torch.uint8)
        esc = v.abs() > 127
        out.append((dc[k], counts[k], pos.cpu().numpy(),
                    v.clamp(-127, 127).to(torch.int8).cpu().numpy(),
                    (blk[esc] * 64 + pos[esc].long()).to(torch.int32)
                    .cpu().numpy(),
                    v[esc].to(torch.int16).cpu().numpy()))
    return out


def write_jpeg(lib, h: int, w: int, qt: np.ndarray, packed) -> bytes:
    """One baseline JFIF 4:2:0 frame from its packed coefficients,
    libjpeg's `jpeg_write_coefficients` (`jc_write_packed`)."""
    info = (ctypes.c_int * 32)()
    info[0], info[1], info[2] = 3, h, w
    for c, (_, _, hb, wb) in enumerate(ref.geometry(h, w)):
        info[3 + c * 7: 3 + c * 7 + 5] = [hb, wb, 2 if c == 0 else 1,
                                          2 if c == 0 else 1, min(c, 1)]
    dc, counts, pos, vals, ei, ev = (np.ascontiguousarray(a)
                                     for a in packed)
    cap = h * w * 3 + (1 << 16)
    out = np.empty(cap, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))
    n = lib.jc_write_packed(
        info, p(qt, ctypes.c_uint16), p(dc, ctypes.c_int16),
        p(counts, ctypes.c_uint8), p(pos, ctypes.c_uint8),
        p(vals, ctypes.c_int8), len(pos), p(ei, ctypes.c_int32),
        p(ev, ctypes.c_int16), len(ei),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"jc_write_packed returned {n}")
    return out[:n].tobytes()


def read_coefficients(lib, data: bytes, h: int, w: int) -> np.ndarray:
    """A JFIF frame's quantised coefficients, Y then Cb then Cr, as one
    (blocks * 64,) int16 vector: libjpeg's `jpeg_read_coefficients`
    (`jc_read`)."""
    n_co = sum(hb * wb * 64 for _, _, hb, wb in ref.geometry(h, w))
    info = (ctypes.c_int * 32)()
    qt = (ctypes.c_uint16 * 256)()
    co = np.zeros(n_co + (1 << 16), np.int16)
    n = lib.jc_read(data, len(data), info, qt,
                    co.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    len(co))
    if n != n_co or (info[0], info[1], info[2]) != (3, h, w):
        raise ValueError(f"jc_read: {n} coefficients of a {info[2]}x"
                         f"{info[1]} frame with {info[0]} planes, want "
                         f"{n_co} of {w}x{h} with 3")
    return co[:n_co]


def write_avi(path, frames, width: int, height: int, fps: float) -> None:
    """A RIFF AVI 1.0 file of one MJPG video stream: `hdrl` (`avih`, one
    `strl` of `strh` and a BITMAPINFOHEADER `strf`), `movi` of `00dc`
    chunks, and an `idx1` of keyframe entries, offsets from the `movi`
    list's type."""
    frames = list(frames)

    def chunk(fourcc: bytes, body: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(body)) + body \
            + b"\0" * (len(body) & 1)

    def lst(kind: bytes, body: bytes) -> bytes:
        return chunk(b"LIST", kind + body)
    n, big = len(frames), max(len(f) for f in frames)
    us = int(round(1e6 / fps))
    avih = struct.pack("<14I", us, big * int(round(fps)), 0, 0x10, n, 0, 1,
                       big, width, height, 0, 0, 0, 0)
    strh = (b"vidsMJPG" + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1000,
                                      int(round(fps * 1000)), 0, n, big, -1,
                                      0)
            + struct.pack("<4h", 0, 0, width, height))
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                       width * height * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, idx, off = [], [], 4
    for f in frames:
        movi.append(chunk(b"00dc", f))
        idx.append(b"00dc" + struct.pack("<III", 0x10, off, len(f)))
        off += len(movi[-1])
    body = b"AVI " + hdrl + lst(b"movi", b"".join(movi)) \
        + chunk(b"idx1", b"".join(idx))
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def avi_frames(path) -> list[bytes]:
    """The `00dc` chunks of an AVI's `movi` list, in order."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI")
    pos, out = 12, []
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if cid == b"LIST" and data[pos + 8:pos + 12] == b"movi":
            p, end = pos + 12, pos + 8 + size
            while p + 8 <= end:
                (sz,) = struct.unpack("<I", data[p + 4:p + 8])
                if data[p + 2:p + 4] == b"dc":
                    out.append(data[p + 8:p + 8 + sz])
                p += 8 + sz + (sz & 1)
            return out
        pos += 8 + size + (size & 1)
    raise ValueError(f"{path}: no movi list")


def write_clips(directory, cfg: dict, seed: int, device) -> dict:
    """The configuration's clips as MJPEG AVIs in `directory`: {clip id:
    path}. Each frame's coefficients are the reference's forward
    transform of its clip frame; libjpeg's Huffman encodes run on a pool
    of threads (the bridge releases the interpreter's lock)."""
    lib = _jpegcoef()
    h, w, q = int(cfg["height"]), int(cfg["width"]), int(cfg["quality"])
    F, sigma = int(cfg["clip_frames"]), float(cfg["noise_sigma"])
    qt = np.zeros((4, 64), np.uint16)
    qt[:2] = ref.qtables(q)
    paths = {}
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        for c in range(1, int(cfg["tracks"]) + 1):
            datas = []
            for f0 in range(0, F, GROUP):
                fs = list(range(f0, min(f0 + GROUP, F)))
                rgb = ref.clip_frames(seed, [c] * len(fs), fs, h, w, sigma,
                                      device)
                packed = _packed(ref.forward(rgb, q))
                datas += pool.map(lambda p: write_jpeg(lib, h, w, qt, p),
                                  packed)
            paths[c] = os.path.join(directory, f"clip{c}.avi")
            write_avi(paths[c], datas, w, h, float(cfg["fps"]))
    return paths


# -- the cell ---------------------------------------------------------------

class Sample(harness.Sampler):
    """The rendered frames' sample, whose `taken` first runs the output
    file's check (`file_check`, set by the cell): where the file fails its
    limits, no frame is taken."""

    file_check = None

    def taken(self):
        frames, ids = super().taken()
        if self.file_check is not None and not self.file_check():
            return frames[:0], []
        return frames, ids


class Cell:
    """One run's set-up, window, traced pass and checks."""

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from lives_tpu_torch.events.event_list import TICKS_PER_SECOND
        from lives_tpu_torch.io import jpeg_encode, jpeg_ingest
        from lives_tpu_torch.io.clips import open_clip
        from lives_tpu_torch.io.jpeg_ingest import MJPEGMultiClipSource
        from lives_tpu_torch.transcode import render_to_encoder
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.sched = s = schedule(cfg, seed)
        # the sample buffer first, before any of the program's objects
        self.sampler = Sample(
            seed, int(traffic["sample_slots"]), (3, s.height, s.width),
            device, int(traffic["sample_stride"]),
            int(traffic["sample_per_chunk"]))
        self.sampler.file_check = self._file_verdict
        self.tpf = int(TICKS_PER_SECOND / s.fps)
        self.chunk = int(cfg["chunk"])
        self._ingest, self._encode = jpeg_ingest, jpeg_encode
        self._render_to_encoder = render_to_encoder
        self.dir = tempfile.mkdtemp(prefix="cardbench-export-")
        self.out = os.path.join(self.dir, "export.avi")
        self.file_samples = self.file_checks = self._verdict = None
        try:
            self.clip_paths = write_clips(self.dir, cfg, seed, device)
            clips = {}
            for c, path in self.clip_paths.items():
                clips[c] = open_clip(path, os.path.join(self.dir, "work"))
                clips[c].unique_id = c
            self.src = MJPEGMultiClipSource(clips, s.width, s.height,
                                            device=device)
            self.el = event_list(s)
            # warm: one whole pass builds every decoder and plan and loads
            # every kernel
            self._pass()
            harness.sync(device)
        except BaseException:
            shutil.rmtree(self.dir, ignore_errors=True)
            raise

    def _pass(self) -> None:
        if not self._render_to_encoder(self.el, self.src, self.out,
                                       encoder="mjpeg",
                                       batch_size=self.chunk):
            raise RuntimeError("render_to_encoder wrote no file")

    def _counts(self) -> dict:
        return {"host_decoded": self.src.host_decoded,
                "fallbacks": self.src.fallbacks,
                "cut": getattr(self._encode, "CUT_FRAMES", None),
                "entropy": getattr(self._ingest, "ENTROPY_FRAMES", None)}

    @contextlib.contextmanager
    def _tap(self, chunks: list):
        """The window's chunks offered to the sample on their way from
        `render_events` to the encoder; `chunks` counts them."""
        from lives_tpu_torch.events import renderer
        orig = renderer.render_events

        def tapped(*args, **kw):
            for tcs, lay in orig(*args, **kw):
                unit = chunks[0]
                if self.sampler.wants(unit):
                    self.sampler.offer(unit, lay.planes[0],
                                       [tc // self.tpf for tc in tcs])
                chunks[0] += 1
                yield tcs, lay
        with mock.patch.object(renderer, "render_events", tapped):
            yield

    def window(self, seconds: float) -> dict:
        self.sampler.reset()
        before = self._counts()
        frames = passes = 0
        chunks = [0]
        harness.sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with self._tap(chunks):
            while True:
                self._pass()
                frames += self.sched.n_frames
                passes += 1
                if time.perf_counter() >= deadline:
                    break
        harness.sync(self.device)
        t1 = time.perf_counter()
        after = self._counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] is not None and before[k] is not None}
        off = {k: moved[k] for k in ("host_decoded", "fallbacks", "cut")
               if moved.get(k)}
        if off:
            shutil.rmtree(self.dir, ignore_errors=True)
            raise RuntimeError(f"the export left its lanes in the window: "
                               f"{off}")
        return {"t0": t0, "window_s": t1 - t0, "frames": frames,
                "chunks": chunks[0], "passes": passes,
                "entropy_frames": moved.get("entropy")}

    def traced(self) -> dict | None:
        """One whole pass, the mux included, under the profiler, after a
        short profile that starts the profiler's device tracing."""
        with harness.traced(self.device):
            self.src.get_batch([1, 1], [0, 1])
            harness.sync(self.device)
        with harness.traced(self.device) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                with trace.span("render_to_encoder"):
                    self._pass()
                with trace.span("synchronize"):
                    harness.sync(self.device)
        out = trace.reduce(prof)
        if out is None:
            return None
        out["spans"] = spans.reduce(prof)
        s = self.sched
        ops, nbytes = work_mjpeg.export_frame(s.n_tracks, s.transitions,
                                              s.effects, s.width, s.height)
        n = s.n_frames
        out.update(units=-(-n // self.chunk), frames=n, ops=ops * n,
                   bytes=nbytes * n)
        return out

    def release(self):
        """Read the last pass's file's sampled frames, drop the program's
        objects and the temporary directory; keep the samples and the
        schedule."""
        try:
            data = avi_frames(self.out)
            ids = file_ids(self.traffic, self.seed, self.sched.n_frames)
            self.file_samples = (ids, [data[j] for j in ids]
                                 if len(data) == self.sched.n_frames
                                 else None)
        except (OSError, ValueError) as e:
            print(f"cardbench: the export's file unread: {e}",
                  file=sys.stderr)
            self.file_samples = None
        self.el = self.src = self._render_to_encoder = None
        self._ingest = self._encode = None
        shutil.rmtree(self.dir, ignore_errors=True)

    def reference(self, ids, dtype=torch.float32) -> torch.Tensor:
        return reference_frames(self.sched, self.cfg, self.seed, ids, dtype,
                                self.device)

    def file_readings(self) -> harness.Readings:
        """The output file's sampled frames' coefficients against the
        reference's export of the same frames."""
        r = harness.Readings()
        if self.file_samples is None or self.file_samples[1] is None:
            return r
        ids, datas = self.file_samples
        lib = _jpegcoef()
        s = self.sched
        limit = int(self.cfg["limits"]["file"]["max_lsb"])
        for i in range(0, len(ids), 4):
            js = ids[i:i + 4]
            want = reference_coefficients(s, self.cfg, self.seed, js,
                                          torch.float32, self.device)
            got = torch.stack([torch.from_numpy(read_coefficients(
                lib, d, s.height, s.width)) for d in datas[i:i + 4]])
            r.add(got.to(self.device),
                  torch.stack([coefficient_frame(want, k)
                               for k in range(len(js))]), js, limit)
        return r

    def _file_verdict(self) -> bool:
        if self._verdict is None:
            n = self.file_readings().numbers()
            self._verdict, self.file_checks = harness.judge(
                n, self.cfg["limits"]["file"],
                int(self.traffic["file_frames"]))
            for k, c in self.file_checks.items():
                print(f"check file.{k} {c['value']} limit {c['limit']}",
                      file=sys.stderr)
        return self._verdict


def file_ids(traffic: dict, seed: int, n_frames: int) -> list[int]:
    """The output file's frames the check reads, drawn from the seed."""
    rng = np.random.default_rng([seed, 0xF1])
    k = min(int(traffic["file_frames"]), n_frames)
    return sorted(int(j) for j in rng.choice(n_frames, size=k,
                                             replace=False))


def control(cfg: dict, traffic: dict, seed: int, n: int, device):
    """(frame ids, reference(ids, dtype)) for the control: `n` frames of
    the seed's timeline, drawn from the seed."""
    sched = schedule(cfg, seed)
    rng = np.random.default_rng([seed, 0xC0])
    ids = sorted(int(j) for j in rng.choice(
        sched.n_frames, size=min(n, sched.n_frames), replace=False))
    return ids, lambda js, dtype: reference_frames(sched, cfg, seed, js,
                                                   dtype, device)


def control_file(cfg: dict, traffic: dict, seed: int, device):
    """(frame ids, coefficients(ids, dtype)) for the file's control: the
    file's sampled frames as the reference exports them, each frame's
    coefficients a (blocks * 64,) int16 row."""
    sched = schedule(cfg, seed)
    ids = file_ids(traffic, seed, sched.n_frames)

    def coefficients(js, dtype):
        co = reference_coefficients(sched, cfg, seed, js, dtype, device)
        return torch.stack([coefficient_frame(co, k)
                            for k in range(len(js))])
    return ids, coefficients


@contextlib.contextmanager
def fault(kind: str):
    """The timed path broken: the chunks `render_events` yields, as the
    render driver breaks them ("stale", "half", "altered"); the file's
    frames each the next one's ("shifted"); one coefficient of every
    frame altered ("coefficient"); the encoder's DCT in bfloat16
    ("bf16_dct")."""
    if kind in ("stale", "half", "altered"):
        from cardbench.drivers import render
        with render.fault(kind):
            yield
        return
    if kind == "shifted":
        from lives_tpu_torch.io import decoders
        orig = decoders.write_mjpeg_avi

        def shifted(path, frames, *args, **kw):
            frames = list(frames)
            return orig(path, frames[1:] + frames[-1:], *args, **kw)
        with mock.patch.object(decoders, "write_mjpeg_avi", shifted):
            yield
        return
    from lives_tpu_torch.io import jpeg_encode
    if kind == "coefficient":
        orig = jpeg_encode.write_jpeg_packed

        def altered(meta, qtabs, dc, *args, **kw):
            dc = np.array(dc, copy=True)
            dc[0] ^= 0x10
            return orig(meta, qtabs, dc, *args, **kw)
        with mock.patch.object(jpeg_encode, "write_jpeg_packed", altered):
            yield
        return
    if kind == "bf16_dct":
        def bf16(left, blocks, right):
            b = torch.bfloat16
            return torch.matmul(torch.matmul(left.to(b), blocks.to(b)),
                                right.to(b)).float()
        with mock.patch.object(jpeg_encode, "block_products", bf16):
            yield
        return
    raise ValueError(kind)


FAULTS = ("stale", "half", "altered", "shifted", "coefficient", "bf16_dct")
