"""Compressed JPEG ingest: entropy decode on the host, dequantise and IDCT
on the device.

Counterpart of `lives_tpu/io/jpeg_ingest.py` (the MJPEG ingest lane). The
JPEG decoder splits at its natural seam (the reference decoder plugins do
the whole decode on the host, `decplugin.h:280` get_frame):

  host  : entropy (Huffman) decode only, `native/jpegcoef.cpp` over
          libjpeg's `jpeg_read_coefficients` (`native.load_jpegcoef`),
          then the v2 sparse pack: int16 DC per block, (count u8) per
          block, (pos u8, val i8) per nonzero AC, an escape list for
          |AC| > 127; written into pinned host buffers;
  wire  : one packed upload a frame batch, `non_blocking=True`;
  device: scatter -> dequantise -> batched 8x8 IDCT as two matrix
          products -> block reassembly -> planar YUV Layer (full-range
          JFIF, `YUVClamping.UNCLAMPED`), which `convert_layer` takes to
          RGB (K2 for 4:2:0, `ops/yuv_kernels.py`).

The host half is the JAX package's numpy and ctypes code, copied
(`:104-297,444-458`); the wire format is the same bytes. The device half
is PyTorch on the tensors' device: `build_device_decoder` (`:300-351`),
`layer_from_planes` (`:375`), `split_layer_batch` (`:410`, plain indexing:
the jitted splitter exists for the TPU's per-op dispatch cost),
`MJPEGClipSource`, `MJPEGMultiClipSource`, `JpegStreamSource`
(`:465-677`). Every class and function that makes tensors takes `device=`
("cuda" by default, raising without CUDA); the tests pass "cpu".

Numerics: the two 8x8 products accumulate in float64 and round once to
float32. PyTorch's TF32 switch for float32 products is process-wide (and
its two APIs raise when mixed), so a float32 product could lose 13 bits
of mantissa to a setting made elsewhere; float64 is the one type no such
switch moves. The rest (dequantisation, `floor(P + 128.5)`, the clamp) is
float32, as in the JAX lane.

Parity contract: the device decoder matches `decode_frame_ref` (the
float64 numpy twin) and the JAX lane within 1 LSB.

Two fallbacks are kept from the JAX package, each counted on its object:
`JpegStreamSource.fallbacks` (a frame past the wire's capacity decodes
through the float64 twin on the host) and `MJPEGMultiClipSource.
host_decoded` (a clip that is not MJPG, or whose stream fails to
entropy-decode, is decoded frame by frame on the host).

Not ported yet: `shard_decode_batch` (`:354`), which goes with the dry
run's JPEG steps over the port's `Mesh` (ROADMAP Queue 1 item 25).
"""

from __future__ import annotations

import ctypes
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import Gamma, Palette, YUVClamping, YUVSubspace
from ..layer import Layer
from ..native import load_jpegcoef
from ..utils.device import resolve_device  # noqa: F401 (re-exported)


@dataclass
class JpegFrame:
    """One frame's entropy-decoded coefficient data."""
    height: int
    width: int
    comps: list        # dicts: hb wb hs vs qno dw dh coefs (nb, 64) int16
    qtabs: np.ndarray  # (4, 64) uint16, natural order


def read_coefficients(data: bytes) -> JpegFrame:
    """Host entropy decode (the cheap pass over the compressed stream)."""
    lib = load_jpegcoef()
    info = (ctypes.c_int * 32)()
    qtabs = (ctypes.c_uint16 * 256)()
    # worst case: 4 comps x full-res blocks
    cap = (len(data) * 64) + (1 << 22)
    coefs = np.empty(cap // 2 + 64, np.int16)
    n = lib.jc_read(data, len(data), info, qtabs,
                    coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    len(coefs))
    if n < 0:
        raise ValueError(f"JPEG entropy decode failed ({n})")
    ncomp, H, W = info[0], info[1], info[2]
    comps = []
    off = 0
    for c in range(min(ncomp, 4)):
        ip = [info[3 + c * 7 + k] for k in range(7)]
        hb, wb, hs, vs, qno, dw, dh = ip
        nb = hb * wb
        comps.append(dict(hb=hb, wb=wb, hs=hs, vs=vs, qno=qno, dw=dw,
                          dh=dh,
                          coefs=coefs[off: off + nb * 64]
                          .reshape(nb, 64).copy()))
        off += nb * 64
    return JpegFrame(H, W, comps,
                     np.ctypeslib.as_array(qtabs).reshape(4, 64).copy())


# ---------------------------------------------------------------------------
# Sparse packing (the wire format)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class JpegMeta:
    """Static per-stream geometry (the decoder's key)."""
    height: int
    width: int
    comp_dims: tuple   # per comp: (hb, wb, qno, dw, dh)
    sampling: tuple    # comp0 (hs, vs)

    @classmethod
    def of(cls, f: JpegFrame) -> "JpegMeta":
        return cls(f.height, f.width,
                   tuple((c["hb"], c["wb"], c["qno"], c["dw"], c["dh"])
                         for c in f.comps),
                   (f.comps[0]["hs"], f.comps[0]["vs"]))

    @property
    def n_blocks(self) -> int:
        return sum(hb * wb for hb, wb, _, _, _ in self.comp_dims)


def esc_cap_for(n_blocks: int) -> int:
    """Escape slots per frame (|AC| > 127 is rare); scales with the
    frame so tiny streams don't pay a fixed padding tax."""
    return max(256, n_blocks // 8)


def pack_frame(f: JpegFrame, capacity: int, esc_cap: int | None = None):
    """Sparse-pack one frame (wire format v2):

      dc     (NB,)  int16  — DC per block, dense (almost always nonzero)
      counts (NB,)  uint8  — nonzero-AC count per block
      pos    (C,)   uint8  — AC position in block (1..63)
      vals   (C,)   int8   — AC value clamped to +-127
      esc    (E,2)  int32/int16 pairs — (global coeff idx, true value)
             for the rare |AC| > 127
      qtabs  (4,64) uint16

    Returns None when C or E overflow (the caller decodes the frame on
    the host)."""
    dcs, all_counts, all_pos, all_vals = [], [], [], []
    esc_idx, esc_val = [], []
    boff = 0
    for c in f.comps:
        co = c["coefs"]                      # (nb, 64)
        dcs.append(co[:, 0])
        bi, pj = np.nonzero(co[:, 1:])
        pos = (pj + 1).astype(np.uint8)
        vals = co[bi, pos]
        all_counts.append(np.bincount(bi, minlength=co.shape[0]))
        all_pos.append(pos)
        all_vals.append(np.clip(vals, -127, 127).astype(np.int8))
        esc = np.abs(vals) > 127
        if esc.any():
            esc_idx.append(((boff + bi[esc]) * 64
                            + pos[esc]).astype(np.int32))
            esc_val.append(vals[esc].astype(np.int16))
        boff += co.shape[0]
    counts = np.concatenate(all_counts)
    if counts.max(initial=0) > 255:
        return None
    pos = np.concatenate(all_pos)
    vals = np.concatenate(all_vals)
    if esc_cap is None:
        esc_cap = esc_cap_for(len(counts))
    n_esc = sum(len(e) for e in esc_idx)
    if len(pos) > capacity or n_esc > esc_cap:
        return None
    cpos = np.zeros(capacity, np.uint8)
    cvals = np.zeros(capacity, np.int8)
    cpos[: len(pos)] = pos
    cvals[: len(vals)] = vals
    ei = np.full(esc_cap, -1, np.int32)
    ev = np.zeros(esc_cap, np.int16)
    if n_esc:
        ei[:n_esc] = np.concatenate(esc_idx)
        ev[:n_esc] = np.concatenate(esc_val)
    return (np.concatenate(dcs).astype(np.int16),
            counts.astype(np.uint8), cpos, cvals, ei, ev, f.qtabs)


def read_packed_native(data: bytes, meta: "JpegMeta", capacity: int,
                       out=None):
    """One native pass: entropy decode + v2 sparse pack straight from the
    coefficient rows (jc_read_packed). Returns the pack_frame tuple, None
    when the stream fails to decode or its geometry or capacity does not
    fit (the caller takes the python path).

    `out=(dc, counts, pos, vals, ei, ev, qtabs_u16)` writes into caller
    buffers (contiguous rows of the batch arrays)."""
    lib = load_jpegcoef()
    NB = meta.n_blocks
    ec = esc_cap_for(NB)
    info = (ctypes.c_int * 32)()
    if out is not None:
        dc, counts, pos, vals, ei, ev, qtabs = out
    else:
        qtabs = np.zeros((4, 64), np.uint16)
        dc = np.zeros(NB, np.int16)
        counts = np.zeros(NB, np.uint8)
        pos = np.zeros(capacity, np.uint8)
        vals = np.zeros(capacity, np.int8)
        ei = np.full(ec, -1, np.int32)
        ev = np.zeros(ec, np.int16)
    nesc = ctypes.c_int(0)

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    n = lib.jc_read_packed(
        data, len(data), info, ptr(qtabs, ctypes.c_uint16),
        ptr(dc, ctypes.c_int16), ptr(counts, ctypes.c_uint8),
        ptr(pos, ctypes.c_uint8), ptr(vals, ctypes.c_int8), capacity,
        ptr(ei, ctypes.c_int32), ptr(ev, ctypes.c_int16), ec,
        ctypes.byref(nesc), NB)
    if n < 0:
        return None
    # geometry must still match the stream meta (the decoder's key)
    dims = tuple((info[3 + c * 7], info[3 + c * 7 + 1],
                  info[3 + c * 7 + 4], info[3 + c * 7 + 5],
                  info[3 + c * 7 + 6]) for c in range(min(info[0], 4)))
    if dims != meta.comp_dims:
        return None
    ei[nesc.value:] = -1
    return dc, counts, pos, vals, ei, ev, qtabs


def wire_bytes(capacity: int, n_blocks: int) -> int:
    """Per-frame transfer size of the packed format."""
    return (n_blocks * 3 + capacity * 2 + esc_cap_for(n_blocks) * 6
            + 4 * 64 * 2)


# ---------------------------------------------------------------------------
# Device decoder: scatter -> dequant -> IDCT -> planes
# ---------------------------------------------------------------------------

def _idct_basis(dtype=np.float32) -> np.ndarray:
    """A[x, u] = 0.5 * c(u) * cos((2x+1) u pi / 16) — pixels = A F A^T."""
    x = np.arange(8)[:, None]
    u = np.arange(8)[None, :]
    A = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    A[:, 0] *= 1.0 / np.sqrt(2.0)
    return A.astype(dtype)


def block_products(left: torch.Tensor, blocks: torch.Tensor,
                   right: torch.Tensor) -> torch.Tensor:
    """left @ blocks @ right over (N, 8, 8) float32 blocks with float64
    (8, 8) bases: accumulated in float64, rounded once to float32 (the
    module's note, "Numerics")."""
    return torch.matmul(torch.matmul(left, blocks.double()), right).float()


def build_device_decoder(meta: JpegMeta, B: int, capacity: int,
                         device="cuda"):
    """fn(dc (B,NB) i16, counts (B,NB) u8, pos (B,C) u8, vals (B,C) i8,
    esc_idx (B,E) i32, esc_val (B,E) i16, qtabs (B,4,64) f32), tensors on
    `device` -> planar YUV planes [(B,h,w) u8 ...] (full-range JFIF:
    UNCLAMPED YCbCr). No step reads a value back to the host."""
    dev = resolve_device(device, "build_device_decoder")
    NB = meta.n_blocks
    TOT = NB * 64
    A = torch.from_numpy(_idct_basis(np.float64)).to(dev)
    At = A.T.contiguous()
    # entry e of the packed ACs belongs to the block whose inclusive count
    # cumsum first exceeds e (jnp.repeat(..., total_repeat_length) in the
    # JAX lane); past the valid entries it clamps, and those go to the
    # dump slot
    entry = torch.arange(capacity, device=dev).expand(B, capacity) \
        .contiguous()

    def decode(dc, counts, pos, vals, esc_idx, esc_val, qtabs):
        csum = counts.long().cumsum(1)
        block_of = torch.searchsorted(csum, entry, right=True) \
            .clamp_(max=NB - 1)
        valid = entry < csum[:, -1:]
        # one extra block holds the dump slot TOT: only it takes duplicate
        # indices (padding), so scatter order never matters
        dense = torch.zeros((B, (NB + 1) * 64), dtype=torch.float32,
                            device=dev)
        dense.scatter_(1, torch.where(valid, block_of * 64 + pos.long(),
                                      TOT), vals.float())
        # escapes override their clamped entries; padding slots (-1)
        # route to the dump slot
        dense.scatter_(1, torch.where(esc_idx >= 0, esc_idx.long(), TOT),
                       esc_val.float())
        dense = dense.view(B, NB + 1, 64)[:, :NB]
        dense[:, :, 0] = dc.float()   # the dense DC column
        planes = []
        off = 0
        for (hb, wb, qno, dw, dh) in meta.comp_dims:
            nb = hb * wb
            q = qtabs[:, qno].reshape(B, 1, 64)      # natural order
            F = (dense[:, off:off + nb] * q).view(B * nb, 8, 8)
            off += nb
            P = block_products(A, F, At)
            P = torch.clamp(torch.floor(P + 128.5), 0, 255).to(torch.uint8)
            planes.append(P.view(B, hb, wb, 8, 8).permute(0, 1, 3, 2, 4)
                          .reshape(B, hb * 8, wb * 8)[:, :dh, :dw])
        return planes

    return decode


def layer_from_planes(planes, meta: JpegMeta) -> Layer:
    """Batched device planes -> Layer (YUV420P/422P/444P, unclamped JFIF;
    greyscale JPEGs become Y + flat chroma)."""
    if len(planes) == 1:
        y = planes[0]
        c = torch.full(y.shape, 128, dtype=torch.uint8, device=y.device)
        return Layer(planes=(y, c, c), palette=int(Palette.YUV444P),
                     clamping=int(YUVClamping.UNCLAMPED),
                     subspace=int(YUVSubspace.YCBCR))
    hs, vs = meta.sampling
    pal = {(2, 2): Palette.YUV420P, (2, 1): Palette.YUV422P,
           (1, 1): Palette.YUV444P}.get((hs, vs), Palette.YUV444P)
    if (hs, vs) != (1, 1):
        # odd geometry: JPEG rounds chroma UP (ceil), the planar layers
        # floor-divide — crop luma to even dims and chroma to match
        y = planes[0]
        H2 = y.shape[1] - (y.shape[1] % vs)
        W2 = y.shape[2] - (y.shape[2] % hs)
        planes = [y[:, :H2, :W2]] + [
            c[:, : H2 // vs, : W2 // hs] for c in planes[1:]]
    return Layer(planes=tuple(planes), palette=int(pal),
                 clamping=int(YUVClamping.UNCLAMPED),
                 subspace=int(YUVSubspace.YCBCR))


def split_layer_batch(lay: Layer, gamma: int | None = None) -> list[Layer]:
    """Batched Layer (planes with a leading axis B) -> B per-frame Layers,
    views of the batch's planes."""
    g = int(Gamma.SRGB) if gamma is None else int(gamma)
    return [lay.replace(planes=tuple(p[i] for p in lay.planes), gamma=g)
            for i in range(int(lay.planes[0].shape[0]))]


# ---------------------------------------------------------------------------
# CPU golden twin (float64; the +/-1 LSB contract partner)
# ---------------------------------------------------------------------------

def decode_frame_ref(f: JpegFrame) -> list[np.ndarray]:
    """Reference decode of the coefficient data (numpy float64): the
    integer-exact contract partner of the device decoder."""
    A = _idct_basis(np.float64)
    planes = []
    for c in f.comps:
        q = f.qtabs[c["qno"]].astype(np.float64)
        F = (c["coefs"].astype(np.float64) * q).reshape(-1, 8, 8)
        P = np.einsum("xu,nuv,yv->nxy", A, F, A)
        P = np.clip(np.floor(P + 128.5), 0, 255)
        planes.append(P.reshape(c["hb"], c["wb"], 8, 8)
                      .transpose(0, 2, 1, 3)
                      .reshape(c["hb"] * 8, c["wb"] * 8)
                      [: c["dh"], : c["dw"]].astype(np.uint8))
    return planes


# ---------------------------------------------------------------------------
# Batched sources over stored JPEG frames
# ---------------------------------------------------------------------------

class MJPEGClipSource:
    """Renderer FrameSource over an MJPG clip decoder (`io/decoders.py`
    AVIDecoder or anything with `get_frame_bytes(n)`): frame batches
    travel as packed coefficients and decode on `device`. `get_frame`
    stays the per-frame contract (decplugin.h:280); this is the wide lane
    next to it."""

    def __init__(self, decoder, *, device="cuda"):
        self.decoder = decoder
        self.device = resolve_device(device, "MJPEGClipSource")
        self.n = decoder.cdata.nframes if hasattr(decoder, "cdata") else 0
        self._src: Optional[JpegStreamSource] = None

    def _stream(self) -> "JpegStreamSource":
        if self._src is None:
            first = self.decoder.get_frame_bytes(0)
            src = JpegStreamSource([first], device=self.device)
            src.frames = _LazyChunks(self.decoder, self.n)
            self._src = src
        return self._src

    @property
    def fallbacks(self) -> int:
        return self._src.fallbacks if self._src is not None else 0

    def get_batch(self, clip_ids, frame_nums) -> Layer:
        """(B,) ids/frames -> batched YUV Layer (clip ids are ignored:
        one source serves one clip, the renderer's per-track contract)."""
        src = self._stream()
        idx = [max(0, min(int(f), self.n - 1)) for f in frame_nums]
        return src.get_batch_planes(idx)


class MJPEGMultiClipSource:
    """Renderer FrameSource over several clips keyed by unique id (the
    `ClipFrameSource` role, compressed domain): a frame batch is grouped
    by clip, each group decodes on `device` through its stream's packed
    format and converts to RGB24 once (K2 for 4:2:0 on the card), groups
    of another geometry are resized, and each lands in batch order with
    one `index_copy_`. A clip that is not MJPG, or whose stream fails to
    entropy-decode, is decoded on the host frame by frame; `host_decoded`
    counts those frames and a warning names the clip once."""

    def __init__(self, clips_by_uid: dict, width: int, height: int, *,
                 device="cuda"):
        self.clips = {int(k): c for k, c in clips_by_uid.items()}
        self.w, self.h = int(width), int(height)
        self.device = resolve_device(device, "MJPEGMultiClipSource")
        self._srcs: dict = {}
        self.host_decoded = 0

    def _src_for(self, uid):
        if uid not in self._srcs:
            clip = self.clips.get(uid)
            dec = getattr(getattr(clip, "cdata", None), "decoder", None)
            if dec is not None and getattr(dec, "fourcc", "") == "MJPG":
                self._srcs[uid] = MJPEGClipSource(dec, device=self.device)
            else:
                self._srcs[uid] = None
        return self._srcs[uid]

    @property
    def fallbacks(self) -> int:
        """Frames past a stream's wire capacity, decoded by the twin."""
        return sum(s.fallbacks for s in self._srcs.values()
                   if s is not None)

    def get_batch(self, clip_ids, frame_nums) -> Layer:
        from ..ops.colorspace import convert_layer
        from ..ops.resize import resize_layer
        B = len(clip_ids)
        out = torch.zeros((B, 3, self.h, self.w), dtype=torch.uint8,
                          device=self.device)
        groups: dict = {}
        for i, (c, f) in enumerate(zip(clip_ids, frame_nums)):
            groups.setdefault(int(c), []).append((i, int(f)))
        for uid, items in groups.items():
            idx = [i for i, _ in items]
            fns = [f for _, f in items]
            src = self._src_for(uid)
            if src is not None:
                try:
                    lay = src.get_batch(None, fns)  # batched YUV
                except Exception as e:
                    # undecodable stream (arithmetic-coded, corrupt
                    # chunk...): this clip decodes on the host from now on
                    warnings.warn(f"MJPEGMultiClipSource: clip {uid} "
                                  f"decodes on the host ({e!r})")
                    self._srcs[uid] = src = None
            if src is not None:
                rgb = convert_layer(lay, Palette.RGB24)
            else:
                clip = self.clips.get(uid)
                if clip is None:
                    continue                        # blank stays zero
                self.host_decoded += len(fns)
                frames = []
                for f in fns:
                    one = clip.get_frame(f)
                    one = one.replace(planes=tuple(
                        p.to(self.device) for p in one.planes))
                    frames.append(convert_layer(one, Palette.RGB24)
                                  .planes[0])
                rgb = Layer(planes=(torch.stack(frames),),
                            palette=int(Palette.RGB24))
            if (rgb.height, rgb.width) != (self.h, self.w):
                rgb = resize_layer(rgb, self.w, self.h)
            out.index_copy_(0, torch.tensor(idx, device=self.device),
                            rgb.planes[0])
        return Layer(planes=(out,), palette=int(Palette.RGB24))


class _LazyChunks:
    """Sequence view over a decoder's raw chunks (no upfront read)."""

    def __init__(self, decoder, n):
        self.decoder, self.n = decoder, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.decoder.get_frame_bytes(int(i) % max(self.n, 1))


class JpegStreamSource:
    """Turns a sequence of JPEG byte strings (an MJPEG stream's frames)
    into batched Layers on `device` through the compressed path. Capacity
    is sized from the first frame; a frame that overflows it decodes
    through the float64 twin on the host and ships as planes
    (`fallbacks` counts them)."""

    def __init__(self, frames: Sequence[bytes],
                 capacity_frac: float | None = None, *, device="cuda"):
        self.device = resolve_device(device, "JpegStreamSource")
        self.frames = list(frames)
        f0 = read_coefficients(self.frames[0])
        self.meta = JpegMeta.of(f0)
        if capacity_frac is not None:
            self.capacity = int(self.meta.n_blocks * 64 * capacity_frac)
        else:
            # size the wire buffers from the stream itself: capacity is
            # shipped whole every frame
            nnz0 = sum(int(np.count_nonzero(c["coefs"][:, 1:]))
                       for c in f0.comps)
            self.capacity = max(int(nnz0 * 1.6), 4096)
        self._dec = {}
        self.fallbacks = 0

    def wire_bytes_per_frame(self) -> int:
        return wire_bytes(self.capacity, self.meta.n_blocks)

    def entropy_pack(self, idx: Sequence[int]):
        """Host half for a frame batch. Returns (dc, counts, pos, vals,
        esc_idx, esc_val, qt) host tensors (pinned when the device is a
        CUDA device) and `falls`, [(row, twin planes)] of the frames
        past the capacity. The native pass writes straight into the rows
        of the batch buffers."""
        B = len(idx)
        NB, cap = self.meta.n_blocks, self.capacity
        ec = esc_cap_for(NB)
        pin = self.device.type == "cuda"

        def buf(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, pin_memory=pin)
        t = (buf((B, NB), torch.int16), buf((B, NB), torch.uint8),
             buf((B, cap), torch.uint8), buf((B, cap), torch.int8),
             buf((B, ec), torch.int32, -1), buf((B, ec), torch.int16),
             buf((B, 4, 64), torch.float32))
        dc, counts, pos, vals, ei, ev, qt = (a.numpy() for a in t)
        qtmp = np.zeros((4, 64), np.uint16)
        falls = []
        for j, i in enumerate(idx):
            data = self.frames[int(i) % len(self.frames)]
            p = read_packed_native(
                data, self.meta, cap,
                out=(dc[j], counts[j], pos[j], vals[j], ei[j], ev[j],
                     qtmp))
            if p is not None:
                qt[j] = qtmp
                continue
            f = read_coefficients(data)
            p = pack_frame(f, cap)
            if p is None:
                self.fallbacks += 1
                falls.append((j, decode_frame_ref(f)))
                # zero coefficients: the row stays blank (ei -1)
                dc[j] = 0
                counts[j] = 0
                ei[j] = -1
                qt[j] = f.qtabs.astype(np.float32)
                continue
            dc[j], counts[j], pos[j], vals[j] = p[0], p[1], p[2], p[3]
            ei[j], ev[j] = p[4], p[5]
            qt[j] = p[6].astype(np.float32)
        return t, falls

    def get_batch_planes(self, idx: Sequence[int]) -> Layer:
        """Entropy decode + pack on the host, one upload, decode on the
        device. Returns the batched YUV Layer."""
        host, falls = self.entropy_pack(idx)
        B = len(idx)
        if B not in self._dec:
            self._dec[B] = build_device_decoder(self.meta, B, self.capacity,
                                                self.device)
        planes = self._dec[B](*(t.to(self.device, non_blocking=True)
                                for t in host))
        for bi, ref_planes in falls:
            for k, ref in enumerate(ref_planes):
                planes[k][bi] = torch.from_numpy(ref).to(self.device)
        return layer_from_planes(planes, self.meta)
