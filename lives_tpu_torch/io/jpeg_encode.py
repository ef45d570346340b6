"""Compressed JPEG encode: quantised DCT coefficients leave the device in
the sparse wire format the ingest lane reads.

Counterpart of `lives_tpu/io/jpeg_encode.py`, the other half of
`io/jpeg_ingest.py`:

  device: RGB -> full-range JFIF YCbCr (BT.601) -> 2x2 chroma box mean
          (4:2:0) -> edge padding, level shift -> batched 8x8 FDCT as two
          matrix products (`Aᵀ P A`, accumulated in float64 and rounded
          once to float32, `jpeg_ingest.block_products`) -> quantise
          (round half to even) -> sparse pack (wire v3 a batch; v2, a
          frame a buffer, through `pack_wire`);
  wire  : v3: one u8 buffer a batch; the host reads its 8·B-byte header,
          then copies the used prefix in one device-to-host copy into
          pinned memory;
  host  : `native/jpegcoef.cpp` `jc_write_packed` rebuilds the blocks and
          runs libjpeg's Huffman encode: baseline JFIF bytes.

Copied from the JAX package (host numpy and ctypes): `quality_qtabs`,
`encode_meta` (`:69-92`), `WireLayout` (`:100-137`), `capacity_for`
(`:140`), `unpack_wire` (`:325`), `CompactLayout` (`:346-397`),
`unpack_compact` (`:494`), `write_jpeg_packed` (`:563-596`; its ctypes
signature is bound by `native.load_jpegcoef`), `encode_frame_ref`
(`:810`, the float64 twin). In PyTorch: `_coef_stage` (`:151-203`),
`build_device_encoder` (v2, `:206-322`), `build_device_encoder_compact`
(v3, `:400-491`) and `JpegDeviceEncoder` (`:603-803`).

Both wires compact the nonzero ACs by rank and scatter: an inclusive
cumsum ranks each nonzero in (frame, block, zigzag) order and one scatter
places it; the padding goes to a dump slot past the end, so only that
slot takes duplicate indices. The JAX package's default sort-based
compaction (`pack_impl="sort"`) exists because scatters serialize on its
TPU; its own test holds the two forms byte-identical
(`tests/test_jpeg_encode.py:207-240`), so the port keeps one form and no
switch between two that compute the same bytes. v3's escapes land right
after the used AC bytes, at an offset computed on the device, by a
scatter at `off + arange(6 * esc_pool)` (`off + 6 * esc_pool <= total`
always holds). Nothing reads a value back to the host before the fetch.

Wire bytes are the JAX package's byte for byte, so AVIs and packs cross
between the two packages. Coefficients match the JAX lane and the
float64 twin within +-1 on a small share of coefficients (a rounding tie
at .5). `shard_encode_batch` (`:845-861`) splits an encoder's frame
batch over a `parallel.mesh.Mesh` axis.

Module counters total every `JpegDeviceEncoder`'s work: `ENCODED_FRAMES`
(frames written), `CUT_FRAMES` (frames written with their ACs cut at the
pool, what each encoder's `overflows` counts) and `FETCH_BYTES` (the
used prefixes fetched). Spans (`diagnostics.span`): `lives.encode.coef`
(`dispatch_batch`, the device half), `lives.encode.fetch` (`_fetch` and
its wait for the device) and `lives.encode.huffman` (the batch's
`write_jpeg_packed` calls). Not ported, on purpose: the
chunked prefix
fetch of the v3 buffer (`_fetch_prefix`, `:657-716`), which exists for
the TPU attachment's transfer latency.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..diagnostics import span
from ..native import load_jpegcoef
from .jpeg_ingest import (JpegMeta, _idct_basis, block_products, esc_cap_for,
                          resolve_device)

#: frames the encoders wrote, those written with their ACs cut at the
#: pool, and the bytes of the used prefixes fetched, since each was last
#: set to 0
ENCODED_FRAMES = 0
CUT_FRAMES = 0
FETCH_BYTES = 0

# ---------------------------------------------------------------------------
# Quantisation tables (ITU-T T.81 Annex K, scaled the libjpeg way)
# ---------------------------------------------------------------------------

_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64)

_STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int64)


def quality_qtabs(quality: int) -> np.ndarray:
    """(4, 64) uint16 natural-order tables at `quality` (libjpeg
    jpeg_set_quality / jpeg_quality_scaling semantics; tables 2/3 unused
    and zeroed)."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - q * 2
    out = np.zeros((4, 64), np.uint16)
    for t, base in ((0, _STD_LUMA), (1, _STD_CHROMA)):
        tab = (base * scale + 50) // 100
        out[t] = np.clip(tab, 1, 255).astype(np.uint16)
    return out


def encode_meta(width: int, height: int, sampling: tuple[int, int] = (2, 2)
                ) -> JpegMeta:
    """Decode-side-convention geometry for an encode of (width, height):
    per comp (hb, wb, qno, dw, dh), unpadded block dims."""
    hs, vs = sampling
    dims = []
    for c in range(3):
        dw = width if c == 0 else -(-width // hs)
        dh = height if c == 0 else -(-height // vs)
        dims.append((-(-dh // 8), -(-dw // 8), 0 if c == 0 else 1, dw, dh))
    return JpegMeta(height, width, tuple(dims), sampling)


# ---------------------------------------------------------------------------
# Wire layout v2 (one u8 buffer a frame)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WireLayout:
    nb: int
    capacity: int
    esc_cap: int

    @property
    def off_stats(self):
        return 0                      # 2 x int32: [n_ac, n_esc]

    @property
    def off_dc(self):
        return 8

    @property
    def off_counts(self):
        return self.off_dc + self.nb * 2

    @property
    def off_pos(self):
        return self.off_counts + self.nb

    @property
    def off_vals(self):
        return self.off_pos + self.capacity

    @property
    def off_esc_idx(self):
        return self.off_vals + self.capacity

    @property
    def off_esc_val(self):
        return self.off_esc_idx + self.esc_cap * 4

    @property
    def total(self):
        # padded to a multiple of 4
        t = self.off_esc_val + self.esc_cap * 2
        return (t + 3) // 4 * 4


def capacity_for(meta: JpegMeta, density: float = 0.35) -> int:
    """AC capacity: `density` nonzero ACs per coefficient is generous for
    q<=90 natural content (ingest measures 0.1-0.3); padded to 128."""
    cap = int(meta.n_blocks * 63 * density)
    return (cap + 127) // 128 * 128


# ---------------------------------------------------------------------------
# Device encoder: RGB -> YCbCr 4:2:0 -> FDCT -> quantise -> pack
# ---------------------------------------------------------------------------

def _coef_stage(meta: JpegMeta, quality: int, device):
    """The stage both wires share: (B, 3, H, W) u8 RGB frames -> (dc (B,
    NB) int16, ac2 (B, NB, 63) int32 quantised natural-order
    coefficients). The JAX stage's `input_palette="yuv444"` has no caller
    in the port and is left out."""
    H, W = meta.height, meta.width
    hs, vs = meta.sampling
    if (hs, vs) not in ((2, 2), (1, 1)):
        raise ValueError("sampling must be 4:2:0 or 4:4:4")
    dev = torch.device(device)
    qt = torch.from_numpy(quality_qtabs(quality).astype(np.float32)).to(dev)
    A = torch.from_numpy(_idct_basis(np.float64)).to(dev)  # FDCT: Aᵀ P A
    At = A.T.contiguous()

    def comp_blocks(plane, hb, wb, dh, dw):
        B = plane.shape[0]
        ph, pw = hb * 8 - dh, wb * 8 - dw
        if ph or pw:
            plane = F.pad(plane[:, None], (0, pw, 0, ph),
                          mode="replicate")[:, 0]
        return (plane.reshape(B, hb, 8, wb, 8).permute(0, 1, 3, 2, 4)
                .reshape(B * hb * wb, 8, 8) - 128.0)

    def coefs(frames):
        B = frames.shape[0]
        x = frames[:, :3].to(torch.float32)
        r, g, b = x[:, 0], x[:, 1], x[:, 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
        cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
        if (hs, vs) == (2, 2):
            ph, pw = H % 2, W % 2
            if ph or pw:
                cb = F.pad(cb[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
                cr = F.pad(cr[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
            h2, w2 = (H + ph) // 2, (W + pw) // 2
            cb = cb.reshape(B, h2, 2, w2, 2).mean(dim=(2, 4))
            cr = cr.reshape(B, h2, 2, w2, 2).mean(dim=(2, 4))
        blocks = []
        for (hb, wb, qno, dw, dh), p in zip(meta.comp_dims, (y, cb, cr)):
            Fq = block_products(At, comp_blocks(p, hb, wb, dh, dw), A)
            q = qt[qno].reshape(8, 8)
            blocks.append(torch.round(Fq / q).to(torch.int32)
                          .reshape(B, hb * wb, 64))
        co = torch.cat(blocks, 1).clamp_(-2047, 2047)        # (B, NB, 64)
        return co[..., 0].to(torch.int16), co[..., 1:]

    return coefs


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The little-endian bytes of t's last axis, as uint8 (the JAX lane's
    `bitcast_convert_type` to u8)."""
    return t.contiguous().view(torch.uint8)


def _compact(sel: torch.Tensor, cap: int):
    """Rank-and-scatter compaction over the last axis of the boolean `sel`:
    (index of each selected entry's slot, cap for the dump slot; the
    count). Entries past `cap` go to the dump slot too."""
    rank = sel.cumsum(-1) - 1
    return torch.where(sel & (rank < cap), rank, cap), rank[..., -1] + 1


def _ac_index(n: int, device):
    """For each of n coefficients in (block, zigzag 1..63) order: its
    zigzag position (u8) and its global index block * 64 + position."""
    i = torch.arange(n, device=device)
    k = i % 63 + 1
    return k.to(torch.uint8), ((i // 63) * 64 + k).to(torch.int32)


def pack_wire(dc: torch.Tensor, ac2: torch.Tensor,
              lay: WireLayout) -> torch.Tensor:
    """Wire v2 of quantised coefficients: dc (B, NB) int16 and ac2 (B, NB,
    63) int32 -> (B, lay.total) u8, on their device."""
    B, dev = ac2.shape[0], ac2.device
    cap, esc_cap = lay.capacity, lay.esc_cap
    acs = ac2.reshape(B, -1)
    kpos, gidx = _ac_index(acs.shape[1], dev)
    m = acs != 0
    counts = m.view(B, lay.nb, 63).sum(2).to(torch.uint8)
    idx, n_ac = _compact(m, cap)
    pos = torch.zeros((B, cap + 1), dtype=torch.uint8, device=dev) \
        .scatter_(1, idx, kpos.expand(B, -1))[:, :cap]
    vals = torch.zeros((B, cap + 1), dtype=torch.int8, device=dev) \
        .scatter_(1, idx, acs.clamp(-127, 127).to(torch.int8))[:, :cap]
    eidx, n_esc = _compact(m & (acs.abs() > 127), esc_cap)
    esc_idx = torch.full((B, esc_cap + 1), -1, dtype=torch.int32,
                         device=dev).scatter_(
        1, eidx, gidx.expand(B, -1))[:, :esc_cap]
    esc_val = torch.zeros((B, esc_cap + 1), dtype=torch.int16,
                          device=dev).scatter_(
        1, eidx, acs.to(torch.int16))[:, :esc_cap]
    stats = torch.stack([n_ac, n_esc], 1).to(torch.int32)
    wire = torch.cat([_bytes(stats), _bytes(dc), counts, pos, _bytes(vals),
                      _bytes(esc_idx), _bytes(esc_val)], 1)
    pad = lay.total - wire.shape[1]
    return F.pad(wire, (0, pad)) if pad else wire


def build_device_encoder(meta: JpegMeta, B: int, capacity: int,
                         quality: int = 85, esc_cap: int | None = None,
                         device="cuda"):
    """fn(rgb (B, 3, H, W) u8 on `device`) -> wire v2 (B, L) u8, and its
    `WireLayout`."""
    dev = resolve_device(device, "build_device_encoder")
    NB = meta.n_blocks
    if esc_cap is None:
        esc_cap = esc_cap_for(NB)
    lay = WireLayout(NB, capacity, esc_cap)
    coefs = _coef_stage(meta, quality, dev)
    return (lambda frames: pack_wire(*coefs(frames), lay)), lay


def unpack_wire(buf: np.ndarray, lay: WireLayout):
    """Host split of one frame's wire buffer -> the pack_frame tuple
    fields (views, no copies) + (n_ac, n_esc)."""
    b = np.ascontiguousarray(buf)
    stats = b[lay.off_stats: lay.off_stats + 8].view(np.int32)
    dc = b[lay.off_dc: lay.off_counts].view(np.int16)
    counts = b[lay.off_counts: lay.off_pos]
    pos = b[lay.off_pos: lay.off_vals]
    vals = b[lay.off_vals: lay.off_esc_idx].view(np.int8)
    esc_idx = b[lay.off_esc_idx: lay.off_esc_val].view(np.int32)
    esc_val = b[lay.off_esc_val: lay.off_esc_val + lay.esc_cap * 2] \
        .view(np.int16)
    return (int(stats[0]), int(stats[1]), dc, counts, pos, vals,
            esc_idx, esc_val)


# ---------------------------------------------------------------------------
# Wire v3: one batch-compacted buffer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CompactLayout:
    """Wire v3: ONE buffer for the whole batch, all live data at the
    front so the host fetches only the used prefix.

        [head]  B x (n_ac i32, n_esc i32)            8*B bytes
        [fixed] B x (dc i16le (NB), counts u8 (NB))  3*NB*B bytes
        [ac]    2-byte entries (pos u8, val i8), all frames' nonzero
                ACs concatenated in (frame, block, zigzag) order,
                sharing ONE B*capacity pool
        [esc]   6-byte entries (global idx i32le, val i16le), placed
                immediately after the used AC bytes, so used bytes stay
                contiguous"""

    B: int
    nb: int
    capacity: int          # per-frame AC pool share (entries)
    esc_cap: int           # per-frame escape pool share (entries)
    chunk: int = 1 << 21   # 2 MiB: the JAX lane's fetch granularity

    @property
    def off_fixed(self):
        return 8 * self.B

    @property
    def off_ac(self):
        return self.off_fixed + 3 * self.nb * self.B

    @property
    def ac_pool(self):
        return self.B * self.capacity

    @property
    def esc_pool(self):
        return self.B * self.esc_cap

    @property
    def total(self):
        t = self.off_ac + 2 * self.ac_pool + 6 * self.esc_pool
        # padded to a chunk multiple (the JAX lane's chunked fetch)
        return -(-t // self.chunk) * self.chunk

    def used(self, total_ac: int, total_esc: int) -> int:
        return (self.off_ac + 2 * min(total_ac, self.ac_pool)
                + 6 * min(total_esc, self.esc_pool))


def pack_compact(dc: torch.Tensor, ac2: torch.Tensor,
                 lay: CompactLayout) -> torch.Tensor:
    """Wire v3 of a batch's quantised coefficients: dc (B, NB) int16 and
    ac2 (B, NB, 63) int32 -> (lay.total,) u8, on their device."""
    B, dev = ac2.shape[0], ac2.device
    counts = (ac2 != 0).sum(2).to(torch.uint8)
    n_ac_f = counts.sum(1, dtype=torch.int32)                # (B,)
    g = ac2.reshape(-1)
    kpos, gidx = _ac_index(g.numel(), dev)
    m = g != 0
    idx, total_ac = _compact(m, lay.ac_pool)
    pos = torch.zeros(lay.ac_pool + 1, dtype=torch.uint8, device=dev) \
        .scatter_(0, idx, kpos)[:lay.ac_pool]
    val8 = torch.zeros(lay.ac_pool + 1, dtype=torch.int8, device=dev) \
        .scatter_(0, idx, g.clamp(-127, 127).to(torch.int8))[:lay.ac_pool]
    # interleave (pos, val) -> contiguous 2-byte entries
    ac_b = torch.stack([pos, _bytes(val8)], 1).reshape(-1)
    em = m & (g.abs() > 127)
    eidx, _ = _compact(em, lay.esc_pool)
    esc_idx = torch.full((lay.esc_pool + 1,), -1, dtype=torch.int32,
                         device=dev).scatter_(0, eidx, gidx)[:lay.esc_pool]
    esc_val = torch.zeros(lay.esc_pool + 1, dtype=torch.int16,
                          device=dev).scatter_(
        0, eidx, g.to(torch.int16))[:lay.esc_pool]
    esc_b = torch.cat([_bytes(esc_idx[:, None]), _bytes(esc_val[:, None])],
                      1).reshape(-1)                         # 6-byte entries
    n_esc_f = em.view(B, -1).sum(1, dtype=torch.int32)
    buf = torch.zeros(lay.total, dtype=torch.uint8, device=dev)
    head = torch.cat([_bytes(n_ac_f[:, None]).reshape(-1),
                      _bytes(n_esc_f[:, None]).reshape(-1),
                      _bytes(dc).reshape(-1), counts.reshape(-1), ac_b])
    buf[:head.numel()] = head
    # the escapes land right after the used AC bytes, so the live data
    # stays one contiguous prefix
    off = lay.off_ac + 2 * torch.clamp(total_ac, max=lay.ac_pool)
    buf.index_copy_(0, off + torch.arange(6 * lay.esc_pool, device=dev),
                    esc_b)
    return buf


def build_device_encoder_compact(meta: JpegMeta, B: int, capacity: int,
                                 quality: int = 85,
                                 esc_cap: int | None = None,
                                 device="cuda"):
    """fn(rgb (B, 3, H, W) u8 on `device`) -> (lay.total,) u8 compact
    buffer (wire v3), and its `CompactLayout`. One compaction over the
    whole batch's (B*NB, 63) coefficients: bytes per entry and escape
    semantics are v2's, only the padding moves out of the fetch."""
    dev = resolve_device(device, "build_device_encoder_compact")
    NB = meta.n_blocks
    if esc_cap is None:
        esc_cap = esc_cap_for(NB)
    lay = CompactLayout(B, NB, capacity, esc_cap)
    coefs = _coef_stage(meta, quality, dev)
    return (lambda frames: pack_compact(*coefs(frames), lay)), lay


def unpack_compact(raw: np.ndarray, lay: CompactLayout):
    """Host split of a fetched used-prefix (or full) v3 buffer ->
    per-frame (n_ac, n_esc, dc, counts, pos, vals, esc_idx, esc_val)
    tuples (the write_jpeg_packed argument set)."""
    B, NB = lay.B, lay.nb
    n_ac = raw[:4 * B].view(np.int32).astype(np.int64)
    n_esc = raw[4 * B: 8 * B].view(np.int32).astype(np.int64)
    dc_all = raw[lay.off_fixed: lay.off_fixed + 2 * NB * B] \
        .view(np.int16).reshape(B, NB)
    cnt_all = raw[lay.off_fixed + 2 * NB * B: lay.off_ac] \
        .reshape(B, NB)
    ac_used = int(min(n_ac.sum(), lay.ac_pool))
    ac = raw[lay.off_ac: lay.off_ac + 2 * ac_used].reshape(-1, 2)
    esc_off = lay.off_ac + 2 * ac_used
    esc_used = int(min(n_esc.sum(), lay.esc_pool))
    esc = raw[esc_off: esc_off + 6 * esc_used].reshape(-1, 6)
    ac_ofs = np.concatenate([[0], np.cumsum(n_ac)])
    esc_ofs = np.concatenate([[0], np.cumsum(n_esc)])
    out = []
    for f in range(B):
        a0, a1 = int(ac_ofs[f]), int(ac_ofs[f + 1])
        truncated = a0 > ac_used or a1 > ac_used
        a0, a1 = min(a0, ac_used), min(a1, ac_used)
        seg = ac[a0:a1]
        pos = np.ascontiguousarray(seg[:, 0])
        vals = np.ascontiguousarray(seg[:, 1]).view(np.int8)
        counts = cnt_all[f]
        if truncated:
            # pool overflow truncates tail frames: clamp counts so the
            # native writer consumes exactly the entries that survived
            c = np.minimum(np.cumsum(counts.astype(np.int64)), a1 - a0)
            counts = np.diff(c, prepend=0).astype(np.uint8)
        e0 = int(min(esc_ofs[f], esc_used))
        e1 = int(min(esc_ofs[f + 1], esc_used))
        eseg = esc[e0:e1]
        ei = (np.ascontiguousarray(eseg[:, :4]).view(np.int32)
              .reshape(-1) - f * NB * 64)
        ev = np.ascontiguousarray(eseg[:, 4:6]).view(np.int16) \
            .reshape(-1)
        out.append((a1 - a0, e1 - e0, dc_all[f], counts, pos, vals,
                    ei, ev))
    return out


# ---------------------------------------------------------------------------
# Host finish: wire -> JPEG bytes (native entropy encode)
# ---------------------------------------------------------------------------

def write_jpeg_packed(meta: JpegMeta, qtabs: np.ndarray, dc, counts, pos,
                      vals, esc_idx, esc_val, n_esc: int) -> bytes:
    """Native entropy encode of one sparse-packed frame -> JFIF bytes."""
    lib = load_jpegcoef()
    info = (ctypes.c_int * 32)()
    info[0] = len(meta.comp_dims)
    info[1] = meta.height
    info[2] = meta.width
    hs, vs = meta.sampling
    for c, (hb, wb, qno, dw, dh) in enumerate(meta.comp_dims):
        ip = 3 + c * 7
        info[ip] = hb
        info[ip + 1] = wb
        info[ip + 2] = hs if c == 0 else 1
        info[ip + 3] = vs if c == 0 else 1
        info[ip + 4] = qno

    keep = []   # the contiguous copies live until the call returns

    def ptr(a, ct):
        keep.append(np.ascontiguousarray(a))
        return keep[-1].ctypes.data_as(ctypes.POINTER(ct))

    cap = meta.height * meta.width * 3 + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.jc_write_packed(
        info, ptr(qtabs.astype(np.uint16), ctypes.c_uint16),
        ptr(dc, ctypes.c_int16), ptr(counts, ctypes.c_uint8),
        ptr(pos, ctypes.c_uint8), ptr(vals, ctypes.c_int8), len(pos),
        ptr(esc_idx, ctypes.c_int32), ptr(esc_val, ctypes.c_int16),
        int(n_esc),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise ValueError(f"jc_write_packed failed ({n})")
    return out[:n].tobytes()


# ---------------------------------------------------------------------------
# The encoder object (what sinks and encoders hold)
# ---------------------------------------------------------------------------

class JpegDeviceEncoder:
    """Batch JPEG encoder: FDCT, quantisation and pack on `device`, the
    entropy encode on the host.

    encode_batch(frames) -> list[bytes]; frames is a (B, 3, H, W) u8
    tensor (RGB) on `device` or a list of (3, H, W) ones, encoded in
    batches of the fixed `batch`, the tail padded by repeating its last
    frame. Every batch leaves the device as one v3 buffer: the JAX
    encoder's `compact=False` path, a v2 buffer a frame, writes the same
    JPEG bytes wherever no pool overflows, so the port keeps v3 alone
    (`pack_wire` stays for v2 readers). The v3 pool of ACs
    is sized by `density` (nonzero ACs a coefficient) and grows after a
    batch that overflowed it. Such a batch is written with its ACs cut at
    the pool, a loss of quality that `overflows` counts as the JAX
    encoder does: a frame for each frame of `encode_batch`, one for each
    `collect_batch`."""

    def __init__(self, width: int, height: int, quality: int = 85,
                 batch: int = 1, sampling: tuple[int, int] = (2, 2),
                 density: float = 0.18, *, device="cuda"):
        self.device = resolve_device(device, "JpegDeviceEncoder")
        self.meta = encode_meta(width, height, sampling)
        self.quality = int(quality)
        self.qtabs = quality_qtabs(quality)
        self.batch = int(batch)
        self.density = float(density)
        self.capacity = capacity_for(self.meta, self.density)
        self.overflows = 0
        self._grow = None
        self._build()

    def _build(self):
        """The coefficient stage and the v3 wire at the current capacity."""
        NB = self.meta.n_blocks
        self.coefs = _coef_stage(self.meta, self.quality, self.device)
        self.clayout = CompactLayout(self.batch, NB, self.capacity,
                                     esc_cap_for(NB))
        self.cfn = lambda frames: pack_compact(*self.coefs(frames),
                                               self.clayout)

    def _padded(self, frames) -> torch.Tensor:
        if isinstance(frames, (list, tuple)):
            frames = torch.stack(list(frames))
        nc = int(frames.shape[0])
        if nc > self.batch:
            raise ValueError("at most `batch` frames a dispatch")
        if nc < self.batch:
            frames = torch.cat([frames, frames[-1:].expand(
                (self.batch - nc,) + tuple(frames.shape[1:]))])
        return frames

    def _fetch(self, buf: torch.Tensor) -> np.ndarray:
        """The used prefix of a v3 buffer on the host: its 8·B-byte header
        first, then the rest of the prefix in one copy into pinned
        memory."""
        global FETCH_BYTES
        with span("lives.encode.fetch"):
            lay = self.clayout
            head = buf[:8 * lay.B].cpu().numpy()
            used = lay.used(int(head[:4 * lay.B].view(np.int32).sum()),
                            int(head[4 * lay.B:].view(np.int32).sum()))
            FETCH_BYTES += used
            if buf.device.type != "cuda":
                return buf[:used].numpy()
            host = torch.empty(used, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf[:used], non_blocking=True)
            torch.cuda.current_stream(buf.device).synchronize()
            return host.numpy()

    def dispatch_batch(self, frames):
        """Enqueue the device half only: returns the device v3 buffer.
        Pair with collect_batch: a producer can dispatch batch k+1 before
        collecting k."""
        with span("lives.encode.coef"):
            if self._grow is not None:
                self.density = self._grow
                self.capacity = capacity_for(self.meta, self.density)
                self._grow = None
                self._build()
            return self.cfn(self._padded(frames))

    def _overflowed(self, raw: np.ndarray) -> bool:
        """Whether the batch's true claims (the header) passed the pools;
        if so, the next batch's pool grows."""
        B = self.clayout.B
        claimed_ac = int(raw[:4 * B].view(np.int32).sum())
        claimed_esc = int(raw[4 * B: 8 * B].view(np.int32).sum())
        if claimed_ac <= self.clayout.ac_pool \
                and claimed_esc <= self.clayout.esc_pool:
            return False
        if self.density < 1.0:
            need = claimed_ac / max(1, self.batch * self.meta.n_blocks * 63)
            self._grow = min(1.0, max(self.density * 1.6, need * 1.3))
        return True

    def _write(self, packed, cut: int = 0) -> list[bytes]:
        """The batch's JPEGs from its packed frames, `cut` of them written
        with their ACs cut at the pool."""
        global ENCODED_FRAMES, CUT_FRAMES
        self.overflows += cut
        CUT_FRAMES += cut
        with span("lives.encode.huffman"):
            out = [write_jpeg_packed(self.meta, self.qtabs, dc, counts, pos,
                                     vals, ei, ev, n_esc)
                   for (n_ac, n_esc, dc, counts, pos, vals, ei, ev)
                   in packed]
        ENCODED_FRAMES += len(out)
        return out

    def collect_batch(self, handle, n: int) -> list[bytes]:
        """Fetch + entropy-encode a dispatch_batch result (first `n`
        frames)."""
        raw = self._fetch(handle)
        packed = unpack_compact(raw, self.clayout)[:n]
        return self._write(packed, int(self._overflowed(raw)))

    def encode_batch(self, frames) -> list[bytes]:
        if isinstance(frames, (list, tuple)):
            frames = torch.stack(list(frames))
        B = int(frames.shape[0])
        if B != self.batch:
            # the fixed batch: oversize inputs in chunks, the tail padded
            outs = []
            for ofs in range(0, B, self.batch):
                chunk = frames[ofs: ofs + self.batch]
                nc = int(chunk.shape[0])
                outs.extend(self.encode_batch(self._padded(chunk))[:nc])
            return outs
        raw = self._fetch(self.dispatch_batch(frames))
        packed = unpack_compact(raw, self.clayout)
        if self._overflowed(raw):
            # emitted best-effort (ACs truncated at the pool — a
            # high-frequency quality loss, never corruption); the pool
            # grows for the next batch
            esc_cap = self.clayout.esc_cap
            packed = [p[:1] + (min(p[1], esc_cap),) + p[2:] for p in packed]
            return self._write(packed, B)
        return self._write(packed)


# ---------------------------------------------------------------------------
# float64 twin (parity contract partner, mirrors decode_frame_ref)
# ---------------------------------------------------------------------------

def encode_frame_ref(rgb: np.ndarray, quality: int = 85,
                     sampling: tuple[int, int] = (2, 2)):
    """Numpy float64 reference of the device maths: returns the quantised
    coefficient blocks per component ((nb, 64) int32 each, natural
    order). The device encoder must match within +-1 on a tiny fraction
    of coefficients (a rounding tie at .5)."""
    H, W = rgb.shape[1], rgb.shape[2]
    meta = encode_meta(W, H, sampling)
    r, g, b = (rgb[i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    hs, vs = sampling
    if (hs, vs) == (2, 2):
        ph, pw = H % 2, W % 2
        if ph or pw:
            cb = np.pad(cb, ((0, ph), (0, pw)), mode="edge")
            cr = np.pad(cr, ((0, ph), (0, pw)), mode="edge")
        cb = cb.reshape(cb.shape[0] // 2, 2, cb.shape[1] // 2, 2) \
            .mean(axis=(1, 3))
        cr = cr.reshape(cr.shape[0] // 2, 2, cr.shape[1] // 2, 2) \
            .mean(axis=(1, 3))
    qt = quality_qtabs(quality).astype(np.float64)
    A = _idct_basis(np.float64)
    blocks = []
    for (hb, wb, qno, dw, dh), p in zip(meta.comp_dims, [y, cb, cr]):
        pp = np.pad(p, ((0, hb * 8 - dh), (0, wb * 8 - dw)), mode="edge")
        P = pp.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3) \
            .reshape(-1, 8, 8) - 128.0
        F = np.einsum("xu,nxy,yv->nuv", A, P, A)
        blocks.append(np.rint(F / qt[qno].reshape(8, 8))
                      .astype(np.int32).reshape(-1, 64))
    return meta, blocks


def shard_encode_batch(mesh, enc: JpegDeviceEncoder, frames,
                       axis: str | None = None) -> list[bytes]:
    """Encode a (B, 3, H, W) u8 RGB batch with its frames split over
    `mesh`'s `axis` (`jpeg_encode.py:845-861`): data-parallel export,
    each device of the axis transforming, quantising and packing its
    shard, and each shard's wire bytes fetched from its own device. B must
    divide by the axis length. Each shard runs an encoder like `enc` (its
    geometry, quality, sampling and pool density) of the shard's batch on
    its device, built once and kept on `enc`. All shards are dispatched
    before the first is collected. Returns the B JPEGs, equal to
    `enc.encode_batch(frames)`'s wherever no pool overflows."""
    if axis is None:
        axis = mesh.axis_names[0]
    devs = mesh.axis_devices(axis)
    if isinstance(frames, (list, tuple)):
        frames = torch.stack(list(frames))
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    B = int(frames.shape[0])
    if B % len(devs):
        raise ValueError(f"a batch of {B} does not split over the "
                         f"{len(devs)} devices of axis {axis!r}")
    Bs = B // len(devs)
    shards = enc.__dict__.setdefault("shards", {})
    handles = []
    for k, d in enumerate(devs):
        e = shards.get((str(d), Bs))
        if e is None:
            e = shards[(str(d), Bs)] = JpegDeviceEncoder(
                enc.meta.width, enc.meta.height, enc.quality, batch=Bs,
                sampling=enc.meta.sampling, density=enc.density, device=d)
        part = frames[k * Bs:(k + 1) * Bs].to(
            d, non_blocking=d.type == "cuda")
        handles.append((e, e.dispatch_batch(part)))
    return [data for e, h in handles for data in e.collect_batch(h, Bs)]
