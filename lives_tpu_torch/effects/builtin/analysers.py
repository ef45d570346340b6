"""Analyser filters: the video passes through, out-params carry
measurements.

Counterpart of `lives_tpu/effects/builtin/analysers.py:19-433`, its nine
filters: blank_frame_detector (`:30-43`), alpha_means (`:46-73`),
histogram (`:76-89`), edge_analyser (`:92-104`), motion_analyser
(`:145-199`), scene_change (`:204-235`), spot_tracker (`:238-259`),
template_tracker (`:266-340`) and haar_analyser (`:347-410`), and its
host helpers `audio_fft`, `BeatDetector`, `haar_matrix` and
`haar_signature_distance`, which compute with numpy there and here.

A stateless analyser takes a batch and reports each out-value as a (B,)
tensor (haar's signatures (B, 128)); the three stateful ones take one
frame and report 0-d tensors, their states in the JAX package's contract.
Every value stays on the frame's device.

The hard selects read the values the jitted JAX filter computes: the
luma as XLA contracts it (`extra.luma_fma`), the 8x8 block means in
XLA's lane order (`extra.block_means`), ties resolved to the lower index
(`jnp.argmax`, `lax.top_k`: a stable descending sort here, never
`torch.topk`). The template tracker's correlation (float64 FFTs) and box sums
(a float64 summed-area table) and haar's resize run in float64, rounded
once to float32, and haar's two 128x128 products as
XLA's CPU dot accumulates (`xla_dot`, one FMA a step in k order), so no
TF32 setting reaches them and the card, the CPU and the JAX package
agree.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...constants import Palette, YUVClamping, YUVSubspace
from ...ops.colorspace import rgb2yuv_constants
from ...ops.resize import interp_matrix
from ...utils.xla_exp import fma32
from ..host import (FILTER_STATEFUL, ChannelTemplate, Filter, Param,
                    register_filter)
from ..util import per_frame, split_alpha, to_f01
from .alpha import alpha_f01, frame_luma, one_frame, scalar
from .extra import _src255, block_means
from .geometry import _gradients

_RGBX = (Palette.RGB24, Palette.RGBA32)
_ONE_IN = (ChannelTemplate("in", _RGBX),)


def _passthrough(ins, p, ctx):
    return ins[0]


def _mk_analyser(name, analyse, params=(), out_params=(), desc=""):
    return register_filter(Filter(
        name=name, process=_passthrough, in_channels=_ONE_IN,
        params=tuple(params), out_params=tuple(out_params),
        analyse=analyse, description=desc))


def _recip(n: int) -> float:
    """1 / n rounded to float32: XLA turns a division by a constant into
    a product with its reciprocal."""
    return float(np.float32(1.0 / n))


def _frame_mean(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> each frame's mean, (B,)."""
    return x.reshape(x.shape[0], -1).mean(1)


def _blank_analyse(ins, p, ctx):
    m = _frame_mean(frame_luma(ins[0]))
    thr = per_frame(p["threshold"], m.device)
    return {"blank": (m < thr).to(torch.float32), "mean_luma": m}


_mk_analyser("blank_frame_detector", _blank_analyse,
             params=(Param("threshold", "num", 0.05, 0.0, 1.0),),
             out_params=(Param("blank", "num", 0.0, 0.0, 1.0),
                         Param("mean_luma", "num", 0.0, 0.0, 1.0)),
             desc="flags near-black frames (blank_frame_detector.c)")


def _means_analyse(ins, p, ctx):
    rgb, al = split_alpha(to_f01(ins[0]))
    out = {f"mean_{c}": _frame_mean(rgb[:, i]) for i, c in enumerate("rgb")}
    # a connected alpha channel (cconx; alpha_means.c reads a separated
    # ALPHA in-channel) wins over the layer's own alpha
    a_conn = ins[1] if len(ins) > 1 else None
    if a_conn is not None:
        out["mean_a"] = _frame_mean(alpha_f01(a_conn))
    elif al is not None:
        out["mean_a"] = _frame_mean(al)
    else:
        out["mean_a"] = torch.ones(rgb.shape[0], device=rgb.device)
    return out


register_filter(Filter(
    name="alpha_means", process=_passthrough, in_channels=_ONE_IN,
    alpha_ins=(ChannelTemplate(
        "alpha", (Palette.A8, Palette.AFLOAT, Palette.A1),
        optional=True),),
    out_params=tuple(Param(f"mean_{c}", "num", 0.0, 0.0, 1.0)
                     for c in "rgba"),
    analyse=_means_analyse,
    description="per-channel means; mean_a reads a connected alpha "
                "channel when wired (alpha_means.c)"))


def luma_histogram(g: torch.Tensor) -> torch.Tensor:
    """`jnp.histogram(g, bins=16, range=(0, 1))`'s counts of each frame
    of g (B, ...), as float32 (B, 16): edges k/16, a value v in [0, 1)
    counts in bin floor(16 v), 1.0 in the last, a value outside [0, 1]
    in none."""
    B = g.shape[0]
    g = g.reshape(B, -1)
    idx = torch.where(g == 1.0, 15, torch.floor(g * 16.0).to(torch.int64))
    ok = (g >= 0.0) & (g <= 1.0)
    idx = torch.where(ok, idx, 16) + 17 * torch.arange(
        B, device=g.device)[:, None]
    counts = torch.bincount(idx.reshape(-1), minlength=17 * B)
    return counts.reshape(B, 17)[:, :16].to(torch.float32)


def _histogram_analyse(ins, p, ctx):
    g = frame_luma(ins[0])
    n = g[0].numel()
    flat = g.reshape(g.shape[0], -1)
    mean = flat.mean(1)
    return {"histogram": luma_histogram(g) * _recip(n),
            "contrast": torch.sqrt(((flat - mean[:, None]) ** 2).mean(1)),
            "brightness": mean}


_mk_analyser("histogram", _histogram_analyse,
             out_params=(Param("contrast", "num", 0.0, 0.0, 1.0),
                         Param("brightness", "num", 0.0, 0.0, 1.0)),
             desc="luma histogram + contrast/brightness stats")


def _edge_analyse(ins, p, ctx):
    g = frame_luma(ins[0])
    gx = _frame_mean(torch.abs(g - torch.roll(g, 1, 2)))
    gy = _frame_mean(torch.abs(g - torch.roll(g, 1, 1)))
    return {"edge_energy": gx + gy}


_mk_analyser("edge_analyser", _edge_analyse,
             out_params=(Param("edge_energy", "num", 0.0, 0.0, 1.0),),
             desc="global edge energy")


# ---------------------------------------------------------------------------
# Audio analysers (host helpers, numpy as in the JAX package:
# `analysers.py:111-140`; reference audio_fft.c/beat_detector.c)
# ---------------------------------------------------------------------------

def audio_fft(samples: np.ndarray, rate: int, bands: int = 16) -> np.ndarray:
    """Log-band magnitude spectrum of a mono float block (audio_fft.c)."""
    mono = samples.mean(1) if samples.ndim == 2 else samples
    spec = np.abs(np.fft.rfft(mono * np.hanning(len(mono))))
    edges = np.logspace(np.log10(20), np.log10(rate / 2), bands + 1)
    freqs = np.fft.rfftfreq(len(mono), 1.0 / rate)
    out = np.zeros(bands, np.float32)
    for b in range(bands):
        m = (freqs >= edges[b]) & (freqs < edges[b + 1])
        out[b] = spec[m].mean() if m.any() else 0.0
    return out


class BeatDetector:
    """Energy-flux beat detector over streamed blocks (beat_detector.c)."""

    def __init__(self, rate: int = 44100, history: int = 43):
        self.rate = rate
        self.energies: list[float] = []
        self.history = history

    def feed(self, block: np.ndarray) -> bool:
        mono = block.mean(1) if block.ndim == 2 else block
        e = float(np.mean(mono * mono))
        hist = self.energies[-self.history:]
        is_beat = bool(hist) and e > 1.4 * (sum(hist) / len(hist)) \
            and e > 1e-5
        self.energies.append(e)
        if len(self.energies) > 4 * self.history:
            self.energies = self.energies[-2 * self.history:]
        return is_beat


# -- optical-flow motion analyser (farneback_analyser.cpp role) ---------------

def _motion_init(w, h, pal, device):
    return torch.zeros((max(h // 8, 1), max(w // 8, 1)), dtype=torch.float32,
                       device=device)


def _downluma(lay):
    """8x-downsampled luma, (hh, ww): each 8x8 block's mean."""
    g = frame_luma(lay)
    h, w = g.shape[-2:]
    hh, ww = max(h // 8, 1), max(w // 8, 1)
    return block_means(g[:, None, :hh * 8, :ww * 8], 8)[0, 0]


def _box_edge(a):
    """3x3 box over an edge-padded plane (`analysers.py:171-174`)."""
    h, w = a.shape
    ap = F.pad(a[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    acc = None
    for r in range(3):
        for c in range(3):
            v = ap[r:r + h, c:c + w]
            acc = v if acc is None else acc + v
    return acc / 9.0


def _motion_process(ins, p, ctx, state):
    """Coarse Lucas-Kanade optical flow on 8x-downsampled luma: the 2x2
    normal equations per block in closed form, confidence-weighted means
    of the flow and its magnitude as out-params."""
    lay = ins[0]
    one_frame("motion_analyser", lay)
    g = _downluma(lay)
    prev = state
    it = g - prev
    iy, ix = (d[0, 0] for d in _gradients(prev[None, None]))
    ixx, iyy, ixy = _box_edge(ix * ix), _box_edge(iy * iy), \
        _box_edge(ix * iy)
    ixt, iyt = _box_edge(ix * it), _box_edge(iy * it)
    det = ixx * iyy - ixy * ixy + 1e-6
    u = (-iyy * ixt + ixy * iyt) / det
    v = (ixy * ixt - ixx * iyt) / det
    wgt = torch.clamp((ixx + iyy) * 16.0, 0.0, 1.0)
    u = torch.clamp(u, -8.0, 8.0) * wgt
    v = torch.clamp(v, -8.0, 8.0) * wgt
    wsum = wgt.sum() + 1e-6
    mag = torch.sqrt(u * u + v * v).sum() / wsum
    return lay, g, {"flow_x": u.sum() / wsum, "flow_y": v.sum() / wsum,
                    "motion": torch.clamp(mag / 4.0, 0.0, 1.0)}


register_filter(Filter(
    name="motion_analyser", process=_motion_process, in_channels=_ONE_IN,
    flags=FILTER_STATEFUL, init_state=_motion_init,
    out_params=(Param("flow_x", "num", 0.0, -8.0, 8.0),
                Param("flow_y", "num", 0.0, -8.0, 8.0),
                Param("motion", "num", 0.0, 0.0, 1.0)),
    description="coarse optical-flow motion analyser "
                "(farneback_analyser.cpp role)"))


# -- scene-change detector (stateful analyser) --------------------------------

def _scene_process(ins, p, ctx, state):
    """Scene-cut detector: the luma histogram's total-variation distance
    to the previous frame's; `cut` fires above the threshold."""
    lay = ins[0]
    one_frame("scene_change", lay)
    g = frame_luma(lay)
    hist = luma_histogram(g)[0] * _recip(max(g[0].numel(), 1))
    dist = torch.abs(hist - state).sum() * 0.5
    return lay, hist, {
        "difference": dist,
        "cut": (dist > scalar(p["threshold"], g.device)).to(torch.float32)}


register_filter(Filter(
    name="scene_change", process=_scene_process, in_channels=_ONE_IN,
    flags=FILTER_STATEFUL,
    init_state=lambda w, h, pal, device: torch.zeros(
        16, dtype=torch.float32, device=device),
    params=(Param("threshold", "num", 0.35, 0.0, 1.0),),
    out_params=(Param("difference", "num", 0.0, 0.0, 1.0),
                Param("cut", "num", 0.0, 0.0, 1.0)),
    description="luma-histogram scene-cut detector"))


def _spot_analyse(ins, p, ctx):
    """Brightest-region tracker: the centre of the brightest 8x8 luma
    block, normalised to 0..1, and its mean."""
    g = frame_luma(ins[0])
    B, h, w = g.shape
    hh, ww = max(h // 8, 1), max(w // 8, 1)
    blocks = block_means(g[:, None, :hh * 8, :ww * 8], 8).reshape(B, -1)
    idx = torch.argmax(blocks, 1)   # the first maximum, as jnp.argmax
    by, bx = idx // ww, idx % ww
    return {"x": (bx.to(torch.float32) + 0.5) * _recip(ww),
            "y": (by.to(torch.float32) + 0.5) * _recip(hh),
            "intensity": blocks.gather(1, idx[:, None])[:, 0]}


_mk_analyser("spot_tracker", _spot_analyse,
             out_params=(Param("x", "num", 0.5, 0.0, 1.0),
                         Param("y", "num", 0.5, 0.0, 1.0),
                         Param("intensity", "num", 0.0, 0.0, 1.0)),
             desc="brightest-region tracker (template-analyser family)")


# -- template tracker (haar_analyser.cpp role) --------------------------------

_TT_SIZE = 32  # template patch side (static)


def _tt_init(w, h, palette, device):
    return {"tmpl": torch.zeros((3, _TT_SIZE, _TT_SIZE), dtype=torch.float32,
                                device=device),
            "have": torch.zeros((), dtype=torch.float32, device=device),
            "x": torch.full((), 0.5, dtype=torch.float32, device=device),
            "y": torch.full((), 0.5, dtype=torch.float32, device=device)}


def _correlate(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The valid cross-correlation of (C, H, W) with (C, t, t), summed
    over the channels, through float64 FFTs: (H - t + 1, W - t + 1)."""
    h, w = img.shape[-2:]
    t = k.shape[-1]
    spec = (torch.fft.rfft2(img) * torch.fft.rfft2(k, s=(h, w)).conj()) \
        .sum(0)
    return torch.fft.irfft2(spec, s=(h, w))[:h - t + 1, :w - t + 1]


def _box_sums(a: torch.Tensor, t: int) -> torch.Tensor:
    """Each t x t window's sum of (H, W) float64, valid windows, from its
    summed-area table."""
    s = F.pad(a.cumsum(0).cumsum(1), (1, 0, 1, 0))
    return s[t:, t:] - s[:-t, t:] - s[t:, :-t] + s[:-t, :-t]


def _tt_process(ins, p, ctx, state):
    """Template tracker: zero-mean cross-correlation of a grabbed 32x32
    patch against the frame. `grab` > 0.5 (or no patch yet) captures the
    patch at the (x, y) params; out-params x, y and score follow the best
    match each frame."""
    lay = ins[0]
    one_frame("template_tracker", lay)
    rgb = split_alpha(to_f01(lay))[0][0]
    dev = rgb.device
    h, w = rgb.shape[-2:]
    t = _TT_SIZE
    want = (scalar(p["grab"], dev) > 0.5) | (state["have"] < 0.5)
    gx = torch.where(want, scalar(p["x"], dev), state["x"])
    gy = torch.where(want, scalar(p["y"], dev), state["y"])
    # clip(g * size - t / 2, 0, size - t) as int32, the product-add one FMA
    cy = torch.clamp(fma32(gy, float(h), -t / 2), 0, h - t).to(torch.int64)
    cx = torch.clamp(fma32(gx, float(w), -t / 2), 0, w - t).to(torch.int64)
    ar = torch.arange(t, device=dev)
    patch = rgb[:, cy + ar][:, :, cx + ar]
    tmpl = torch.where(want, patch, state["tmpl"])
    tz = tmpl - tmpl.mean()
    img = rgb.to(torch.float64)
    num = _correlate(img, tz.to(torch.float64))
    s1 = _box_sums(img.sum(0), t)
    s2 = _box_sums((img * img).sum(0), t)
    n = 3.0 * t * t
    var = torch.clamp(s2 - s1 * s1 / n, min=1e-6)
    energy = torch.clamp((tz * tz).sum(), min=1e-6).to(torch.float64)
    score_map = (num / torch.sqrt(var * energy)).to(torch.float32)
    gw = score_map.shape[1]
    idx = torch.argmax(score_map.reshape(-1))
    by, bx = idx // gw, idx % gw
    score = score_map.reshape(-1)[idx]
    nx = (bx.to(torch.float32) + t / 2) * _recip(w)
    ny = (by.to(torch.float32) + t / 2) * _recip(h)
    new_state = {"tmpl": tmpl,
                 "have": torch.ones((), dtype=torch.float32, device=dev),
                 "x": torch.where(want, gx, nx),
                 "y": torch.where(want, gy, ny)}
    return lay, new_state, {"x": new_state["x"], "y": new_state["y"],
                            "score": torch.clamp(score, -1.0, 1.0)}


register_filter(Filter(
    name="template_tracker", process=_tt_process, in_channels=_ONE_IN,
    flags=FILTER_STATEFUL, init_state=_tt_init,
    params=(Param("grab", "num", 0.0, 0.0, 1.0),
            Param("x", "num", 0.5, 0.0, 1.0),
            Param("y", "num", 0.5, 0.0, 1.0)),
    out_params=(Param("x", "num", 0.5, 0.0, 1.0),
                Param("y", "num", 0.5, 0.0, 1.0),
                Param("score", "num", 0.0, -1.0, 1.0)),
    description="ZNCC patch tracker, one MXU conv (haar_analyser role)"))


# -- Haar wavelet image signature (gdk/haar_analyser.cpp) ---------------------

#: signature geometry, matching the reference (haar_analyser.h:30-34)
HAAR_N = 128
HAAR_COEFS = 40
_haar_m_cache: list = []


def haar_matrix() -> np.ndarray:
    """The reference's multi-level in-place Haar row decomposition
    (gdk/haar_analyser.cpp:99 `haar2D`: sums unscaled, differences scaled
    by the accumulated 0.7071 a level, the row DC by the final factor) as
    a dense (N, N) float64 operator, the identity pushed through the
    recurrence (`analysers.py:347-372`). The 2-D transform is
    `M @ A @ M.T`."""
    if _haar_m_cache:
        return _haar_m_cache[0]
    a = np.eye(HAAR_N, dtype=np.float64)  # row i = response to e_i
    c, h = 1.0, HAAR_N
    while h > 1:
        h1 = h // 2
        c *= 0.7071  # the reference's literal, not 1/sqrt(2)
        s = a[0:h:2] + a[1:h:2]
        d = (a[0:h:2] - a[1:h:2]) * c
        a[:h1], a[h1:h] = s, d
        h = h1
    a[0] *= c
    _haar_m_cache.append(a)
    return a


@functools.lru_cache(maxsize=16)
def _on_device(n: int, kind: str, device: str) -> torch.Tensor:
    """haar's float32 operators on `device`, uploaded once: the bilinear
    resize from n to 128, or (kind "haar") `haar_matrix()`."""
    m = haar_matrix().astype(np.float32) if kind == "haar" else \
        interp_matrix(n, HAAR_N, kind)
    return torch.from_numpy(m).to(device)


def _f64_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of float32 operands in float64, rounded once to float32."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.float32)


def xla_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of float32 (..., n, K) and (..., K, m) as XLA's CPU dot
    computes it: the products accumulated in k order from 0, each step one
    FMA (held bit for bit against `jnp.dot` by
    tests/test_torch_analysers.py)."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1] + (1,),
                                             b.shape[:-2] + (1, 1))[:-1]
                      + b.shape[-1:], dtype=torch.float32, device=b.device)
    for k in range(a.shape[-1]):
        acc = fma32(a[..., k:k + 1], b[..., k:k + 1, :], acc)
    return acc


def _yuv_unclamped(r, g, b):
    """`rgb_to_yuv(r, g, b, clamping=UNCLAMPED)` of 0-255 float planes as
    the jitted plan computes it: each row's three products summed as
    fma(m2, b, fma(m0, r, m1 * g)), the chroma bias added, floored and
    clipped to u8."""
    m = rgb2yuv_constants(YUVSubspace.YCBCR, YUVClamping.UNCLAMPED)[0]
    out = []
    for i, bias in enumerate((0.0, 128.0, 128.0)):
        v = fma32(b, float(m[i, 2]), fma32(r, float(m[i, 0]),
                                           g * float(m[i, 1]))) + bias
        out.append(torch.clamp(torch.floor(v), 0, 255).to(torch.uint8))
    return out


def _haar_analyse(ins, p, ctx):
    """The frame's Haar signature (gdk/haar_analyser.cpp:436): resized to
    128x128, unclamped YUV planes in 0..255, the 2-D Haar transform of
    each, and per plane the indices of the `nco` largest |coefficients|
    but the DC, negated where the coefficient is not positive, in
    descending order, the rest of the 128 slots 0; `avg_*` is
    DC / (2 N^2) / 255 (`analysers.py:375-410`)."""
    rgb = _src255(ins[0])[0]   # XLA folds to_f01's 1/255 times 255
    B, _, h, w = rgb.shape
    dev = rgb.device
    # the bilinear resize as two products, each in float64
    ah = _on_device(h, "bilinear", str(dev))
    aw = _on_device(w, "bilinear", str(dev))
    small = _f64_matmul(_f64_matmul(ah, rgb), aw.T)
    y, u, v = _yuv_unclamped(small[:, 0], small[:, 1], small[:, 2])
    m = _on_device(0, "haar", str(dev))
    nco = p["nco"]
    nco = nco.to(torch.int64).clamp(1, HAAR_N).reshape(-1, 1) \
        if isinstance(nco, torch.Tensor) else min(max(int(nco), 1), HAAR_N)
    valid = torch.arange(HAAR_N, device=dev)[None] < nco
    outs = {}
    planes = torch.stack([y, u, v], 1).to(torch.float32)
    all_coefs = xla_dot(xla_dot(m, planes), m.T.contiguous())
    for c, name in enumerate("yuv"):
        coefs = all_coefs[:, c].reshape(B, -1)
        outs[f"avg_{name}"] = coefs[:, 0] / (2.0 * HAAR_N * HAAR_N) / 255.0
        mag = torch.abs(coefs)
        mag[:, 0] = -1.0  # the DC is never in the signature
        idx = torch.sort(mag, stable=True, dim=1,
                         descending=True)[1][:, :HAAR_N]
        signed = torch.where(coefs.gather(1, idx) > 0, idx, -idx)
        outs[f"sig_{name}"] = torch.where(valid, signed, 0).to(torch.int32)
    return outs


_mk_analyser(
    "haar_analyser", _haar_analyse,
    params=(Param("nco", "int", HAAR_COEFS, 1, HAAR_N,
                  label="Number of Coefficients"),),
    out_params=(Param("sig_y", "int", 0, -HAAR_N * HAAR_N, HAAR_N * HAAR_N),
                Param("sig_u", "int", 0, -HAAR_N * HAAR_N, HAAR_N * HAAR_N),
                Param("sig_v", "int", 0, -HAAR_N * HAAR_N, HAAR_N * HAAR_N),
                Param("avg_y", "num", 0.0, 0.0, 1.0),
                Param("avg_u", "num", 0.0, 0.0, 1.0),
                Param("avg_v", "num", 0.0, 0.0, 1.0)),
    desc="imgSeek-style Haar wavelet signature: top-nco coefficient "
         "indices + DC averages per YUV plane as two MXU matmuls "
         "(gdk/haar_analyser.cpp)")


def haar_signature_distance(sig_a: dict, sig_b: dict,
                            w_avg: float = 1.0) -> float:
    """Host-side distance between two `haar_analyser` out-dicts of one
    frame each (the imgSeek query metric): matching signed indices reduce
    it, DC deltas add to it. Smaller is more similar."""
    def host(v):
        return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v).reshape(-1)
    d = 0.0
    for c in "yuv":
        a = {int(i) for i in host(sig_a[f"sig_{c}"]) if int(i) != 0}
        b = {int(i) for i in host(sig_b[f"sig_{c}"]) if int(i) != 0}
        n = max(len(a), 1)
        d += 1.0 - len(a & b) / n
        d += w_avg * abs(float(host(sig_a[f"avg_{c}"])[0])
                         - float(host(sig_b[f"avg_{c}"])[0]))
    return d
