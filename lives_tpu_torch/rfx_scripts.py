"""The RFX script library: the reference's rendered-effect scripts
(`lives-plugins/plugins/effects/RFXscripts/*.script`, e.g.
blur.script:24-40) on an explicit device.

Counterpart of `lives_tpu/rfx_scripts.py:1-836`: the same registry of
scripts, each a declarative entry mapping the script's RFX params onto a
builtin filter and a value transform, run by `rfx.apply_rendered_effect`
on `device`, or a runner for the scripts that are not one filter
(two-source transitions, frame-order and frame-range edits, the freeze,
the overlay, resize, text) and the clip generators (`gen_*`). Every pixel
operation runs as PyTorch on the chosen device; PIL's image coding (and
its resize of an overlay image, whose bytes the JAX package takes from
PIL too) stays on the host.

The batched transitions compute what the JAX package's JITTED step
computes (read from its XLA plan on the CPU): a division by 255 is a
product with the float32 reciprocal, `fade` is `fma(a, (1 - t) / 255,
b * (t / 255))`, bwthresh's grey is `fma(b2, 0.114, fma(b0, 0.299, b1 *
0.587))` over the scaled channels before its hard select, and `(out *
255 + 0.5).astype(uint8)` is one FMA before the truncation; skip_forwards'
mix is `fma(a, 1 - pc, b * pc)`. The FMAs go through `utils.xla_exp.fma32`
(the same bits on the CPU and the card). Host-numpy arithmetic of the
JAX runners (the overlay, the freeze's desaturation, gen_text) is the
same eager operations here, with true divisions (`_div`), since PyTorch
turns a CUDA tensor's division by a Python number into a product with its
reciprocal.

Param definitions come from the reference script files when
`LIVES_TPU_RFX_SCRIPTS` names their directory (`rfx.parse_rfx_params` on
the <params> DSL), so generated UIs match the originals; else from the
registry's defaults.

    apply_script(clip, "blur", radius=5, device="cuda")
    apply_script(clip, "fade_in_out", direction=0)   # per-frame ramp
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .constants import Palette
from .io.clips import (BATCH, Clip, _pool_map, create_clip,
                       read_rgb_batch, rgb_layer)
from .rfx import apply_rendered_effect, parse_rfx_params
from .utils.device import resolve_device
from .utils.xla_exp import fma32

_REF_ENV = "LIVES_TPU_RFX_SCRIPTS"


def _ref_scripts() -> Optional[Path]:
    d = os.environ.get(_REF_ENV)
    return Path(d) if d else None


@dataclass(frozen=True)
class ScriptDef:
    """One RFX script: our filter + param mapping.

    `mapping(params, n_frames) -> (filter_values dict)`; entries may be
    callables f(frame)->value for per-frame animation."""
    name: str
    filter: str
    mapping: Callable[[dict, int], dict]
    defaults: dict = field(default_factory=dict)
    # host-op scripts (frame-index edits, two-source transitions, clip
    # generators) execute via a runner instead of the filter engine:
    # runner(clip, start, end, progress, device=, **params) -> frames
    runner: Optional[Callable] = None

    def params_spec(self) -> list[dict]:
        """Param defs from the actual reference script when present.
        Runner-backed scripts advertise their own defaults."""
        user = getattr(self, "user_spec", None)
        if user is not None:   # user-authored (rfx_builder) scripts
            return list(user)
        if self.runner is not None:
            def kind_of(v):
                if isinstance(v, bool):
                    return "bool"
                if isinstance(v, str):
                    return "string"
                if isinstance(v, int):
                    return "int"
                return "num"
            return [{"name": k, "kind": kind_of(v), "default": v}
                    for k, v in self.defaults.items()]
        ref = _ref_scripts()
        p = ref / f"{self.name}.script" if ref else None
        if p is not None and p.is_file():
            try:
                spec = parse_rfx_params(p.read_text(errors="replace"))
                if spec:
                    return spec
            except Exception:
                pass
        return [{"name": k, "kind": "num", "default": v}
                for k, v in self.defaults.items()]


def script_specials(name: str) -> list[dict]:
    """Special-widget hints for a script's param window (reference
    paramspecial.c), parsed from the reference .script when one exists.
    Indices arrive resolved to param names."""
    from .rfx import parse_rfx_specials
    ref = _ref_scripts()
    p = ref / f"{name}.script" if ref else None
    if p is None or not p.is_file():
        return []
    try:
        text = p.read_text(errors="replace")
        return parse_rfx_specials(text, parse_rfx_params(text))
    except Exception:
        return []


def parse_param_value(v):
    """Parse a CLI/OSC string param: int-looking stays int, float-looking
    becomes float, everything else stays a string."""
    if not isinstance(v, str):
        return v
    try:
        if v.lstrip("-").isdigit():
            return int(v)
        if "." in v:
            return float(v)
    except ValueError:
        pass
    return v


_SCRIPTS: dict[str, ScriptDef] = {}


def _script(name, filter_name, defaults=None, mapping=None):
    defaults = defaults or {}

    def default_mapping(p, n):
        return {**{k: p.get(k, d) for k, d in defaults.items()}}

    _SCRIPTS[name] = ScriptDef(name, filter_name,
                               mapping or default_mapping, defaults)


# -- 1:1 filter mappings (script param -> filter param) ----------------------
_script("blur", "gaussian_blur",
        {"radius": 4, "amount": 1.0},
        lambda p, n: {"radius": int(p.get("radius", 4)),
                      "amount": p.get("amount", 1.0)})
_script("brightness_change", "brightness_contrast", {"delta": 0.2},
        lambda p, n: {"brightness": p.get("delta", 0.2)})
_script("contrast", "brightness_contrast", {"contrast": 1.5},
        lambda p, n: {"contrast": p.get("contrast", 1.5)})
_script("gamma_change", "gamma_adjust", {"gamma": 1.2},
        lambda p, n: {"gamma": p.get("gamma", 1.2)})
_script("saturation_change", "saturation", {"saturation": 1.5},
        lambda p, n: {"saturation": p.get("saturation", 1.5)})
_script("hue_change", "hue_rotate", {"angle": 0.2},
        lambda p, n: {"angle": p.get("angle", 0.2)})
_script("negate", "negate", {})
_script("sepia", "sepia", {"amount": 1.0})
_script("monochrome", "greyscale", {})
_script("posterize", "posterize", {"levels": 4},
        lambda p, n: {"levels": int(p.get("levels", 4))})
_script("solarize", "solarize", {"threshold": 0.5})
_script("colorize", "tint", {"red": 1.0, "green": 0.8, "blue": 0.5,
                             "amount": 1.0})
_script("colour_filter", "colour_balance",
        {"red": 1.0, "green": 1.0, "blue": 1.0})
_script("flip", "flip_vertical", {})
_script("flop", "flip_horizontal", {})
_script("rotate", "rotate", {"degrees": 90.0})
_script("pixilate", "pixelate", {"block": 8},
        lambda p, n: {"block": int(p.get("block", 8))})
_script("emboss", "emboss", {"strength": 0.5, "amount": 1.0})
_script("charcoal", "charcoal", {"strength": 0.5})
_script("edge_detect", "edge", {})
_script("noisify", "noise", {},
        lambda p, n: {"mono": bool(p.get("mono", False))})
_script("spread", "spread", {"amount": 0.3})
_script("wave", "wave", {"amplitude": 0.3, "wavelength": 0.25})
_script("swirl", "swirl", {"degrees": 90.0})
_script("shift_horizontal", "shift", {"dx": 0.25},
        lambda p, n: {"dx": p.get("dx", 0.25), "dy": 0.0})
_script("shift_vertical", "shift", {"dy": 0.25},
        lambda p, n: {"dx": 0.0, "dy": p.get("dy", 0.25)})
_script("despekle", "box_blur", {},
        lambda p, n: {"radius": 1, "amount": 1.0})
_script("enhance", "sharpen", {"amount": 0.8},
        lambda p, n: {"radius": 2, "amount": p.get("amount", 0.8)})
_script("normalize", "levels", {},
        lambda p, n: {"black": 0.05, "white": 0.95})
_script("dream", "dream", {})
_script("tunnel", "lens", {"amount": 0.8},
        lambda p, n: {"amount": p.get("amount", 0.8)})
_script("randomzoom", "rotozoom", {},
        lambda p, n: {"angle": 0.0, "zoom": 1.3})
_script("deinterlace", "deinterlace", {"amount": 1.0})


# -- per-frame animated scripts ----------------------------------------------

def _fade_mapping(p, n_frames):
    """fade_in_out.script: brightness ramp over the range.
    direction 0 = fade in, 1 = fade out."""
    fade_in = int(p.get("direction", 0)) == 0
    span = max(n_frames - 1, 1)

    def ramp(frame):
        t = min(max(frame / span, 0.0), 1.0)
        lvl = t if fade_in else 1.0 - t
        return lvl - 1.0  # brightness offset: -1 (black) .. 0 (unchanged)

    return {"brightness": ramp}


_SCRIPTS["fade_in_out"] = ScriptDef("fade_in_out", "brightness_contrast",
                                    _fade_mapping, {"direction": 0})


def _spin_mapping(p, n_frames):
    """spin.script: full rotations across the range."""
    turns = float(p.get("turns", 1.0))
    span = max(n_frames - 1, 1)
    return {"degrees": lambda f: 360.0 * turns * (f / span)}


_SCRIPTS["spin"] = ScriptDef("spin", "rotate", _spin_mapping, {"turns": 1.0})


def _shrink_mapping(p, n_frames):
    """shrink_expand.script: zoom ramp."""
    z0, z1 = float(p.get("start", 1.0)), float(p.get("end", 0.2))
    span = max(n_frames - 1, 1)
    return {"angle": 0.0,
            "zoom": lambda f: z0 + (z1 - z0) * (f / span)}


_SCRIPTS["shrink_expand"] = ScriptDef("shrink_expand", "rotozoom",
                                      _shrink_mapping,
                                      {"start": 1.0, "end": 0.2})


# -- API ----------------------------------------------------------------------

def list_scripts() -> list[str]:
    return sorted(_SCRIPTS)


def get_script(name: str) -> ScriptDef:
    return _SCRIPTS[name]


def apply_textover(clip: Clip, text: str, start: int = 0,
                   end: int | None = None, *, device="cuda",
                   **style) -> int:
    """textover.script: burn text onto a frame range (host PIL raster,
    composited on `device` by `text.overlay_text`, a batch at a time)."""
    from .text import overlay_text
    dev = resolve_device(device, "apply_textover")
    end_ = clip.frames if end is None else min(end, clip.frames)
    for ofs in range(start, end_, BATCH):
        hi = min(ofs + BATCH, end_)
        lay = rgb_layer(read_rgb_batch(clip, range(ofs, hi), dev))
        clip.put_frames(range(ofs, hi), overlay_text(
            lay, text, **style).planes[0].cpu().numpy())
    clip.save_header()
    return max(end_ - start, 0)


def apply_script(clip: Clip, name: str, start: int = 0,
                 end: int | None = None, batch_size: int = 32,
                 progress=None, *, device="cuda", **params) -> int:
    """Execute an RFX script on clip frames [start, end) on `device`.
    Returns frames processed."""
    sd = _SCRIPTS[name]
    dev = resolve_device(device, "apply_script")
    if sd.runner is not None:
        end_r = clip.frames if end is None else min(end, clip.frames)
        return sd.runner(clip, start, end_r, progress, device=dev,
                         **params)
    end_ = clip.frames if end is None else min(end, clip.frames)
    n = max(end_ - start, 0)
    raw = sd.mapping(params, n)
    # animated entries receive RANGE-relative frame numbers
    values = {k: ((lambda f, _fn=v: _fn(f - start)) if callable(v) else v)
              for k, v in raw.items()}
    return apply_rendered_effect(clip, sd.filter, start=start, end=end_,
                                 values=values, batch_size=batch_size,
                                 progress=progress, device=dev)


# ===========================================================================
# Library completion: the remaining reference RFXscripts. Filter-backed
# entries run through the batched engine above; frame-index edits,
# two-source transitions and clip generators run as runners
# (`ScriptDef.runner`), their pixel work on the device.
# ===========================================================================

_script("colour_replace", "colour_replace",
        {"red": 0.0, "green": 0.0, "blue": 0.0,
         "red2": 1.0, "green2": 1.0, "blue2": 1.0, "tolerance": 0.1})


def _modulate_mapping(p, n_frames):
    """modulate.script: brightness/saturation/hue ramps (the script steps
    p1/p3/p5 per frame from start to end values)."""
    span = max(n_frames - 1, 1)

    def norm(v):
        # values > 4 are ImageMagick percent scale (100 = unchanged);
        # each endpoint normalises independently
        return v / 100.0 if v > 4.0 else v

    def ramp(k0, k1):
        a = norm(float(p.get(k0, 1.0)))
        b = norm(float(p.get(k1, p.get(k0, 1.0))))
        return lambda f: a + (b - a) * (f / span)

    return {"brightness": ramp("bstart", "bend"),
            "saturation": ramp("sstart", "send"),
            "hue": ramp("hstart", "hend")}


_SCRIPTS["modulate"] = ScriptDef(
    "modulate", "modulate", _modulate_mapping,
    {"bstart": 1.0, "bend": 1.0, "sstart": 1.0, "send": 1.0,
     "hstart": 1.0, "hend": 1.0})


def _cycle_mapping(p, n_frames):
    """cycle.script: colour cycling as an accumulating hue rotation
    (`shift` degrees + `step` per frame)."""
    shift = float(p.get("shift", 0.0))
    step = float(p.get("step", 10.0))
    return {"angle": lambda f: ((shift + step * f) / 360.0) % 1.0}


_SCRIPTS["cycle"] = ScriptDef("cycle", "hue_rotate", _cycle_mapping,
                              {"shift": 0.0, "step": 10.0})


def _pan_zoom_mapping(p, n_frames):
    """pan_and_zoomy (weed-plugins/scripts): Ken Burns: animate zoom and
    target point from a start to an end view across the range."""
    span = max(n_frames - 1, 1)

    def ramp(k0, k1, d0, d1):
        a, b = float(p.get(k0, d0)), float(p.get(k1, d1))
        return lambda f: a + (b - a) * (f / span)

    return {"zoom": ramp("zstart", "zend", 1.0, 2.0),
            "x": ramp("xstart", "xend", 0.5, 0.5),
            "y": ramp("ystart", "yend", 0.5, 0.5)}


_SCRIPTS["pan_and_zoom"] = ScriptDef(
    "pan_and_zoom", "targeted_zoom", _pan_zoom_mapping,
    {"zstart": 1.0, "zend": 2.0, "xstart": 0.5, "xend": 0.5,
     "ystart": 0.5, "yend": 0.5})

_script("blank_frames", "solid_colour",
        {"red": 0.0, "green": 0.0, "blue": 0.0})


# -- device arithmetic as the JAX package computes it -------------------------

#: float32 1/255: XLA turns a division by 255 into this product
_R255 = float(np.float32(1.0 / 255.0))


def _f32(x: float) -> float:
    return float(np.float32(x))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c correctly rounded on any device (numpy's true division): a
    CUDA tensor divided by a Python number is a product with the
    reciprocal in PyTorch, so divide by a tensor of c."""
    return x / torch.full_like(x, c)


def _to_u8_fma(out: torch.Tensor) -> torch.Tensor:
    """`(out * 255.0 + 0.5).astype(uint8)` of a jitted JAX step over
    out in [0, 1]: one FMA, then the truncation."""
    return fma32(out, 255.0, 0.5).to(torch.uint8)


# -- two-source transitions ---------------------------------------------------

def _pull_rgb(src, ns, width: int, height: int, device) -> torch.Tensor:
    """Frames `ns` (modulo length) of a Clip, a Clipboard or a list of
    Layers, as (B, 3, H, W) uint8 on `device` at (width, height)."""
    from .ops.colorspace import convert_layer
    from .ops.resize import resize_layer
    if hasattr(src, "get_frame"):          # Clip
        total = max(src.frames, 1)
        batch = read_rgb_batch(src, [n % total for n in ns], device)
    elif hasattr(src, "frames") and isinstance(src.frames, list):
        # clipedit.Clipboard: host (3,H,W) u8 arrays
        k = max(len(src.frames), 1)
        arrs = [np.asarray(src.frames[n % k]) for n in ns]
        if len({a.shape for a in arrs}) == 1:
            batch = torch.from_numpy(np.stack(arrs)).to(device)
        else:
            return torch.stack([_pull_rgb(src, [n], width, height,
                                          device)[0] for n in ns])
    else:                                   # plain list of layers
        layers = list(src)
        k = max(len(layers), 1)
        frames = []
        for n in ns:
            lay = layers[n % k]
            lay = lay.replace(planes=tuple(p.to(device) for p in lay.planes))
            frames.append(convert_layer(lay, Palette.RGB24).planes[0])
        batch = torch.stack(frames)
    if tuple(batch.shape[-2:]) != (height, width):
        batch = resize_layer(rgb_layer(batch), width, height).planes[0]
    return batch


def _transition_blend_fn(mode: str):
    """Batched device blend for the rendered transitions, as the JITTED
    JAX step computes it: (a_u8, b_u8 (B,3,H,W) uint8, t (B,) float32,
    thresh, tiles) -> float32 out in [0, 1] before the clip."""

    def fade(a, b, t, thresh, tiles):
        sa = ((1.0 - t) * _R255).view(-1, 1, 1, 1)
        sb = (t * _R255).view(-1, 1, 1, 1)
        return fma32(a.to(torch.float32), sa, b.to(torch.float32) * sb)

    # the mask of these two is exact (0 or 1): `a * (1 - m) + b * m` of the
    # scaled frames is x * (1/255) of the selected frame
    def checkerboard(a, b, t, thresh, tiles):
        h, w = a.shape[-2:]
        ty = torch.arange(h, device=a.device)[:, None] \
            // max(h // max(int(tiles), 1), 1)
        tx = torch.arange(w, device=a.device)[None, :] \
            // max(w // max(int(tiles), 1), 1)
        m = ((tx + ty) % 2) == 1
        return torch.where(m, b, a).to(torch.float32) * _R255

    def bwthresh(a, b, t, thresh, tiles):
        c = b.to(torch.float32) * _R255
        g = fma32(c[:, 2], _f32(0.114),
                  fma32(c[:, 0], _f32(0.299), c[:, 1] * _f32(0.587)))
        m = (g > _f32(thresh))[:, None]
        return torch.where(m, b, a).to(torch.float32) * _R255

    return {"fade": fade, "checkerboard": checkerboard,
            "bwthresh": bwthresh}[mode]


def _run_transition(clip: Clip, other, mode: str, start: int, end: int,
                    progress=None, pstart: float = 0.0, pend: float = 1.0,
                    thresh: float = 0.5, tiles: int = 8,
                    batch_size: int = 32, *, device) -> int:
    """transition_fade / _checkerboard / _bwthresh: blend the clip's frames
    with a second source on the device, a batch at a time (the reference
    composites via ImageMagick once per frame)."""
    if other is None:
        raise ValueError("transition scripts need other=<Clip|Clipboard>")
    blend = _transition_blend_fn(mode)
    span = max(end - start - 1, 1)
    done = 0
    for ofs in range(start, end, batch_size):
        hi = min(ofs + batch_size, end)
        a = read_rgb_batch(clip, range(ofs, hi), device)
        b = _pull_rgb(other, [n - start for n in range(ofs, hi)],
                      clip.width, clip.height, device)
        t = pstart + (pend - pstart) * (
            np.arange(ofs, hi, dtype=np.float32) - start) / span
        t = torch.from_numpy(np.asarray(t, np.float32)).to(device)
        out = torch.clamp(blend(a, b, t, thresh, tiles), 0.0, 1.0)
        clip.put_frames(range(ofs, hi), _to_u8_fma(out).cpu().numpy())
        for _ in range(ofs, hi):
            done += 1
            if progress:
                progress(done, end - start)
    clip.save_header()
    return done


def _splice_runner(clip, start, end, progress=None, other=None,
                   keep: int = 4, insert: int = 4, *, device, **_):
    """transition_splice.script: alternate runs of `insert` frames from
    the other source then `keep` original frames (the reference emits the
    clipboard run first: $lc starts at $p0), pure frame replacement."""
    if other is None:
        raise ValueError("transition_splice needs other=<Clip|Clipboard>")
    keep, insert = int(keep), int(insert)
    done = 0
    cyc = max(keep, 0) + max(insert, 0)
    if cyc == 0:
        return 0
    for n in range(start, end):
        k = (n - start) % cyc
        if k < insert:  # clipboard run comes FIRST (reference $lc=$p0)
            arr = _pull_rgb(other, [n - start], clip.width, clip.height,
                            device)[0]
            clip.put_frame(n, rgb_layer(arr))
        done += 1
        if progress:
            progress(done, end - start)
    clip.save_header()
    return done


def _mk_transition_runner(mode):
    def runner(clip, start, end, progress=None, other=None, *, device,
               **params):
        return _run_transition(clip, other, mode, start, end, progress,
                               **{k: v for k, v in params.items()
                                  if k in ("pstart", "pend", "thresh",
                                           "tiles", "batch_size")},
                               device=device)
    return runner


_SCRIPTS["transition_fade"] = ScriptDef(
    "transition_fade", "(two-source)", lambda p, n: {},
    {"pstart": 0.0, "pend": 1.0}, runner=_mk_transition_runner("fade"))
_SCRIPTS["transition_checkerboard"] = ScriptDef(
    "transition_checkerboard", "(two-source)", lambda p, n: {},
    {"tiles": 8}, runner=_mk_transition_runner("checkerboard"))
_SCRIPTS["transition_bwthresh"] = ScriptDef(
    "transition_bwthresh", "(two-source)", lambda p, n: {},
    {"thresh": 0.5}, runner=_mk_transition_runner("bwthresh"))
_SCRIPTS["transition_splice"] = ScriptDef(
    "transition_splice", "(two-source)", lambda p, n: {},
    {"keep": 4, "insert": 4}, runner=_splice_runner)


# -- frame-order / frame-range ops --------------------------------------------

def _jumble_runner(clip, start, end, progress=None, seed: int = 0, *,
                   device, **_):
    """jumble.script: each output frame becomes a random frame from the
    range (sampling WITH replacement, like the reference's int(rand))."""
    from PIL import Image
    from .io.decoders import image_layer
    seed = int(seed)
    rng = np.random.default_rng(seed or None)
    src = rng.integers(start, end, end - start)
    # stage only the UNIQUE sampled source frames as image files (disk,
    # not RAM), then write outputs reading from the stage
    stage = tempfile.mkdtemp(prefix="jumble_", dir=clip.clip_dir)

    def save(job):
        sn, arr = job
        Image.fromarray(np.ascontiguousarray(np.moveaxis(arr, 0, -1))).save(
            f"{stage}/{sn}.png")

    def load(sn):
        return image_layer(f"{stage}/{int(sn)}.png",
                           has_alpha=lambda im: False).planes[0].numpy()
    try:
        uniq = [int(s) for s in np.unique(src)]
        for ofs in range(0, len(uniq), BATCH):
            ns = uniq[ofs: ofs + BATCH]
            host = read_rgb_batch(clip, ns, device).cpu().numpy()
            _pool_map(save, list(zip(ns, host)))
        for ofs in range(0, len(src), BATCH):
            part = list(src[ofs: ofs + BATCH])
            clip.put_frames(range(start + ofs, start + ofs + len(part)),
                            _pool_map(load, part))
            if progress:
                for i in range(ofs, ofs + len(part)):
                    progress(i + 1, end - start)
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    clip.save_header()
    return end - start


_SCRIPTS["jumble"] = ScriptDef("jumble", "(frame-order)",
                               lambda p, n: {}, {"seed": 0},
                               runner=_jumble_runner)


def _skip_forwards_runner(clip, start, end, progress=None, skip: int = 8,
                          pc_start: float = 50.0, pc_step: float = 0.0, *,
                          device, **_):
    """skip_forwards.script: blend each frame with a future frame; the
    lookahead counts down each frame (skip..0) then resets, the blend
    percentage ramping by pc_step: a stuttering look-ahead echo."""
    skip = int(skip)
    # read-only source pass (pull before overwriting), kept on the host
    hi_src = min(end + skip, clip.frames)
    srcs = np.concatenate([
        read_rgb_batch(clip, range(o, min(o + BATCH, hi_src)),
                       device).cpu().numpy()
        for o in range(start, hi_src, BATCH)]) \
        if hi_src > start else np.zeros((0, 3, clip.height, clip.width),
                                        np.uint8)
    # the frames that mix: (n, source i, lookahead j, pc)
    jobs = []
    diff, pc = skip, pc_start
    for n in range(start, end):
        i = n - start
        j = i + diff
        if diff > 0 and j < len(srcs):
            jobs.append((n, i, j, np.float32(min(max(pc / 100.0, 0.0),
                                                 1.0))))
        diff -= 1
        pc += pc_step
        if diff < 0:
            diff, pc = skip, pc_start
    mixed = {}
    for o in range(0, len(jobs), BATCH):
        part = jobs[o: o + BATCH]
        a = torch.from_numpy(srcs[[q[1] for q in part]]).to(device)
        b = torch.from_numpy(srcs[[q[2] for q in part]]).to(device)
        p = torch.from_numpy(np.asarray([q[3] for q in part],
                                        np.float32)).to(device)
        p = p.view(-1, 1, 1, 1)
        out = fma32(a.to(torch.float32), 1.0 - p, b.to(torch.float32) * p)
        out = torch.clamp(out + 0.5, 0, 255).to(torch.uint8).cpu().numpy()
        mixed.update({q[0]: out[k] for k, q in enumerate(part)})
    clip.put_frames(list(mixed), list(mixed.values()))
    done = 0
    for n in range(start, end):
        done += 1
        if progress:
            progress(done, end - start)
    clip.save_header()
    return done


_SCRIPTS["skip_forwards"] = ScriptDef(
    "skip_forwards", "(frame-blend)", lambda p, n: {},
    {"skip": 8, "pc_start": 50.0, "pc_step": 0.0},
    runner=_skip_forwards_runner)


def _trim_runner(clip, start, end, progress=None, x: int = 0, y: int = 0,
                 width: int = 0, height: int = 0, border: bool = False,
                 bx: int = 0, by: int = 0, *, device, **_):
    """trim_frames.script: crop every frame to (width,height) at (x,y);
    with border=True the crop is placed onto a black full-size frame at
    (bx,by) instead of being scaled back up."""
    from .ops.resize import resize_layer
    x, y, bx, by = int(x), int(y), int(bx), int(by)
    w = int(width) or clip.width
    h = int(height) or clip.height
    x = min(max(x, 0), clip.width - 1)
    y = min(max(y, 0), clip.height - 1)
    w = min(w, clip.width - x)
    h = min(h, clip.height - y)
    done = 0
    for ofs in range(start, end, BATCH):
        hi = min(ofs + BATCH, end)
        arr = read_rgb_batch(clip, range(ofs, hi), device)[
            :, :, y: y + h, x: x + w]
        if border:
            out = torch.zeros((hi - ofs, 3, clip.height, clip.width),
                              dtype=torch.uint8, device=arr.device)
            yy = min(max(by, 0), clip.height - h)
            xx = min(max(bx, 0), clip.width - w)
            out[:, :, yy: yy + h, xx: xx + w] = arr
        else:
            out = resize_layer(rgb_layer(arr.contiguous()), clip.width,
                               clip.height).planes[0]
        clip.put_frames(range(ofs, hi), out.cpu().numpy())
        for _ in range(ofs, hi):
            done += 1
            if progress:
                progress(done, end - start)
    clip.save_header()
    return done


_SCRIPTS["trim_frames"] = ScriptDef(
    "trim_frames", "(geometry)", lambda p, n: {},
    {"x": 0, "y": 0, "width": 0, "height": 0, "border": False},
    runner=_trim_runner)


def _photo_still_runner(clip, start, end, progress=None, flash: int = 2,
                        hold: int = 12, desaturate: bool = True, *,
                        device, **_):
    """photo_still.script: a camera-flash freeze: `flash` white frames,
    then the first frame held (optionally desaturated to B&W photo look)
    for `hold` frames; the rest untouched."""
    flash, hold = int(flash), int(hold)
    arr = read_rgb_batch(clip, [start], device)[0]
    if desaturate:
        # the JAX runner's host numpy: float64 products, left to right
        f = arr.to(torch.float64)
        g = (0.299 * f[0] + 0.587 * f[1] + 0.114 * f[2]).to(torch.uint8)
        arr = torch.stack([g, g, g])
    arr = arr.cpu().numpy()
    white = np.full_like(arr, 255)
    ns = range(start, min(end, start + flash + hold))
    clip.put_frames(ns, [white if n - start < flash else arr for n in ns])
    done = 0
    for _ in ns:
        done += 1
        if progress:
            progress(done, end - start)
    clip.save_header()
    return done


_SCRIPTS["photo_still"] = ScriptDef(
    "photo_still", "(freeze)", lambda p, n: {},
    {"flash": 2, "hold": 12, "desaturate": True},
    runner=_photo_still_runner)


def _image_overlay_runner(clip, start, end, progress=None, image: str = "",
                          x: int = 0, y: int = 0, scale: float = 1.0,
                          alpha: float = 1.0, dx: float = 0.0,
                          dy: float = 0.0, dscale: float = 0.0,
                          dalpha: float = 0.0, *, device, **_):
    """image_overlay.script: composite an image file over the frames, with
    optional per-frame position/size/alpha animation deltas. The overlay
    image is resized by PIL on the host, as in the JAX package; the
    composite runs on the device."""
    from PIL import Image
    if not image:
        raise ValueError("image_overlay needs image=<path>")
    img = Image.open(image).convert("RGBA")
    done = 0
    for ofs in range(start, end, BATCH):
        hi = min(ofs + BATCH, end)
        frames = read_rgb_batch(clip, range(ofs, hi), device)
        outs = []
        for k, n in enumerate(range(ofs, hi)):
            i = n - start
            s = max(scale + dscale * i, 0.01)
            a = min(max(alpha + dalpha * i, 0.0), 1.0)
            ox, oy = int(x + dx * i), int(y + dy * i)
            ow, oh = max(int(img.width * s), 1), max(int(img.height * s), 1)
            over = torch.from_numpy(np.array(img.resize((ow, oh)))).to(
                device).permute(2, 0, 1).to(torch.float32)
            over = _div(over, 255.0)
            base = frames[k].to(torch.float32)
            # clip the overlay rect to the frame
            x0, y0 = max(ox, 0), max(oy, 0)
            x1 = min(ox + ow, clip.width)
            y1 = min(oy + oh, clip.height)
            if x1 > x0 and y1 > y0:
                sub = over[:, y0 - oy: y1 - oy, x0 - ox: x1 - ox]
                m = sub[3] * _f32(a)
                base[:, y0:y1, x0:x1] = (base[:, y0:y1, x0:x1] * (1.0 - m)
                                         + sub[:3] * 255.0 * m)
            outs.append(torch.clamp(base + 0.5, 0, 255).to(torch.uint8))
        clip.put_frames(range(ofs, hi), torch.stack(outs).cpu().numpy())
        for _ in range(ofs, hi):
            done += 1
            if progress:
                progress(done, end - start)
    clip.save_header()
    return done


_SCRIPTS["image_overlay"] = ScriptDef(
    "image_overlay", "(composite)", lambda p, n: {},
    {"image": "", "x": 0, "y": 0, "scale": 1.0, "alpha": 1.0},
    runner=_image_overlay_runner)


def _resize_runner(clip, start, end, progress=None, width: int = 0,
                   height: int = 0, *, device, **_):
    """resize.script: re-render every frame at a new geometry."""
    from .rfx import resize_all
    return resize_all(clip, int(width) or clip.width,
                      int(height) or clip.height,
                      progress=progress, device=device)


_SCRIPTS["resize"] = ScriptDef("resize", "(geometry)", lambda p, n: {},
                               {"width": 0, "height": 0},
                               runner=_resize_runner)


def _textover_runner(clip, start, end, progress=None, text: str = "", *,
                     device, **style):
    style = {k: v for k, v in style.items() if v not in ("", None)}
    if "size" in style:
        style["size"] = int(style["size"])
    return apply_textover(clip, text, start, end, device=device, **style)


# font = truetype name/path (the reference script's fontchooser special)
_SCRIPTS["textover"] = ScriptDef("textover", "(text)", lambda p, n: {},
                                 {"text": "", "size": 32, "font": ""},
                                 runner=_textover_runner)


# -- clip generators (gen_*.script) -------------------------------------------

def frame_calculator(fps: float, hours: float = 0.0, minutes: float = 0.0,
                     seconds: float = 0.0) -> int:
    """frame_calculator.script: time -> 1-based frame number at fps."""
    t = hours * 3600.0 + minutes * 60.0 + seconds
    return int(t * fps + 0.5) + 1


def _fill_clip(c: Clip, frame: np.ndarray, frames: int) -> Clip:
    """Write one host (3, H, W) frame `frames` times and save the header."""
    c.put_frames(range(frames), [frame] * frames)
    c.frames = frames
    c.save_header()
    return c


def gen_coloured_frames(workdir, width: int = 640, height: int = 480,
                        frames: int = 25, fps: float = 25.0,
                        red: float = 0.0, green: float = 0.0,
                        blue: float = 0.0, name: str = "coloured", *,
                        device="cuda"):
    """gen_coloured_frames.script / gen_blank_frames.script: a new clip of
    constant-colour frames, made on `device`."""
    dev = resolve_device(device, "gen_coloured_frames")
    c = create_clip(workdir, width, height, fps, name=name)
    col = torch.from_numpy(np.array([red, green, blue], np.float32)).to(dev)
    px = (col * 255.0 + 0.5).to(torch.uint8)[:, None, None]
    return _fill_clip(c, px.expand(3, height, width).contiguous().cpu()
                      .numpy(), frames)


def gen_blank_frames(workdir, **kw):
    """gen_blank_frames.script: black frames."""
    kw.setdefault("name", "blank")
    return gen_coloured_frames(workdir, red=0.0, green=0.0, blue=0.0, **kw)


def gen_text(workdir, text: str, width: int = 640, height: int = 480,
             frames: int = 25, fps: float = 25.0, size: int = 48,
             colour=(255, 255, 255), bg=(0.0, 0.0, 0.0), *,
             device="cuda"):
    """gen_text.script: title frames: text centred on a colour background
    (the mask rasterised by PIL on the host, the blend on `device`)."""
    from .text import render_text_mask
    dev = resolve_device(device, "gen_text")
    c = create_clip(workdir, width, height, fps, name="title")
    mask = torch.from_numpy(render_text_mask(
        text, width, height, size=size, colour=colour,
        valign="middle")).to(dev)
    m = _div(mask[3].to(torch.float32), 255.0)
    bgcol = torch.from_numpy(np.array(bg, np.float32)).to(dev)[
        :, None, None] * 255.0
    out = torch.clamp(bgcol * (1.0 - m) + mask[:3].to(torch.float32) * m
                      + 0.5, 0, 255).to(torch.uint8)
    return _fill_clip(c, out.cpu().numpy(), frames)


def gen_clip_from_image(workdir, image: str, frames: int = 25,
                        fps: float = 25.0, width: int = 0, height: int = 0):
    """gen_clip_from_image.script: a clip holding one image for N frames
    (PIL's decode and resize on the host, as in the JAX package: no other
    pixel work)."""
    from PIL import Image
    img = Image.open(image).convert("RGB")
    if width and height:
        img = img.resize((width, height))
    w, h = img.size
    c = create_clip(workdir, w, h, fps, name=Path(image).stem)
    arr = np.ascontiguousarray(np.asarray(img, np.uint8).transpose(2, 0, 1))
    return _fill_clip(c, arr, frames)
