"""Text rendering and subtitles (reference `src/pangotext.c`; .srt/.sub
load and save, `src/clip_load_save.c:35,1752`).

Counterpart of `lives_tpu/text.py:1-188`, the whole module. Text is
rasterised on the host with PIL into a (4, H, W) uint8 RGBA mask, with the
same PIL calls in the same order as the JAX package, so the two masks are
the same bytes on one machine; the mask is composited on the device.

`overlay_text` and `SubtitleOverlay.apply` take an RGB-family layer, with
or without a batch axis, as the JAX functions take a frame: its first
plane read as RGB(A) values 0-255, blended as `rgb * (1 - a) + mask * a`
in float32, rounded half up and clipped to uint8. `SubtitleOverlay` keeps
each mask on the device, keyed by text, size and device, as the two
tensors of that blend, so a subtitle that stays on screen is uploaded
once, not every frame.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .constants import is_rgb_palette
from .layer import Layer

try:
    from PIL import Image, ImageDraw, ImageFont
    HAVE_PIL = True
except Exception:  # pragma: no cover
    HAVE_PIL = False


def render_text_mask(text: str, width: int, height: int,
                     size: int = 32, colour=(255, 255, 255),
                     halign: str = "center", valign: str = "bottom",
                     margin: int = 16, font: str = "") -> np.ndarray:
    """Rasterise text to an (4, H, W) uint8 RGBA overlay. `font` is a
    truetype file name/path (the reference's fontchooser special,
    paramspecial.c); empty falls back to DejaVu then PIL's default."""
    if not HAVE_PIL:
        raise RuntimeError("PIL required for text rendering")
    img = Image.new("RGBA", (width, height), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    fnt = None
    if font:
        for cand in (font, f"{font}.ttf"):
            try:
                fnt = ImageFont.truetype(cand, size)
                break
            except Exception:
                pass
    if fnt is None:
        try:
            fnt = ImageFont.truetype("DejaVuSans-Bold.ttf", size)
        except Exception:
            fnt = ImageFont.load_default()
    lines = text.split("\n")
    line_h = size + 4
    total_h = line_h * len(lines)
    if valign == "bottom":
        y0 = height - margin - total_h
    elif valign == "top":
        y0 = margin
    else:
        y0 = (height - total_h) // 2
    for i, line in enumerate(lines):
        bbox = draw.textbbox((0, 0), line, font=fnt)
        tw = bbox[2] - bbox[0]
        if halign == "center":
            x = (width - tw) // 2
        elif halign == "left":
            x = margin
        else:
            x = width - margin - tw
        y = y0 + i * line_h
        # outline for legibility (pangotext draws shadow/outline too)
        for dx, dy in ((-2, 0), (2, 0), (0, -2), (0, 2)):
            draw.text((x + dx, y + dy), line, font=fnt,
                      fill=(0, 0, 0, 255))
        draw.text((x, y), line, font=fnt, fill=(*colour, 255))
    return np.moveaxis(np.asarray(img), -1, 0).copy()


def blend_terms(mask: np.ndarray, device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(1 - a, mask_rgb * a) of an RGBA mask, float32 (1, H, W) and
    (3, H, W) on `device`: the two factors of the overlay's blend."""
    m = torch.from_numpy(mask).to(device).to(torch.float32)
    a = m[3:4] / 255.0
    return 1.0 - a, m[:3] * a


def _composite(layer: Layer, terms) -> Layer:
    """The blend of `lives_tpu/text.py:84-92` on the layer's first plane,
    (..., C, H, W), keeping an alpha channel."""
    if not is_rgb_palette(layer.palette):
        raise ValueError(
            f"text overlay: an RGB-family layer is needed, got palette "
            f"{layer.palette} (give the player an RGB sink for subtitles)")
    inv_a, rgb_a = terms
    src = layer.planes[0]
    arr = src.to(torch.float32)
    rgb = arr[..., :3, :, :] * inv_a + rgb_a
    out = torch.clamp(torch.floor(rgb + 0.5), 0, 255).to(torch.uint8)
    if arr.shape[-3] == 4:
        out = torch.cat([out, src[..., 3:4, :, :]], -3)
    return layer.replace(planes=(out,))


def overlay_text(layer: Layer, text: str, **style) -> Layer:
    """Composite text onto an RGB-family layer (render_text_to_layer
    successor)."""
    mask = render_text_mask(text, layer.width, layer.height, **style)
    return _composite(layer, blend_terms(mask, layer.device))


# ---------------------------------------------------------------------------
# Subtitles
# ---------------------------------------------------------------------------

@dataclass
class Subtitle:
    start: float            # seconds
    end: float
    text: str


def _srt_time(s: str) -> float:
    m = re.match(r"(\d+):(\d+):(\d+)[,.](\d+)", s.strip())
    h, mi, se, ms = (int(x) for x in m.groups())
    return h * 3600 + mi * 60 + se + ms / 1000.0


def _srt_fmt(t: float) -> str:
    ms = int(round(t * 1000))
    return f"{ms // 3600000:02d}:{ms // 60000 % 60:02d}:" \
           f"{ms // 1000 % 60:02d},{ms % 1000:03d}"


def load_srt(path: str | Path) -> list[Subtitle]:
    """.srt parser (reference reload_subs, clip_load_save.c:1752)."""
    text = Path(path).read_text(errors="replace")
    subs = []
    for block in re.split(r"\n\s*\n", text.strip()):
        lines = [l for l in block.splitlines() if l.strip()]
        if len(lines) < 2:
            continue
        ti = 1 if re.fullmatch(r"\d+", lines[0].strip()) else 0
        m = re.match(r"(.+?)\s*-->\s*(.+)", lines[ti])
        if not m:
            continue
        subs.append(Subtitle(_srt_time(m.group(1)), _srt_time(m.group(2)),
                             "\n".join(lines[ti + 1:])))
    return subs


def save_srt(path: str | Path, subs: list[Subtitle]):
    """save_subs_to_file (clip_load_save.c:35)."""
    out = []
    for i, s in enumerate(subs, 1):
        out.append(f"{i}\n{_srt_fmt(s.start)} --> {_srt_fmt(s.end)}\n"
                   f"{s.text}\n")
    Path(path).write_text("\n".join(out))


def load_sub(path: str | Path, fps: float = 25.0) -> list[Subtitle]:
    """MicroDVD .sub parser: {start_frame}{end_frame}text."""
    subs = []
    for line in Path(path).read_text(errors="replace").splitlines():
        m = re.match(r"\{(\d+)\}\{(\d+)\}(.*)", line.strip())
        if m:
            subs.append(Subtitle(int(m.group(1)) / fps,
                                 int(m.group(2)) / fps,
                                 m.group(3).replace("|", "\n")))
    return subs


def sub_at(subs: list[Subtitle], t: float) -> str | None:
    for s in subs:
        if s.start <= t < s.end:
            return s.text
    return None


class SubtitleOverlay:
    """Player-side subtitle compositor; each mask stays on the device,
    keyed by (text, width, height, device)."""

    def __init__(self, subs: list[Subtitle], **style):
        self.subs = subs
        self.style = style
        self._cache: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        #: masks rasterised and uploaded so far
        self.uploads = 0

    def apply(self, layer: Layer, t: float) -> Layer:
        text = sub_at(self.subs, t)
        if not text:
            return layer
        key = (text, layer.width, layer.height, str(layer.device))
        terms = self._cache.get(key)
        if terms is None:
            mask = render_text_mask(text, layer.width, layer.height,
                                    **self.style)
            terms = self._cache[key] = blend_terms(mask, layer.device)
            self.uploads += 1
        return _composite(layer, terms)
