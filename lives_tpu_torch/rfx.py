"""Rendered (non-realtime) effects on clips: the RFX system successor.

Counterpart of `lives_tpu/rfx.py:33-236` (`apply_rendered_effect`,
`resize_all`, `undo_rendered_effect`, `parse_rfx_params`,
`parse_rfx_specials`). The reference pipeline (`src/effects.c:127
do_effect`) forks a Perl script that shells ImageMagick once per
extracted frame image. Here a rendered effect is the Filter object the
realtime path uses, applied over a frame range by `FrameGraph.run_batch`
on an explicit device, with frames pulled from the clip a batch at a time
(`io.clips.read_rgb_batch`: a YUV4MPEG clip's batch is one upload a plane
and one K2 launch on the card) and written back as images on the host.
A value given as a callable f(frame) becomes a traced parameter stream,
one value a frame, as in the JAX package.

Undo: the previous frame images are copied to an undo directory inside
the clip, a virtual frame's decoder index to a `.virtual` note
(reference per-clip undo state, cliphandler.h:510-540).
"""

from __future__ import annotations

import re
import shutil
from typing import Callable, Optional

import numpy as np

from .constants import Palette
from .effects.host import instantiate, split_params
from .graph.nodemodel import FrameGraph, SinkSpec
from .io.clips import Clip, read_rgb_batch, rgb_layer
from .layer import Layer
from .utils.device import resolve_device

UNDO_DIR = ".undo"


def apply_rendered_effect(clip: Clip, filter_name: str,
                          start: int = 0, end: int | None = None,
                          values: dict | None = None,
                          batch_size: int = 32,
                          progress: Optional[Callable[[int, int],
                                                      None]] = None,
                          keep_undo: bool = True, *, device="cuda") -> int:
    """Apply `filter_name` to clip frames [start, end) on `device`.
    Returns frames processed. Frames become real images (virtual entries
    are realized).

    `values` entries may be callables f(frame_number) -> value: those
    become per-frame traced parameter streams (the RFX fade/ramp scripts
    animate params over the range)."""
    dev = resolve_device(device, "apply_rendered_effect")
    end = clip.frames if end is None else min(end, clip.frames)
    values = dict(values or {})
    anim = {k: v for k, v in values.items() if callable(v)}
    static_vals = {k: v for k, v in values.items() if not callable(v)}
    inst = instantiate(filter_name, **static_vals,
                       **{k: f(start) for k, f in anim.items()})
    graph = FrameGraph([inst], SinkSpec(), fps=clip.fps)

    undo = clip.clip_dir / UNDO_DIR
    if keep_undo:
        if undo.exists():
            shutil.rmtree(undo)
        undo.mkdir()
        (undo / "range").write_text(f"{start} {end}\n")

    done = 0
    for ofs in range(start, end, batch_size):
        hi = min(ofs + batch_size, end)
        batch = Layer(planes=(read_rgb_batch(clip, range(ofs, hi), dev),),
                      palette=int(Palette.RGB24), gamma=int(clip.gamma))
        tcs = np.arange(ofs, hi, dtype=np.float32) / clip.fps
        params = None
        if anim:
            _, tp = split_params(inst)
            params = [{k: (np.asarray([f(n) for n in range(ofs, hi)],
                                      np.float32)
                           if (f := anim.get(k)) is not None
                           else np.broadcast_to(np.float32(v), (hi - ofs,)))
                       for k, v in tp.items()}]
        out = graph.run_batch([batch], tcs,
                              np.arange(ofs, hi, dtype=np.int32),
                              traced_params=params)
        out_arr = out.planes[0].cpu().numpy()
        for n in range(ofs, hi):
            if keep_undo:
                src = clip.image_path(n)
                if src.exists():
                    shutil.copy2(src, undo / src.name)
                else:
                    (undo / (src.name + ".virtual")).write_text(
                        str(int(clip.frame_index[n])
                            if clip.frame_index is not None else n))
        clip.put_frames(range(ofs, hi), out_arr)
        for _ in range(ofs, hi):
            done += 1
            if progress:
                progress(done, end - start)
    clip.save_header()
    return done


def resize_all(clip: Clip, width: int, height: int,
               batch_size: int = 32,
               progress=None, *, device="cuda") -> int:
    """Re-render every frame at a new geometry on `device` (reference
    `resize_all`, colourspace.c:15935). Materialises all frames as
    images."""
    from .ops.resize import resize_layer
    dev = resolve_device(device, "resize_all")
    done = 0
    for ofs in range(0, clip.frames, batch_size):
        hi = min(ofs + batch_size, clip.frames)
        batch = rgb_layer(read_rgb_batch(clip, range(ofs, hi), dev))
        clip.put_frames(range(ofs, hi), resize_layer(
            batch, width, height).planes[0].cpu().numpy())
        for _ in range(ofs, hi):
            done += 1
            if progress:
                progress(done, clip.frames)
    clip.width, clip.height = width, height
    clip.save_header()
    return done


def undo_rendered_effect(clip: Clip) -> bool:
    """Restore the pre-effect frames (reference undo model)."""
    undo = clip.clip_dir / UNDO_DIR
    if not undo.is_dir():
        return False
    for f in undo.iterdir():
        if f.name == "range":
            continue
        if f.suffix == ".virtual":
            n = int(f.stem.split(".")[0]) - 1
            entry = int(f.read_text())
            if clip.frame_index is not None:
                clip.frame_index[n] = entry
            img = clip.clip_dir / f.name.replace(".virtual", "")
            if img.exists():
                img.unlink()
        else:
            shutil.copy2(f, clip.clip_dir / f.name)
    shutil.rmtree(undo)
    clip.save_header()
    return True


# ---------------------------------------------------------------------------
# RFX script parameter DSL (RFX.spec): parser for param definitions, so
# reference .script param blocks stay loadable for generated UIs
# (`rfx.py:141-236`, host Python, copied).
# ---------------------------------------------------------------------------

def parse_rfx_params(script_text: str) -> list[dict]:
    """Parse an RFX <params> section (RFX.spec format:
    name|label|type|default|min|max[|step...]). Returns param dicts
    compatible with effects.host.Param kwargs."""
    m = re.search(r"<params>\s*(.*?)\s*</params>", script_text, re.S)
    if not m:
        return []
    out = []
    for line in m.group(1).splitlines():
        line = line.strip()
        if not line:
            continue
        bits = line.split("|")
        if len(bits) < 3:
            continue
        name, label, ptype = bits[0], bits[1], bits[2]
        d: dict = {"name": name, "label": label.replace("_", "")}
        if ptype.startswith("num"):
            d["kind"] = "num" if ptype != "num0" else "int"
            d["default"] = float(bits[3]) if len(bits) > 3 else 0.0
            d["min"] = float(bits[4]) if len(bits) > 4 else 0.0
            d["max"] = float(bits[5]) if len(bits) > 5 else 1.0
        elif ptype == "bool":
            d["kind"] = "bool"
            d["default"] = bits[3].strip() in ("1", "TRUE", "true") \
                if len(bits) > 3 else False
        elif ptype == "colRGB24":
            d["kind"] = "color"
            d["default"] = tuple(int(x) for x in bits[3:6]) \
                if len(bits) > 5 else (0, 0, 0)
        elif ptype == "string_list":
            d["kind"] = "string_list"
            d["choices"] = tuple(x.strip() for x in bits[4:]) \
                if len(bits) > 4 else ()
            d["default"] = int(bits[3]) if len(bits) > 3 else 0
        elif ptype == "string":
            d["kind"] = "string"
            d["default"] = bits[3] if len(bits) > 3 else ""
        out.append(d)
    return out


def parse_rfx_specials(script_text: str,
                       params: list[dict]) -> list[dict]:
    """Parse `special|<type>|<idx...>` hints from an RFX
    `<param_window>` section (reference src/paramspecial.c:60-112:
    aspect = keep-aspect link between two num params, fileread = file
    chooser on a string param, fontchooser, password = masked entry,
    mergealign = merge-dialog alignment, framedraw = interactive
    overlay). Numeric indices resolve to param names so front-ends
    never see raw indices."""
    m = re.search(r"<param_window>\s*(.*?)\s*</param_window>",
                  script_text, re.S)
    if not m:
        return []
    names = [p["name"] for p in params]

    def pname(tok):
        try:
            i = int(tok)
            return names[i] if 0 <= i < len(names) else None
        except ValueError:
            return tok if tok in names else None

    out = []
    for line in m.group(1).splitlines():
        bits = [b for b in line.strip().split("|") if b != ""]
        if len(bits) < 2 or bits[0] != "special":
            continue
        kind = bits[1]
        if kind == "framedraw" and len(bits) >= 3:
            pts = [q for q in (pname(t) for t in bits[3:]) if q]
            out.append({"type": "framedraw", "subtype": bits[2],
                        "params": pts})
        elif kind in ("aspect", "mergealign") and len(bits) >= 4:
            pts = [q for q in (pname(t) for t in bits[2:4]) if q]
            if len(pts) == 2:
                out.append({"type": kind, "params": pts})
        elif kind in ("fileread", "fontchooser", "password") \
                and len(bits) >= 3:
            q = pname(bits[2])
            if q:
                out.append({"type": kind, "params": [q]})
    return out
