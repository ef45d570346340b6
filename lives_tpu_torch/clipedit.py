"""Clip editing ops: cut/copy/paste/insert/trim via the clipboard model,
merge through a transition, and the frame-edit undo.

Counterpart of `lives_tpu/clipedit.py:1-314` (reference:
mainw->clipboard, `src/callbacks.c` edit menu handlers, insert/delete via
cvirtual + smogrify file ops, `src/merge.c`). The clipboard holds
materialised frames (host RGB arrays + an audio segment), so pastes are
decoder-independent, as in the reference, which renders clipboard frames
to images.

The pixel work runs on an explicit device (`device="cuda"` by default,
raising without CUDA): `copy_frames` reads the range a batch at a time
(`io.clips.read_rgb_batch`: one upload a plane and one K2 launch for a
YUV4MPEG clip's batch on the card) and keeps the frames on the host;
`merge_clipboard` runs the transition through `FrameGraph.run_batch`
with the clipboard on track 0 (the transition's fg) and the ramp as its
traced parameter, computed in numpy float32 as in the JAX package. A
one-instance chain is below the composite route's three (`FrameGraph.
_composite_len`, as the JAX package's `nodemodel.py:503-506`), so a merge
takes the plain route with or without `LIVES_TPU_PALLAS_COMPOSITE=1` in
both packages.

Undo rests on hardlinks: `snapshot_edit_undo` links the clip's images
into `.editundo` (`put_frame` never truncates an image in place) and
copies its audio; `undo_edit` swaps the snapshot with the current state,
so a second undo redoes.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass, field

import numpy as np
import torch

from .io.clips import BATCH, Clip, read_rgb_batch, rgb_layer
from .utils.device import resolve_device


@dataclass
class Clipboard:
    frames: list[np.ndarray] = field(default_factory=list)  # (3,H,W) u8
    audio: np.ndarray | None = None
    arate: int = 0
    fps: float = 25.0

    def __len__(self):
        return len(self.frames)


def copy_frames(clip: Clip, start: int, end: int,
                with_audio: bool = True, *, device="cuda") -> Clipboard:
    """Copy frames [start, end) to a clipboard (edit menu Copy), converted
    on `device`."""
    dev = resolve_device(device, "copy_frames")
    cb = Clipboard(fps=clip.fps)
    hi_all = min(end, clip.frames)
    for ofs in range(start, hi_all, BATCH):
        hi = min(ofs + BATCH, hi_all)
        cb.frames.extend(read_rgb_batch(clip, range(ofs, hi), dev)
                         .cpu().numpy())
    # live sources (generators, capture devices) have no audio store
    if with_audio and getattr(clip, "achans", 0):
        a = clip.read_audio()
        s0 = int(start / clip.fps * clip.arate)
        s1 = int(end / clip.fps * clip.arate)
        cb.audio = a[s0:s1]
        cb.arate = clip.arate
    return cb


def cut_frames(clip: Clip, start: int, end: int,
               with_audio: bool = True, keep_undo: bool = True, *,
               device="cuda") -> Clipboard:
    """Cut = copy + delete (edit menu Cut)."""
    cb = copy_frames(clip, start, end, with_audio, device=device)
    delete_frames(clip, start, end, with_audio, keep_undo=keep_undo)
    return cb


def delete_frames(clip: Clip, start: int, end: int,
                  with_audio: bool = True, keep_undo: bool = True):
    """Delete frames [start, end) (+ the matching audio span)."""
    end = min(end, clip.frames)
    if keep_undo:
        snapshot_edit_undo(clip)
    # image files must shift down to keep positional -1 entries valid
    idx = clip.frame_index if clip.frame_index is not None \
        else np.full(clip.frames, -1, np.int32)
    keep = [n for n in range(clip.frames) if not (start <= n < end)]
    _relayout_images(clip, idx, keep)
    clip.frame_index = idx[keep].astype(np.int32)
    clip.frames = len(keep)
    if with_audio and clip.achans and clip.audio_path.exists():
        a = clip.read_audio()
        s0 = int(start / clip.fps * clip.arate)
        s1 = int(end / clip.fps * clip.arate)
        clip.write_audio(np.concatenate([a[:s0], a[s1:]]), clip.arate)
    clip.save_header()


def paste_insert(clip: Clip, at: int, cb: Clipboard,
                 with_audio: bool = True, keep_undo: bool = True):
    """Insert clipboard frames before timeline frame `at` (edit Insert).
    Host work: the clipboard's frames are written as images."""
    if keep_undo:
        snapshot_edit_undo(clip)
    n_ins = len(cb)
    idx = clip.frame_index if clip.frame_index is not None \
        else np.full(clip.frames, -1, np.int32)
    # shift existing image files up to make room
    order = list(range(clip.frames))
    new_order = order[:at] + [-1] * n_ins + order[at:]
    _relayout_images(clip, idx, new_order, reverse=True)
    clip.frame_index = np.concatenate(
        [idx[:at], np.full(n_ins, -1, np.int32), idx[at:]]).astype(np.int32)
    clip.frames += n_ins
    clip.put_frames(range(at, at + n_ins), cb.frames)
    if with_audio and cb.audio is not None and clip.arate:
        a = clip.read_audio()
        s0 = int(at / clip.fps * clip.arate)
        ins = cb.audio
        if cb.arate != clip.arate and len(ins):
            from .audio.engine import resample
            ins = resample(ins, cb.arate, clip.arate)
        clip.write_audio(np.concatenate([a[:s0], ins, a[s0:]]), clip.arate)
    clip.save_header()


def trim_clip(clip: Clip, start: int, end: int):
    """Keep only [start, end) (edit Trim / 'delete all outside selection')."""
    snapshot_edit_undo(clip)   # ONE undo step for the whole trim
    if end < clip.frames:
        delete_frames(clip, end, clip.frames, with_audio=True,
                      keep_undo=False)
    if start > 0:
        delete_frames(clip, 0, start, with_audio=True, keep_undo=False)


def _relayout_images(clip: Clip, idx: np.ndarray, new_order: list[int],
                     reverse: bool = False):
    """Rename image files so positional -1 entries stay correct after a
    reorder. new_order[i] = old frame shown at new position i (-1 = new
    slot, no file)."""
    renames = []
    for new_pos, old in enumerate(new_order):
        if old < 0 or old >= len(idx) or idx[old] >= 0:
            continue
        src = clip.image_path(old)
        if src.exists() and new_pos != old:
            renames.append((src, clip.image_path(new_pos)))
    tmp = []
    for src, dst in renames:
        t = src.with_suffix(src.suffix + ".mv")
        os.rename(src, t)
        tmp.append((t, dst))
    for t, dst in tmp:
        os.rename(t, dst)


def merge_clipboard(clip: Clip, cb: Clipboard, transition: str = "crossfade",
                    start: int = 0, end: int | None = None,
                    ramp: tuple[float, float] = (0.0, 1.0),
                    with_audio: bool = True, batch_size: int = 32,
                    progress=None, *, device="cuda", **params) -> int:
    """Merge the clipboard into the clip's selection through any registered
    2-input transition filter on `device`, the reference Merge dialog
    (`src/merge.c`: clipboard composited over the selection with a
    realtime transition, amount ramping across the range; the clipboard
    loops when shorter). Clipboard audio crossfades in when present.

    The CLIPBOARD rides track 0 (the transition's fg), so `ramp` is the
    clipboard weight for every transition: (0, 1) = the selection
    dissolves/wipes into the clipboard; the audio blend follows the same
    ramp."""
    from .effects.host import instantiate, split_params
    from .graph.nodemodel import FrameGraph, SinkSpec
    from .ops.resize import resize_layer

    end = clip.frames if end is None else min(end, clip.frames)
    n = max(end - start, 0)
    if n == 0 or not len(cb.frames):
        return 0
    dev = resolve_device(device, "merge_clipboard")
    inst = instantiate(transition, **params)
    if inst.filter.n_in != 2:
        raise ValueError(f"{transition!r} is not a 2-input transition")
    snapshot_edit_undo(clip)   # merge rewrites frames: one undo step
    inst.in_tracks = (0, 1)
    # the ramped param: transitions name their blend knob differently
    ramp_param = next((nm for nm in ("amount", "opacity")
                       if any(q.name == nm for q in inst.filter.params)),
                      None)
    traced = split_params(inst)[1]
    if ramp_param is None:
        traced0 = sorted(traced)
        ramp_param = traced0[0] if traced0 else None
    graph = FrameGraph([inst], SinkSpec(), fps=clip.fps)
    span = max(n - 1, 1)
    done = 0
    for ofs in range(start, end, batch_size):
        hi = min(ofs + batch_size, end)
        la = rgb_layer(read_rgb_batch(clip, range(ofs, hi), dev))
        b_frames = []
        for k in range(ofs, hi):
            arr = cb.frames[(k - start) % len(cb.frames)]
            if arr.shape[1:] != (clip.height, clip.width):
                # a clipboard frame of another geometry, resized alone
                arr = resize_layer(rgb_layer(torch.from_numpy(arr).to(dev)),
                                   clip.width, clip.height
                                   ).planes[0].cpu().numpy()
            b_frames.append(arr)
        lb = rgb_layer(torch.from_numpy(np.stack(b_frames)).to(dev))
        tcs = np.arange(ofs, hi, dtype=np.float32) / clip.fps
        frames = np.arange(ofs, hi, dtype=np.int32)
        amt = ramp[0] + (ramp[1] - ramp[0]) * (
            np.arange(ofs, hi, dtype=np.float32) - start) / span
        tp = [{k2: (amt if k2 == ramp_param
                    else np.broadcast_to(np.float32(v), (hi - ofs,)))
               for k2, v in traced.items()}]
        out = graph.run_batch([lb, la], tcs, frames, traced_params=tp)
        clip.put_frames(range(ofs, hi), out.planes[0].cpu().numpy())
        for _ in range(ofs, hi):
            done += 1
            if progress:
                progress(done, n)
    if with_audio and cb.audio is not None and getattr(clip, "achans", 0):
        a = clip.read_audio()
        s0 = int(start / clip.fps * clip.arate)
        s1 = min(int(end / clip.fps * clip.arate), len(a))
        seg = a[s0:s1]
        cba = cb.audio
        if cb.arate and cb.arate != clip.arate:
            from .audio.engine import resample as _resample
            cba = _resample(cba, cb.arate, clip.arate)
        if not len(cba) or not len(seg):
            clip.save_header()
            return done
        reps = int(np.ceil(len(seg) / max(len(cba), 1)))
        cba = np.tile(cba[:, : seg.shape[1]], (reps, 1))[: len(seg)]
        t = (ramp[0] + (ramp[1] - ramp[0])
             * np.linspace(0, 1, len(seg), dtype=np.float32))[:, None]
        a[s0:s1] = seg * (1.0 - t) + cba * t
        clip.write_audio(a, clip.arate)
    clip.save_header()
    return done


# ---------------------------------------------------------------------------
# Frame-edit undo (reference: per-clip undo state for insert/delete ops,
# cliphandler.h undo fields + smogrify undo files). Swap semantics: undoing
# stashes the current state, so a second undo acts as redo.
# ---------------------------------------------------------------------------

EDIT_UNDO_DIR = ".editundo"


def _layout_meta(clip: Clip) -> str:
    return json.dumps(
        {"frames": clip.frames,
         "frame_index": (clip.frame_index.tolist()
                         if clip.frame_index is not None else None),
         "achans": clip.achans, "arate": clip.arate})


def snapshot_edit_undo(clip: Clip) -> None:
    """Snapshot the clip's frame layout before a destructive edit.
    Images are HARDLINKED (no data copy: put_frame never truncates an
    inode in place), audio is copied, index/metadata json'd."""
    d = clip.clip_dir / EDIT_UNDO_DIR
    if d.exists():
        shutil.rmtree(d)
    d.mkdir()
    (d / "meta.json").write_text(_layout_meta(clip))
    for p in clip.clip_dir.glob(f"*.{clip.img_type}"):
        os.link(p, d / p.name)
    if clip.audio_path.exists():
        shutil.copy2(clip.audio_path, d / "audio")


def undo_edit(clip: Clip) -> bool:
    """Restore the pre-edit frame layout (and stash the current one, so
    calling again redoes). Returns False when there is nothing to undo."""
    d = clip.clip_dir / EDIT_UNDO_DIR
    if not (d / "meta.json").is_file():
        return False
    redo = clip.clip_dir / (EDIT_UNDO_DIR + ".swap")
    if redo.exists():
        shutil.rmtree(redo)
    redo.mkdir()
    # stash current state for redo
    (redo / "meta.json").write_text(_layout_meta(clip))
    for p in clip.clip_dir.glob(f"*.{clip.img_type}"):
        os.link(p, redo / p.name)
        p.unlink()
    if clip.audio_path.exists():
        shutil.move(str(clip.audio_path), redo / "audio")
    # restore the snapshot
    meta = json.loads((d / "meta.json").read_text())
    for p in d.glob(f"*.{clip.img_type}"):
        os.link(p, clip.clip_dir / p.name)
    if (d / "audio").exists():
        shutil.copy2(d / "audio", clip.audio_path)
    clip.frames = meta["frames"]
    clip.frame_index = (np.asarray(meta["frame_index"], np.int32)
                        if meta["frame_index"] is not None else None)
    clip.achans, clip.arate = meta["achans"], meta["arate"]
    clip.version += 1
    clip.save_header()
    shutil.rmtree(d)
    shutil.move(str(redo), d)   # swap: next undo_edit redoes
    return True
