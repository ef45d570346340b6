"""Video resampling: clip fps changes by frame reordering
(reference `src/resample.c`: `reorder_frames` :2408, `deorder_frames` :2533;
event-list quantisation lives in events/event_list.py `quantise`).

Counterpart of `lives_tpu/resample.py:1-83`, host Python copied: a
resample moves no pixel, so it takes no device.

Virtual (decoder-backed) frames retime by frame-index rewrite — no pixel
data moves. Image-backed frames are re-ordered physically like the
reference, but with hardlinks where possible instead of copies.
"""

from __future__ import annotations

import os
import shutil
import numpy as np

from .io.clips import Clip


def _apply_order(clip: Clip, src: np.ndarray):
    """Rewrite the clip so that new frame i shows old frame src[i]."""
    old_index = clip.frame_index if clip.frame_index is not None \
        else np.full(clip.frames, -1, np.int32)
    new_index = old_index[src].astype(np.int32)

    if (new_index < 0).any():
        # physically re-lay image files in the new order (reorder_frames);
        # hardlink when the fs allows, copy otherwise
        tmp = []
        for i, s in enumerate(src):
            if old_index[s] >= 0:
                tmp.append(None)
                continue
            old_path = clip.image_path(int(s))
            new_name = clip.clip_dir / f".reorder_{i + 1:08d}.{clip.img_type}"
            try:
                os.link(old_path, new_name)
            except OSError:
                shutil.copy2(old_path, new_name)
            tmp.append(new_name)
        # remove old images, move new ones into place
        for n in range(clip.frames):
            if old_index[n] < 0:
                p = clip.image_path(n)
                if p.exists():
                    p.unlink()
        for i, t in enumerate(tmp):
            if t is not None:
                t.rename(clip.clip_dir / f"{i + 1:08d}.{clip.img_type}")

    clip.frame_index = new_index
    clip.frames = len(src)
    clip.version += 1
    clip.save_header()


def resample_clip_fps(clip: Clip, new_fps: float) -> int:
    """Retime the clip to new_fps by duplicating/dropping frames
    (nearest-frame policy, resample.c reorder_frames). Returns new count."""
    if clip.fps <= 0 or new_fps <= 0:
        raise ValueError("fps must be positive")
    old_n = clip.frames
    new_n = max(1, int(round(old_n * new_fps / clip.fps)))
    # centre-aligned nearest sampling: output interval i covers source
    # time ((i+0.5)/new_fps), so 2x upsampling yields clean frame pairs
    src = np.minimum(((np.arange(new_n) + 0.5) * clip.fps / new_fps)
                     .astype(np.int64), old_n - 1)
    _apply_order(clip, src)
    clip.fps = new_fps
    clip.save_header()
    return new_n


def reverse_clip(clip: Clip):
    """Reverse playback order."""
    _apply_order(clip, np.arange(clip.frames)[::-1].copy())


def speed_change(clip: Clip, factor: float) -> int:
    """Constant-speed change: keeps all frames, rescales fps (the
    reference's 'change fps without resampling')."""
    clip.fps = clip.fps * factor
    clip.save_header()
    return clip.frames
