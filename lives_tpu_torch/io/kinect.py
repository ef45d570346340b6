"""The `depth_key` filter: depth-window keying of an RGB frame by a
connected AFLOAT depth channel.

Counterpart of `lives_tpu/io/kinect.py:165-212` (reference
`lives-plugins/weed-plugins/freenect.c:276-300`, the keying loop): every
pixel whose depth lies outside [minthresh, maxthresh) becomes the solid
colour with alpha 0. The depth plane is [0, 1] by the AFLOAT convention
(millimetres / 65536); the thresholds stay in millimetres and rescale
here. Unconnected, the frame passes through.

The freenect camera and the Kinect clip (`KinectCamera`, `KinectClip`,
`:56-162`) come with ROADMAP Queue 1 item 23, the host surfaces: here
they raise naming it.
"""

from __future__ import annotations

import torch

from ..constants import Palette
from ..effects.host import ChannelTemplate, Filter, Param, register_filter
from ..effects.util import bparam, split_alpha, to_f01

KINECT_W, KINECT_H = 640, 480
_DEPTH_MAX = 65536
_ITEM23 = ("the freenect camera and the Kinect clip are not ported yet "
           "(ROADMAP Queue 1 item 23)")


def load_freenect():
    raise NotImplementedError(_ITEM23)


class KinectCamera:
    def __init__(self, *a, **kw):
        raise NotImplementedError(_ITEM23)


class KinectClip:
    def __init__(self, *a, **kw):
        raise NotImplementedError(_ITEM23)


def _depth_key_process(ins, p, ctx):
    lay = ins[0]
    depth_lay = ins[1] if len(ins) > 1 else None
    if depth_lay is None:
        return lay
    rgb, _ = split_alpha(to_f01(lay))
    d = depth_lay.planes[0].to(torch.float32)[:, None]
    cut = (d >= bparam(p["maxthresh"]) * (1.0 / _DEPTH_MAX)) \
        | (d < bparam(p["minthresh"]) * (1.0 / _DEPTH_MAX))
    col = torch.stack(torch.broadcast_tensors(*(
        torch.as_tensor(p[c], dtype=torch.float32, device=rgb.device)
        .reshape(-1) for c in ("ccol_r", "ccol_g", "ccol_b"))), 1)
    out = torch.where(cut, col[:, :, None, None], rgb)
    alpha = torch.where(cut, 0.0, 1.0)
    arr = torch.cat([out, alpha], 1)
    return lay.replace(
        planes=(torch.clamp(arr * 255.0 + 0.5, 0, 255).to(torch.uint8),),
        palette=int(Palette.RGBA32))


register_filter(Filter(
    name="depth_key", process=_depth_key_process,
    in_channels=(ChannelTemplate("in", (Palette.RGB24, Palette.RGBA32)),),
    alpha_ins=(ChannelTemplate("depth", (Palette.AFLOAT,), optional=True),),
    params=(Param("minthresh", "num", 0.0, 0.0, float(_DEPTH_MAX)),
            Param("maxthresh", "num", float(_DEPTH_MAX), 0.0,
                  float(_DEPTH_MAX)),
            Param("ccol_r", "num", 0.0, 0.0, 1.0),
            Param("ccol_g", "num", 0.0, 0.0, 1.0),
            Param("ccol_b", "num", 0.0, 0.0, 1.0)),
    description="depth-window keying (freenect.c:276 keying loop) "
                "for any RGB + AFLOAT depth pair"))
