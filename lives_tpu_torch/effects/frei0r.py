"""frei0r bridge: host frei0r 1.x video plugins as filters.

Counterpart of `lives_tpu/effects/frei0r.py:65-181` (reference
`lives-plugins/weed-plugins/frei0r.c`). A pure-ctypes frei0r host:
`scan_plugins` reads $FREI0R_PATH (default /usr/lib/frei0r-1), and the
registry stays empty where no plugin is found. `register_frei0r_filters`
wraps each filter plugin as a host `Filter` named `f0r_<name>`: its
RGBA32 frames cross to the host in one copy a call (a chunk's frames
together), go through the plugin frame by frame, and come back as a
layer on the input layer's device.

A bridged filter runs in every route of the port, since the port's
chains run eagerly: `apply_instance`, `FrameGraph.run`, `run_batch`, the
renderer and the player. The fused kernels never take one (their op
tables hold no `f0r_` name, so the plan falls to the plain chain). The
JAX package's jitted routes hand the plugin a tracer and raise
`TypeError` (ROADMAP Queue 3); only its eager `apply_instance` runs one,
which is what the port's routes compute frame for frame. A float RGB
layer (the chain's float dtype between effects) goes to RGBA32 before the
plugin; the JAX host casts its floats to bytes, which truncates them
(ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

# plugin_type
F0R_PLUGIN_TYPE_FILTER = 0
F0R_PLUGIN_TYPE_SOURCE = 1
F0R_PLUGIN_TYPE_MIXER2 = 2
F0R_PLUGIN_TYPE_MIXER3 = 3

# colour models
F0R_COLOR_MODEL_BGRA8888 = 0
F0R_COLOR_MODEL_RGBA8888 = 1
F0R_COLOR_MODEL_PACKED32 = 2

F0R_PARAM_BOOL = 0
F0R_PARAM_DOUBLE = 1
F0R_PARAM_COLOR = 2
F0R_PARAM_POSITION = 3
F0R_PARAM_STRING = 4


class F0rPluginInfo(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p),
                ("author", ctypes.c_char_p),
                ("plugin_type", ctypes.c_int),
                ("color_model", ctypes.c_int),
                ("frei0r_version", ctypes.c_int),
                ("major_version", ctypes.c_int),
                ("minor_version", ctypes.c_int),
                ("num_params", ctypes.c_int),
                ("explanation", ctypes.c_char_p)]


class F0rParamInfo(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p),
                ("type", ctypes.c_int),
                ("explanation", ctypes.c_char_p)]


@dataclass
class Frei0rPlugin:
    path: str
    name: str
    plugin_type: int
    color_model: int
    params: list[tuple[str, int]]


def search_paths() -> list[Path]:
    env = os.environ.get("FREI0R_PATH",
                         "/usr/lib/frei0r-1:/usr/local/lib/frei0r-1")
    return [Path(p) for p in env.split(":") if Path(p).is_dir()]


def scan_plugins() -> list[Frei0rPlugin]:
    out = []
    for d in search_paths():
        for so in sorted(d.glob("*.so")):
            try:
                lib = ctypes.CDLL(str(so))
                lib.f0r_init()
                info = F0rPluginInfo()
                lib.f0r_get_plugin_info(ctypes.byref(info))
            except (OSError, AttributeError):
                continue
            params = []
            for i in range(info.num_params):
                pi = F0rParamInfo()
                lib.f0r_get_param_info(ctypes.byref(pi), i)
                params.append((pi.name.decode("utf-8", "replace"), pi.type))
            out.append(Frei0rPlugin(str(so),
                                    info.name.decode("utf-8", "replace"),
                                    info.plugin_type, info.color_model,
                                    params))
    return out


class Frei0rInstance:
    """A constructed frei0r effect processing RGBA uint8 frames."""

    def __init__(self, plugin: Frei0rPlugin, width: int, height: int):
        self.plugin = plugin
        self.width, self.height = width, height
        self.lib = ctypes.CDLL(plugin.path)
        self.lib.f0r_construct.restype = ctypes.c_void_p
        self.lib.f0r_init()
        self.handle = self.lib.f0r_construct(width, height)

    def set_param_double(self, index: int, value: float):
        d = ctypes.c_double(value)
        self.lib.f0r_set_param_value(ctypes.c_void_p(self.handle),
                                     ctypes.byref(d), index)

    def update(self, frame_rgba: np.ndarray, t: float = 0.0,
               frame2: np.ndarray | None = None) -> np.ndarray:
        """frame_rgba: (H, W, 4) uint8 -> processed (H, W, 4)."""
        inp = np.ascontiguousarray(frame_rgba, np.uint8)
        out = np.empty_like(inp)
        pi = inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        po = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        if self.plugin.plugin_type == F0R_PLUGIN_TYPE_MIXER2 \
                and frame2 is not None:
            p2 = np.ascontiguousarray(frame2, np.uint8).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint32))
            self.lib.f0r_update2(ctypes.c_void_p(self.handle),
                                 ctypes.c_double(t), pi, p2, None, po)
        else:
            self.lib.f0r_update(ctypes.c_void_p(self.handle),
                                ctypes.c_double(t), pi, po)
        return out

    def close(self):
        if self.handle:
            self.lib.f0r_destruct(ctypes.c_void_p(self.handle))
            self.handle = None


def _per_frame(v, b: int) -> float:
    """Frame b's value of a scalar or a (B,) per-frame parameter."""
    if isinstance(v, torch.Tensor):
        return float(v.reshape(-1)[b if v.numel() > 1 else 0])
    return float(v)


def register_frei0r_filters() -> int:
    """Wrap every discovered frei0r filter as a host Filter. Returns the
    count. Bridged names are prefixed 'f0r_'."""
    from ..constants import Palette
    from ..layer import Layer
    from ..ops.colorspace import convert_layer
    from .host import ChannelTemplate, Filter, Param, register_filter

    n = 0
    for plug in scan_plugins():
        if plug.plugin_type not in (F0R_PLUGIN_TYPE_FILTER,):
            continue
        doubles = [(i, nm) for i, (nm, t) in enumerate(plug.params)
                   if t == F0R_PARAM_DOUBLE]

        def mk_process(plug=plug, doubles=doubles):
            insts: dict = {}

            def process(ins, p, ctx):
                # a float RGB layer satisfies the RGBA32 template in
                # negotiation (`effects.host.negotiate_layer`): the plugin
                # takes bytes, so it goes to RGBA32 on its device first
                lay = convert_layer(ins[0], Palette.RGBA32)
                key = (lay.width, lay.height)
                inst = insts.get(key)
                if inst is None:
                    inst = Frei0rInstance(plug, lay.width, lay.height)
                    insts[key] = inst
                planes = lay.planes[0]
                batched = planes.dim() == 4
                x = planes if batched else planes[None]
                # one device -> host copy of the frames, (B, H, W, C)
                arr = x.movedim(1, -1).contiguous().cpu().numpy()
                outs = []
                for b in range(arr.shape[0]):
                    for i, nm in doubles:
                        inst.set_param_double(i, _per_frame(p[nm], b))
                    outs.append(inst.update(arr[b], _per_frame(ctx.tc, b)))
                out = torch.from_numpy(np.stack(outs)).movedim(-1, 1) \
                    .contiguous().to(lay.device)
                return Layer(planes=(out if batched else out[0],),
                             palette=int(Palette.RGBA32), gamma=lay.gamma)
            return process

        register_filter(Filter(
            name=f"f0r_{plug.name.lower().replace(' ', '_')}",
            process=mk_process(),
            in_channels=(ChannelTemplate("in", (Palette.RGBA32,)),),
            params=tuple(Param(nm, "num", 0.5, 0.0, 1.0)
                         for _, nm in doubles),
            description=f"frei0r: {plug.name}"))
        n += 1
    return n
