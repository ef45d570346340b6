"""Batch event-list renderer: the main path.

Counterpart of `lives_tpu/events/renderer.py:41-301` (reference
`render_events`, src/events.c:3802). The event list is segmented at
filter-map boundaries; within a segment the chain is static, so whole frame
chunks run through one `FrameGraph.run_batch` call each, with per-frame
parameter values interpolated on the host into ``(B,)`` arrays.

A segment's `FrameGraph` lives across its chunks, so a stateful chain's
state carries from one chunk to the next, as in the JAX package.
`ClipFrameSource` and `render_recording` (`renderer.py:304-346`) render
decoded clips: each track's chunk of frames is read on the host, uploaded
once and converted on the source's device (K2 for YUV420P clips). The
channel wiring a recorded take carries on its init events (`cconx` props,
`player._annotate_rec_cconx`) becomes the segment graph's cconx
(`_cconx_for`), so a re-render re-applies the performance's wiring.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Iterator, Protocol, Sequence

import numpy as np
import torch

from ..diagnostics import span
from ..effects.host import DEFERRED, Instance, get_filter
from ..graph.nodemodel import _STATIC_KINDS, FrameGraph, SinkSpec
from ..layer import Layer, _plane_shapes, layer_blank
from ..ops.colorspace import convert_layer
from .event_list import (Event, EventList, EventType, TICKS_PER_SECOND,
                         is_audio_terminator)


class FrameSource(Protocol):
    """Supplies source layers per (clip, frame). The batch form returns a
    Layer whose planes carry a leading batch axis."""

    def get_batch(self, clip_ids: Sequence[int],
                  frame_nums: Sequence[int]) -> Layer: ...


@dataclass
class Segment:
    """A run of FRAME events under one constant filter map."""
    frames: list[Event]
    inits: list[Event]       # active FILTER_INIT events, application order


def segment_events(el: EventList) -> list[Segment]:
    """Split the timeline at filter-map changes, track-pattern changes and
    STATIC-kind PARAM_CHANGEs, in one pass over the sorted events
    (`lives_tpu/events/renderer.py:41`)."""
    segs: list[Segment] = []
    cur: list[Event] = []
    cur_ids: tuple | None = None
    cur_clips: tuple | None = None
    cur_snapshot: list[Event] = []
    inits_by_id: dict[str, Event] = {}
    order: list[str] | None = None
    pending_split = False
    kind_cache: dict[tuple[str, str], str] = {}
    # DEINITs rank AFTER the FRAME at the same tc, but a frame at that tc
    # already sees the init inactive
    INF = float("inf")
    deinit_tc: dict[str, int] = {}
    for e in el.events:
        if e.type == EventType.FILTER_DEINIT:
            d = e.props.get("init_event")
            if d is not None and d not in deinit_tc:
                deinit_tc[d] = e.tc

    def active_list(tc):
        alive = {k: v for k, v in inits_by_id.items()
                 if deinit_tc.get(k, INF) > tc}
        if order is not None:
            out = [alive[i] for i in order if i in alive]
            out += [v for k, v in alive.items() if k not in order]
            return out
        return list(alive.values())

    def static_change(e) -> bool:
        init = inits_by_id.get(e.props.get("init_event"))
        if init is None:
            return False
        key = (init.props["filter"], e.props["param"])
        if key not in kind_cache:
            try:
                kind_cache[key] = get_filter(key[0]).param(key[1]).kind
            except KeyError:
                kind_cache[key] = "num"
        return kind_cache[key] in _STATIC_KINDS

    for e in el.events:
        if e.type == EventType.FILTER_INIT:
            if e.props.get("audio"):
                continue  # audio filters mix in the audio path
            inits_by_id[e.event_id] = e
        elif e.type == EventType.FILTER_MAP:
            order = e.props.get("init_events")
        elif e.type == EventType.PARAM_CHANGE and static_change(e):
            pending_split = True
        elif e.type == EventType.FRAME:
            act = active_list(e.tc)
            ids = tuple(i.event_id for i in act)
            clips = tuple(e.clips)
            if cur and (ids != cur_ids or clips != cur_clips
                        or pending_split):
                segs.append(Segment(frames=cur, inits=cur_snapshot))
                cur = []
            if not cur:
                cur_snapshot = act
                cur_ids, cur_clips = ids, clips
            pending_split = False
            cur.append(e)
    if cur:
        segs.append(Segment(frames=cur, inits=cur_snapshot))
    return segs


def _chain_for(inits: list[Event], el: EventList,
               start_tc: int | None = None
               ) -> "tuple[list[Event], list[Instance]]":
    """Instances for a segment's active inits, aligned pairwise with the
    inits kept (`lives_tpu/events/renderer.py:122`). A filter neither
    registry holds (an imported reference layout naming a plugin the JAX
    package does not ship) is skipped with a warning, as the JAX package
    skips it. A filter the JAX package registers and the port defers
    (`DEFERRED`) raises naming its item: skipping it would render
    something else than the reference."""
    kept, chain = [], []
    for init in inits:
        if init.props.get("audio"):
            continue  # audio-only filters (avol) mix in the audio path
        name = init.props["filter"]
        try:
            f = get_filter(name)
        except KeyError:
            if name in DEFERRED:
                raise NotImplementedError(
                    f"filter {name!r} is not ported yet ({DEFERRED[name]})"
                ) from None
            warnings.warn(f"skipping unknown filter {name!r} "
                          "(not in the registry)")
            continue
        values = dict(init.props.get("values", {}))
        if start_tc is not None:
            # fold in recorded STATIC-kind param changes effective at the
            # segment start (traced kinds interpolate per frame instead)
            for e in el.events:
                if e.tc > start_tc:
                    break
                if (e.type == EventType.PARAM_CHANGE
                        and e.props.get("init_event") == init.event_id):
                    try:
                        kind = f.param(e.props["param"]).kind
                    except KeyError:
                        continue
                    if kind in _STATIC_KINDS:
                        values[e.props["param"]] = e.props["value"]
        inst = Instance(filter=f, values=values,
                        in_tracks=tuple(init.props.get("in_tracks", (0,))),
                        out_tracks=tuple(init.props.get("out_tracks", (0,))))
        kept.append(init)
        chain.append(inst)
    return kept, chain


def _cconx_for(kept: list[Event]) -> list[tuple]:
    """The channel wiring recorded on init events
    (`lives_tpu/events/renderer.py:167-180`): [[src_init_event_id,
    out_channel, slot], ...] on the destination's init -> (src_idx, name,
    dst_idx, slot) over the kept chain, forward edges only."""
    idx = {init.event_id: i for i, init in enumerate(kept)}
    edges = []
    for di, init in enumerate(kept):
        for src_eid, name, slot in init.props.get("cconx", ()):
            si = idx.get(src_eid)
            if si is not None and si < di:
                edges.append((si, name, di, slot))
    return edges


def _interp_arrays(el: EventList, inits: list[Event],
                   chain: list[Instance], tcs: list[int]):
    """Per-instance dicts of per-frame traced param arrays (host numpy),
    pchains evaluated with np.interp for the whole chunk
    (`lives_tpu/events/renderer.py:183`)."""
    tcs_arr = np.asarray(tcs, np.float64)
    pchains: dict[tuple[str, str], list] = {}
    for e in el.events:
        if e.type == EventType.PARAM_CHANGE:
            pchains.setdefault(
                (e.props["init_event"], e.props["param"]), []).append(
                (e.tc, e.props["value"]))
    out = []
    for init, inst in zip(inits, chain):
        d = {}
        for p in inst.filter.params:
            if p.kind in _STATIC_KINDS:
                continue
            base = init.props.get("values", {}).get(p.name, p.default)
            chain_pts = pchains.get((init.event_id, p.name))
            if not chain_pts:
                d[p.name] = np.full(len(tcs), base, np.float32)
                continue
            numeric = all(isinstance(v, (int, float))
                          for _, v in chain_pts)
            if not numeric:
                vals = [el.interp_param(init, p.name, tc) for tc in tcs]
                d[p.name] = np.asarray(vals, np.float32)
                continue
            xp = np.asarray([init.tc] + [t for t, _ in chain_pts],
                            np.float64)
            fp = np.asarray([base if base is not None
                             else chain_pts[0][1]]
                            + [v for _, v in chain_pts], np.float64)
            # np.interp needs increasing xp; an init-time change (same tc)
            # must win over the base value
            keep = np.concatenate([xp[1:] > xp[:-1], [True]])
            d[p.name] = np.interp(tcs_arr, xp[keep],
                                  fp[keep]).astype(np.float32)
        out.append(d)
    return out


def render_events(el: EventList, source, sink: SinkSpec | None = None,
                  batch_size: int = 32, fps: float | None = None
                  ) -> Iterator[tuple[list[int], Layer]]:
    """Render an event list; yields (tc_list, batched output Layer) chunks
    on the source's device (`lives_tpu/events/renderer.py:232`)."""
    fps = fps or el.fps
    sink = sink or SinkSpec(width=el.width, height=el.height)
    # spans close before each `yield`: a consumer's work between chunks
    # is never put down to the renderer
    with span("lives.render.segment"):
        segs = segment_events(el)
    if segs and is_audio_terminator(segs[-1].frames[-1]):
        # a trailing audio terminator bounds the timeline's audio; it is
        # not a frame of video content
        segs[-1].frames.pop()
        if not segs[-1].frames:
            segs.pop()
    for seg in segs:
        with span("lives.render.chain"):
            inits, chain = _chain_for(seg.inits, el, seg.frames[0].tc)
            graph = FrameGraph(chain, sink, fps=fps,
                               cconx=_cconx_for(inits))
        n_tracks = max((len(f.clips) for f in seg.frames), default=0)
        for ofs in range(0, len(seg.frames), batch_size):
            with span("lives.render.chunk"):
                chunk = seg.frames[ofs: ofs + batch_size]
                tcs = [f.tc for f in chunk]
                # int64: FRAME events recorded from live playback carry
                # 63-bit clip unique_ids
                cids = np.full((n_tracks, len(chunk)), -1, np.int64)
                fnums = np.zeros((n_tracks, len(chunk)), np.int64)
                for j, f in enumerate(chunk):
                    for t in range(min(n_tracks, len(f.clips))):
                        cids[t, j] = f.clips[t]
                        fnums[t, j] = f.frames[t]
                params = _interp_arrays(el, inits, chain, tcs)
                tcs_s = np.asarray(tcs, np.float64) / TICKS_PER_SECOND
                frame_idx = np.asarray(
                    [round(tc * fps / TICKS_PER_SECOND) for tc in tcs],
                    np.int32)
                traced = hasattr(source, "traced_layer")
                if not traced:
                    layers = [source.get_batch(list(cids[t]),
                                               list(fnums[t]))
                              for t in range(n_tracks)]
            if traced:
                # generation is the plan's LOAD step (one call per chunk)
                out = graph.run_batch([], tcs_s.astype(np.float32),
                                      frame_idx, params, source=source,
                                      src_args=(cids, fnums))
            else:
                out = graph.run_batch(layers, tcs_s.astype(np.float32),
                                      frame_idx, params)
            yield tcs, out


def render_to_arrays(el: EventList, source, sink: SinkSpec | None = None,
                     batch_size: int = 32,
                     progress_cb=None) -> tuple[np.ndarray, list[int]]:
    """Render everything; return (stacked host frames, tcs)
    (`lives_tpu/events/renderer.py:288`)."""
    outs, all_tcs = [], []
    for tcs, lay in render_events(el, source, sink, batch_size):
        outs.append(lay.planes[0].cpu().numpy())
        all_tcs.extend(tcs)
        if progress_cb is not None:
            progress_cb(len(all_tcs))
    return np.concatenate(outs, 0), all_tcs


class ClipFrameSource:
    """FrameSource over decoded clips keyed by the unique_ids that live
    recordings store in FRAME events (`renderer.py:304`; reference
    deal_with_render_choice, events.c:5955). Frames come out in `palette`
    (RGB24 by default) on `device`.

    `get_batch` reads a track's chunk on the host straight into one stacked
    array a plane, uploads each plane once and converts the chunk once on
    the device: one K2 launch a track a chunk for YUV420P clips on a CUDA
    device. A chunk whose frames differ in palette or geometry converts
    frame by frame, still on the device. A clip id the source lacks gives a
    blank frame (`layer_blank`) at the first clip's geometry. Clip ids are
    compared as Python ints (63-bit unique_ids)."""

    def __init__(self, clips_by_uid: dict, palette: int | None = None, *,
                 device: torch.device | str):
        from ..constants import Palette
        self.clips = {int(k): c for k, c in clips_by_uid.items()}
        self.palette = palette or int(Palette.RGB24)
        self.device = torch.device(device)

    def _blank(self) -> Layer:
        ref = next(iter(self.clips.values()), None)
        return layer_blank(getattr(ref, "width", 64),
                           getattr(ref, "height", 64), self.palette,
                           device=self.device)

    def get_batch(self, clip_ids, frame_nums) -> Layer:
        clips = [self.clips.get(int(c)) for c in clip_ids]
        nums = [int(f) for f in frame_nums]
        # a clip-like without `frame_config` (a generator clip, a test's
        # in-memory clip) goes frame by frame
        configs = {getattr(c, "frame_config", lambda f: None)(f)
                   for c, f in zip(clips, nums) if c is not None}
        if len(configs) == 1 and None not in configs:
            out = self._chunk(clips, nums, *configs.pop())
            if out is not None:
                return out
        return self._frame_by_frame(clips, nums)

    def _chunk(self, clips, nums, pal, w, h, clamping, subspace, gamma):
        """The chunk read into stacked host planes, one upload a plane, one
        conversion; None when the blank frames' planes do not fit it."""
        B = len(clips)
        host = [np.zeros((B,) + s, np.uint8) for s in _plane_shapes(pal, w, h)]
        for j, (c, f) in enumerate(zip(clips, nums)):
            if c is not None:
                c.get_frame(f, out=tuple(p[j] for p in host))
        lay = Layer(planes=tuple(torch.from_numpy(p).to(self.device)
                                 for p in host),
                    palette=pal, clamping=clamping, subspace=subspace,
                    gamma=gamma)
        planes = convert_layer(lay, self.palette).planes
        blank_rows = [j for j, c in enumerate(clips) if c is None]
        if blank_rows:
            blank = self._blank().planes
            if [tuple(b.shape) for b in blank] != \
                    [tuple(p.shape[1:]) for p in planes]:
                return None
            for p, b in zip(planes, blank):
                p[blank_rows] = b
        return Layer(planes=planes, palette=self.palette)

    def _frame_by_frame(self, clips, nums) -> Layer:
        """Each frame uploaded and converted on its own (`renderer.py:
        324-336`), then stacked on the device."""
        frames = []
        for c, f in zip(clips, nums):
            if c is None:
                frames.append(self._blank())
                continue
            lay = c.get_frame(f)
            lay = lay.replace(planes=tuple(p.to(self.device)
                                           for p in lay.planes))
            frames.append(convert_layer(lay, self.palette))
        return Layer(planes=tuple(torch.stack([fr.planes[i] for fr in frames])
                                  for i in range(len(frames[0].planes))),
                     palette=self.palette)


def render_recording(el: EventList, clips_by_uid: dict,
                     sink: SinkSpec | None = None, fps: float | None = None,
                     batch_size: int = 32, *,
                     device: torch.device | str):
    """Render a recorded performance (quantised to its fps grid) against
    the clips it referenced, on `device` (`renderer.py:339`). Returns
    (host frames array, tcs)."""
    q = el.quantise(fps or el.fps or 25.0)
    src = ClipFrameSource(clips_by_uid, device=device)
    return render_to_arrays(q, src, sink, batch_size)
