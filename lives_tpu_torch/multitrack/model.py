"""Headless multitrack editor model.

Counterpart of `lives_tpu/multitrack/model.py:1-1004`, copied (host
Python over the port's event lists; importing it would import the JAX
package): the same edits write the same event list, byte for byte in
JSON and in the binary Weed format. `render` hands the timeline to the
port's `render_to_arrays` on the source's device (K1 for a
`DeviceSyntheticSource` on a CUDA device); `render_audio` mixes through
the port's `audio.engine`.

Successor of the reference multitrack engine (`src/multitrack.c`, 20k LoC of
which ~15k is GTK UI). The key design fact carries over exactly
(multitrack.h:756-773): a *block* is only a **view** — the event list is the
single source of truth and every edit is an event-list rewrite. Undo is a
bounded ring of serialized event lists (the reference's snapshot model).

The timeline is a frame grid at the event list's fps (the reference
quantises inserted clips to the timeline fps too, via resample.c).

Audio model (reference events.c:1251 insert_audio_event_at): FRAME events
carry sparse per-track audio *transitions* as flat pairs —
``audio_clips = [track, clip, ...]`` and ``audio_seeks = [seek, vel, ...]``
— a state machine: an entry switches that track's audio to play `clip`
from `seek` seconds at velocity `vel` until the next entry; vel == 0 or
clip < 0 means off (audio.c:3656 records off as vel 0). Backing audio
tracks use negative indices (-1 = first), video tracks >= 0 carry their
own audio (events.c:2653 avol in_tracks layout). Per-track volume is the
avol filter model: one FILTER_INIT spanning the timeline whose
multi-valued "volume" param is keyframed via PARAM_CHANGE pchains
(events.c:2636 add_track_to_avol_init, mixed at audio.c:1686).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from ..events.event_list import (EventList, EventType, TICKS_PER_SECOND,
                                 filter_deinit_event, filter_init_event,
                                 filter_map_event, frame_event,
                                 get_audio_entry, param_change_event,
                                 remove_audio_entry, set_audio_entry)


class Gravity(enum.IntEnum):
    """multitrack.h:113-117 lives_mt_grav_mode_t."""
    NORMAL = 0
    LEFT = 1
    RIGHT = 2


class InsertMode(enum.IntEnum):
    """multitrack.h:103-111 lives_mt_insert_mode_t (reference ordinals;
    AMATCH/FLEX are unimplemented there too)."""
    NORMAL = 0      # only insert if it fits (clipped to the free gap)
    OVERWRITE = 2   # overwrite existing blocks
    FILL = 4        # fill the gap / selection (side picked by gravity)


@dataclass(frozen=True)
class Block:
    """A contiguous run of one clip on one track — a view, never stored."""
    track: int
    start: int          # timeline frame index
    length: int
    clip: int
    offset: int         # first clip frame used

    @property
    def end(self) -> int:
        return self.start + self.length


@dataclass(frozen=True)
class AudioBlock:
    """A backing-audio-track block view (multitrack.c audio block model):
    derived from the sparse audio-transition state machine."""
    track: int          # negative: -1 = first backing audio track
    start: int          # timeline frame index
    length: int
    clip: int
    seek: float         # clip audio start, seconds
    vel: float = 1.0

    @property
    def end(self) -> int:
        return self.start + self.length


class Multitrack:
    def __init__(self, fps: float = 25.0, width: int = 1920,
                 height: int = 1080, n_tracks: int = 2,
                 n_audio_tracks: int = 1, undo_depth: int = 32):
        self.el = EventList(fps=fps, width=width, height=height)
        self.n_tracks = n_tracks
        # backing audio tracks (negative indices -1..-n); reference default
        # is one (multitrack.c opts.back_audio_tracks)
        self.n_audio_tracks = n_audio_tracks
        self.gravity = Gravity.NORMAL
        self.insert_mode = InsertMode.NORMAL
        # multitrack autotransition (mt->opts.atrans_fx; liblives
        # multitrack::setAutoTransition): inserting a block that overlaps
        # a neighbouring track auto-adds this transition over the
        # overlap, with its blend ramped across it
        self.autotrans_filter: Optional[str] = None
        # region selection (multitrack.c region model): (tracks, start, end)
        self.sel_tracks: list[int] = []
        self.sel_start: int = 0
        self.sel_end: int = 0
        self._avol_id: Optional[str] = None
        self._undo: list[str] = []
        self._redo: list[str] = []
        self._undo_depth = undo_depth

    # -- grid helpers ------------------------------------------------------
    def _tpf(self) -> float:
        return TICKS_PER_SECOND / self.el.fps

    def frame_tc(self, i: int) -> int:
        return int(round(i * self._tpf()))

    def tc_frame(self, tc: int) -> int:
        return int(round(tc / self._tpf()))

    def _frame_event_at(self, i: int):
        return self.el.get_frame_event_at(self.frame_tc(i), exact=True)

    def _ensure_frame_event(self, i: int):
        e = self._frame_event_at(i)
        if e is None:
            e = frame_event(self.frame_tc(i), [-1] * self.n_tracks,
                            [0] * self.n_tracks)
            self.el.insert(e)
        # widen track arrays if needed
        while len(e.props["clips"]) < self.n_tracks:
            e.props["clips"].append(-1)
            e.props["frames"].append(0)
        return e

    @staticmethod
    def _has_video(e) -> bool:
        return any(c >= 0 for c in e.props.get("clips", []))

    @staticmethod
    def _audio_off_only(e) -> bool:
        """True if the event's audio entries are all off markers."""
        ac = e.props.get("audio_clips") or []
        asx = e.props.get("audio_seeks") or []
        if not ac:
            return False
        for i in range(0, len(ac) - 1, 2):
            vel = asx[i + 1] if i + 1 < len(asx) else 1.0
            if ac[i + 1] >= 0 and vel != 0.0:
                return False
        return True

    @property
    def n_frames(self) -> int:
        evs = self.el.frame_events()
        if not evs:
            return 0
        last = evs[-1]
        i = self.tc_frame(last.tc)
        # a trailing pure audio terminator bounds the timeline, it is not
        # a frame of content
        if not self._has_video(last) and self._audio_off_only(last):
            return i
        return i + 1

    # -- undo (bounded event-list snapshots) -------------------------------
    def _checkpoint(self):
        self._undo.append(self.el.to_json())
        if len(self._undo) > self._undo_depth:
            self._undo.pop(0)
        self._redo.clear()

    def undo(self) -> bool:
        if not self._undo:
            return False
        self._redo.append(self.el.to_json())
        self.el = EventList.from_json(self._undo.pop())
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        self._undo.append(self.el.to_json())
        self.el = EventList.from_json(self._redo.pop())
        return True

    # -- track ops ---------------------------------------------------------
    def add_track(self) -> int:
        self.n_tracks += 1
        self._avol_add_track()
        return self.n_tracks - 1

    def add_audio_track(self) -> int:
        """Add a backing audio track; returns its (negative) index."""
        self.n_audio_tracks += 1
        self._avol_add_track()
        return -self.n_audio_tracks

    # -- selection (region ops operate on it) ------------------------------
    def select_region(self, tracks: Sequence[int], start: int, end: int):
        self.sel_tracks = list(tracks)
        self.sel_start, self.sel_end = int(start), int(end)

    def clear_selection(self):
        self.sel_tracks, self.sel_start, self.sel_end = [], 0, 0

    # -- block geometry helpers --------------------------------------------
    def _occupied(self, track: int) -> list[tuple[int, int]]:
        """Sorted [start, end) occupied intervals on a track."""
        return [(b.start, b.end) for b in self.blocks(track)]

    def _gap_at(self, track: int, i: int) -> tuple[int, int]:
        """The free interval [lo, hi) containing frame i (hi may be a
        large sentinel when the gap is unbounded to the right)."""
        lo, hi = 0, 1 << 40
        for s, e in self._occupied(track):
            if e <= i:
                lo = max(lo, e)
            elif s > i:
                hi = min(hi, s)
                break
            else:                      # i inside a block: zero gap
                return (i, i)
        return (lo, hi)

    # -- block ops (all are event-list rewrites) ---------------------------
    def insert_block(self, track: int, clip: int, start: int, length: int,
                     offset: int = 0, with_audio: bool = True,
                     mode: InsertMode | None = None) -> Optional[Block]:
        """Place clip frames on a track (multitrack.c insert handlers).

        Honours ``self.gravity`` (NORMAL = at `start`; LEFT = snap back
        against the previous block; RIGHT = snap forward so the block ends
        flush against the next block) and the insert mode (NORMAL fits
        into the free gap, clipping the length; OVERWRITE replaces;
        FILL fills the gap/selection). Returns the Block view, or None if
        nothing could be inserted. ``with_audio`` writes the clip's audio
        transitions alongside (reference mt->opts.insert_audio)."""
        mode = self.insert_mode if mode is None else mode
        if track < 0:
            raise ValueError("use insert_audio_block for audio tracks")
        start = max(0, int(start))
        length = int(length)
        if self.gravity == Gravity.LEFT:
            prev = [b for b in self.blocks(track) if b.end <= start]
            start = prev[-1].end if prev else 0
        elif self.gravity == Gravity.RIGHT:
            nxt = [b for b in self.blocks(track) if b.start >= start]
            if nxt:
                prev = [b for b in self.blocks(track)
                        if b.end <= nxt[0].start]
                floor = prev[-1].end if prev else 0
                start = max(floor, nxt[0].start - length)
        if mode == InsertMode.NORMAL:
            lo, hi = self._gap_at(track, start)
            if hi <= start:
                return None
            length = min(length, hi - start)
        elif mode == InsertMode.FILL:
            lo, hi = self._gap_at(track, start)
            if self.sel_tracks and track in self.sel_tracks \
                    and self.sel_end > self.sel_start:
                lo, hi = max(lo, self.sel_start), min(hi, self.sel_end)
            if hi >= (1 << 39):
                # unbounded right gap with nothing to fill against:
                # degrade to a normal-length insert from the gap start
                # (fuzz found the sentinel otherwise became the fill
                # target — a 2^40-frame grid)
                hi = lo + length
            if hi <= lo:
                return None
            fill = min(length, hi - lo)
            # side picked by gravity (multitrack.h:110 comment): RIGHT
            # fills flush against the gap end, else from the gap start
            start = hi - fill if self.gravity == Gravity.RIGHT else lo
            length = fill
        if length <= 0:
            return None
        self._checkpoint()
        b = self._write_block(track, clip, start, length, offset,
                              with_audio)
        if self.autotrans_filter:
            self._apply_autotrans(b)
        return b

    def _apply_autotrans(self, b: Block):
        """Auto-add the configured transition over overlaps with the
        neighbouring tracks, blend ramped 0->1 across each overlap
        (multitrack.c atrans handling)."""
        for ot in (b.track - 1, b.track + 1):
            if not 0 <= ot < self.n_tracks:
                continue
            for nb in self.blocks(ot):
                s, e = max(b.start, nb.start), min(b.end, nb.end)
                if e - s <= 0:
                    continue
                lo, hi = min(ot, b.track), max(ot, b.track)
                saved = list(self._undo)
                fid = self.add_effect(self.autotrans_filter, [lo, hi],
                                      s, e - s, values={"amount": 0.0})
                self.set_keyframe(fid, s, "amount", 0.0)
                self.set_keyframe(fid, e, "amount", 1.0)
                self._undo[:] = saved   # one undo step for the insert

    def _fill_grid(self, upto: int):
        """The timeline frame grid is complete: every frame slot from 0 to
        the last content frame has a FRAME event (the reference's
        multitrack event lists are full grids too — quantise_events emits
        one event per timeline frame). Leading/inner gaps are blank
        events, so renders preserve gap timing."""
        if upto - self.n_frames > 10_000_000:
            raise ValueError(
                f"refusing to materialise a {upto}-frame grid "
                "(runaway edit coordinates)")
        for i in range(self.n_frames, upto):
            self._ensure_frame_event(i)

    def _fill_holes(self):
        """Re-complete the frame grid below the last event (gap inserts
        can shift a trailing audio terminator past the content, leaving
        slots with no event — which a render would silently compress)."""
        evs = self.el.frame_events()
        if not evs:
            return
        top = self.tc_frame(evs[-1].tc)
        have = {self.tc_frame(e.tc) for e in evs}
        for i in range(top):
            if i not in have:
                self._ensure_frame_event(i)

    def _write_block(self, track: int, clip: int, start: int, length: int,
                     offset: int, with_audio: bool) -> Block:
        self._fill_grid(start)
        end = start + length
        end_state = self._audio_state_at(track, self.frame_tc(end))
        for k in range(length):
            e = self._ensure_frame_event(start + k)
            e.props["clips"][track] = clip
            e.props["frames"][track] = offset + k
        if with_audio:
            self._clear_audio_range(track, start + 1, end)
            e0 = self._ensure_frame_event(start)
            set_audio_entry(e0, track, clip, offset / self.el.fps, 1.0)
            self._terminate_audio(track, end, end_state)
        return Block(track, start, length, clip, offset)

    def delete_block(self, block: Block):
        self._checkpoint()
        pre = self._audio_state_at(block.track,
                                   self.frame_tc(block.start) - 1)
        end_state = self._audio_state_at(block.track,
                                         self.frame_tc(block.end))
        for k in range(block.start, block.end):
            e = self._frame_event_at(k)
            if e is not None and block.track < len(e.props["clips"]):
                e.props["clips"][block.track] = -1
                e.props["frames"][block.track] = 0
        self._clear_audio_range(block.track, block.start, block.end)
        if pre is not None and pre[2] != 0.0 and pre[0] >= 0:
            # audio flowing in from the left must stop here
            e0 = self._ensure_frame_event(block.start)
            set_audio_entry(e0, block.track, pre[0], 0.0, 0.0)
        self._terminate_audio(block.track, block.end, end_state,
                              only_if_needed=True)
        self._prune_empty()

    def _block_has_audio(self, block: Block) -> bool:
        """Whether the block carries its own audio-on transition (blocks
        inserted with_audio=False must stay silent through edits)."""
        e = self._frame_event_at(block.start)
        if e is None:
            return False
        ent = get_audio_entry(e, block.track)
        return ent is not None and ent[0] == block.clip and ent[2] != 0.0

    def move_block(self, block: Block, new_track: int,
                   new_start: int) -> Block:
        self._checkpoint()
        saved = self._undo.pop()  # merge both rewrites into one undo step
        had_audio = self._block_has_audio(block)
        self.delete_block(block)
        self._undo.pop()
        nb = self._write_block(new_track, block.clip, max(0, new_start),
                               block.length, block.offset, had_audio)
        self._undo.append(saved)
        return nb

    def split_block(self, block: Block, at: int) -> tuple[Block, Block]:
        """Split at timeline frame `at` (inside the block). A
        BLOCK_START marker makes the split DURABLE — without it the two
        views would re-merge on the next blocks() scan (the reference
        records EVENT_MARKER_BLOCK_START for exactly this,
        events.h:357, multitrack.c:17219)."""
        from ..events.event_list import marker_event
        self._checkpoint()
        tc = self.frame_tc(at)
        for e in self.el.events:
            if e.tc == tc and e.type == EventType.MARKER \
                    and e.props.get("lives_type") == 1:
                if block.track not in e.props.setdefault("tracks", []):
                    e.props["tracks"].append(block.track)
                break
        else:
            self.el.insert(marker_event(tc, lives_type=1,
                                        tracks=[block.track]))
        a = Block(block.track, block.start, at - block.start, block.clip,
                  block.offset)
        b = Block(block.track, at, block.end - at, block.clip,
                  block.offset + (at - block.start))
        return a, b

    def _split_marks(self, track: int) -> set[int]:
        """Timeline frames where BLOCK_START markers split this track."""
        out = set()
        for e in self.el.events:
            if e.type == EventType.MARKER \
                    and e.props.get("lives_type") == 1:
                trs = e.props.get("tracks", [])
                if isinstance(trs, int):   # single-element binary leaf
                    trs = [trs]
                if not trs or track in trs:
                    out.add(self.tc_frame(e.tc))
        return out

    def trim_block(self, block: Block, new_length: int,
                   from_start: bool = False) -> Optional[Block]:
        """Shorten a block (block-resize handler role). ``from_start``
        trims the head (offset advances) instead of the tail."""
        new_length = int(new_length)
        if new_length >= block.length or new_length <= 0:
            return block if new_length == block.length else None
        self._checkpoint()
        saved = self._undo.pop()
        if from_start:
            cut = Block(block.track, block.start,
                        block.length - new_length, block.clip, block.offset)
            kept = Block(block.track, block.start + (block.length
                                                     - new_length),
                         new_length, block.clip,
                         block.offset + block.length - new_length)
        else:
            cut = Block(block.track, block.start + new_length,
                        block.length - new_length, block.clip,
                        block.offset + new_length)
            kept = Block(block.track, block.start, new_length, block.clip,
                         block.offset)
        had_audio = self._block_has_audio(block)
        self.delete_block(cut)
        self._undo.pop()
        self._undo.append(saved)
        if from_start and had_audio:
            # re-anchor audio seek at the new head
            e0 = self._frame_event_at(kept.start)
            if e0 is not None:
                set_audio_entry(e0, kept.track, kept.clip,
                                kept.offset / self.el.fps, 1.0)
        return kept

    # -- gap / region ops (multitrack.c insert gap / remove gaps) ----------
    def insert_gap(self, tracks: Sequence[int], start: int, length: int):
        """Shift the content of `tracks` at or after `start` right by
        `length` frames. When every video track shifts, effect events
        after `start` shift with the content (reference insert-gap over
        the full selection)."""
        self._checkpoint()
        tracks = list(tracks)
        start, length = int(start), int(length)
        shift_all = set(t for t in tracks if t >= 0) \
            >= set(range(self.n_tracks))
        self._shift_content(tracks, start, length)
        self._fill_holes()
        if shift_all:
            dt = int(round(length * self._tpf()))
            tc0 = self.frame_tc(start)
            for e in list(self.el.events):
                if e.tc >= tc0 and e.type in (EventType.FILTER_INIT,
                                              EventType.FILTER_DEINIT,
                                              EventType.PARAM_CHANGE,
                                              EventType.FILTER_MAP):
                    e.tc += dt
            self.el.reindex()

    def _shift_content(self, tracks: Sequence[int], start: int,
                       length: int):
        """Move per-track (clip, frame, audio) content right by length."""
        n = self.n_frames
        for t in tracks:
            if t >= 0:
                runs = [(i, self._frame_event_at(i)) for i in
                        range(start, n)]
                content = []
                for i, e in runs:
                    if e is not None and t < len(e.props["clips"]) \
                            and e.props["clips"][t] >= 0:
                        content.append((i, e.props["clips"][t],
                                        e.props["frames"][t]))
                        e.props["clips"][t] = -1
                        e.props["frames"][t] = 0
                for i, c, f in content:
                    e = self._ensure_frame_event(i + length)
                    e.props["clips"][t] = c
                    e.props["frames"][t] = f
            # audio transitions shift for both audio + video tracks
            moves = []
            for i in range(start, n):
                e = self._frame_event_at(i)
                if e is None:
                    continue
                ent = get_audio_entry(e, t)
                if ent is not None:
                    moves.append((i, ent))
                    remove_audio_entry(e, t)
            for i, (c, s, v) in moves:
                e = self._ensure_frame_event(i + length)
                set_audio_entry(e, t, c, s, v)

    def remove_gaps(self, tracks: Sequence[int] | None = None,
                    start: int | None = None, end: int | None = None,
                    first_only: bool = False):
        """Close gaps leftwards per track within the region (reference
        remove-gaps / remove-first-gap on the selection)."""
        self._checkpoint()
        tracks = list(tracks) if tracks is not None else (
            self.sel_tracks or list(range(self.n_tracks)))
        start = self.sel_start if start is None else int(start)
        end = (self.sel_end or self.n_frames) if end is None else int(end)
        for t in tracks:
            blks = [b for b in self.blocks(t)
                    if b.start >= start and b.end <= end] if t >= 0 else \
                   [b for b in self.audio_blocks(t)
                    if b.start >= start and b.end <= end]
            pos = start
            moved_one = False
            for b in blks:
                if b.start > pos and not (first_only and moved_one):
                    if t >= 0:
                        self._move_inline(b, pos)
                    else:
                        self._move_audio_inline(b, pos)
                    moved_one = True
                    pos += b.length
                else:
                    pos = max(pos, b.end)
        # a single undo step for the whole operation
        if len(self._undo) >= 2 and self._undo[-1] == self._undo[-2]:
            self._undo.pop()

    def _move_inline(self, block: Block, new_start: int):
        saved = list(self._undo)
        had_audio = self._block_has_audio(block)
        self.delete_block(block)
        self._write_block(block.track, block.clip, new_start, block.length,
                          block.offset, had_audio)
        self._undo[:] = saved

    def _move_audio_inline(self, ab: "AudioBlock", new_start: int):
        saved = list(self._undo)
        self.delete_audio_block(ab)
        self._write_audio_block(ab.track, ab.clip, new_start, ab.length,
                                ab.seek, ab.vel)
        self._undo[:] = saved

    def _prune_empty(self):
        """Remove trailing frame events that carry no video and no live
        audio (inner gaps are part of the timeline and stay). A trailing
        pure terminator survives only while it actually terminates audio."""
        evs = self.el.frame_events()
        while evs:
            e = evs[-1]
            if self._has_video(e):
                break
            ac = e.props.get("audio_clips")
            if ac and not self._audio_off_only(e):
                break
            if ac:
                tracks = [ac[i] for i in range(0, len(ac) - 1, 2)]
                if any(self._audio_state_at(t, e.tc - 1) is not None
                       for t in tracks):
                    break
            self.el.remove(e)
            evs.pop()

    def blocks(self, track: int) -> list[Block]:
        """Derive block views by scanning the event list; BLOCK_START
        markers break contiguous runs (durable splits)."""
        marks = self._split_marks(track)
        out: list[Block] = []
        cur: Optional[list] = None  # [start, clip, offset, len]
        for e in self.el.frame_events():
            i = self.tc_frame(e.tc)
            clips = e.props["clips"]
            c = clips[track] if track < len(clips) else -1
            f = e.props["frames"][track] if track < len(clips) else 0
            if cur is not None:
                contiguous = (i == cur[0] + cur[3]
                              and c == cur[1] and f == cur[2] + cur[3]
                              and i not in marks)
                if contiguous:
                    cur[3] += 1
                    continue
                out.append(Block(track, cur[0], cur[3], cur[1], cur[2]))
                cur = None
            if c >= 0:
                cur = [i, c, f, 1]
        if cur is not None:
            out.append(Block(track, cur[0], cur[3], cur[1], cur[2]))
        return out

    # -- audio blocks (backing tracks; multitrack.c audio block model) -----
    def insert_audio_block(self, track: int, clip: int, start: int,
                           length: int, seek: float = 0.0,
                           vel: float = 1.0) -> Optional[AudioBlock]:
        """Place an audio block on a backing audio track (negative index)
        or write standalone audio for a video track."""
        start = max(0, int(start))
        if self.insert_mode == InsertMode.NORMAL:
            spans = [(b.start, b.end) for b in self.audio_blocks(track)]
            for s, e in spans:
                if s <= start < e:
                    return None
                if s > start:
                    length = min(length, s - start)
                    break
        if length <= 0:
            return None
        self._checkpoint()
        return self._write_audio_block(track, clip, start, length, seek,
                                       vel)

    def _write_audio_block(self, track, clip, start, length, seek, vel):
        end = start + length
        # materialise the block's interior grid too: a video render of an
        # audio-only span must produce black frames of the right
        # duration, not compress time (soak found renders shorter than
        # n_frames)
        self._fill_grid(end)
        end_state = self._audio_state_at(track, self.frame_tc(end))
        self._clear_audio_range(track, start + 1, end)
        e0 = self._ensure_frame_event(start)
        set_audio_entry(e0, track, clip, float(seek), float(vel))
        self._terminate_audio(track, end, end_state)
        return AudioBlock(track, start, length, clip, float(seek),
                          float(vel))

    def delete_audio_block(self, ab: AudioBlock):
        self._checkpoint()
        self._clear_audio_range(ab.track, ab.start, ab.end)
        # stop marker only if a later on-state follows at end (keep it)
        e_end = self._frame_event_at(ab.end)
        if e_end is None or get_audio_entry(e_end, ab.track) is None:
            nxt = self._next_audio_entry_after(ab.track, ab.end)
            if nxt is not None:
                e0 = self._ensure_frame_event(ab.start)
                set_audio_entry(e0, ab.track, ab.clip, 0.0, 0.0)
        self._prune_empty()

    def audio_blocks(self, track: int) -> list[AudioBlock]:
        """Derive audio block views from the transition state machine."""
        out: list[AudioBlock] = []
        cur = None  # (start_frame, clip, seek, vel)
        for e in self.el.frame_events():
            ent = get_audio_entry(e, track)
            if ent is None:
                continue
            i = self.tc_frame(e.tc)
            clip, seek, vel = ent
            if cur is not None:
                out.append(AudioBlock(track, cur[0], i - cur[0], cur[1],
                                      cur[2], cur[3]))
                cur = None
            if clip >= 0 and vel != 0.0:
                cur = (i, clip, seek, vel)
        if cur is not None:
            out.append(AudioBlock(track, cur[0],
                                  max(1, self.n_frames - cur[0]), cur[1],
                                  cur[2], cur[3]))
        return out

    def _audio_state_at(self, track: int, tc: int):
        """(clip, seek_now_seconds, vel) active on `track` at tc, or None.
        Walks the sparse transitions (the editor's per-edit helper)."""
        if tc < 0:
            return None
        state = None  # (clip, seek, vel, since_tc)
        for e in self.el.frame_events():
            if e.tc > tc:
                break
            ent = get_audio_entry(e, track)
            if ent is not None:
                state = (ent[0], ent[1], ent[2], e.tc)
        if state is None or state[2] == 0.0 or state[0] < 0:
            return None
        clip, seek, vel, since = state
        return (clip, seek + (tc - since) / TICKS_PER_SECOND * vel, vel)

    def _next_audio_entry_after(self, track: int, i: int):
        tc = self.frame_tc(i)
        for e in self.el.frame_events():
            if e.tc <= tc:
                continue
            ent = get_audio_entry(e, track)
            if ent is not None:
                return (e, ent)
        return None

    def _clear_audio_range(self, track: int, start: int, end: int):
        """Drop the track's audio transitions in frames [start, end)."""
        tc0, tc1 = self.frame_tc(start), self.frame_tc(end)
        for e in self.el.frame_events():
            if e.tc < tc0:
                continue
            if e.tc >= tc1:
                break
            remove_audio_entry(e, track)

    def _terminate_audio(self, track: int, end: int, end_state,
                         only_if_needed: bool = False):
        """At frame `end`, either resume the audio that was playing there
        before the edit, or (on insert) write an off marker — the state
        machine must not let block audio flow past the block
        (reference writes off as vel 0, audio.c:3656)."""
        e_end = self._frame_event_at(end)
        if e_end is not None and get_audio_entry(e_end, track) is not None:
            return  # a following block's own transition rules from here
        if end_state is not None:
            e = self._ensure_frame_event(end)
            set_audio_entry(e, track, end_state[0], end_state[1],
                            end_state[2])
        elif not only_if_needed:
            e = self._ensure_frame_event(end)
            set_audio_entry(e, track, -1, 0.0, 0.0)

    # -- per-track volume: the avol filter model ---------------------------
    def _avol_tracks(self) -> list[int]:
        """avol in_tracks layout (events.c:2653): backing audio tracks
        first (negative), then video tracks."""
        return list(range(-self.n_audio_tracks, 0)) + \
            list(range(self.n_tracks))

    def _ensure_avol(self):
        init = self.el.get(self._avol_id) if self._avol_id else None
        if init is None:
            for e in self.el.events:
                if e.type == EventType.FILTER_INIT \
                        and e.props.get("filter") == "avol":
                    init = e
                    break
        if init is None:
            tracks = self._avol_tracks()
            init = filter_init_event(
                0, "avol", in_tracks=tracks, out_tracks=[],
                values={"volume": [1.0] * len(tracks)}, audio=True)
            self.el.insert(init)
            self.el.insert(filter_deinit_event(
                max(self.el.duration_ticks, 1), init.event_id))
        self._avol_id = init.event_id
        return init

    def _avol_add_track(self):
        """Widen the avol init + every pchain entry to the new track list
        (reference add_track_to_avol_init, events.c:2636)."""
        if self._avol_id is None and not any(
                e.type == EventType.FILTER_INIT
                and e.props.get("filter") == "avol"
                for e in self.el.events):
            return
        init = self._ensure_avol()
        old_tracks = list(init.props.get("in_tracks", []))
        new_tracks = self._avol_tracks()
        vols = list(init.props["values"].get(
            "volume", [1.0] * len(old_tracks)))
        old_map = dict(zip(old_tracks, vols))
        init.props["in_tracks"] = new_tracks
        init.props["values"]["volume"] = [old_map.get(t, 1.0)
                                          for t in new_tracks]
        for pc in self.el.pchain(init.event_id, "volume"):
            old_vals = dict(zip(old_tracks, pc.props["value"]))
            pc.props["value"] = [old_vals.get(t, 1.0) for t in new_tracks]

    def set_track_volume(self, track: int, vol: float,
                         frame: int | None = None):
        """Static (frame=None) or keyframed per-track volume via the avol
        pchain (the audio mixer model, audio.c:1686 consumption)."""
        init = self._ensure_avol()
        tracks = init.props["in_tracks"]
        if track not in tracks:
            self._avol_add_track()
            tracks = init.props["in_tracks"]
        idx = tracks.index(track)
        if frame is None:
            init.props["values"]["volume"][idx] = float(vol)
            return
        tc = self.frame_tc(frame)
        for pc in self.el.pchain(init.event_id, "volume"):
            if pc.tc == tc:
                pc.props["value"][idx] = float(vol)
                return
        # new keyframe: start from the interpolated state at tc
        cur = [float(v) for v in self.el.interp_param(init, "volume", tc)]
        cur[idx] = float(vol)
        self.el.insert(param_change_event(tc, init.event_id, "volume",
                                          cur))

    def track_volume(self, track: int, frame: int | None = None) -> float:
        init = self._ensure_avol()
        tracks = init.props["in_tracks"]
        if track not in tracks:
            return 1.0
        idx = tracks.index(track)
        if frame is None:
            return float(init.props["values"]["volume"][idx])
        v = self.el.interp_param(init, "volume", self.frame_tc(frame))
        return float(v[idx])

    # -- effects -----------------------------------------------------------
    def add_effect(self, filter_name: str, tracks: Sequence[int],
                   start: int, length: int,
                   values: dict | None = None) -> str:
        """Attach an effect over [start, start+length) (per-block/region fx,
        multitrack fx model). Returns the init event id."""
        self._checkpoint()
        tc0 = self.frame_tc(start)
        tc1 = self.frame_tc(start + length)
        init = filter_init_event(tc0, filter_name, in_tracks=list(tracks),
                                 out_tracks=[tracks[0]],
                                 values=dict(values or {}))
        self.el.insert(init)
        self.el.insert(filter_deinit_event(tc1, init.event_id))
        self._rebuild_filter_maps()
        return init.event_id

    def add_audio_effect(self, filter_name: str, tracks: Sequence[int],
                         start: int, length: int,
                         values: dict | None = None) -> str:
        """Attach an AUDIO filter region (audio/fx.py registry) over
        [start, start+length) — the reference applies audio instances
        during render_audio_segment (weed_apply_audio_instance,
        effects-weed.c:2747). Empty `tracks` = master bus. Keyframe its
        params with set_keyframe like video effects."""
        from ..audio.fx import get_audio_filter
        get_audio_filter(filter_name)       # validate early
        self._checkpoint()
        tc0 = self.frame_tc(start)
        tc1 = self.frame_tc(start + length)
        init = filter_init_event(tc0, filter_name,
                                 in_tracks=list(tracks), out_tracks=[],
                                 values=dict(values or {}), audio=True)
        self.el.insert(init)
        self.el.insert(filter_deinit_event(tc1, init.event_id))
        return init.event_id

    def add_region_effect(self, filter_name: str,
                          values: dict | None = None) -> str:
        """Apply an effect over the current region selection."""
        if not self.sel_tracks or self.sel_end <= self.sel_start:
            raise ValueError("no region selected")
        return self.add_effect(filter_name, self.sel_tracks,
                               self.sel_start,
                               self.sel_end - self.sel_start, values)

    def remove_effect(self, init_id: str):
        self._checkpoint()
        drop = [e for e in self.el.events
                if (e.type in (EventType.FILTER_INIT,)
                    and e.event_id == init_id)
                or (e.type in (EventType.FILTER_DEINIT,
                               EventType.PARAM_CHANGE)
                    and e.props.get("init_event") == init_id)]
        for e in drop:
            self.el.remove(e)
        self._rebuild_filter_maps()

    def set_keyframe(self, init_id: str, frame: int, param: str, value):
        """Keyframed param (pchain entry)."""
        self._checkpoint()
        self.el.insert(param_change_event(self.frame_tc(frame), init_id,
                                          param, value))

    def keyframes(self, init_id: str, param: str) -> list[tuple[int, Any]]:
        """(frame, value) pairs of a pchain (keyframe UI feed)."""
        return [(self.tc_frame(e.tc), e.props["value"])
                for e in self.el.pchain(init_id, param)]

    def remove_keyframe(self, init_id: str, frame: int, param: str) -> bool:
        tc = self.frame_tc(frame)
        for e in self.el.pchain(init_id, param):
            if e.tc == tc:
                self._checkpoint()
                self.el.remove(e)
                return True
        return False

    def effects(self) -> list[dict]:
        """Summaries of every (non-audio) effect on the timeline."""
        out = []
        for e in self.el.events:
            if e.type != EventType.FILTER_INIT or e.props.get("audio"):
                continue
            deinit = next((d for d in self.el.events
                           if d.type == EventType.FILTER_DEINIT
                           and d.props.get("init_event") == e.event_id),
                          None)
            out.append(dict(
                id=e.event_id, filter=e.props["filter"],
                tracks=e.props.get("in_tracks", []),
                start=self.tc_frame(e.tc),
                end=self.tc_frame(deinit.tc) if deinit else self.n_frames))
        return out

    def _rebuild_filter_maps(self):
        """Regenerate FILTER_MAP events at every init/deinit boundary —
        one O(N) pass (reference filter-map maintenance,
        events.c:1014-1753). Audio-only inits (avol) stay out of the
        video maps."""
        for e in [e for e in self.el.events
                  if e.type == EventType.FILTER_MAP]:
            self.el.remove(e)
        inits: dict[str, Any] = {}
        bounds: dict[int, bool] = {}
        deinit_tc: dict[str, int] = {}
        for e in self.el.events:
            if e.type == EventType.FILTER_INIT \
                    and not e.props.get("audio"):
                inits[e.event_id] = e
                bounds[e.tc] = True
            elif e.type == EventType.FILTER_DEINIT:
                if e.props.get("init_event") in inits:
                    bounds[e.tc] = True
                deinit_tc[e.props.get("init_event")] = e.tc
        INF = float("inf")
        for tc in sorted(bounds):
            active = [i for i in inits.values()
                      if i.tc <= tc and deinit_tc.get(i.event_id,
                                                      INF) > tc]
            self.el.insert(filter_map_event(
                tc, [i.event_id for i in active]))

    # -- render ------------------------------------------------------------
    def render(self, source, sink=None, batch_size: int = 32,
               progress_cb=None):
        """Render the timeline (render_to_clip path) via the batch
        renderer; returns (frames array, tcs). `progress_cb(done)` fires
        per rendered batch (render progress dialog hook)."""
        from ..events.renderer import render_to_arrays
        from ..graph.nodemodel import SinkSpec
        sink = sink or SinkSpec(width=self.el.width, height=self.el.height)
        return render_to_arrays(self.el, source, sink, batch_size,
                                progress_cb=progress_cb)

    def render_audio(self, clips: dict, arate: int = 44100,
                     channels: int = 2):
        """Mix the timeline's audio from the per-track transition state
        machine, through the avol volume envelopes
        (render_audio_segment + avol, audio.c:1686). Layouts predating
        the audio-event schema (no transitions AND no avol anywhere) fall
        back to legacy clip placement; a modern timeline whose blocks
        were inserted with_audio=False renders silence."""
        from ..audio.engine import render_audio as _legacy
        from ..audio.engine import render_timeline_audio
        if getattr(self.el, "schema", 2) < 2 and not any(
                e.props.get("audio_clips")
                for e in self.el.frame_events()):
            # pre-0.3 container (no audio-transition schema): legacy
            # clip-placement semantics
            return _legacy(self.el, clips, arate, channels)
        self._ensure_avol()
        return render_timeline_audio(self.el, clips, arate, channels,
                                     legacy_fallback=False)

    # -- layout save/load --------------------------------------------------
    def save_layout(self, path: str):
        """JSON (debug container) by default; `.lay`/`.bin` or any
        non-.json suffix writes the reference's binary Weed format
        (events/weed_binary.py) for interop with real LiVES layouts."""
        import pathlib
        p = pathlib.Path(path)
        if p.suffix.lower() == ".json":
            p.write_text(self.el.to_json())
        else:
            from ..events.weed_binary import save_event_list_binary
            with open(p, "wb") as fh:
                save_event_list_binary(self.el, fh)

    @classmethod
    def load_layout(cls, path: str, n_tracks: int | None = None
                    ) -> "Multitrack":
        import pathlib
        raw = pathlib.Path(path).read_bytes()
        if raw[:1] in (b"{", b"["):  # JSON debug container
            el = EventList.from_json(raw.decode())
        else:
            import io as _io
            from ..events.weed_binary import load_event_list_binary
            el = load_event_list_binary(_io.BytesIO(raw))
        mt = cls(fps=el.fps, width=el.width, height=el.height)
        mt.el = el
        mt.n_tracks = n_tracks or max(
            (len(e.props.get("clips", [])) for e in el.events
             if e.type == EventType.FRAME), default=2)
        for e in el.events:
            if e.type == EventType.FILTER_INIT \
                    and e.props.get("filter") == "avol":
                mt._avol_id = e.event_id
                neg = [t for t in e.props.get("in_tracks", []) if t < 0]
                mt.n_audio_tracks = max(len(neg), 1)
                break
        return mt
