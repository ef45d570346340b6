"""Multitrack edit-session soak: drives a full editing session through
the BROWSER endpoints (webui /api/cmd → the OSC method table), the way
the timeline JS does — insert/move/trim/delete blocks, gravity + insert
modes, region selection + region fx, keyframes, gaps, audio blocks and
volume changes, with undo/redo mixed in — then renders the surviving
timeline and checks invariants (the multitrack.c editing surface at
soak depth).

Counterpart of `tools/mt_edit_soak.py:1-243` with the same ops, weights,
invariants and seed semantics, over the port's `OSCServer`, `Player`,
`WebUI` and `Multitrack`. The player runs on `--device` (`cuda` by
default, which raises without CUDA) and the render's source (`Src`,
`:221-227`) builds its frames there. `session` is the soak as a
function: it returns the render's frames beside the counts.

Usage: python -m lives_tpu_torch.tools.mt_edit_soak [--ops 300]
    [--seed 0] [--device cuda]
Exits nonzero on any endpoint error or invariant violation.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import urllib.request


def api(base, path, args):
    req = urllib.request.Request(
        base + "/api/cmd",
        data=json.dumps({"path": path, "args": args}).encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def get_timeline(base):
    with urllib.request.urlopen(base + "/api/timeline", timeout=10) as r:
        return json.loads(r.read())


def session(n_ops: int = 300, seed: int = 0, device="cuda",
            log=lambda s: print(s, flush=True)) -> dict:
    """The soak: `n_ops` random edits, the invariants every 50, then the
    render of what survives. Returns {"errors", "n_frames", "rendered",
    "frames" (the render's host frames, or None), "timeline" (the final
    /api/timeline)}; an invariant violation raises AssertionError."""
    import torch

    from ..constants import Palette
    from ..layer import Layer
    from ..multitrack.model import Multitrack
    from ..osc.server import OSCServer
    from ..player import CollectSink, Player
    from ..utils.device import resolve_device
    from ..webui import WebUI

    dev = resolve_device(device, "mt_edit_soak")
    rng = random.Random(seed)
    srv = OSCServer(player=Player(sink=CollectSink(), device=dev))
    srv.multitrack = Multitrack(n_tracks=3, width=64, height=32)

    class FakeClip:
        def __init__(self, uid):
            self.unique_id = uid
            self.frames = rng.randint(10, 60)
            self.fps = 25.0
            self.width, self.height = 64, 32
    for cid in (1, 2, 3):
        srv.clips[cid] = FakeClip(cid)

    ui = WebUI(srv).start()
    base = f"http://{ui.host}:{ui.port}"
    errors = 0
    fx_ids: list[str] = []

    def op_insert():
        t = rng.randrange(3)
        return api(base, "/block/insert",
                   [rng.choice([1, 2, 3]), t, rng.uniform(0, 6)])

    def op_move():
        tl = get_timeline(base)
        cands = [(tr["track"], i) for tr in tl["tracks"]
                 for i in range(len(tr["blocks"]))]
        if not cands:
            return {"ok": True}
        t, i = rng.choice(cands)
        return api(base, "/block/move",
                   [t, i, rng.randrange(3), rng.uniform(0, 6)])

    def op_trim():
        tl = get_timeline(base)
        cands = [(tr["track"], i, b) for tr in tl["tracks"]
                 for i, b in enumerate(tr["blocks"])]
        if not cands:
            return {"ok": True}
        t, i, b = rng.choice(cands)
        return api(base, "/block/trim",
                   [t, i, rng.uniform(0.05, (b["end"] - b["start"]) / 25.0),
                    rng.randint(0, 1)])

    def op_delete():
        tl = get_timeline(base)
        cands = [(tr["track"], len(tr["blocks"])) for tr in tl["tracks"]
                 if tr["blocks"]]
        if not cands:
            return {"ok": True}
        t, n = rng.choice(cands)
        return api(base, "/block/delete", [t, rng.randrange(n)])

    def op_modes():
        api(base, "/mt/gravity/set", [rng.choice([0, 1, 2])])
        return api(base, "/mt/insert_mode/set", [rng.choice([0, 2, 4])])

    def op_region_fx():
        t = rng.randrange(3)
        s = rng.randrange(0, 80)
        api(base, "/mt/region/select", [s, s + rng.randint(2, 30), t])
        r = api(base, "/mt/fx/region",
                [rng.choice(["negate", "vignette", "saturation"]),
                 s, s + rng.randint(2, 30), t])
        if r.get("ok") and r.get("ret"):
            fx_ids.append(r["ret"])
        return r

    def op_keyframe():
        if not fx_ids:
            return {"ok": True}
        fid = rng.choice(fx_ids)
        return api(base, "/mt/keyframe/set",
                   [fid, rng.randrange(0, 100), "amount",
                    rng.uniform(0, 1)])

    def op_fx_remove():
        if not fx_ids:
            return {"ok": True}
        return api(base, "/mt/fx/remove", [fx_ids.pop()])

    def op_gap():
        if rng.random() < 0.5:
            return api(base, "/mt/gap/insert",
                       [rng.uniform(0, 3), rng.uniform(0.1, 1.0),
                        rng.randrange(3)])
        return api(base, "/mt/gap/remove", [rng.randint(0, 1)])

    def op_audio():
        if rng.random() < 0.5:
            return api(base, "/mt/ablock/insert",
                       [rng.choice([1, 2, 3]), -1, rng.uniform(0, 5),
                        rng.uniform(0.2, 2.0)])
        return api(base, "/mt/track/volume/set",
                   [rng.choice([-1, 0, 1, 2]), rng.uniform(0, 1.2),
                    rng.randrange(0, 100) if rng.random() < 0.5 else None]
                   if rng.random() < 0.5 else
                   [rng.choice([-1, 0, 1, 2]), rng.uniform(0, 1.2)])

    def op_undo():
        return api(base, rng.choice(["/mt/undo", "/mt/redo"]), [])

    def op_wave():
        # the timeline audio-row waveform endpoint must always answer
        # (zeros for empty/unknown tracks, never a 500)
        trk = rng.choice([-1, -2, 0])
        w = rng.choice([64, 200, 600])
        with urllib.request.urlopen(
                f"{base}/api/audio_wave/{trk}?w={w}", timeout=10) as r:
            wv = json.loads(r.read())
        assert wv["width"] == w and len(wv["mins"]) == w
        return {"ok": True}

    def op_datacons():
        # the connections editor endpoint + churn: map/enable two keys,
        # wire param+alpha connections, read the listing, unwire
        api(base, "/effect_key/map", [9, "motion_mask"])
        api(base, "/effect_key/map", [10, "alpha_visualizer"])
        api(base, "/effect_key/enable", [9])
        api(base, "/effect_key/enable", [10])
        api(base, "/effect_key/outparameter/connection/add",
            [9, 0, 10, 0, rng.choice([0, 1])])
        api(base, "/effect_key/outchannel/connection/add", [9, 0, 10, 0])
        with urllib.request.urlopen(f"{base}/api/datacons",
                                    timeout=10) as r:
            dc = json.loads(r.read())
        assert dc["pconx"] and dc["cconx"]
        assert dc["pconx"][0]["src"] == 9 and dc["cconx"][0]["dst"] == 10
        if rng.random() < 0.7:
            api(base, "/effect_key/outparameter/connection/delete", [9, 0])
            api(base, "/effect_key/outchannel/connection/delete", [9, 0])
        return {"ok": True}

    ops = ([op_insert] * 5 + [op_move] * 3 + [op_trim] * 2
           + [op_delete] * 2 + [op_modes] + [op_region_fx] * 2
           + [op_keyframe] * 2 + [op_fx_remove] + [op_gap] * 2
           + [op_audio] * 3 + [op_undo] * 2 + [op_wave] + [op_datacons])
    try:
        for k in range(n_ops):
            fn = rng.choice(ops)
            try:
                r = fn()
                if not r.get("ok", False):
                    log(f"op {k} {fn.__name__}: {r.get('error')}")
                    errors += 1
            except Exception as e:  # noqa: BLE001 - counted as an error
                log(f"op {k} {fn.__name__}: EXC {e}")
                errors += 1
            if k % 50 == 49:
                # invariants: timeline readable, blocks sane, no overlap
                tl = get_timeline(base)
                for tr in tl["tracks"]:
                    last = -1
                    for b in sorted(tr["blocks"], key=lambda b: b["start"]):
                        assert b["end"] > b["start"], (tr, b)
                        assert b["start"] >= last, \
                            f"overlap on {tr['track']}"
                        last = b["end"]
        timeline = get_timeline(base)
    finally:
        ui.stop()
        srv.player.stop()

    # final render of whatever survives (the render_to_clip path)
    mt = srv.multitrack
    rendered, frames = 0, None
    if mt.n_frames:
        class Src:
            def get_batch(self, cids, fnums):
                arrs = [torch.full((3, 32, 64), (int(c) * 40) % 255,
                                   dtype=torch.uint8, device=dev)
                        if c >= 0 else torch.zeros((3, 32, 64),
                                                   dtype=torch.uint8,
                                                   device=dev)
                        for c in cids]
                return Layer(planes=(torch.stack(arrs),),
                             palette=int(Palette.RGB24))
        frames, _ = mt.render(Src(), batch_size=16)
        rendered = len(frames)
        # grid completeness: the render must cover every timeline frame
        # (time never compresses)
        assert rendered == mt.n_frames, (rendered, mt.n_frames)
        audio = mt.render_audio({})
        assert len(audio) >= 0
    return {"errors": errors, "n_frames": mt.n_frames, "rendered": rendered,
            "frames": frames, "timeline": timeline}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the player's and the render's device")
    args = ap.parse_args(argv)
    got = session(args.ops, args.seed, args.device)
    print(f"mt_edit_soak: {args.ops} ops, {got['errors']} errors, "
          f"{got['n_frames']} frames, rendered {got['rendered']}")
    return 1 if got["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
