"""Exhaustive online test of every realtime effect and parameter — the
lives-rte-test.pl successor (reference `tools/lives-rte-test.pl`: map
each plugin on an effect key over OSC while playing, sweep every
parameter across its range, and watch for errors/crashes).

Counterpart of `tools/rte_test.py:1-170` (`test_filter` `:58`,
`run_rte_test` `:96`, the self-hosted player `:104-116`) over the port's
`OSCClient`, `Player`, `OSCServer` and `GeneratorClip`. The port adds the
`device`, `width` and `height` keywords (`--device`, `--width`,
`--height`): the self-hosted player and its generators run on `device`
(`cuda` by default, which raises without CUDA) at width x height (the JAX
tool's 192x128 by default). The self-hosted player turns `async_compile`
off, so every pumped frame renders the filter at the setting just made,
and an exception a frame raises is a failure in the filter's list (the
JAX tool stops at the first). `frames_rendered` counts the frames
pumped.

Usage:
    python -m lives_tpu_torch.tools.rte_test [--match SUBSTR] [--limit N]
        [--port P] [--frames N] [--key K] [--device cuda]
        [--width 192] [--height 128]

Without --port it self-hosts a player (plasma generator foreground,
colour-bars background so transitions have two channels) and renders
--frames real frames per filter with the effect enabled. Against a
running instance (--port) it drives the same sweep over UDP.

Per filter: map on the key, enable, render; for every parameter, set
min / midpoint / max (num), both states (bool), every choice index
(string_list), and the default back (string); each set is followed by
an /app/ping barrier that collects /error replies, and numeric sets
must echo back through value/get. Exits nonzero listing the failures.
"""

from __future__ import annotations

import argparse
import socket
import sys

from ..osc.client import OSCClient
from ..utils.device import resolve_device

P = "/effect_key/parameter"
#: frames pumped, and parameter settings made, since the counts were last
#: set to 0
frames_rendered = 0
settings_swept = 0


def _sweep_values(cli: OSCClient, key: int, i: int):
    """Yield the wire values to try for parameter i of the key's filter."""
    kind = cli.query1(f"{P}/type/get", key, i)
    if kind in ("float", "int"):
        lo = float(cli.query1(f"{P}/min/get", key, i))
        hi = float(cli.query1(f"{P}/max/get", key, i))
        vals = [lo, (lo + hi) / 2.0, hi]
        if kind == "int":
            vals = sorted({int(round(v)) for v in vals})
        for v in vals:
            yield kind, v
    elif kind == "bool":
        yield kind, 1
        yield kind, 0
    elif kind == "string_list":
        n = int(cli.query1(f"{P}/gui/choices/count", key, i) or 0)
        for c in range(n):
            yield kind, c
    elif kind == "string":
        d = cli.query1(f"{P}/default/get", key, i)
        yield kind, str(d if d is not None else "")
    # color params: exercised via default/get round trip only (value/set
    # takes component lists; the param UI covers those paths)


def _pumped(pump, k: int, what: str, errs: list[str]) -> None:
    """Render k frames; an exception is the setting's failure."""
    try:
        pump(k)
    except Exception as e:  # noqa: BLE001 - reported, never passed over
        errs.append(f"{what} (render): {type(e).__name__}: {e}")


def test_filter(cli: OSCClient, name: str, key: int,
                pump=None, frames: int = 2) -> list[str]:
    """Map, enable, render, sweep every param, disable. Returns errors."""
    global settings_swept
    errs: list[str] = []
    # the JAX tool maps onto the key's first free mode (`:61`), so from
    # its second filter on the key keeps serving the first filter and no
    # other filter is rendered or swept; unmapping first puts each filter
    # in mode 1 with a fresh instance
    cli.send("/effect_key/unmap", key)
    cli.send("/effect_key/map", key, name)
    cli.send("/effect_key/enable", key)
    errs += [f"{name}: {e}" for e in cli.barrier()]
    if errs:
        cli.send("/effect_key/disable", key)
        cli.barrier()
        return errs                      # could not even instantiate
    if pump:
        _pumped(pump, frames, name, errs)    # render with defaults
    n = int(cli.query1(f"{P}/count", key) or 0)
    for i in range(n):
        pname = cli.query1(f"{P}/name/get", key, i)
        for kind, v in _sweep_values(cli, key, i):
            settings_swept += 1
            cli.send(f"{P}/value/set", key, i, v)
            for e in cli.barrier():
                errs.append(f"{name}.{pname}={v!r}: {e}")
            if kind == "float":
                got = cli.query1(f"{P}/value/get", key, i)
                if abs(float(got) - float(v)) > 1e-4 * (abs(v) + 1.0):
                    errs.append(
                        f"{name}.{pname}: set {v} read back {got}")
            if pump:                     # render a frame at this setting
                _pumped(pump, 1, f"{name}.{pname}={v!r}", errs)
    if pump:
        _pumped(pump, frames, name, errs)    # the swept end state
    cli.send("/effect_key/disable", key)
    errs += [f"{name} (disable): {e}" for e in cli.barrier()]
    return errs


def self_host(device="cuda", width: int = 192, height: int = 128):
    """A player on `device` (plasma over colour_bars at width x height,
    playing, `async_compile` off) behind an `OSCServer` on port 0.
    Returns (player, server, pump), pump(k) rendering k frames."""
    from ..io.genclip import GeneratorClip
    from ..osc.server import OSCServer
    from ..player import NullSink, Player
    p = Player(sink=NullSink(), device=resolve_device(device, "rte_test"))
    p.async_compile = False
    p.state.fg_clip = GeneratorClip("plasma", width, height,
                                    device=p.device)
    p.state.bg_clip = GeneratorClip("colour_bars", width, height,
                                    device=p.device)
    srv = OSCServer(p, port=0)
    srv.start()
    p.state.playing = True

    def pump(k):
        # the JAX tool's pump calls process_one back to back (`:113-115`),
        # and a cycle whose clock frame is the one shown renders nothing
        # (`player.py` process_one): forgetting the shown frame makes
        # every call render the clock's frame with the chain as it stands
        global frames_rendered
        for _ in range(k):
            shown = p.frames_shown
            p.state.frame = -1
            p.process_one()
            frames_rendered += p.frames_shown - shown
    return p, srv, pump


def run_rte_test(port: int | None = None, host: str = "127.0.0.1",
                 match: str | None = None, limit: int | None = None,
                 key: int = 1, frames: int = 2, timeout: float = 10.0,
                 log=lambda s: print(s, flush=True), *, device="cuda",
                 width: int = 192, height: int = 128):
    """Returns (tested_names, {filter: [error, ...]})."""
    owned = None
    pump = None
    if port is None:
        p, srv, pump = self_host(device, width, height)
        port = srv.port
        owned = (p, srv)

    cli = OSCClient(host, port, timeout)
    try:
        names = str(cli.query1("/effects/list") or "").split()
        if match:
            names = [n for n in names if match in n]
        if limit:
            names = names[:int(limit)]
        failures: dict[str, list[str]] = {}
        for j, name in enumerate(names):
            errs = test_filter(cli, name, key, pump, frames)
            if errs:
                failures[name] = errs
                for e in errs:
                    log(f"FAIL {e}")
            else:
                log(f"ok   [{j + 1}/{len(names)}] {name}")
        return names, failures
    finally:
        cli.close()
        if owned:
            owned[0].stop()
            owned[1].stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--match", help="only filters containing SUBSTR")
    ap.add_argument("--limit", type=int, help="stop after N filters")
    ap.add_argument("--key", type=int, default=1)
    ap.add_argument("--frames", type=int, default=2,
                    help="frames rendered per filter (self-host only)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None,
                    help="attach to a running instance instead of "
                         "self-hosting")
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="the self-hosted player's device")
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=128)
    a = ap.parse_args(argv)
    if a.port is None:                   # raises without the device
        resolve_device(a.device, "rte_test")
    try:
        names, failures = run_rte_test(
            a.port, a.host, a.match, a.limit, a.key, a.frames, a.timeout,
            device=a.device, width=a.width, height=a.height)
    except (RuntimeError, socket.timeout, OSError) as e:
        print(f"engine not responding: {e}", file=sys.stderr)
        return 2
    nerr = sum(len(v) for v in failures.values())
    print(f"rte_test: {len(names)} filters, "
          f"{len(failures)} failing, {nerr} errors")
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
