"""Batch-process every open clip over OSC — the batchproc.pl successor
(reference `tools/batchproc.pl`: run a templated OSC command against
each clip of a running instance; `$clip` in the command expands to the
clip id, e.g. `batchproc.pl "/clip/encode_as,/home/user/file$clip.mpg"`).

Counterpart of `tools/batchproc.py:1-88` (`run_batch` `:42`) over
`lives_tpu_torch.osc.client.OSCClient`. A plain OSC client: it renders
nothing itself, so it takes no device; the instance it drives renders on
its own.

Usage:
    python -m lives_tpu_torch.tools.batchproc \
        '/clip/encode_as,/tmp/out$clip.y4m' [--host H] [--port P] \
        [--timeout S]

The command is `path[,arg1,arg2,...]`. Each clip is made foreground
with /clip/select first (the reference's switch-clip loop), then the
templated command runs; an /app/ping barrier after each command awaits
completion and collects /error replies.

Numeric-looking args are sent as int/float, everything else as string.
Exits nonzero if any per-clip command fails or the engine stops
responding.
"""

from __future__ import annotations

import argparse
import socket
import sys

from ..osc.client import OSCClient


def _coerce(tok: str):
    for typ in (int, float):
        try:
            return typ(tok)
        except ValueError:
            pass
    return tok


def run_batch(cmd: str, host: str = "127.0.0.1", port: int = 49999,
              timeout: float = 5.0,
              log=lambda s: print(s, flush=True)) -> list[tuple[int, bool]]:
    """Run `path[,args...]` once per open clip, `$clip` substituted.

    Returns [(clip_id, ok), ...] in processing order.
    """
    parts = cmd.split(",")
    path_t, args_t = parts[0], parts[1:]
    with OSCClient(host, port, timeout) as cli:
        listing = str(cli.query1("/clip/list") or "").strip()
        ids = [int(t) for t in listing.split()] if listing else []
        results: list[tuple[int, bool]] = []
        for cid in ids:
            sub = lambda s: s.replace("$clip", str(cid))  # noqa: E731
            cli.send("/clip/select", cid)
            cli.send(sub(path_t), *[_coerce(sub(a)) for a in args_t])
            errors = cli.barrier()
            for e in errors:
                log(f"clip {cid}: FAILED: {e}")
            if not errors:
                log(f"clip {cid}: ok")
            results.append((cid, not errors))
        return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", help="path[,arg1,arg2...]; $clip = clip id")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=49999,
                    help="command port of the running instance")
    ap.add_argument("--timeout", type=float, default=5.0)
    a = ap.parse_args(argv)
    try:
        results = run_batch(a.cmd, a.host, a.port, a.timeout)
    except (RuntimeError, socket.timeout, OSError) as e:
        print(f"engine not responding: {e}", file=sys.stderr)
        return 2
    if not results:
        print("no clips open", file=sys.stderr)
        return 1
    return 0 if all(ok for _, ok in results) else 1


if __name__ == "__main__":
    sys.exit(main())
