"""Notify-socket monitor (reference tools/monitorlives.pl): subscribes to a
running instance's notify socket and prints decoded events.

Counterpart of `tools/monitor.py:1-53` over the port's `build_message` and
`NOTIFY` (`lives_tpu_torch/osc/server.py:36`). A plain OSC client: it
renders nothing, so it takes no device. `Monitor` is the loop as an
object, so a program can run it on a thread and read what it decoded.

Usage: python -m lives_tpu_torch.tools.monitor --osc-port 49999 \
    [--seconds 30]
"""

from __future__ import annotations

import argparse
import socket
import threading
import time

from ..osc import build_message
from ..osc.server import NOTIFY

NAMES = {v: k for k, v in vars(NOTIFY).items() if isinstance(v, int)}


def decode(data: bytes) -> tuple[str, str]:
    """One notify datagram (`msg_number|msg_string\\n`) as (name, rest)."""
    msg = data.decode(errors="replace").rstrip("\n\x00")
    num, _, rest = msg.partition("|")
    return (NAMES.get(int(num), num) if num.isdigit() else num), rest


class Monitor:
    """A notify socket subscribed to the instance at (host, osc_port):
    `run` prints each event until `seconds` pass or `stop` is called, and
    keeps every decoded (name, rest) in `events`."""

    def __init__(self, osc_port: int = 49999, host: str = "127.0.0.1",
                 out=print):
        self.host, self.osc_port, self.out = host, osc_port, out
        self.events: list[tuple[str, str]] = []
        self._stop = threading.Event()
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.bind(("0.0.0.0", 0))
        self.rx.settimeout(0.2)

    def subscribe(self) -> None:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            tx.sendto(build_message("/lives/open_notify_socket",
                                    self.rx.getsockname()[1]),
                      (self.host, self.osc_port))
        finally:
            tx.close()
        self.out(f"listening for notifications from "
                 f"{self.host}:{self.osc_port}")

    def run(self, seconds: float | None = None) -> list[tuple[str, str]]:
        t_end = time.time() + seconds if seconds else None
        try:
            while not self._stop.is_set() and (t_end is None
                                               or time.time() < t_end):
                try:
                    data, _ = self.rx.recvfrom(4096)
                except socket.timeout:
                    continue
                name, rest = decode(data)
                self.events.append((name, rest))
                self.out(f"{name}: {rest}")
        finally:
            self.rx.close()
        return self.events

    def stop(self) -> None:
        self._stop.set()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--osc-port", type=int, default=49999)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    mon = Monitor(args.osc_port, args.host)
    mon.subscribe()
    try:
        mon.run(args.seconds)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
