"""Lightweight OSC client — the role `sendOSC` plays for the
reference's Perl control scripts (`tools/autolives.pl`,
`tools/batchproc.pl`, `tools/lives-rte-test.pl` all shell out to it).

Speaks this package's wire protocol (`osc/protocol.py`, the reference
libOSC format): fire-and-forget sends, structured queries that await
the reply echoed on the request path, and an in-order completion
barrier built on /app/ping (the server dispatches packets sequentially,
so a pong implies every previously sent command finished).

Counterpart of `lives_tpu/osc/client.py:1-74`, copied.
"""

from __future__ import annotations

import socket

from .protocol import build_message, parse_packet


class OSCClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 49999,
                 timeout: float = 5.0):
        self.addr = (host, int(port))
        self.timeout = timeout
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("0.0.0.0", 0))

    # -- plain send ---------------------------------------------------------
    def send(self, path: str, *args) -> None:
        self.sock.sendto(build_message(path, *args), self.addr)

    # -- query: await the structured reply on the request path -------------
    def query(self, path: str, *args, timeout: float | None = None):
        """Returns the reply args list. Raises RuntimeError on /error,
        socket.timeout if the engine does not answer."""
        self.send(path, *args)
        self.sock.settimeout(timeout or self.timeout)
        while True:
            data, _ = self.sock.recvfrom(65536)
            for msg in parse_packet(data):
                if msg.address == "/error":
                    raise RuntimeError(
                        " ".join(str(a) for a in msg.args))
                if msg.address == path:
                    return msg.args

    def query1(self, path: str, *args, timeout: float | None = None):
        """First reply arg (the common scalar-query case)."""
        args_out = self.query(path, *args, timeout=timeout)
        return args_out[0] if args_out else None

    # -- barrier: drain replies until the pong ------------------------------
    def barrier(self, timeout: float | None = None) -> list[str]:
        """Ping and drain replies until the pong arrives; returns the
        /error strings seen on the way (failures of previously sent
        commands). Non-error replies are discarded."""
        self.send("/app/ping")
        self.sock.settimeout(timeout or self.timeout)
        errors: list[str] = []
        while True:
            data, _ = self.sock.recvfrom(65536)
            for msg in parse_packet(data):
                if msg.address == "/error":
                    errors.append(" ".join(str(a) for a in msg.args))
                elif msg.address == "/app/ping":
                    return errors

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
