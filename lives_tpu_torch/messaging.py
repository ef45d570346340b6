"""Message console ring buffer (reference `src/messaging.c`: `d_print`
console + bounded ring; crash-log dump `save_log_file`
clip_load_save.c:151).

Counterpart of `lives_tpu/messaging.py:1-51`, copied: pure Python, and the
port imports nothing of the JAX package. The process-wide `console` is the
port's own."""

from __future__ import annotations

import time
from collections import deque
from pathlib import Path
from typing import Callable

_LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3}


class MessageRing:
    def __init__(self, capacity: int = 10000):
        self.ring: deque[tuple[float, str, str]] = deque(maxlen=capacity)
        self.listeners: list[Callable[[str, str], None]] = []
        self.level = "info"

    def d_print(self, msg: str, level: str = "info"):
        self.ring.append((time.time(), level, msg))
        if _LEVELS.get(level, 1) >= _LEVELS.get(self.level, 1):
            for fn in self.listeners:
                fn(level, msg)

    def debug(self, msg):
        self.d_print(msg, "debug")

    def info(self, msg):
        self.d_print(msg, "info")

    def warn(self, msg):
        self.d_print(msg, "warn")

    def error(self, msg):
        self.d_print(msg, "error")

    def tail(self, n: int = 50) -> list[str]:
        return [f"{lvl}: {m}" for _, lvl, m in list(self.ring)[-n:]]

    def save_log(self, path: str | Path):
        """Crash-log dump (save_log_file)."""
        Path(path).write_text("\n".join(
            f"{time.strftime('%H:%M:%S', time.localtime(t))} {lvl} {m}"
            for t, lvl, m in self.ring))


#: process-wide console (mainw->msg ring analogue)
console = MessageRing()
d_print = console.d_print
