"""Realtime player (reference L6, src/player.c): counterpart of
`lives_tpu/player/__init__.py`, less the GL and SDL sinks (ROADMAP Queue 1
item 23)."""

from .player import KeyMap, Player, PlayerState
from .sinks import CollectSink, NullSink, Y4MSink

__all__ = ["Player", "PlayerState", "KeyMap", "CollectSink", "NullSink",
           "Y4MSink"]
