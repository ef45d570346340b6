"""Realtime player (reference L6, src/player.c): counterpart of
`lives_tpu/player/__init__.py`."""

from .gl import GLSink
from .player import KeyMap, Player, PlayerState
from .sinks import CollectSink, NullSink, PNGSink, Y4MSink

__all__ = ["Player", "PlayerState", "KeyMap", "CollectSink", "NullSink",
           "PNGSink", "Y4MSink", "GLSink"]
