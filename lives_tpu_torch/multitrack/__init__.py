"""Multitrack timeline model (reference L: src/multitrack.c, headless):
counterpart of `lives_tpu/multitrack/__init__.py`."""

from .model import AudioBlock, Block, Gravity, InsertMode, Multitrack
