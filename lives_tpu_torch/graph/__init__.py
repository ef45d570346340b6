"""Plan compiler: the single-frame live path and the batch render form
(counterpart of `lives_tpu/graph/__init__.py`)."""

from .nodemodel import FrameGraph, GenSlot, SinkSpec
