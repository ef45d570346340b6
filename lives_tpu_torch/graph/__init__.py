"""Plan compiler, batch render form (counterpart of
`lives_tpu/graph/__init__.py`)."""

from .nodemodel import FrameGraph, SinkSpec
