"""Effect host and builtin filters (counterpart of
`lives_tpu/effects/__init__.py`)."""

from .host import (Filter, FrameContext, Instance, Param, apply_instance,
                   get_filter, instantiate, list_filters, register_filter)

__all__ = ["Filter", "FrameContext", "Instance", "Param", "apply_instance",
           "get_filter", "instantiate", "list_filters", "register_filter"]
