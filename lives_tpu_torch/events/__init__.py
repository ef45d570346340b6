"""Event lists + batch renderer (counterpart of
`lives_tpu/events/__init__.py`)."""

from .event_list import (Event, EventList, EventType, TICKS_PER_SECOND,
                         filter_deinit_event, filter_init_event,
                         filter_map_event, frame_event, marker_event,
                         param_change_event)
from .renderer import render_events, render_to_arrays, segment_events
from .weed_binary import (load_event_list_binary, save_event_list_binary,
                          read_plants, serialise_plant)
