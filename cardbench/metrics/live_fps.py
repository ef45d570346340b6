"""live_fps: live frames shown over the whole window, each ended by the
card's synchronise (host clock)."""

from cardbench.reading import frame_rate as read  # noqa: F401
