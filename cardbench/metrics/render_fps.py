"""render_fps (and render_fps.<cell>): frames rendered over the whole
window, the window ended by the card's synchronise after its last chunk
(host clock)."""

from cardbench.reading import frame_rate as read  # noqa: F401
