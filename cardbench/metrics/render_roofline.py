"""render_roofline (and render_roofline.<cell>): the least time the
traced stretch's render work could take on the card (`work.render_frame`
a frame) as a share of the device kernel time the trace holds, in
percent."""

from cardbench.reading import roofline as read  # noqa: F401
