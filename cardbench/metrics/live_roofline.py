"""live_roofline: the least time the traced stretch's live frames could
take on the card (`work.live_frame` a frame) as a share of the device
kernel time the trace holds, in percent."""

from cardbench.reading import roofline as read  # noqa: F401
