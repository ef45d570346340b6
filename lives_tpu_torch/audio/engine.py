"""Audio resampling and channel mixing for the clip editor.

Copies of `lives_tpu/audio/engine.py:65-75` (`resample`) and `:94-104`
(`to_channels`), which import no framework; the port keeps its own copy
rather than importing the JAX package. `clipedit.paste_insert` and
`merge_clipboard` and `audioedit.append_audio` call them. Audio is float32
(n, channels) in [-1, 1] on the host, as in the JAX package.

The rest of the JAX module (sample conversion, velocity resampling, the
event-list mix-down, the realtime feeders) is ROADMAP Queue 1 item 23.
"""

from __future__ import annotations

import numpy as np


def resample(data: np.ndarray, from_rate: float, to_rate: float) -> np.ndarray:
    """Linear-interp resample (n, ch) (sample_move_d16_d16 policy)."""
    if from_rate == to_rate or len(data) == 0:
        return data
    n_out = int(round(len(data) * to_rate / from_rate))
    x = np.arange(n_out, dtype=np.float64) * (from_rate / to_rate)
    i0 = np.minimum(x.astype(np.int64), len(data) - 1)
    i1 = np.minimum(i0 + 1, len(data) - 1)
    f = (x - i0)[:, None].astype(np.float32)
    return data[i0] * (1.0 - f) + data[i1] * f


def to_channels(data: np.ndarray, channels: int) -> np.ndarray:
    """Up/down-mix channel count (simple average / duplicate)."""
    if data.shape[1] == channels:
        return data
    if channels == 1:
        return data.mean(1, keepdims=True)
    if data.shape[1] == 1:
        return np.repeat(data, channels, 1)
    out = np.zeros((len(data), channels), np.float32)
    out[:, : data.shape[1]] = data[:, :channels]
    return out
