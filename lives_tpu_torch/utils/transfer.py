"""Host-to-device transfers of small parameter arrays that never hold the
host: a copy from pageable memory, or a read of a device value, would wait
for the device's queue to drain."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A small host array on `device`, through pinned memory on a CUDA
    device."""
    t = torch.from_numpy(arr)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pack_column(vals: Sequence, device) -> torch.Tensor:
    """A ``(len(vals), 1)`` float32 column on `device`. The host numbers
    (Python and numpy scalars, CPU tensors) go in one upload; a value that
    is a tensor on a device is copied into its row there, never read
    back."""
    on_dev = [isinstance(v, torch.Tensor) and v.device.type != "cpu"
              for v in vals]
    col = upload(np.asarray([0.0 if d else float(v)
                             for v, d in zip(vals, on_dev)],
                            np.float32).reshape(-1, 1), device)
    for i, (v, d) in enumerate(zip(vals, on_dev)):
        if d:
            col[i].copy_(v.reshape(1))
    return col
