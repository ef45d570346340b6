"""The explicit device of an entry point."""

from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """`device` as a torch.device; a CUDA device raises without CUDA, as
    `Player` does (`player/player.py:330-343`). There is no fallback: the
    CPU runs only where the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device 'cuda' was asked for but CUDA is "
                           "not available; pass device='cpu' for the CPU")
    return dev
