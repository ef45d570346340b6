"""Process-stable unique ids for clip-like sources.

A copy of `lives_tpu/utils/uid.py:13` (`stable_uid`), which imports no
framework; the port keeps its own copy rather than importing the JAX
package. The values are the same in both packages.

Python's salted str hash makes `hash(name)`-style uids differ across
processes, which breaks anything serialised and reloaded later: recorded
FRAME events reference sources by uid, and crash recovery replays them in
a new process (reference: clip unique_id persists in the clip header,
cliphandler.h). Uids are derived from content with md5 instead."""

from __future__ import annotations

import hashlib


def stable_uid(*parts) -> int:
    """63-bit uid deterministically derived from `parts` (stringified)."""
    h = hashlib.md5("\x1f".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)
