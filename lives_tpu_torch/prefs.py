"""Preferences: disk-backed config with live/deferred split.

Successor of `src/preferences.c` (~300 string-keyed prefs; `prefs` /
`future_prefs` double-buffer — deferred prefs apply at restart,
preferences.h:1080+). Here: a typed dataclass of the engine-relevant subset,
a string-keyed overflow dict for everything else, JSON on disk, and the same
live/deferred pattern (`set(..., deferred=True)` lands in `future`; `apply_
future()` is the "restart").

A copy of `lives_tpu/prefs.py:1-221`, which is framework-neutral (the JAX
package cannot be imported without jax, so the port copies it), less
`REFERENCE_PREF_KEYS` (`:105-167`), the reference's pref-key namespace,
which only the web UI reads (ROADMAP Slice 8). The port reads two knobs,
both default "0" as in the JAX package: `fused_stateful`
(`LIVES_TPU_FUSED_STATEFUL`), "1" renders a qualifying stateful chain with
the fused stateful sweep kernel (`graph/stateful_sweep.py`); and
`pallas_composite` (`LIVES_TPU_PALLAS_COMPOSITE`), "1" runs the leading
point effects of a chain over decoded layers as the composite kernel
(`graph/composite.py`). Every other entry of `ENV_KNOBS` is a TPU or XLA
knob of the JAX package that the port leaves unread.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class Prefs:
    # engine
    pb_quality: int = 2             # 1=low 2=med 3=high (PB_QUALITY_*)
    pbq_adaptive: bool = True       # adaptive quality under load
    rte_keys_virtual: int = 64
    nfx_threads: int = 8            # batch width hint (was pthread count)
    # playback
    def_fps: float = 25.0
    loop_mode: bool = True
    # rendering
    render_batch_size: int = 48
    img_type: str = "png"
    # colour
    screen_gamma: float = 1.4
    yuv_clamping: int = 0
    # audio
    audio_rate: int = 44100
    audio_channels: int = 2
    # paths
    workdir: str = ""
    weed_plugin_path: str = ""      # extra filter module dirs
    # devices
    osc_port: int = 49999
    # everything else (string-keyed, reference PREF_* namespace)
    extra: dict[str, Any] = field(default_factory=dict)

    def get(self, key: str, default=None):
        if hasattr(self, key):
            return getattr(self, key)
        return self.extra.get(key, default)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        extra = d.pop("extra")
        d.update(extra)
        return d


class PrefsStore:
    """prefs + future_prefs double buffer, JSON-backed."""

    FIELDS = {f.name for f in dataclasses.fields(Prefs)} - {"extra"}

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path else None
        self.prefs = Prefs()
        self.future: dict[str, Any] = {}
        if self.path and self.path.exists():
            self.load()

    def set(self, key: str, value, deferred: bool = False):
        if deferred:
            self.future[key] = value
            return
        if key in self.FIELDS:
            setattr(self.prefs, key, value)
        else:
            self.prefs.extra[key] = value

    def get(self, key: str, default=None):
        return self.prefs.get(key, default)

    def apply_future(self):
        """Apply deferred prefs (the reference does this at restart)."""
        for k, v in self.future.items():
            self.set(k, v)
        self.future.clear()

    def save(self):
        if not self.path:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(
            {"prefs": self.prefs.to_dict(), "future": self.future},
            indent=1))

    def load(self):
        d = json.loads(self.path.read_text())
        stored = d.get("prefs", {})
        for k, v in stored.items():
            self.set(k, v)
        self.future = d.get("future", {})


#: engine knobs that historically lived in LIVES_TPU_* env vars: the env
#: var (when set) OVERRIDES the stored pref — one config source of truth
#: with env as the override layer (VERDICT round-2 item 8)
ENV_KNOBS = {
    "fused_sweep": ("LIVES_TPU_FUSED_SWEEP", "1"),
    "chain_dtype": ("LIVES_TPU_CHAIN_DTYPE", "bf16"),
    "float_chain": ("LIVES_TPU_FLOAT_CHAIN", "1"),
    "sweep_tile": ("LIVES_TPU_SWEEP_TILE", ""),
    "sweep_vmem_mb": ("LIVES_TPU_SWEEP_VMEM_MB", ""),
    "pallas_composite": ("LIVES_TPU_PALLAS_COMPOSITE", "0"),
    "in_scan_gen": ("LIVES_TPU_IN_SCAN_GEN", "1"),
    "pallas_interpret": ("LIVES_TPU_PALLAS_INTERPRET", "0"),
    "sweep_bands": ("LIVES_TPU_SWEEP_BANDS", ""),
    "fused_stateful": ("LIVES_TPU_FUSED_STATEFUL", "0"),
    "mjpeg_device_decode": ("LIVES_TPU_MJPEG_DEVICE_DECODE", "1"),
}

_store = None


def store() -> "PrefsStore":
    """The process-wide PrefsStore (created lazily; path from
    $LIVES_TPU_PREFS or ~/.lives_tpu/prefsrc)."""
    global _store
    if _store is None:
        import os
        _store = PrefsStore(os.environ.get(
            "LIVES_TPU_PREFS",
            os.path.join(os.path.expanduser("~"), ".lives_tpu",
                         "prefsrc")))
    return _store


def set_store(s):
    """Swap the process store (tests / embedded apps)."""
    global _store
    _store = s


def pref(key: str, default=None):
    """Read one config value through the single source of truth:
    LIVES_TPU_* env override > PrefsStore > default. Engine call sites
    (nodemodel, pallas kernels, player) consult THIS, never os.environ
    directly."""
    import os
    if key in ENV_KNOBS:
        env_name, builtin = ENV_KNOBS[key]
        v = os.environ.get(env_name)
        if v is not None:
            return v
        return str(store().get(key, builtin if default is None
                               else default))
    return store().get(key, default)
