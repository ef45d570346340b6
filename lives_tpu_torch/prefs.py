"""Preferences: disk-backed config with live/deferred split.

Successor of `src/preferences.c` (~300 string-keyed prefs; `prefs` /
`future_prefs` double-buffer — deferred prefs apply at restart,
preferences.h:1080+). Here: a typed dataclass of the engine-relevant subset,
a string-keyed overflow dict for everything else, JSON on disk, and the same
live/deferred pattern (`set(..., deferred=True)` lands in `future`; `apply_
future()` is the "restart").

A copy of `lives_tpu/prefs.py:1-221`, which is framework-neutral (the JAX
package cannot be imported without jax, so the port copies it), with
`REFERENCE_PREF_KEYS` (`:105-167`), the reference's pref-key namespace,
which the web UI's preferences panel lists. The port reads two knobs,
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


#: the reference's string pref-key namespace (preferences.h PREF_* values,
#: 186 keys) — all exist, persist through the extra dict, and default to
#: None until set (get() returns typed values once written)
REFERENCE_PREF_KEYS = (
    "active_autotrans", "ahold_threshold", "allow_easing",
    "allow_unstable_effects", "antialias", "apply_gamma", "ar_clipset",
    "ar_layout", "audio_dir", "audio_opts", "audio_player", "audio_src",
    "auto_deinterlace", "auto_trim_pad_audio", "autoclean_trash",
    "autoload_subtitles", "autotrans_key", "backwards_compatibility",
    "badfile_intent", "cdplay_device", "ce_maxspect", "ce_thumb_mode",
    "clear_disk_opts", "cmdline_args", "colour_pick_time",
    "colour_pick_variance", "concat_images", "conserve_space",
    "def_GUI_font", "default_author_name", "default_fps",
    "default_image_format", "disabled_decoders", "disk_quota",
    "dl_bandwidth_K", "dload_match_method", "ds_crit_level",
    "ds_warn_level", "encoder", "encoder_acodec",
    "experimental_bt709_gamma", "extra_colours", "filesel_maximised",
    "focus_steal", "force_single_monitor", "frei0r_path", "genq_mode",
    "gui_theme", "hide_framebar_when_not_playing",
    "hide_main_window_during_playback", "image_dir", "insert_resample",
    "instant_open", "jack_audio_config_file", "jack_audio_connect_server",
    "jack_audio_driver", "jack_audio_startup_server",
    "jack_auxport_client", "jack_inport_client", "jack_opts",
    "jack_outport_client", "jack_trans_config_file",
    "jack_trans_connect_server", "jack_trans_startup_server",
    "jack_transport_driver", "ladspa_path", "last_jack_adriver",
    "last_jack_aserver", "last_jack_tdriver", "last_jack_tserver",
    "letterbox_ce", "letterbox_encoding", "letterbox_mt", "lib_dir",
    "libvis_path", "lives_warning_mask", "load_rfx_builtin",
    "master_volume", "max_clip_volume", "max_disp_vtracks",
    "max_text_messages", "midi_check_rate", "midi_rcv_channel",
    "midi_rpt", "midisynch", "monitors", "mouse_scroll_clips",
    "msg_disable_during_playback", "msg_routing", "msg_textsize",
    "mt_auto_back", "mt_backaudio", "mt_def_achans", "mt_def_arate",
    "mt_def_asamps", "mt_def_fps", "mt_def_height",
    "mt_def_signed_endian", "mt_def_width", "mt_enter_prompt",
    "mt_exit_render", "mt_pertrack_audio", "mt_show_ctx", "mt_undo_buf",
    "never_trim_audio", "nfx_threads", "no_framedrop",
    "no_letterbox_gens", "omc_dev_opts", "omc_js_fname", "omc_midi_fname",
    "open_compression_percent", "open_maximised", "osc_port", "osc_start",
    "output_type", "pa_restart", "pa_start_opts", "pb_quality",
    "pb_quality_adaptive", "pbtimer_maxdif", "pbtimer_resync_factor",
    "pogo_mode", "prefer_trash", "prefix_dir", "proj_dir",
    "push_audio_to_gens", "rec_desktop_audio", "rec_ext_audio",
    "rec_stop-dwarn", "rec_stop-gb", "rec_stop-quota", "recent",
    "record_opts", "recrender_amicro", "recrender_crash_protection",
    "recrender_fx_posn_state", "recrender_presmooth", "recrender_qsmooth",
    "recrender_quant_mode", "recrender_rend_amicro", "recrender_super",
    "render_prompt", "repl_nullframes", "rte_keymodes",
    "rte_keys_virtual", "save_directories", "screen_gamma",
    "screen_scale", "self_transition", "sepwin", "sepwin_type",
    "show_audio_src", "show_button_icons", "show_developer_options",
    "show_menu_icons", "show_messages", "show_msgs_on_startup",
    "show_overlay_messages", "show_player_stats", "show_quota_on_startup",
    "show_recent_files", "show_subtitles", "show_toolbar",
    "show_tooltips", "show_urgency_messages", "startup_interface",
    "startup_phase", "stop_screensaver", "stream_audio_out", "tempdir",
    "trickplay_blend_change", "trickplay_fpschange",
    "trickplay_scratch_back", "trickplay_scratch_fwd", "unique_id",
    "use_screen_gamma", "vid_load_dir", "vid_playback_plugin",
    "vid_save_dir", "video_open_command", "vj_mode_startup",
    "warn_file_size", "webcam_match_method", "weed_plugin_path", "workdir"
)


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
