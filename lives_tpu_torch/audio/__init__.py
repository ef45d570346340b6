"""Audio helpers (counterpart of `lives_tpu/audio/`): so far only the
framework-neutral `engine.resample` and `engine.to_channels` the clip
editor calls."""
