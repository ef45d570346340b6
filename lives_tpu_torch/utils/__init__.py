"""Framework-neutral helpers (counterpart of `lives_tpu/utils/`)."""
