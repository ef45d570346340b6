"""Pixel-engine ops (counterpart of `lives_tpu/ops/__init__.py`)."""
