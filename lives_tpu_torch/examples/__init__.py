"""Examples over lives_tpu_torch, each run as `python -m
lives_tpu_torch.examples.<name>`: counterparts of the JAX package's
`examples/embed_demo.py`, `export_demo.py` and `multichip_render.py`, on
`--device` (`cuda` by default, which raises without CUDA)."""
