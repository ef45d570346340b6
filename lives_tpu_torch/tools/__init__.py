"""The user tools over lives_tpu_torch: OSC clients and self-hosting
drivers, each run as `python -m lives_tpu_torch.tools.<name>`.

Counterparts of the JAX package's `tools/batchproc.py`, `monitor.py`,
`rte_test.py`, `soaktest.py` and `mt_edit_soak.py`, with the same names,
functions and command lines. A tool that hosts its own player puts it on
`--device` (`cuda` by default, which raises without CUDA)."""
