"""cardbench: the benchmark of `lives_tpu_torch`, the PyTorch and CUDA
port, on NVIDIA H100 cards.

One command runs one cell once, from the root of a checkout:

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` at the root names the cells; each configuration
(`configs/`), traffic mix (`traffic/`), driver of an entry point
(`drivers/`) and metric reader (`metrics/`) is a file of its own, found by
the name `BENCHMARK.json` gives it. The yardstick lives here and nowhere
in the program: the work counts (`work.py`), the trace reduction
(`trace.py`), the plain reference (`reference/`), the comparison that
decides `correct` (`harness.py`) and the check that no JAX module was
loaded (`guard.py`). `calibrate.py` reads the comparison's numbers over
many seeds, for the program and for its lower-precision control.
"""
