"""Hold `lives_tpu_torch.utils.sinf` bit for bit against `jnp.sin` on every
float32 in a range of bit patterns (on the CPU, where XLA calls the C
library's `sinf`); with `--cos`, `utils.sinf.cosf` against `jnp.cos` (the
C library's `cosf`), and with `--exp`, `utils.xla_exp.expf` against
`jax.jit(jnp.exp)` (XLA's own expansion), each on x and -x.

    JAX_PLATFORMS=cpu python tools/sinf_exhaustive.py            # [0, 2^17)
    JAX_PLATFORMS=cpu python tools/sinf_exhaustive.py 0x0 0x24000000
    JAX_PLATFORMS=cpu python tools/sinf_exhaustive.py --cos
    JAX_PLATFORMS=cpu python tools/sinf_exhaustive.py --exp 0x0 0x42b40000

The default range, every non-negative float32 below 2^17 (bit patterns
0 to 0x48000000, 1.2e9 values), covers `spread`'s hash arguments (up to
about 1.3e5 at 1920x1080). It prints a line a chunk of 2^23 values and
the mismatch count; it exits 1 on any mismatch.
"""

import sys
import time
from pathlib import Path

import numpy as np


def main(argv) -> int:
    import jax
    import jax.numpy as jnp
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from lives_tpu_torch.utils.sinf import cosf, sinf
    from lives_tpu_torch.utils.xla_exp import expf
    fn = argv.pop(0)[2:] if argv and argv[0] in ("--cos", "--exp") \
        else "sin"
    twin, ref_fn, signs = {
        "sin": (sinf, jnp.sin, (1,)), "cos": (cosf, jnp.cos, (1, -1)),
        "exp": (expf, jax.jit(jnp.exp), (1, -1))}[fn]
    lo, hi = (int(a, 0) for a in argv) if argv else (0, 0x48000000)
    step, bad, t0 = 1 << 23, 0, time.perf_counter()
    for a in range(lo, hi, step):
        n = 0
        for sign in signs:
            x = sign * np.arange(a, min(a + step, hi),
                                 dtype=np.uint32).view(np.float32)
            ref = np.asarray(ref_fn(x)).view(np.uint32)
            got = twin(torch.from_numpy(x)).numpy().view(np.uint32)
            n += int((ref != got).sum())
        bad += n
        print(f"chunk {a:#010x} mismatches={n} "
              f"s={time.perf_counter() - t0:.1f}", flush=True)
    print(f"{fn} range {lo:#010x}-{hi:#010x} values={hi - lo} "
          f"signs={len(signs)} mismatches={bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
