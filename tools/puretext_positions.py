"""Hold the port's puretext letter positions against the JAX package's
jitted filter over letter counts and batch sizes (on the CPU).

    JAX_PLATFORMS=cpu python tools/puretext_positions.py
    JAX_PLATFORMS=cpu python tools/puretext_positions.py --n 25,56,128 --b 1,4

For each letter count n (a text of n glyphs at 640x360, size 14), batch
size B and mode, it compares `lives_tpu_torch.effects.builtin.puretext.
letters` with the JAX `_positions` and its casts, jitted and vmapped over B
frames as the JAX FrameGraph runs them, over `--pairs` (tc, speed) pairs
(one frame at a time for B = 1, the first 600), and prints the count of
differing cell origins, rotations and opacities. It exits 1 on any
difference.
"""

import argparse
import sys
from pathlib import Path

import numpy as np


def jax_letters(mode, text, size, w, h):
    """The JAX filter's letter arrays, jitted and vmapped over frames
    (`lives_tpu/effects/builtin/puretext.py:203-226`)."""
    import jax
    import jax.numpy as jnp
    from lives_tpu.effects.builtin import puretext as jpt
    atlas, lx, ly, widx, _ = jpt._text_atlas(text, size, w, h, mode == 1)
    n, K, cell, _ = atlas.shape
    idx = np.arange(n)

    def f(t, speed):
        px, py, alpha, var = jpt._positions(
            mode, t, jnp.asarray(lx), jnp.asarray(ly), jnp.asarray(widx),
            jnp.asarray(jpt._hash01(idx, 11)),
            jnp.asarray(jpt._hash01(idx, 97)), n, w, h, cell, speed)
        inside = ((px > -cell) & (px < w) & (py > -cell) & (py < h)) \
            .astype(jnp.float32)
        return (jnp.clip(px.astype(jnp.int32), 0, w - cell),
                jnp.clip(py.astype(jnp.int32), 0, h - cell),
                jnp.clip((var * K).astype(jnp.int32), 0, K - 1),
                alpha * inside)
    return jax.jit(jax.vmap(f))


def text_of(n: int) -> str:
    """A text of n glyphs in words of up to 10 letters."""
    out, glyphs = [], 0
    while glyphs < n:
        ch = "ABCDEFGHIJ KLMNOP"[len(out) % 17]
        out.append(ch)
        glyphs += ch != " "
    return "".join(out)


def main(argv) -> int:
    import jax.numpy as jnp
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from lives_tpu_torch.effects.builtin import puretext
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", default="11,25,48,55,56,64,69,128")
    ap.add_argument("--b", default="1,4,96")
    ap.add_argument("--pairs", type=int, default=3000)
    a = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    tc = np.concatenate([np.arange(0, 10, 0.01), rng.uniform(
        0, 30, a.pairs - 1000)]).astype(np.float32)
    sp = rng.uniform(0.05, 10.0, len(tc)).astype(np.float32)
    sp[:300] = 1.0
    w, h, size, total = 640, 360, 14, 0
    for n in (int(x) for x in a.n.split(",")):
        text = text_of(n)
        for B in (int(x) for x in a.b.split(",")):
            for mode in range(len(puretext.MODES)):
                fn = jax_letters(mode, text, size, w, h)
                on = puretext._atlas_on(text, size, w, h, mode == 1, "cpu")
                bad, stop = 0, (600 if B == 1 else len(tc) // B * B)
                for k in range(0, stop, B):
                    ref = fn(jnp.asarray(tc[k:k + B]),
                             jnp.asarray(sp[k:k + B]))
                    got = puretext.letters(
                        mode, torch.from_numpy(tc[k:k + B])[:, None],
                        torch.from_numpy(sp[k:k + B])[:, None], on, w, h)
                    bad += sum(int((g.numpy() != np.asarray(r)).sum())
                               for g, r in zip(got, ref))
                total += bad
                print(f"n={n} B={B} mode={puretext.MODES[mode]} "
                      f"differing={bad}", flush=True)
    print(f"differing={total}", flush=True)
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
