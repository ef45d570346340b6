"""Map which float forms the JAX package's jitted puretext plan computes
for each letter, over letter counts, batch sizes and modes (on the CPU).

    JAX_PLATFORMS=cpu python tools/puretext_forms.py
    JAX_PLATFORMS=cpu python tools/puretext_forms.py --n 50-72 --b 1,96
    JAX_PLATFORMS=cpu python tools/puretext_forms.py --check

XLA's code generator contracts a multiply and an add into one FMA where
LLVM keeps a loop over the letters, not where it unrolls one. Two of
puretext's per-letter values end in such a sum: spiral_text's theta
`i * 0.55 - ts * 0.6` and spinning_letters' rotation `ts * 1.5 + i * 0.13`
(`lives_tpu/effects/builtin/puretext.py:157,165`); a one-letter
starfield's distance `ts * 0.4 + rnd2` is a third. For each letter
count n (`chip_smoke.letters_text(n)`, n glyphs at 640x360, size 14),
batch size B and mode, this evaluates the JAX filter's letters (`puretext_positions.
jax_letters`: cell origins, rotations, opacities), jitted and vmapped
over B frames as the JAX FrameGraph runs them, on `--pairs` (tc, speed)
pairs, beside the port's `puretext.letters` with every letter in the
unrolled form and with every letter contracted. One line a case
classifies each letter (`c` equal to the contracted form alone, `u` to
the unrolled form alone, `.` to both, `?` to neither; runs such as
`c0-63 u64-68`; the other modes print `whole`) and counts the letters
where the port's rule (`puretext.contracted`: `LOOP_KEPT`, `LANES`)
picks a form the plan does not compute (`rule_differing`). The last line
is the total, `differing=N`. The default grid is every letter count of
1-256, the port's batch sizes (1: the player and `FrameGraph.run`; 8:
`render_last_recording`; 32: the console and the editor; 96: the
largest a render's `batch_size` is held to) and the seven modes: 7,168
cases, about 40 minutes on one core (split `--n` over processes). Past
96 frames a batch the rule misses spiral_text's form on 1-2 letters of
56-63 (`--n 56-63 --b 128 --modes 0`).

`--check` exits 1 where the rule and the plan disagree on any letter.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

W, H, SIZE = 640, 360, 14


def parse_counts(s: str) -> list[int]:
    out = []
    for part in s.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b or a) + 1))
    return out


def jax_positions(mode, text):
    """The JAX `_positions` of `text`, jitted and vmapped over frames."""
    import jax
    import jax.numpy as jnp
    from lives_tpu.effects.builtin import puretext as jpt
    atlas, lx, ly, widx, _ = jpt._text_atlas(text, SIZE, W, H, mode == 1)
    n, _, cell, _ = atlas.shape
    idx = np.arange(n)

    def f(t, speed):
        return jpt._positions(
            mode, t, jnp.asarray(lx), jnp.asarray(ly), jnp.asarray(widx),
            jnp.asarray(jpt._hash01(idx, 11)),
            jnp.asarray(jpt._hash01(idx, 97)), n, W, H, cell, speed)
    return jax.jit(jax.vmap(f))


def runs(labels: str) -> str:
    """'ccccuu' -> 'c0-3 u4-5'."""
    out, j = [], 0
    while j < len(labels):
        k = j
        while k + 1 < len(labels) and labels[k + 1] == labels[j]:
            k += 1
        out.append(f"{labels[j]}{j}" + (f"-{k}" if k > j else ""))
        j = k + 1
    return " ".join(out)


def classify(ref: np.ndarray, u: np.ndarray, c: np.ndarray) -> str:
    """Per letter (last axis): which of the two forms equals `ref` on
    every sample."""
    n = ref.shape[-1]
    mu = (u == ref).reshape(-1, n).all(axis=0)
    mc = (c == ref).reshape(-1, n).all(axis=0)
    return "".join("." if a and b else "u" if a else "c" if b else "?"
                   for a, b in zip(mu, mc))


def samples(pairs: int, B: int):
    rng = np.random.default_rng(0)
    tc = np.concatenate([np.arange(0, 10, 0.01), rng.uniform(
        0, 30, max(pairs - 1000, 0))]).astype(np.float32)[:pairs]
    sp = rng.uniform(0.05, 10.0, len(tc)).astype(np.float32)
    sp[:300] = 1.0
    stop = len(tc) // B * B
    return tc[:stop].reshape(-1, B), sp[:stop].reshape(-1, B)


def main(argv) -> int:
    import jax.numpy as jnp
    import torch
    from chip_smoke import letters_text
    from lives_tpu_torch.effects.builtin import puretext
    torch.set_num_threads(1)
    from tools.puretext_positions import jax_letters
    rule_of = puretext.contracted
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", default="1-256")
    ap.add_argument("--b", default="1,8,32,96")
    ap.add_argument("--modes", default="0-6")
    ap.add_argument("--pairs", type=int, default=768)
    ap.add_argument("--check", action="store_true")
    a = ap.parse_args(argv)
    bad_total = 0
    for B in (int(x) for x in a.b.split(",")):
        tcs, sps = samples(a.pairs, B)
        for n in parse_counts(a.n):
            text = letters_text(n)
            for mode in parse_counts(a.modes):
                fn = jax_letters(mode, text, SIZE, W, H)
                on = puretext._atlas_on(text, SIZE, W, H, mode == 1, "cpu")
                nl = on[0].shape[0]
                refs = [np.stack([np.asarray(v, np.float64) for v in
                                  fn(jnp.asarray(tc), jnp.asarray(sp))])
                        for tc, sp in zip(tcs, sps)]
                # the port's forms do not depend on the batch: all frames
                # at once, with no letter and with every letter contracted
                forms = {}
                for contract in (False, True):
                    puretext.contracted = lambda *_, k=nl * contract: k
                    try:
                        forms[contract] = [np.stack([
                            g.numpy().astype(np.float64)
                            for g in puretext.letters(
                                mode, torch.from_numpy(tcs.reshape(-1, 1)),
                                torch.from_numpy(sps.reshape(-1, 1)), on,
                                W, H, B)])]
                    finally:
                        puretext.contracted = rule_of
                # (frames, 4 values, letters)
                ref = np.concatenate(refs, 1).transpose(1, 0, 2)
                u = np.concatenate(forms[False], 1).transpose(1, 0, 2)
                c = np.concatenate(forms[True], 1).transpose(1, 0, 2)
                rule = np.arange(nl) < rule_of(mode, nl, B)
                pick = np.where(rule, c, u)
                bad = int((pick != ref).any(axis=(0, 1)).sum())
                bad_total += bad
                if mode in (0, 1):   # spiral's px, py; spinning's var
                    sl = slice(0, 2) if mode == 0 else slice(2, 3)
                    what = ("theta " if mode == 0 else "var ") + runs(
                        classify(ref[:, sl], u[:, sl], c[:, sl]))
                else:
                    what = "whole"
                print(f"n={nl} B={B} mode={puretext.MODES[mode]} {what} "
                      f"rule_differing={bad}", flush=True)
    print(f"differing={bad_total}", flush=True)
    return 1 if a.check and bad_total else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
