"""MilkDrop `.milk` preset interpreter (the projectM role) on torch tensors.

Counterpart of `lives_tpu/effects/milkdrop.py` (reference
`lives-plugins/plugins/playback/video/projectM.cpp`): the ns-eel subset of
`per_frame_*` / `per_pixel_*` equations (tokenizer and parser `:68-212`,
`_Compiler` `:258-420`, `compile_expressions` `:449`), `parse_preset`
and `MilkPreset` (`:492-620`), and `build_preset_process` (`:868-1226`),
which makes a preset a stateful generator: per-frame and per-pixel
equations, the warp field and its bilinear feedback of the previous
frame, the 48-point waveform splat, custom waves then custom shapes, the
motion-vector lattice, the warp and comp shaders of
`effects/milkshader.py` (or echo, post-filters and gamma), u8 out. The
state is `(prev (3,H,W) f32, q (32,) f32, inited (1,))`, and the two
2^20-entry megabuf/gmegabuf arrays where the preset uses them
(`uses_buffers`). `register_milk_preset`, `load_milk_preset`,
`BUILTIN_PRESETS` and `register_builtin_presets` (`:1229-1357`) register
presets as `milk_<name>` generator filters.

Where the scalars live. A frame's per-frame equations, q-vars and object
code evaluate on the preset's device, as 0-d float32 tensors, beside the
per-pixel work: nothing is read back to the host, so the card's queue
never drains inside a frame, at the price of one small launch for each
scalar operation (chip_smoke.py phase 23a counts the launches a frame).
Numbers fold to Python floats wherever no runtime value is involved, as
the JAX package's compiler folds them (`:35-37`).

Numerics. The JAX package's frame is one jitted XLA program
(`GeneratorClip` jits `process`), and the port computes what that CPU
plan computes wherever a hard select reads a value (`if`/`above`, the
wrap seam `u - floor(u)`, the texel floors, a shape's edge, the
shaders' comparisons): a multiply that feeds an add is one FMA
(`milkshader._Prod`, `add`, `sub`; a q-var's products stay in their lane,
`milkshader.land`), `(A * C1) * C2` folds its constants, a division by a
constant is a product with the float32 reciprocal, `sin`, `cos`, `exp`
and `log` are the twins of `utils.sinf` and `utils.xla_exp`, and `rand`
is the int32 hash with int32 wrapping. Other transcendentals evaluate in
float64 and round once to float32 (within an ulp of XLA's own
approximations). The splats (the
waveform's, the custom waves', the motion vectors' and darken_center's
`exp`) feed no hard select; they evaluate in float64, so the CPU and a GPU
give the same bits. A megabuf write with colliding indices keeps the last
writer, as XLA's CPU scatter does, on every device.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..constants import Gamma, Palette
from ..layer import Layer
from ..utils.sinf import cosf, sincosf, sinf
from ..utils.transfer import upload
from ..utils.xla_exp import expf, fma32, logf
from .milkshader import (Vec, _box_blur, _i32, _wrap32, add, atan2,
                         bilinear_rows, compile_hlsl, div_const, f32, f64fn,
                         land, mul, recip, sub, tag, to_t, val)

__all__ = ["compile_expressions", "parse_preset", "MilkPreset",
           "load_milk_preset", "register_milk_preset", "BUILTIN_PRESETS",
           "register_builtin_presets", "build_preset_process", "wave_splat"]


# ---------------------------------------------------------------------------
# ns-eel subset: tokenizer (`milkdrop.py:59-82`)


_TOKEN_RE = re.compile(r"""
    (?P<num>(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|==|!=|&&|\|\||[-+*/%^=;,()!<>?:])
  | (?P<ws>\s+)
  | (?P<comment>//[^\n]*)
""", re.VERBOSE)


def _tokenize(src: str) -> list[str | float]:
    out: list[str | float] = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if m is None:
            raise ValueError(f"milkdrop expr: bad char {src[i]!r} at {i}")
        i = m.end()
        if m.lastgroup == "num":
            out.append(float(m.group("num")))
        elif m.lastgroup == "name":
            out.append(m.group("name").lower())
        elif m.lastgroup == "op":
            out.append(m.group("op"))
    return out


# ---------------------------------------------------------------------------
# parser -> tiny AST (tuples), `milkdrop.py:90-208`: ("num", v) ("var",
# name) ("call", name, args) ("bin", op, a, b) ("un", op, a) ("tern", c,
# a, b) ("assign", name, expr) ("bufassign", buf, index, expr)


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, t):
        got = self.next()
        if got != t:
            raise ValueError(f"milkdrop expr: expected {t!r}, got {got!r}")

    def statements(self):
        """assign (';' assign)* — trailing/empty statements tolerated."""
        out = []
        while self.peek() is not None:
            if self.peek() == ";":
                self.next()
                continue
            out.append(self.assign())
        return out

    def assign(self):
        if (isinstance(self.peek(), str)
                and self.i + 1 < len(self.toks)
                and self.toks[self.i + 1] == "="):
            name = self.next()
            self.next()
            return ("assign", name, self.assign())
        e = self.ternary()
        # ns-eel lvalue call: megabuf(i) = v / gmegabuf(i) = v
        if (e[0] == "call" and e[1] in ("megabuf", "gmegabuf")
                and len(e[2]) == 1 and self.peek() == "="):
            self.next()
            return ("bufassign", e[1], e[2][0], self.assign())
        return e

    def ternary(self):
        c = self.or_()
        if self.peek() == "?":
            self.next()
            a = self.assign()
            self.expect(":")
            b = self.assign()
            return ("tern", c, a, b)
        return c

    def _binlevel(self, sub_, ops):
        def level():
            a = sub_()
            while self.peek() in ops:
                op = self.next()
                a = ("bin", op, a, sub_())
            return a
        return level

    def or_(self):
        return self._binlevel(self.and_, ("||",))()

    def and_(self):
        return self._binlevel(self.cmp, ("&&",))()

    def cmp(self):
        return self._binlevel(self.addsub,
                              ("==", "!=", "<", ">", "<=", ">="))()

    def addsub(self):
        return self._binlevel(self.muldiv, ("+", "-"))()

    def muldiv(self):
        return self._binlevel(self.unary, ("*", "/", "%"))()

    def unary(self):
        if self.peek() == "-":
            self.next()
            return ("un", "-", self.unary())
        if self.peek() == "!":
            self.next()
            return ("un", "!", self.unary())
        if self.peek() == "+":
            self.next()
            return self.unary()
        return self.power()

    def power(self):
        a = self.primary()
        if self.peek() == "^":  # right-assoc, binds tighter than unary -
            self.next()
            return ("bin", "^", a, self.unary())
        return a

    def primary(self):
        t = self.next()
        if isinstance(t, float):
            return ("num", t)
        if t == "(":
            e = self.assign()
            self.expect(")")
            return e
        if isinstance(t, str) and t not in ("", None):
            if self.peek() == "(":
                self.next()
                args = []
                if self.peek() != ")":
                    args.append(self.assign())
                    while self.peek() == ",":
                        self.next()
                        args.append(self.assign())
                self.expect(")")
                return ("call", t, args)
            return ("var", t)
        raise ValueError(f"milkdrop expr: unexpected token {t!r}")


# ---------------------------------------------------------------------------
# evaluator


def _is_t(v) -> bool:
    return isinstance(val(v), torch.Tensor)


def rand_hash(frame, site: int, dev) -> torch.Tensor:
    """Counter-based uniform in [0,1) of (frame, site), `milkdrop.py:215`:
    an int32 murmur-style mix that wraps like int32, exact on every
    device; frame is a float32 tensor (truncated to int32) or a number.
    A 0-d float32 tensor on `dev`."""
    if isinstance(val(frame), torch.Tensor):
        f = val(frame).to(torch.float32).to(torch.int32).to(torch.int64)
    else:
        f = torch.full((), int(np.float32(frame)), dtype=torch.int64,
                       device=dev)
    h = _wrap32(f * _i32(0x9E3779B1) + _i32(site * 0x85EBCA6B))
    h = h ^ (h >> 13)
    h = _wrap32(h * _i32(0xC2B2AE35))
    h = h ^ (h >> 16)
    return (h & 0x7FFFFF).to(torch.float32) * f32(1.0 / 0x800000)


def _truthy(v):
    v = val(v)
    if isinstance(v, float):
        return 1.0 if abs(v) > 1e-30 else 0.0
    return (torch.abs(v) > 1e-30).to(torch.float32)


def _minmax(fn, a, b):
    a, b = val(a), val(b)
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return fn(a, b)
    return torch.clamp(a, max=f32(b)) if fn is torch.minimum \
        else torch.clamp(a, min=f32(b))


#: float32(1e-38), a subnormal, and 1 / float32(ln 10): jnp.log10 is
#: log(x) / log(10), and XLA folds the division into this product
_EPS38 = f32(1e-38)
_RLN10 = recip(f32(math.log(10.0)))

_F1 = {
    "sin": (math.sin, sinf), "cos": (math.cos, cosf),
    "tan": (math.tan, f64fn(torch.tan)),
    "asin": (math.asin, f64fn(torch.asin)),
    "acos": (math.acos, f64fn(torch.acos)),
    "atan": (math.atan, f64fn(torch.atan)),
    "sqrt": (lambda x: math.sqrt(abs(x)),
             lambda x: torch.sqrt(torch.abs(x))),
    "exp": (math.exp, expf),
    "log": (lambda x: math.log(x) if x > 0 else -87.3,
            lambda x: logf(torch.clamp(x, min=_EPS38))),
    "log10": (lambda x: math.log10(x) if x > 0 else -37.9,
              lambda x: logf(torch.clamp(x, min=_EPS38)) * _RLN10),
    "abs": (abs, torch.abs),
    "floor": (math.floor, torch.floor), "ceil": (math.ceil, torch.ceil),
    "int": (float, torch.trunc),
    "sign": (lambda x: float(np.sign(x)), torch.sign),
    "sqr": (lambda x: x * x, lambda x: mul(x, x)),
    "invsqrt": (lambda x: 1.0 / math.sqrt(abs(x) + 1e-30),
                f64fn(lambda x: torch.rsqrt(torch.abs(x) + 1e-30))),
    "bnot": (lambda x: 0.0 if abs(x) > 1e-30 else 1.0,
             lambda x: (torch.abs(x) <= 1e-30).to(torch.float32)),
}


def safe_pow(a, b):
    """eel pow on tensors (`milkdrop.py:409`): exp(log(max(|a|, 1e-38)) *
    b), negated where a < 0 and trunc(b) is odd (projectM's behaviour).
    A constant base folds on the host, as XLA folds it."""
    a, b = val(a), val(b)
    tb = isinstance(b, torch.Tensor)
    if not isinstance(a, torch.Tensor):
        af = f32(a)
        la = f32(math.log(max(abs(af), f32(1e-38))))
        if tb:
            # exp(0 * b) is 1 wherever b is finite, NaN elsewhere
            e = b * 0.0 + 1.0 if la == 0.0 else expf(b * la)
        else:
            e = float(expf(torch.tensor(f32(la * f32(b)))))
        if af >= 0:
            return e
        if tb:
            return e * torch.where(torch.remainder(torch.trunc(b), 2) == 1,
                                   -1.0, 1.0)
        return -e if math.trunc(b) % 2 == 1 else e
    la = logf(torch.clamp(torch.abs(a), min=_EPS38))
    e = expf(val(mul(la, b)))
    if tb:
        neg = torch.where(torch.remainder(torch.trunc(b), 2) == 1, -1.0, 1.0)
        return e * torch.where(a < 0, neg, 1.0)
    if math.trunc(b) % 2 == 1:
        return e * torch.where(a < 0, -1.0, 1.0)
    return e


class _Compiler:
    """AST -> value (`milkdrop.py:258`). Constant subtrees fold to Python
    floats; anything touching a runtime value is a float32 tensor on the
    preset's device (or a pending product, `milkshader._Prod`)."""

    def __init__(self, dev):
        self.rand_sites = 0
        self.dev = dev

    def eval(self, node, env):
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "var":
            return env.get(node[1], 0.0)
        if kind == "assign":
            env[node[1]] = self.eval(node[2], env)
            return env[node[1]]
        if kind == "un":
            v = self.eval(node[2], env)
            if node[1] == "-":
                return tag(-v, land(v)) if isinstance(v, torch.Tensor) \
                    else -v
            v = val(v)
            return 1.0 - _truthy(v) if isinstance(v, float) \
                else tag((torch.abs(v) <= 1e-30).to(torch.float32), land(v))
        if kind == "tern":
            c = self.eval(node[1], env)
            a = self.eval(node[2], env)
            b = self.eval(node[3], env)
            return tag(self._select(c, a, b), land(c, a, b))
        if kind == "bin":
            a = self.eval(node[2], env)
            b = self.eval(node[3], env)
            r = self._bin(node[1], a, b)
            return r if node[1] in "+-*" else tag(r, land(a, b))
        if kind == "call":
            return self._call(node[1], node[2], env)
        if kind == "bufassign":
            v = self.eval(node[3], env)
            idx = self.eval(node[2], env)
            buf = env.get(node[1])
            if buf is None:
                return v          # buffers not wired: write is a no-op
            env[node[1]] = buf_write(buf, idx, v)
            return v
        raise ValueError(f"bad node {node!r}")

    @staticmethod
    def _select(c, a, b):
        c = val(c)
        if isinstance(c, float):
            return a if abs(c) > 1e-30 else b
        return torch.where(torch.abs(c) > 1e-30, val(a), val(b))

    def _bin(self, op, a, b):
        const = not _is_t(a) and not _is_t(b)
        if op == "+":
            return add(a, b)
        if op == "-":
            return sub(a, b)
        if op == "*":
            return mul(a, b)
        a, b = val(a), val(b)
        if op == "/":
            if const:
                return a / b if abs(b) > 1e-30 else 0.0
            if not isinstance(b, torch.Tensor):
                return div_const(a, b) if abs(b) > 1e-30 else 0.0
            ok = torch.abs(b) > 1e-30
            return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)
        if op == "%":  # eel: integer modulo, x%0 == 0
            if const:
                bi = int(b)
                return float(int(a) % bi) if bi else 0.0
            ai = torch.trunc(to_t(a, self.dev))
            if not isinstance(b, torch.Tensor):
                bi = math.trunc(b)
                if abs(bi) <= 0.5:
                    return 0.0
                return sub(ai, mul(float(bi), torch.floor(
                    val(div_const(ai, float(bi))))))
            bi = torch.trunc(b)
            ok = torch.abs(bi) > 0.5
            safe = torch.where(ok, bi, 1.0)
            return torch.where(ok, val(sub(ai, mul(safe, torch.floor(
                ai / safe)))), 0.0)
        if op == "^":
            if const:
                try:
                    return float(math.pow(a, b))
                except ValueError:
                    return 0.0
            return safe_pow(a, b)
        if op in ("==", "!=", "<", ">", "<=", ">="):
            if const:
                return float({"==": a == b, "!=": a != b, "<": a < b,
                              ">": a > b, "<=": a <= b, ">=": a >= b}[op])
            fn = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
                  ">": torch.gt, "<=": torch.le, ">=": torch.ge}[op]
            if not isinstance(a, torch.Tensor):
                a = f32(a)
                return fn(torch.full_like(b, a), b).to(torch.float32)
            return fn(a, f32(b) if not isinstance(b, torch.Tensor)
                      else b).to(torch.float32)
        if op == "&&":
            return _truthy(a) * _truthy(b)
        if op == "||":
            ta, tb = _truthy(a), _truthy(b)
            return val(sub(ta + tb, mul(ta, tb)))
        raise ValueError(f"bad op {op}")

    def _call(self, name, argn, env):
        args = [self.eval(a, env) for a in argn]
        r = self._call_values(name, args, env)
        if name in ("rand", "megabuf", "gmegabuf"):
            return r
        return tag(r, land(*args))

    def _call_values(self, name, args, env):
        const = all(not _is_t(a) for a in args)
        if name in _F1 and len(args) == 1:
            py, tf = _F1[name]
            return py(val(args[0])) if const else tf(val(args[0]).to(torch.float32))
        if name == "pow":
            return self._bin("^", args[0], args[1])
        if name == "atan2":
            return math.atan2(args[0], args[1]) if const \
                else atan2(to_t(args[0], self.dev), to_t(args[1], self.dev))
        if name in ("min", "max"):
            if const:
                return (min if name == "min" else max)(*args)
            return _minmax(torch.minimum if name == "min" else torch.maximum,
                           args[0], args[1])
        if name == "sigmoid":
            c = args[1] if len(args) > 1 else 1.0
            if const:
                return 1.0 / (1.0 + math.exp(-args[0] * c))
            return f64fn(torch.sigmoid)(to_t(mul(args[0], c), self.dev))
        if name == "if":
            return self._select(args[0], args[1], args[2])
        if name in ("equal", "above", "below"):
            op = {"equal": "==", "above": ">", "below": "<"}[name]
            return self._bin(op, args[0], args[1])
        if name in ("band", "bor"):
            return self._bin("&&" if name == "band" else "||",
                             args[0], args[1])
        if name == "rand":
            self.rand_sites += 1
            site = self.rand_sites
            hi = args[0] if args else 1.0
            return mul(rand_hash(env.get("frame", 0.0), site, self.dev), hi)
        if name in ("megabuf", "gmegabuf"):
            # ns-eel indexed scratch memory; out-of-range reads are 0
            buf = env.get(name)
            if buf is None:
                return 0.0
            return buf_read(buf, args[0])
        raise ValueError(f"milkdrop expr: unknown function {name}")


def _index(buf, idx):
    """(int index tensor or int, in-range mask or bool) of an eel index:
    trunc of its float32 value."""
    n = buf.shape[0]
    idx = val(idx)
    if not isinstance(idx, torch.Tensor):
        i = math.trunc(f32(idx))
        return i, 0 <= i < n
    i = torch.trunc(idx.to(torch.float32)).to(torch.int32).to(torch.int64)
    return i, (i >= 0) & (i < n)


def buf_read(buf, idx):
    """buf[trunc(idx)], 0 out of range (`milkdrop.py:394-405`)."""
    i, ok = _index(buf, idx)
    if not isinstance(i, torch.Tensor):
        return buf[i] if ok else 0.0
    safe = torch.clamp(i, 0, buf.shape[0] - 1)
    return torch.where(ok, buf[safe], 0.0)


def buf_write(buf, idx, v) -> torch.Tensor:
    """A new buffer with buf[trunc(idx)] = v (`milkdrop.py:295-306`): an
    out-of-range index writes the current value at the clipped index back,
    and where indices collide the last writer in row-major order wins, as
    XLA's CPU scatter applies its updates in order; on every device."""
    i, ok = _index(buf, idx)
    if not isinstance(i, torch.Tensor):
        if not ok:
            return buf
        out = buf.clone()
        out[i] = val(v) if isinstance(val(v), torch.Tensor) else f32(val(v))
        return out
    # the index and value grids broadcast together (x is a row, y a
    # column here; the JAX package's are whole frames), in row-major order
    i, ok, v = torch.broadcast_tensors(i, ok, to_t(v, buf.device))
    safe = torch.clamp(i, 0, buf.shape[0] - 1).reshape(-1)
    cur = buf[safe]
    vals = torch.where(ok.reshape(-1), v.reshape(-1), cur)
    if safe.numel() > 1:
        # every write to an index carries the value of its last writer
        pos = torch.arange(safe.numel(), device=buf.device)
        last = torch.full_like(buf, -1, dtype=torch.int64).scatter_reduce(
            0, safe, pos, "amax")
        vals = vals[last[safe]]
    return buf.index_put((safe,), vals)


_KNOWN_FNS = frozenset(_F1) | {
    "pow", "atan2", "min", "max", "sigmoid", "if", "equal", "above",
    "below", "band", "bor", "rand", "megabuf", "gmegabuf"}


def _check_calls(node):
    if node[0] == "call":
        if node[1] not in _KNOWN_FNS:
            raise ValueError(f"milkdrop expr: unknown function {node[1]}")
        for a in node[2]:
            _check_calls(a)
    elif node[0] in ("bin",):
        _check_calls(node[2])
        _check_calls(node[3])
    elif node[0] == "tern":
        for c in node[1:]:
            _check_calls(c)
    elif node[0] == "un":
        _check_calls(node[2])
    elif node[0] == "assign":
        _check_calls(node[2])
    elif node[0] == "bufassign":
        _check_calls(node[2])
        _check_calls(node[3])


def uses_buffers(*sources: str) -> bool:
    """True when any equation block references megabuf/gmegabuf (gates
    whether the generator's state carries the scratch arrays)."""
    return any("megabuf" in (s or "") for s in sources)


def compile_expressions(src: str) -> Callable[..., dict]:
    """Compile a ';'-separated ns-eel statement block into `fn(env, dev)
    -> env` (env: name -> Python float or float32 tensor; `dev` is where a
    runtime value made from numbers alone, `rand`'s hash, lives: the
    device of the env's tensors by default, else the CPU)."""
    stmts = _Parser(_tokenize(src)).statements()
    for s in stmts:
        _check_calls(s)

    def run(env: dict, dev=None) -> dict:
        env = dict(env)
        if dev is None:
            dev = next((val(v).device for v in env.values()
                        if isinstance(val(v), torch.Tensor)),
                       torch.device("cpu"))
        comp = _Compiler(dev)
        for s in stmts:
            comp.eval(s, env)
        return env

    return run


# ---------------------------------------------------------------------------
# preset file (`milkdrop.py:471-616`)


#: custom-shape defaults (MilkDrop's CShape defaults)
SHAPE_DEFAULTS = {
    "enabled": 0.0, "sides": 4.0, "additive": 0.0, "thickoutline": 0.0,
    "textured": 0.0, "num_inst": 1.0, "x": 0.5, "y": 0.5, "rad": 0.1,
    "ang": 0.0, "tex_ang": 0.0, "tex_zoom": 1.0,
    "r": 1.0, "g": 0.0, "b": 0.0, "a": 1.0,
    "r2": 0.0, "g2": 1.0, "b2": 0.0, "a2": 0.0,
    "border_r": 1.0, "border_g": 1.0, "border_b": 1.0, "border_a": 0.1,
}

#: custom-wave defaults (CWave)
WAVE_DEFAULTS = {
    "enabled": 0.0, "samples": 512.0, "sep": 0.0, "bspectrum": 0.0,
    "busedots": 0.0, "bdrawthick": 0.0, "badditive": 0.0,
    "scaling": 1.0, "smoothing": 0.5,
    "r": 1.0, "g": 1.0, "b": 1.0, "a": 1.0,
}


@dataclass
class MilkPreset:
    name: str = "preset"
    init: dict = field(default_factory=dict)       # scalar init values
    per_frame_init: str = ""
    per_frame: str = ""
    per_pixel: str = ""
    # custom objects: n -> {"cfg": {field: float}, "init"/"frame"(/"point"
    # for waves): joined equation text}
    shapes: dict = field(default_factory=dict)
    waves: dict = field(default_factory=dict)
    #: MilkDrop 2 HLSL blocks (joined, backtick-stripped)
    warp_code: str = ""
    comp_code: str = ""
    #: set by build_preset_process when a shader fell back (reason str)
    shader_fallback: dict = field(default_factory=dict)

    DEFAULTS = {
        "fdecay": 0.98, "fgammaadj": 2.0, "fwarpscale": 1.0,
        "fwarpanimspeed": 1.0, "zoom": 1.0, "zoomexp": 1.0, "rot": 0.0,
        "warp": 1.0, "cx": 0.5, "cy": 0.5, "dx": 0.0, "dy": 0.0,
        "sx": 1.0, "sy": 1.0, "wave_r": 0.6, "wave_g": 0.6, "wave_b": 0.6,
        "wave_a": 0.8, "wave_x": 0.5, "wave_y": 0.5, "wave_mystery": 0.0,
        "nwavemode": 0, "fwavescale": 1.0, "fwavesmoothing": 0.75,
        "bdarkencenter": 0, "echo_zoom": 1.0, "echo_alpha": 0.0,
        "bwrap": 1, "binvert": 0, "bbrighten": 0, "bdarken": 0,
        "bsolarize": 0,
        "nmotionvectorsx": 12.0, "nmotionvectorsy": 9.0,
        "mv_dx": 0.0, "mv_dy": 0.0, "mv_l": 0.9,
        "mv_r": 1.0, "mv_g": 1.0, "mv_b": 1.0, "mv_a": 0.0,
    }

    def value(self, key: str) -> float:
        return float(self.init.get(key, self.DEFAULTS.get(key, 0.0)))


_LINE_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(.*?)\s*$")
_SHAPECODE_RE = re.compile(r"^shapecode_(\d+)_([a-z0-9_]+)$")
_SHAPEEQ_RE = re.compile(r"^shape_(\d+)_(init|per_frame)_?(\d+)$")
_WAVECODE_RE = re.compile(r"^wavecode_(\d+)_([a-z0-9_]+)$")
_WAVEEQ_RE = re.compile(r"^wave_(\d+)_(init|per_frame|per_point)_?(\d+)$")
_EQ_KEY = {"init": "init", "per_frame": "frame", "per_point": "point"}


def parse_preset(text: str, name: str = "preset") -> MilkPreset:
    """Parse `.milk` INI text (`milkdrop.py:541`). Equation lines
    concatenate in numeric order; custom waves and shapes parse into
    `pre.waves` / `pre.shapes`; shader blocks into `pre.warp_code` /
    `pre.comp_code`."""
    pre = MilkPreset(name=name)
    frames, pixels, finits = {}, {}, {}
    shader_lines: dict[str, dict[int, str]] = {"warp": {}, "comp": {}}
    objeqs: dict[tuple, dict] = {}
    for line in text.splitlines():
        if line.startswith(("[", ";", "//")):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            continue
        key, v = m.group(1).lower(), m.group(2)
        sm = re.match(r"^(warp|comp)_(\d+)$", key)
        if sm is not None:
            shader_lines[sm.group(1)][int(sm.group(2))] = \
                v[1:] if v.startswith("`") else v
            continue
        if key.startswith(("comp_", "warp_")):
            continue  # other shader-era keys (e.g. *_shader_version)
        cm = _SHAPECODE_RE.match(key) or _WAVECODE_RE.match(key)
        if cm is not None:
            store = pre.shapes if key.startswith("shape") else pre.waves
            try:
                x = float(v)
            except ValueError:
                continue
            if math.isfinite(x):  # nan/inf config would poison feedback
                store.setdefault(int(cm.group(1)),
                                 {"cfg": {}})["cfg"][cm.group(2)] = x
            continue
        em = _SHAPEEQ_RE.match(key) or _WAVEEQ_RE.match(key)
        if em is not None:
            store = pre.shapes if key.startswith("shape") else pre.waves
            store.setdefault(int(em.group(1)), {"cfg": {}})
            objeqs.setdefault((key[0] == "s", int(em.group(1)),
                               _EQ_KEY[em.group(2)]), {})[
                int(em.group(3))] = v
            continue
        for prefix, store in (("per_frame_init_", finits),
                              ("per_frame_", frames),
                              ("per_pixel_", pixels),
                              ("per_vertex_", pixels)):
            if key.startswith(prefix):
                try:
                    n = int(key[len(prefix):])
                except ValueError:
                    break
                store[n] = v
                break
        else:
            try:
                x = float(v)
            except ValueError:
                continue  # non-numeric metadata
            if math.isfinite(x):
                pre.init[key] = x
    join = lambda d: "\n".join(d[k].rstrip(";") + ";"  # noqa: E731
                               for k in sorted(d))
    pre.per_frame_init = join(finits)
    pre.per_frame = join(frames)
    pre.per_pixel = join(pixels)
    for (is_shape, n, which), eqs in objeqs.items():
        store = pre.shapes if is_shape else pre.waves
        store[n][which] = join(eqs)
    pre.warp_code = "\n".join(
        shader_lines["warp"][k] for k in sorted(shader_lines["warp"]))
    pre.comp_code = "\n".join(
        shader_lines["comp"][k] for k in sorted(shader_lines["comp"]))
    return pre


# ---------------------------------------------------------------------------
# renderer: preset -> stateful generator filter


_WAVE_POINTS = 48
_2PI, _6PI, _14PI = f32(2 * np.pi), f32(6 * np.pi), f32(14 * np.pi)


def _col3(vals, dev) -> torch.Tensor:
    """Three channel values (numbers or 0-d tensors) as a (3, 1, 1)
    float32 tensor on `dev`: numbers alone in one pinned upload."""
    vals = [val(v) for v in vals]
    if not any(isinstance(v, torch.Tensor) for v in vals):
        return upload(np.asarray(vals, np.float32).reshape(3, 1, 1), dev)
    return torch.stack([to_t(v, dev).reshape(()) for v in vals]) \
        .reshape(3, 1, 1)


def _harmonics(env, i, ph, dev):
    """bass sin(2 pi i + ph) + 0.6 mid sin(6 pi i + 1.7 ph) + 0.35 treb
    sin(14 pi i + 2.3 ph) (`milkdrop.py:637-639,663-667`), (n,) float32;
    the three sines in one call of the twin."""
    s1, s2, s3 = sinf(torch.stack([
        to_t(add(mul(i, _2PI), ph), dev),
        to_t(add(mul(i, _6PI), mul(ph, 1.7)), dev),
        to_t(add(mul(i, _14PI), mul(ph, 2.3)), dev)]))
    bass, mid, treb = (env.get(k, 0.3) for k in ("bass", "mid", "treb"))
    w = add(mul(bass, s1), mul(val(mul(mid, 0.6)), s2))
    return val(add(mul(val(mul(treb, 0.35)), s3), w))


def _iota(n, dev):
    """arange(n) / max(n - 1, 1) as XLA computes it: times the float32
    reciprocal."""
    return torch.arange(n, dtype=torch.float32, device=dev) \
        * recip(max(n - 1, 1))


def _wave_curve(env, t, mode: int, dev):
    """(xs, ys, vol) of the basic waveform (`milkdrop.py:626`): the PCM
    wave synthesised from the band levels, three harmonics."""
    i = _iota(_WAVE_POINTS, dev)
    bass = env.get("bass", 0.3)
    mid = env.get("mid", 0.3)
    treb = env.get("treb", 0.3)
    vol = env.get("vol", (bass + mid + treb) / 3.0)
    ph = val(mul(t, 2.1))
    wave = val(mul(val(mul(_harmonics(env, i, ph, dev), 0.5)),
                   env.get("wave_scale", 1.0)))
    wx = env.get("wave_x", 0.5)
    wy = sub(1.0, env.get("wave_y", 0.5))  # milkdrop y is bottom-up
    if mode == 0:  # circular
        ca, sa = sincosf(val(mul(i, _2PI)))
        r = add(mul(wave, 0.25), add(mul(0.1, vol), 0.25))
        xs = add(mul(val(mul(ca, r)), 0.75), wx)
        ys = add(mul(sa, r), wy)
    elif mode == 1:  # x-spray: wave drawn vertically
        xs = add(wx, wave)
        ys = i
    else:  # centered / horizontal line family
        xs = i
        ys = add(wy, wave)
    return to_t(xs, dev), to_t(ys, dev), vol


def _synth_pcm(env, t, ph_off: float, n: int, dev):
    """Synthesised PCM channel for custom waves (`milkdrop.py:657`)."""
    i = _iota(n, dev)
    ph = val(add(mul(t, 2.1), ph_off)) if ph_off else val(mul(t, 2.1))
    return _harmonics(env, i, ph, dev)


def _splat_axes(xs, ys, px, py, aspect):
    """The squared distances of n splat points along each axis, float64:
    ((xs - px) aspect)^2 as (n, 1, W) and (ys - py)^2 as (n, H, 1), for
    the points' exp(-(dx2 + dy2) / sigma) over the frame (a splat feeds no
    hard select, so it evaluates in float64); xs (1, W), ys (H, 1), px/py
    (n,)."""
    n = px.shape[0]
    dx = val(mul(sub(xs, px.reshape(n, 1, 1)), aspect)).to(torch.float64)
    dy = val(sub(ys, py.reshape(n, 1, 1))).to(torch.float64)
    return dx * dx, dy * dy


def wave_splat(xs, ys, wxs, wys, aspect, h) -> torch.Tensor:
    """The basic waveform's coverage, (H, W) float64 (`milkdrop.py:
    1086-1090`): the sum of exp(-d2 / sigma) over its points (wxs, wys) in
    milkdrop's bottom-up y, sigma = (2.5 / h)^2, added point after point
    as the JAX plan adds them; a full-frame exp a point."""
    inv_sigma = 1.0 / float(np.float32((2.5 / h) ** 2))
    dx2, dy2 = _splat_axes(xs, ys, wxs, 1.0 - wys, aspect)
    acc = torch.zeros((dy2.shape[1], dx2.shape[2]), dtype=torch.float64,
                      device=dx2.device)
    for k in range(wxs.shape[0]):
        acc += torch.exp((dx2[k] + dy2[k]) * -inv_sigma)
    return acc


_OBJ_ENV_KEYS = ("time", "frame", "fps", "bass", "mid", "treb", "vol",
                 "bass_att", "mid_att", "treb_att", "vol_att",
                 "meshx", "meshy", "pixelsx", "pixelsy",
                 "aspectx", "aspecty", "instance", "num_inst")


def _obj_env(env, cfg):
    """Scalar environment for custom-object code (`milkdrop.py:676`)."""
    e = {k: env[k] for k in _OBJ_ENV_KEYS if k in env}
    for k in range(32):
        e[f"q{k + 1}"] = env.get(f"q{k + 1}", 0.0)
    for k in range(8):
        e[f"t{k + 1}"] = 0.0
    e.update(cfg)
    return e


def _run_obj_code(env, cfg, init_fn, frame_fn, dev):
    """init code in a frame-0 environment, then per-frame code on the
    result (`milkdrop.py:689`)."""
    e = _obj_env(env, cfg)
    e0 = dict(e)
    e0["time"] = 0.0
    e0["frame"] = 0.0
    e0 = init_fn(e0, dev)
    for k in range(8):
        e[f"t{k + 1}"] = e0[f"t{k + 1}"]
    return frame_fn(e, dev)


def _g(env, n):
    """An object field as a float32 value: a Python float or a tensor (the
    shape's fields hold SHAPE_DEFAULTS where its code set none)."""
    v = val(env.get(n, 0.0))
    return v if isinstance(v, torch.Tensor) else f32(v)


def _cos_sin(a):
    """(cos a, sin a): the twins on a tensor, the float32 library values
    of a number (XLA folds a constant's cos with the C library's cosf)."""
    a = val(a)
    if isinstance(a, torch.Tensor):
        return sincosf(a.to(torch.float32))
    t = torch.tensor(f32(a))
    return float(cosf(t)), float(sinf(t))


def _draw_custom_shape(out, prev, senv, xs, ys, aspect, sides: int,
                       textured: bool, additive: bool, thick: bool, h, w):
    """One custom-shape instance (`milkdrop.py:703`): the regular
    `sides`-gon's SDF, centre->vertex gradient, border ring."""
    dev = out.device
    cx, cy, rad = _g(senv, "x"), _g(senv, "y"), _g(senv, "rad")
    rad = torch.clamp(rad, min=f32(1e-4)) if isinstance(rad, torch.Tensor) \
        else max(rad, f32(1e-4))
    ang = _g(senv, "ang")
    dx = val(mul(sub(xs, cx), aspect))                   # (1, W)
    dy = val(sub(ys, sub(1.0, cy)))                      # (H, 1)
    dist = torch.sqrt(val(add(mul(dx, dx), mul(dy, dy)))) + f32(1e-9)
    step = f32(2.0 * math.pi / sides)
    th = val(sub(atan2(torch.broadcast_to(dy, dist.shape),
                       torch.broadcast_to(dx, dist.shape)), ang))
    r = torch.fmod(th, step)                  # jnp.remainder by step > 0
    r = torch.where((r != 0) & (r < 0), r + step, r)
    phi = r - f32(step / 2)
    redge = val(mul(rad, f32(math.cos(math.pi / sides)))) / cosf(phi)
    tgrad = torch.clamp(dist / redge, 0.0, 1.0)
    inside = (dist <= redge).to(torch.float32)
    c1 = _col3([_g(senv, "r"), _g(senv, "g"), _g(senv, "b")], dev)
    c2 = _col3([_g(senv, "r2"), _g(senv, "g2"), _g(senv, "b2")], dev)
    rgb = fma32(c1, (1.0 - tgrad)[None], c2 * tgrad[None])
    if textured:
        # the previous frame zoomed by tex_zoom and rotated by tex_ang
        # around the shape's centre, tinted by the gradient
        tzoom = _g(senv, "tex_zoom")
        tz = val(mul(val(mul(torch.clamp(tzoom, min=f32(1e-3))
                             if isinstance(tzoom, torch.Tensor)
                             else max(tzoom, f32(1e-3)), 2.0)), rad))
        ca, sa = _cos_sin(_g(senv, "tex_ang"))
        du = val(sub(mul(dx, ca), mul(dy, sa)))
        dv = val(add(mul(dx, sa), mul(dy, ca)))

        def texel(d, n):
            d = d / tz if isinstance(tz, torch.Tensor) else div_const(d, tz)
            return torch.clamp(val(add(d, 0.5)) * float(n - 1), 0.0,
                               n - 1.0).to(torch.int64)
        tu, tv = texel(du, w), texel(dv, h)
        rgb = prev[:, tv, tu] * rgb
    alpha = torch.clamp(val(add(mul(_g(senv, "a"), 1.0 - tgrad),
                                mul(_g(senv, "a2"), tgrad))), 0.0, 1.0) \
        * inside
    if additive:
        out = fma32(rgb, alpha[None], out)
    else:
        out = fma32(out, (1.0 - alpha)[None], rgb * alpha[None])
    if isinstance(rad, torch.Tensor):
        bw = val(add(mul(rad, 0.06 if thick else 0.02), f32(1.5 / h)))
    else:       # constants fold one float32 operation at a time
        bw = f32(f32(rad * f32(0.06 if thick else 0.02)) + f32(1.5 / h))
    ba = _g(senv, "border_a")
    ba = torch.clamp(ba, 0.0, 1.0) if isinstance(ba, torch.Tensor) \
        else min(max(ba, 0.0), 1.0)
    bmask = (torch.abs(dist - redge) <= bw).to(torch.float32) * ba
    brgb = _col3([_g(senv, "border_r"), _g(senv, "border_g"),
                  _g(senv, "border_b")], dev)
    return fma32(out, (1.0 - bmask)[None], brgb * bmask[None])


def _draw_custom_wave(out, wenv, point_fn, t, xs, ys, aspect,
                      usedots: bool, thick: bool, additive: bool,
                      sep: float, smoothing: float, h):
    """One custom wave (`milkdrop.py:751`): per_point code vectorised over
    the 48 samples, points splatted as gaussians."""
    dev = out.device
    n = _WAVE_POINTS
    scaling = wenv.get("scaling", 1.0)
    v1 = val(mul(_synth_pcm(wenv, t, 0.0, n, dev), scaling))
    v2 = val(mul(_synth_pcm(wenv, t, 0.7 + 0.03 * sep, n, dev), scaling))
    if smoothing > 0:  # one-pass neighbour smoothing, strength-weighted
        k = f32(min(max(smoothing, 0.0), 0.98) * 0.5)
        c = f32(1 - 2 * k)
        v1 = fma32(v1, c, (torch.roll(v1, 1) + torch.roll(v1, -1)) * k)
        v2 = fma32(v2, c, (torch.roll(v2, 1) + torch.roll(v2, -1)) * k)
    i = _iota(n, dev)
    penv = dict(wenv)
    penv.update({"sample": i, "value1": v1, "value2": v2,
                 "x": i, "y": fma32(v1, 0.5, 0.5)})
    penv = point_fn(penv, dev)

    def bcast(k_):
        return torch.broadcast_to(to_t(penv.get(k_, 0.0), dev), (n,))
    pxs, pys = bcast("x"), bcast("y")
    rgbs = torch.stack([bcast("r"), bcast("g"), bcast("b")], 1) \
        .reshape(n, 3, 1, 1)
    pa = torch.clamp(bcast("a"), 0.0, 1.0)
    sig = 1.2 if usedots else (3.5 if thick else 2.2)
    inv_sigma = 1.0 / float(np.float32((sig / h) ** 2))
    dx2, dy2 = _splat_axes(xs, ys, pxs, 1.0 - pys, aspect)
    for k in range(n):
        ak = (torch.exp((dx2[k] + dy2[k]) * -inv_sigma).to(torch.float32)
              * pa[k])[None]
        if additive:
            out = fma32(rgbs[k], ak, out)
        else:
            out = fma32(out, 1.0 - ak, rgbs[k] * ak)
    return out


def _shader_uniforms(env, t, frame, w, h, rad, ang, dev):
    """The uniform set MilkDrop 2 hands its warp/comp shaders
    (`milkdrop.py:790`); uv and uv_orig are added per call site."""
    def f4(fn, rates):
        """Vec of 0.5 + 0.5 fn(t r) over the rates, one call of the
        twin."""
        x = [val(mul(t, r)) for r in rates]
        if isinstance(x[0], torch.Tensor):
            c = fn(torch.stack([xi.reshape(()) for xi in x]))
            return Vec(list(val(add(mul(0.5, c), 0.5)).unbind(0)))
        c = fn(torch.tensor([f32(xi) for xi in x]))
        return Vec([to_t(f32(0.5 + f32(0.5 * float(ci))), dev) for ci in c])

    se = {
        "rad": rad, "ang": ang, "time": t, "fps": env.get("fps", 30.0),
        "frame": frame, "progress": 0.0, "decay": env.get("decay", 0.98),
        "gamma": env.get("gamma", 2.0),
        "texsize": Vec([float(w), float(h), 1.0 / w, 1.0 / h]),
        "aspect": Vec([1.0, float(w) / float(h),
                       1.0, float(h) / float(w)]),
        "hue_shader": f4(cosf, (0.0923, 0.0741, 0.1123)),
        "rand_frame": Vec([rand_hash(frame, 101 + k, dev)
                           for k in range(4)]),
        "rand_preset": Vec([rand_hash(1234, 55 + k, dev)
                            for k in range(4)]),
        "roam_cos": f4(cosf, (0.3, 1.3, 5.0, 20.0)),
        "roam_sin": f4(sinf, (0.3, 1.3, 5.0, 20.0)),
        "slow_roam_cos": f4(cosf, (0.005, 0.008, 0.013, 0.022)),
        "slow_roam_sin": f4(sinf, (0.005, 0.008, 0.013, 0.022)),
    }
    for k in ("bass", "mid", "treb", "vol", "bass_att", "mid_att",
              "treb_att", "vol_att"):
        se[k] = env.get(k, 1.0)
    for k in (1, 2, 3):
        # blur-pyramid value range: the identity window
        se[f"blur{k}_min"] = 0.0
        se[f"blur{k}_max"] = 1.0
    for k in range(32):
        se[f"q{k + 1}"] = env.get(f"q{k + 1}", 0.0)
    return se


def _shader_trial(prog, texwrap):
    """Evaluate a compiled shader on a 2x2 grid of the CPU with the real
    uniform set and texture accessor (`milkdrop.py:832`): compile_hlsl
    only parses, and an unknown uniform or intrinsic, a bad swizzle or an
    unsupported sampler shows at evaluation, which must happen while the
    preset builds, not mid-playback. Raises ValueError."""
    cpu = torch.device("cpu")
    z = torch.zeros((2, 2), dtype=torch.float32)
    env = _shader_uniforms({}, 0.0, 0.0, 2, 2, z, z, cpu)
    env["uv"] = Vec([z, z])
    env["uv_orig"] = Vec([z, z])
    env["_texwrap"] = texwrap
    prog.run(env, _tex_accessor(torch.zeros((3, 2, 2)), 2))


def _tex_accessor(canvas, h):
    """Sampler name -> (3,H,W) texture over a canvas (`milkdrop.py:847`):
    the main variants alias the canvas; blur1/2/3 are box blurs of it,
    made once a frame on first use."""
    cache = {}

    def tex(name):
        if name not in cache:
            if name.startswith("sampler_blur"):
                lvl = int(name[-1]) if name[-1] in "123" else 0
                if not lvl:
                    raise ValueError(f"hlsl: unknown sampler {name}")
                r = max(1, int(h * {1: 0.01, 2: 0.025, 3: 0.06}[lvl]))
                cache[name] = _box_blur(canvas, r)
            else:
                cache[name] = canvas    # *_main address variants
        return cache[name]

    return tex


#: INI key -> runtime equation-variable name (`milkdrop.py:882-892`): both
#: MilkDrop's own `.milk` spellings and the short aliases
RENAME = {"fdecay": "decay", "fgammaadj": "gamma",
          "fwavescale": "wave_scale", "fwarpscale": "warpscale",
          "fwarpanimspeed": "warpanimspeed", "nwavemode": "wave_mode",
          "fwavesmoothing": "wave_smoothing", "bwrap": "wrap",
          "btexwrap": "wrap", "binvert": "invert",
          "bbrighten": "brighten", "bdarken": "darken",
          "bsolarize": "solarize", "bdarkencenter": "darken_center",
          "fzoomexponent": "zoomexp", "fvideoechozoom": "echo_zoom",
          "fvideoechoalpha": "echo_alpha", "fwavealpha": "wave_a",
          "fwaveparam": "wave_mystery",
          "nmotionvectorsx": "mv_x", "nmotionvectorsy": "mv_y"}

#: ns-eel scratch memory entries (`milkdrop.py:932`)
BUF_N = 1 << 20


def _scalar(v, dev) -> torch.Tensor:
    """A per-frame value (a number, a 0-d or (1,) tensor) as a 0-d float32
    tensor on `dev`."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32).reshape(())
    return torch.full((), f32(v), dtype=torch.float32, device=dev)


class _Grid:
    """The frame-invariant per-pixel grid of one geometry and device
    (`milkdrop.py:1006-1013`): x (1, W) and y (H, 1) in [0, 1], each an
    iota times the float32 reciprocal of n - 1 and kept a pending product
    (XLA contracts `x - c` into fma(iota, 1 / (n - 1), -c)), their (H, W)
    broadcasts for the shaders, and rad and ang (H, W)."""

    def __init__(self, h, w, dev):
        ix = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, w)
        iy = torch.arange(h, dtype=torch.float32, device=dev).reshape(h, 1)
        rx, ry = recip(max(w - 1, 1)), recip(max(h - 1, 1))
        self.xs, self.ys = mul(ix, rx), mul(iy, ry)
        self.xs_full = mul(ix.expand(h, w), rx)
        self.ys_full = mul(iy.expand(h, w), ry)
        aspect = float(w) / float(h)
        dx = val(mul(sub(self.xs, 0.5), aspect))
        dy = val(sub(self.ys, 0.5))
        self.rad = torch.sqrt(fma32(dx, dx, dy * dy)) \
            * f32(2.0 / math.hypot(aspect, 1.0))
        self.ang = atan2(torch.broadcast_to(dy, (h, w)), torch.broadcast_to(
            val(add(mul(val(sub(self.xs, 0.5)), aspect), f32(1e-9))),
            (h, w)))


def build_preset_process(pre: MilkPreset):
    """(process(ins, p, ctx, state), init_state(w, h, pal, device)) for a
    MilkPreset (`milkdrop.py:868`): a stateful generator whose state is
    (prev (3,H,W) f32, q (32,) f32, inited (1,)) [+ megabuf, gmegabuf]."""
    per_frame = compile_expressions(pre.per_frame)
    per_pixel = compile_expressions(pre.per_pixel)
    per_init = compile_expressions(pre.per_frame_init)

    base_env = {}
    for k in pre.DEFAULTS:
        base_env[RENAME.get(k, k)] = float(pre.DEFAULTS[k])
    for k, v in pre.init.items():
        base_env[RENAME.get(k, k)] = float(v)
    wave_mode = int(base_env.get("wave_mode", 0)) & 7

    # custom shapes / waves: static config + compiled equation code;
    # disabled objects compile to nothing
    shape_defs = []
    for n_ in sorted(pre.shapes):
        obj = pre.shapes[n_]
        cfg = {**SHAPE_DEFAULTS, **obj.get("cfg", {})}
        if cfg["enabled"] <= 0:
            continue
        shape_defs.append((cfg,
                           compile_expressions(obj.get("init", "")),
                           compile_expressions(obj.get("frame", ""))))
    wave_defs = []
    for n_ in sorted(pre.waves):
        obj = pre.waves[n_]
        cfg = {**WAVE_DEFAULTS, **obj.get("cfg", {})}
        if cfg["enabled"] <= 0:
            continue
        wave_defs.append((cfg,
                          compile_expressions(obj.get("init", "")),
                          compile_expressions(obj.get("frame", "")),
                          compile_expressions(obj.get("point", ""))))

    has_bufs = uses_buffers(
        pre.per_frame, pre.per_pixel, pre.per_frame_init,
        *(o.get(k, "") for o in list(pre.shapes.values())
          + list(pre.waves.values()) for k in ("init", "frame", "point")))

    # MilkDrop 2 shader blocks: out-of-subset code records the reason and
    # the preset renders with the fixed-function pipeline
    warp_prog = comp_prog = None
    texwrap_static = float(base_env.get("wrap", 1.0))
    if pre.warp_code.strip() or pre.comp_code.strip():
        for which, code in (("warp", pre.warp_code),
                            ("comp", pre.comp_code)):
            try:
                prog = compile_hlsl(code)
                if prog is not None:
                    _shader_trial(prog, texwrap_static)
            except ValueError as e:     # the shader's text, out of subset
                pre.shader_fallback[which] = str(e)
                prog = None
            if which == "warp":
                warp_prog = prog
            else:
                comp_prog = prog

    grids: dict = {}

    def init_state(w, h, pal, device):
        base = (torch.zeros((3, h, w), dtype=torch.float32, device=device),
                torch.zeros((32,), dtype=torch.float32, device=device),
                torch.zeros((1,), dtype=torch.float32, device=device))
        if has_bufs:
            return base + (
                torch.zeros((BUF_N,), dtype=torch.float32, device=device),
                torch.zeros((BUF_N,), dtype=torch.float32, device=device))
        return base

    def process(ins, p, ctx, state):
        prev, q, inited = state[:3]
        dev = prev.device
        h, w = prev.shape[-2:]
        key = (h, w, str(dev))
        if key not in grids:
            grids[key] = _Grid(h, w, dev)
        gr = grids[key]
        xs, ys = gr.xs, gr.ys
        t = _scalar(ctx.tc, dev)
        frame = _scalar(ctx.frame, dev)

        env = dict(base_env)
        band = {k: _scalar(p[k], dev) for k in ("bass", "mid", "treb",
                                                  "vol")}
        env.update({
            "time": t, "frame": frame, "fps": float(ctx.fps or 30.0),
            "bass": band["bass"], "mid": band["mid"], "treb": band["treb"],
            "vol": band["vol"], "bass_att": band["bass"],
            "mid_att": band["mid"], "treb_att": band["treb"],
            "vol_att": band["vol"],
            "meshx": 32.0, "meshy": 24.0, "pixelsx": float(w),
            "pixelsy": float(h), "aspectx": 1.0,
            "aspecty": float(w) / float(h),
        })
        qs = q.unbind(0)
        for k in range(32):
            env[f"q{k + 1}"] = tag(qs[k], True)
        if has_bufs:
            env["megabuf"], env["gmegabuf"] = state[3:5]
        # per_frame_init's q values land only while inited == 0
        env_init = per_init(dict(env), dev)
        first = inited[0] <= 0.5
        for k in range(32):
            qk = f"q{k + 1}"
            if qk in env_init and env_init[qk] is not env[qk]:
                env[qk] = tag(torch.where(first, to_t(env_init[qk], dev),
                                          env[qk]), True)
        # values may stay pending products (`milkshader._Prod`): XLA's
        # plan contracts a per-frame product into the per-pixel add that
        # reads it
        env = per_frame(env, dev)
        q_out = torch.stack([to_t(env[f"q{k + 1}"], dev).reshape(())
                             for k in range(32)])

        # ---- per-pixel warp field ----
        aspect = float(w) / float(h)
        penv = dict(env)
        penv.update({"x": xs, "y": sub(1.0, ys), "rad": gr.rad,
                     "ang": gr.ang})
        penv = per_pixel(penv, dev)
        cxv, cyv = penv["cx"], penv["cy"]

        ze = val(penv["zoomexp"])
        if not isinstance(ze, torch.Tensor) and f32(ze) > 0 \
                and f32(math.log(f32(ze))) == 0.0:
            inner = 1.0     # exp(0 * b) of the finite b = 2 rad - 1
        else:
            inner = safe_pow(ze, gr.rad * 2.0 - 1.0)
        zoom_coef = safe_pow(penv["zoom"], inner)
        u, v = sub(xs, cxv), sub(ys, cyv)
        if isinstance(zoom_coef, torch.Tensor):
            u, v = u / zoom_coef, v / zoom_coef
        else:
            u, v = val(div_const(u, zoom_coef)), val(div_const(v, zoom_coef))
        rot = val(penv["rot"])
        if isinstance(rot, torch.Tensor) or rot != 0.0:
            cr, sr = _cos_sin(rot)
            u, v = (val(sub(mul(u, cr), mul(v, sr))),
                    val(add(mul(u, sr), mul(v, cr))))
        # classic milkdrop warp ripple (4 phase-locked sines)
        warp = val(mul(penv["warp"], 0.0035))
        wt = val(mul(t, val(env.get("warpanimspeed", 1.0))))
        wsc = val(env.get("warpscale", 1.0))

        # the ripple's four frequencies, a + b cos(wt c + d): one call of
        # the twin
        fqs = ((11.68, 4.0, 1.413, 10.0), (8.77, 3.0, 1.113, 7.0),
               (10.54, 3.0, 1.233, 3.0), (11.49, 4.0, 0.933, 5.0))
        cs = cosf(torch.stack([to_t(add(mul(wt, c), d), dev).reshape(())
                               for _a, _b, c, d in fqs])).unbind(0)
        f0, f1, f2, f3 = (val(add(a, mul(b, ck)))
                          for (a, b, _c, _d), ck in zip(fqs, cs))
        if not isinstance(warp, torch.Tensor) and warp == 0.0:
            # warp * sin(.) is 0 wherever the sine is finite
            u, v = to_t(u, dev), to_t(v, dev)
        else:
            # the four terms' arguments, then their sines and cosines in
            # one call of each twin
            a1 = add(mul(wt, 0.333), mul(wsc, val(sub(mul(xs, f0),
                                                      mul(ys, f3)))))
            a2 = sub(mul(wt, 0.753), mul(wsc, val(sub(mul(xs, f1),
                                                      mul(ys, f2)))))
            a3 = sub(mul(wt, 0.375), mul(wsc, val(add(mul(xs, f2),
                                                      mul(ys, f1)))))
            a4 = add(mul(wt, 0.825), mul(wsc, val(add(mul(xs, f0),
                                                      mul(ys, f3)))))
            s1, s4 = sinf(torch.stack(torch.broadcast_tensors(
                to_t(a1, dev), to_t(a4, dev))))
            c2, c3 = cosf(torch.stack(torch.broadcast_tensors(
                to_t(a2, dev), to_t(a3, dev))))
            u = val(add(val(add(u, mul(warp, s1))), mul(warp, c2)))
            v = val(add(val(add(v, mul(warp, c3))), mul(warp, s4)))

        def unscale(x, s, d, c):
            s = val(s)
            x = x / s if isinstance(s, torch.Tensor) else div_const(x, s)
            return val(add(sub(x, d), c))
        u = unscale(u, penv["sx"], penv["dx"], cxv)
        v = unscale(v, penv["sy"], penv["dy"], cyv)
        u, v = torch.broadcast_to(u, (h, w)), torch.broadcast_to(v, (h, w))
        du_warp = val(sub(u, xs))
        dv_warp = val(sub(v, ys))

        if warp_prog is not None:
            # MilkDrop 2: the warp shader consumes the mesh-warped uv and
            # makes the new canvas itself
            senv = _shader_uniforms(env, t, frame, w, h, gr.rad, gr.ang, dev)
            senv["uv"] = Vec([u, v])
            senv["uv_orig"] = Vec([gr.xs_full, gr.ys_full])
            senv["_texwrap"] = texwrap_static
            out = torch.clamp(warp_prog.run(senv, _tex_accessor(prev, h)),
                              0.0, 1.0)
        else:
            # bilinear feedback sample of the previous frame; bWrap picks
            # toroidal addressing or edge clamp, per frame
            wrap_on = val(env.get("wrap", 1.0))
            wrap_on = wrap_on > 0.5 if isinstance(wrap_on, torch.Tensor) \
                else f32(wrap_on) > 0.5

            def wrapped(x):
                out_ = (x < 0.0) | (x > 1.0)
                if isinstance(wrap_on, torch.Tensor):
                    out_ = out_ & wrap_on
                elif not wrap_on:
                    return x
                return torch.where(out_, x - torch.floor(x), x)
            u, v = wrapped(u), wrapped(v)
            fu = torch.clamp(u * float(w - 1), 0.0, w - 1.0)
            fv = torch.clamp(v * float(h - 1), 0.0, h - 1.0)
            x0 = torch.floor(fu).to(torch.int64)
            y0 = torch.floor(fv).to(torch.int64)
            x1 = torch.clamp(x0 + 1, max=w - 1)
            y1 = torch.clamp(y0 + 1, max=h - 1)
            ax = (fu - x0.to(torch.float32))[None]
            ay = (fv - y0.to(torch.float32))[None]
            out = val(mul(bilinear_rows(prev, y0, x0, y1, x1, ax, ay),
                          env["decay"]))

        # ---- basic waveform splat (wave_mode is static preset config) ----
        wxs, wys, _vol = _wave_curve(env, t, 0 if wave_mode == 0
                                     else (1 if wave_mode == 1 else 2), dev)
        acc = wave_splat(xs, ys, wxs, wys, aspect, h)
        wa = val(env["wave_a"])
        wa = torch.clamp(wa, 0.0, 1.0) if isinstance(wa, torch.Tensor) \
            else min(max(f32(wa), 0.0), 1.0)
        alpha = (torch.clamp(acc.to(torch.float32), 0.0, 1.0) * wa)[None]
        wave_rgb = _col3([env["wave_r"], env["wave_g"], env["wave_b"]], dev)
        out = fma32(out, 1.0 - alpha, wave_rgb * alpha)

        # ---- custom waves then custom shapes (MilkDrop draw order) ----
        for cfg, init_fn, frame_fn, point_fn in wave_defs:
            wenv = _run_obj_code(env, cfg, init_fn, frame_fn, dev)
            out = _draw_custom_wave(
                out, wenv, point_fn, t, xs, ys, aspect,
                usedots=cfg["busedots"] > 0, thick=cfg["bdrawthick"] > 0,
                additive=cfg["badditive"] > 0, sep=float(cfg["sep"]),
                smoothing=float(cfg["smoothing"]), h=h)
        for cfg, init_fn, frame_fn in shape_defs:
            n_inst = max(1, min(int(cfg["num_inst"]), 4))
            # shape code sees the CLAMPED instance count
            cfg_run = {**cfg, "num_inst": float(n_inst)}
            for inst in range(n_inst):
                senv = _run_obj_code(
                    {**env, "instance": float(inst),
                     "num_inst": float(n_inst)}, cfg_run,
                    init_fn, frame_fn, dev)
                out = _draw_custom_shape(
                    out, prev, senv, xs, ys, aspect,
                    sides=max(3, min(int(cfg["sides"]), 100)),
                    textured=cfg["textured"] > 0,
                    additive=cfg["additive"] > 0,
                    thick=cfg["thickoutline"] > 0, h=h, w=w)

        # ---- motion-vector grid, statically gated on mv_a ----
        if base_env.get("mv_a", 0.0) > 0 or "mv_a" in pre.per_frame:
            out = _motion_vectors(out, env, xs, ys, du_warp, dv_warp,
                                  aspect, h, dev)
        out = torch.clamp(out, 0.0, 1.0)

        # ---- composite (display) pass: echo and post-filters reach only
        # what is shown; the feedback texture stays untouched
        new_state = (out, q_out, torch.ones((1,), dtype=torch.float32,
                                            device=dev))
        if has_bufs:
            # per-pixel writes win over per-frame writes; both persist
            new_state = new_state + (to_t(penv["megabuf"], dev),
                                     to_t(penv["gmegabuf"], dev))
        if comp_prog is not None:
            senv = _shader_uniforms(env, t, frame, w, h, gr.rad, gr.ang, dev)
            senv["uv"] = Vec([gr.xs_full, gr.ys_full])
            senv["uv_orig"] = Vec([gr.xs_full, gr.ys_full])
            senv["_texwrap"] = texwrap_static
            disp = torch.clamp(comp_prog.run(senv, _tex_accessor(out, h)),
                               0.0, 1.0)
            return _u8_layer(disp), new_state
        disp = out
        if base_env.get("echo_alpha", 0.0) > 0.0 or "echo" in pre.per_frame:
            disp = _echo(disp, out, env, xs, ys, h, w)
        disp = _post_filters(disp, env, gr, base_env, pre)
        gamma = val(env.get("gamma", 2.0))
        disp = torch.clamp(val(mul(disp, gamma)), 0.0, 1.0)
        return _u8_layer(disp), new_state

    return process, init_state


def _u8_layer(disp: torch.Tensor) -> Layer:
    """(3,H,W) in [0,1] -> a one-frame (1,3,H,W) RGB24 layer: floor(x *
    255 + 0.5) as one FMA, XLA's."""
    u8 = torch.clamp(torch.floor(fma32(disp, 255.0, 0.5)), 0, 255) \
        .to(torch.uint8)
    return Layer(planes=(u8[None],), palette=int(Palette.RGB24),
                 gamma=int(Gamma.SRGB))


def _clip01(x):
    x = val(x)
    return torch.clamp(x, 0.0, 1.0) if isinstance(x, torch.Tensor) \
        else min(max(f32(x), 0.0), 1.0)


def _motion_vectors(out, env, xs, ys, du, dv, aspect, h, dev):
    """Streaks from lattice points along the warp field
    (`milkdrop.py:1124-1154`), drawn analytically on the modular
    lattice."""
    def clip(x, lo, hi):
        x = val(x)
        return torch.clamp(x, lo, hi) if isinstance(x, torch.Tensor) \
            else min(max(f32(x), lo), hi)
    nx = clip(env.get("mv_x", 12.0), 1.0, 64.0)
    nyv = clip(env.get("mv_y", 9.0), 1.0, 48.0)
    gx = val(mul(add(xs, env.get("mv_dx", 0.0)), nx))
    gy = val(mul(sub(ys, env.get("mv_dy", 0.0)), nyv))

    def over_n(x, n):
        return x / n if isinstance(n, torch.Tensor) else div_const(x, n)
    ddx = val(mul(val(over_n(gx - torch.floor(gx) - 0.5, nx)), aspect))
    ddy = val(over_n(gy - torch.floor(gy) - 0.5, nyv))
    wmag = torch.sqrt(fma32(du, du, dv * dv)) + f32(1e-9)
    axx, axy = du / wmag, dv / wmag
    dpar = fma32(ddx, axx, ddy * axy)
    dperp = fma32(-ddx, axy, ddy * axx)
    seg = val(mul(val(mul(env.get("mv_l", 0.9), 0.5)),
                  torch.clamp(wmag, max=0.05)))
    over = torch.clamp(torch.abs(dpar) - seg, min=0.0)
    inv_sig = 1.0 / float(np.float32((1.3 / h) ** 2))
    d2 = fma32(dperp, dperp, over * over).to(torch.float64)
    mvmask = torch.exp(d2 * -inv_sig).to(torch.float32)
    mva = (mvmask * _clip01(env.get("mv_a", 0.0)))[None]
    mvrgb = _col3([env.get("mv_r", 1.0), env.get("mv_g", 1.0),
                   env.get("mv_b", 1.0)], dev)
    return fma32(out, 1.0 - mva, mvrgb * mva)


def _echo(disp, out, env, xs, ys, h, w):
    """Video echo: a second, centre-zoomed nearest tap mixed by
    echo_alpha (`milkdrop.py:1182-1192`)."""
    ez = val(env.get("echo_zoom", 1.0))
    ez = torch.clamp(ez, min=f32(1e-3)) if isinstance(ez, torch.Tensor) \
        else max(f32(ez), f32(1e-3))

    def tap(x, n):
        x = val(sub(x, 0.5))
        x = add(x / ez, 0.5) if isinstance(ez, torch.Tensor) \
            else add(div_const(x, ez), 0.5)
        return torch.clamp(val(x) * float(n - 1), 0.0, n - 1.0)
    eu, ev = tap(xs, w), tap(ys, h)
    echo = out[:, torch.floor(ev).to(torch.int64),
               torch.floor(eu).to(torch.int64)]
    ea = _clip01(env.get("echo_alpha", 0.0))
    return fma32(disp, 1.0 - ea, echo * ea)


def _post_filters(disp, env, gr, base_env, pre):
    """brighten = sqrt, darken = square, solarize = 4x(1-x), invert = 1-x
    and darken_center, each gated per frame (`milkdrop.py:1197-1210`)."""
    def gate(name, fn, x):
        g = val(env.get(name, 0.0))
        if isinstance(g, torch.Tensor):
            return torch.where(g > 0.5, fn(x), x)
        return fn(x) if f32(g) > 0.5 else x
    disp = gate("brighten", torch.sqrt, disp)
    disp = gate("darken", lambda x: x * x, disp)
    disp = gate("solarize", lambda x: (4.0 * x) * (1.0 - x), disp)
    disp = gate("invert", lambda x: 1.0 - x, disp)
    if base_env.get("darken_center", 0.0) > 0 \
            or "darken_center" in pre.per_frame:
        r6 = (gr.rad * 6.0).to(torch.float64)
        e = torch.exp(-(r6 * r6)).to(torch.float32)
        mask = fma32(e, -f32(3.0 / 32.0), 1.0)
        disp = gate("darken_center", lambda x: x * mask[None], disp)
    return disp


_MILK_PARAMS = None


def _milk_params():
    global _MILK_PARAMS
    if _MILK_PARAMS is None:
        from .host import Param
        _MILK_PARAMS = (Param("bass", "num", 0.3, 0.0, 2.0),
                        Param("mid", "num", 0.3, 0.0, 2.0),
                        Param("treb", "num", 0.3, 0.0, 2.0),
                        Param("vol", "num", 0.3, 0.0, 2.0))
    return _MILK_PARAMS


def register_milk_preset(text: str, name: str | None = None):
    """Parse + register a preset as generator filter `milk_<name>`;
    returns the Filter. Re-registration replaces (`milkdrop.py:1244`)."""
    from .host import (FILTER_IS_GENERATOR, FILTER_STATEFUL, Filter,
                       register_filter)
    pre = parse_preset(text, name or "preset")
    process, init_state = build_preset_process(pre)
    fname = f"milk_{(name or pre.name).lower()}"
    return register_filter(Filter(
        name=fname, process=process, in_channels=(),
        params=_milk_params(),
        flags=FILTER_IS_GENERATOR | FILTER_STATEFUL,
        init_state=init_state,
        description=f"MilkDrop preset {pre.name!r} "
                    "(projectM.cpp role; audio via pconx)"))


def load_milk_preset(path):
    """Load a `.milk` file and register it (filter `milk_<stem>`)."""
    from pathlib import Path
    p = Path(path)
    return register_milk_preset(p.read_text(errors="replace"), p.stem)


# -- built-in presets, the JAX package's (`milkdrop.py:1270-1352`) ---------

BUILTIN_PRESETS = {
    "tunnel": """[preset00]
fDecay=0.96
fGammaAdj=1.7
nWaveMode=0
wave_r=0.2
wave_g=0.65
wave_b=1.0
wave_a=0.9
zoom=1.035
rot=0.01
warp=0.12
per_frame_1=zoom = zoom + 0.04*bass;
per_frame_2=rot = rot + 0.02*sin(time*0.35);
per_frame_3=wave_r = 0.5 + 0.5*sin(time*0.9);
per_frame_4=wave_b = 0.5 + 0.5*cos(time*1.1);
per_pixel_1=zoom = zoom + rad*0.02;
""",
    "spin": """[preset00]
fDecay=0.975
nWaveMode=2
zoom=1.0
warp=0.35
per_frame_1=q1 = q1 + 0.35*treb;
per_frame_2=rot = 0.05*sin(q1);
per_frame_3=dx = 0.003*sin(time*0.8);
per_frame_4=dy = 0.003*cos(time*0.66);
per_pixel_1=rot = rot + 0.03*sin(rad*6 - time);
""",
    "pulse": """[preset00]
fDecay=0.94
nWaveMode=5
wave_x=0.5
wave_y=0.35
per_frame_init_1=q2 = 0.5;
per_frame_1=q2 = q2*0.9 + bass*0.3;
per_frame_2=zoom = 1.0 + 0.08*q2;
per_frame_3=warp = 0.4*q2;
per_frame_4=wave_g = if(above(q2,0.4), 1.0, 0.4);
""",
    "geometry": """[preset00]
fDecay=0.962
fGammaAdj=1.8
nWaveMode=0
wave_a=0.25
zoom=1.012
rot=0.004
warp=0.25
nMotionVectorsX=10
nMotionVectorsY=7
mv_a=0.18
mv_r=0.3
mv_g=0.5
mv_b=1.0
per_frame_1=q1 = q1*0.85 + bass*0.4;
per_frame_2=zoom = zoom + 0.03*q1;
shapecode_0_enabled=1
shapecode_0_sides=6
shapecode_0_rad=0.12
shapecode_0_num_inst=3
shapecode_0_additive=1
shapecode_0_r=1
shapecode_0_g=0.45
shapecode_0_b=0.1
shapecode_0_a=0.55
shapecode_0_a2=0
shapecode_0_border_a=0.3
shape_0_per_frame1=t1 = instance*2.0944 + time*0.5;
shape_0_per_frame2=x = 0.5 + 0.3*cos(t1);
shape_0_per_frame3=y = 0.5 + 0.3*sin(t1);
shape_0_per_frame4=rad = 0.1 + 0.1*q1;
shape_0_per_frame5=ang = time*0.8;
wavecode_0_enabled=1
wavecode_0_bDrawThick=1
wavecode_0_scaling=0.8
wavecode_0_r=0.2
wavecode_0_g=1.0
wavecode_0_b=0.7
wave_0_per_point1=x = sample;
wave_0_per_point2=y = 0.85 + 0.1*value1 + 0.03*sin(sample*12.57 + time*2);
wave_0_per_point3=a = 0.9 - 0.5*sample;
""",
}


def register_builtin_presets():
    for name, text in BUILTIN_PRESETS.items():
        register_milk_preset(text, name)
