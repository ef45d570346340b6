"""MilkDrop 2 shader-era preset support: an HLSL-subset evaluator on torch
tensors for the `warp_*` / `comp_*` blocks.

Counterpart of `lives_tpu/effects/milkshader.py` (the reference renders
these through projectM's GL shader pipeline,
`lives-plugins/plugins/playback/video/projectM.cpp`). The shader body is
parsed once (`compile_hlsl`, `:837`) and evaluated each frame on the
preset's device: every value is a Python float (a literal, folded as the
JAX package folds it) or a float32 tensor, a component of a `Vec`
(`:60-110`). The tokenizer and parser (`:112-356`) are the JAX package's.

Subset, as the JAX package's: float/float2/float3/float4 (and half, int)
declarations, assignments and compound assignments, swizzle reads and
writes, flattening constructors, ?: (componentwise on a vector
condition), the intrinsics of `_Eval.call` (`:544-645`), MilkDrop's
GetPixel/GetBlur1..3, the samplers `sampler_main` and its fc/pc/fw/pw
variants, `sampler_blur1/2/3` and the procedural noise samplers
(`:358-435`), predicated `if` (both branches evaluate, a select merges
every variable either touched, `_exec_if` `:799`), and `for` loops with
constant bounds unrolled under a 4,096-statement budget (`_unrolled_cost`,
`:866`). Out of subset: while/do/return, dynamic loop bounds, structs,
matrices and user functions. Every error a shader's text can cause
raises ValueError, which `effects.milkdrop.build_preset_process` records
in `shader_fallback` before the preset renders with the fixed-function
pipeline: that is the JAX package's handling of a preset's content, and
it catches ValueError only, nothing a device or the torch runtime raises.

Numerics. The JAX package's frame is one jitted XLA program, and the
values here are the ones its CPU plan computes where a hard select
(`floor`, `step`, a comparison, a texel pick) reads them: a multiply that
feeds an add is one FMA there (`_Prod`, `add`, `sub`: the left product of
an add of two products is the one contracted), a division by a constant
is a product with the float32 reciprocal (`recip`), and `sin`, `cos`,
`exp` and `log` are `utils.sinf`'s and `utils.xla_exp`'s twins of XLA's.
The other
transcendentals evaluate in float64 and round once to float32: within an
ulp of XLA's own approximations and the same bits on the CPU and on a
GPU. `_box_blur`'s prefix sums run in float64, so the order of a GPU's
scan does not show in the float32 result.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.sinf import cosf, sinf
from ..utils.xla_exp import expf, fma32, logf

__all__ = ["compile_hlsl", "ShaderProgram", "Vec"]


# ---------------------------------------------------------------------------
# float32 arithmetic as the JAX package's jitted CPU plan rounds it
# ---------------------------------------------------------------------------

def f32(x: float) -> float:
    """A Python number rounded to float32, as a Python float."""
    return float(np.float32(x))


def recip(c: float) -> float:
    """float32(1 / float32(c)): XLA turns a division by a constant into a
    product with this reciprocal."""
    return float(np.float32(1.0) / np.float32(c))


class _Prod:
    """a * b, not rounded yet: XLA's CPU code generator contracts a
    product that feeds an add or a subtract into one FMA. At least one
    factor is a tensor; a Python factor is a float32 value. `ql` marks a
    product of q-lane values (`land`)."""

    __slots__ = ("a", "b", "ql")

    def __init__(self, a, b, ql=False):
        self.a = a if isinstance(a, torch.Tensor) else f32(a)
        self.b = b if isinstance(b, torch.Tensor) else f32(b)
        self.ql = ql

    def value(self) -> torch.Tensor:
        return tag(self.a * self.b, self.ql)

    def __neg__(self):
        return _Prod(-self.a if isinstance(self.a, torch.Tensor)
                     else -self.a, self.b, self.ql)


def val(x):
    """A value with any pending product rounded."""
    return x.value() if isinstance(x, _Prod) else x


def tag(t, ql: bool):
    """Mark tensor `t` as a q-lane value where `ql` (`land`)."""
    if ql and isinstance(t, torch.Tensor):
        t._ql = True
    return t


def is_ql(x):
    """True for a q-lane value, False for another runtime value, None for
    a number."""
    if isinstance(x, _Prod):
        return x.ql
    if isinstance(x, torch.Tensor):
        return getattr(x, "_ql", False)
    return None


def land(*xs) -> bool:
    """Whether an operation of `xs` runs in the q lane. The JAX plan reads
    a q-var as a slice of the state's q vector, and XLA moves the slice's
    reshape to a scalar past every elementwise operation whose other
    operands are constants: those operations run on a one-element vector,
    and a product there reaches a scalar add as a vector element, which
    LLVM does not contract. An add of a q-lane product and a scalar
    product contracts the scalar one."""
    lanes = [q for q in (is_ql(x) for x in xs) if q is not None]
    return bool(lanes) and all(lanes)


def _fma(a, b, c):
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    return fma32(a, b, val(c))


def _const(x) -> bool:
    return not isinstance(x, (torch.Tensor, _Prod))


def mul(a, b):
    """a * b, kept pending. As XLA's algebraic simplifier does, a product
    by 1 is the other factor, and (A * C1) * C2 is A * (C1 * C2) with the
    constants' product folded in float32."""
    if _const(a) and _const(b):
        return a * b
    if _const(a):
        a, b = b, a
    if _const(b):
        if b == 1.0:
            return a
        if isinstance(a, _Prod) and _const(a.b):
            return _Prod(a.a, f32(np.float32(a.b) * np.float32(b)), a.ql)
        if isinstance(a, _Prod) and _const(a.a):
            return _Prod(a.b, f32(np.float32(a.a) * np.float32(b)), a.ql)
    a, b = val(a), val(b)
    return _Prod(a, b, land(a, b))


def _zero(x) -> bool:
    return _const(x) and x == 0.0


def add(a, b):
    """a + b; a product operand contracts into an FMA (the left one where
    both are products of the same lane), and an added constant 0 is
    dropped, as XLA drops it."""
    if _zero(b):
        return a
    if _zero(a):
        return b
    ql = land(a, b)
    if isinstance(a, _Prod) and a.ql == ql:
        return tag(_fma(a.a, a.b, b), ql)
    if isinstance(b, _Prod) and b.ql == ql:
        return tag(_fma(b.a, b.b, a), ql)
    return tag(val(a) + val(b), ql)


def sub(a, b):
    if _zero(b):
        return a
    ql = land(a, b)
    if isinstance(a, _Prod) and a.ql == ql:
        b = val(b)
        return tag(_fma(a.a, a.b, -b), ql)
    if isinstance(b, _Prod) and b.ql == ql:
        return tag(_fma(-b.a if isinstance(b.a, torch.Tensor) else -b.a,
                        b.b, a), ql)
    return tag(val(a) - val(b), ql)


def div_const(a, c: float):
    """A tensor divided by a constant: the product with its reciprocal."""
    return mul(a, recip(c))


def f64fn(fn):
    """A float32 function evaluated in float64 and rounded once."""
    def g(x: torch.Tensor) -> torch.Tensor:
        return fn(x.to(torch.float64)).to(torch.float32)
    return g


atan2 = (lambda y, x: torch.atan2(y.to(torch.float64), x.to(torch.float64))
         .to(torch.float32))


def to_t(x, dev) -> torch.Tensor:
    """A value as a float32 tensor on `dev`; a Python number by a fill on
    the device (no copy from the host's memory)."""
    x = val(x)
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.full((), f32(x), dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# values: a Vec is a tuple of 1..4 components, each a float32 tensor
# (usually (h, w)) or a Python float. Scalars stay bare.
# ---------------------------------------------------------------------------

_SWZ = {"x": 0, "y": 1, "z": 2, "w": 3,
        "r": 0, "g": 1, "b": 2, "a": 3}


class Vec:
    __slots__ = ("c",)

    def __init__(self, comps):
        self.c = tuple(comps)

    @property
    def n(self):
        return len(self.c)


def _comps(v):
    if isinstance(v, tuple):
        raise ValueError(f"hlsl: sampler {v[1]} used as a value")
    return list(v.c) if isinstance(v, Vec) else [v]


def _mkvec(comps):
    return comps[0] if len(comps) == 1 else Vec(comps)


def _broadcast2(a, b):
    """Component lists for a binary op: scalar op vec broadcasts."""
    ca, cb = _comps(a), _comps(b)
    if len(ca) == len(cb):
        return ca, cb
    if len(ca) == 1:
        return ca * len(cb), cb
    if len(cb) == 1:
        return ca, cb * len(ca)
    raise ValueError(f"hlsl: size mismatch {len(ca)} vs {len(cb)}")


def _map2(f, a, b):
    ca, cb = _broadcast2(a, b)
    return _mkvec([f(x, y) for x, y in zip(ca, cb)])


def _map1(f, a):
    return _mkvec([f(x) for x in _comps(a)])


# ---------------------------------------------------------------------------
# tokenizer / parser (C expression subset), the JAX package's
# ---------------------------------------------------------------------------

_TOK_RE = re.compile(r"""
    (?P<num>\d+\.\d*[fF]?|\.\d+[fF]?|\d+[fF]?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\+\+|--|\+=|-=|\*=|/=|==|!=|<=|>=|&&|\|\||[-+*/%=<>!?:,;.(){}\[\]])
  | (?P<ws>\s+)
""", re.VERBOSE)


def _tokenize(src: str):
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    src = re.sub(r"//[^\n]*", " ", src)
    toks = []
    i = 0
    while i < len(src):
        m = _TOK_RE.match(src, i)
        if m is None:
            raise ValueError(f"hlsl: bad char {src[i]!r}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "num":
            toks.append(float(m.group().rstrip("fF")))
        else:
            toks.append(m.group())
    return toks


_TYPES = {"float": 1, "float2": 2, "float3": 3, "float4": 4,
          "half": 1, "half2": 2, "half3": 3, "half4": 4, "int": 1}


class _Parser:
    def __init__(self, toks):
        self.t = toks
        self.i = 0

    def peek(self, k=0):
        j = self.i + k
        return self.t[j] if j < len(self.t) else None

    def next(self):
        v = self.peek()
        self.i += 1
        return v

    def expect(self, tok):
        got = self.next()
        if got != tok:
            raise ValueError(f"hlsl: expected {tok!r}, got {got!r}")

    # -- statements --

    def block(self):
        out = []
        while self.peek() is not None and self.peek() != "}":
            if self.peek() == ";":
                self.next()
                continue
            if self.peek() in ("while", "do", "return"):
                raise ValueError(
                    f"hlsl: control flow out of subset ({self.peek()})")
            out.append(self.statement())
        return out

    def stmt_or_block(self):
        if self.peek() == "{":
            self.next()
            out = self.block()
            self.expect("}")
            return out
        return [self.statement()]

    def _const(self, what):
        neg = False
        if self.peek() == "-":
            self.next()
            neg = True
        t = self.next()
        if not isinstance(t, float):
            raise ValueError(f"hlsl: {what} must be a numeric constant")
        return -t if neg else t

    def statement(self):
        t = self.peek()
        if t == "if":
            self.next()
            self.expect("(")
            cond = self.ternary()
            self.expect(")")
            then = self.stmt_or_block()
            els = []
            if self.peek() == "else":
                self.next()
                els = self.stmt_or_block()
            return ("if", cond, then, els)
        if t == "for":
            self.next()
            self.expect("(")
            scoped = False
            if self.peek() in _TYPES:
                self.next()
                scoped = True
            var = self.next()
            self.expect("=")
            start = self._const("for start")
            self.expect(";")
            if self.next() != var:
                raise ValueError("hlsl: for must test its loop variable")
            cmpop = self.next()
            if cmpop not in ("<", "<="):
                raise ValueError("hlsl: for bound out of subset")
            stop = self._const("for bound")
            self.expect(";")
            if self.peek() == "++":            # ++i
                self.next()
                v3, step = self.next(), 1.0
            else:
                v3 = self.next()
                nxt = self.next()
                if nxt == "++":
                    step = 1.0
                elif nxt == "+=":
                    step = self._const("for step")
                else:
                    raise ValueError("hlsl: for increment out of subset")
            if v3 != var:
                raise ValueError("hlsl: for must step its loop variable")
            if step <= 0:
                raise ValueError("hlsl: for step must be positive")
            self.expect(")")
            body = self.stmt_or_block()
            return ("for", var, start, stop, cmpop, step, body, scoped)
        if isinstance(t, str) and t in _TYPES:
            self.next()
            decls = []
            while True:
                name = self.next()
                init = None
                if self.peek() == "=":
                    self.next()
                    init = self.ternary()
                decls.append((name, init))
                if self.peek() != ",":
                    break
                self.next()
            self.expect(";")
            return ("decl", _TYPES[t], decls)
        # lvalue: name [.swz] (=|+=|-=|*=|/=) expr ;
        if isinstance(t, str) and isinstance(self.peek(1), (str, float)):
            j = self.i
            name = self.next()
            swz = None
            if self.peek() == ".":
                self.next()
                swz = self.next()
            op = self.peek()
            if op in ("=", "+=", "-=", "*=", "/="):
                self.next()
                val_ = self.ternary()
                self.expect(";")
                return ("set", name, swz, op, val_)
            if op in ("++", "--"):           # i++; / i--;
                self.next()
                self.expect(";")
                return ("set", name, swz, op[0] + "=", ("num", 1.0))
            self.i = j                       # plain expression statement
        e = self.ternary()
        self.expect(";")
        return ("expr", e)

    # -- expressions --

    def ternary(self):
        c = self.or_()
        if self.peek() == "?":
            self.next()
            a = self.ternary()
            self.expect(":")
            b = self.ternary()
            return ("tern", c, a, b)
        return c

    def _lvl(self, sub_, ops):
        a = sub_()
        while self.peek() in ops:
            op = self.next()
            a = ("bin", op, a, sub_())
        return a

    def or_(self):
        return self._lvl(self.and_, ("||",))

    def and_(self):
        return self._lvl(self.cmp, ("&&",))

    def cmp(self):
        return self._lvl(self.add, ("==", "!=", "<", ">", "<=", ">="))

    def add(self):
        return self._lvl(self.mul, ("+", "-"))

    def mul(self):
        return self._lvl(self.unary, ("*", "/", "%"))

    def unary(self):
        if self.peek() == "-":
            self.next()
            return ("neg", self.unary())
        if self.peek() == "!":
            self.next()
            return ("not", self.unary())
        if self.peek() == "+":
            self.next()
            return self.unary()
        return self.postfix()

    def postfix(self):
        e = self.primary()
        while self.peek() == ".":
            self.next()
            e = ("swz", e, self.next())
        return e

    def primary(self):
        t = self.next()
        if isinstance(t, float):
            return ("num", t)
        if t == "(":
            e = self.ternary()
            self.expect(")")
            return e
        if isinstance(t, str):
            if self.peek() == "(":
                self.next()
                args = []
                if self.peek() != ")":
                    args.append(self.ternary())
                    while self.peek() == ",":
                        self.next()
                        args.append(self.ternary())
                self.expect(")")
                return ("call", t, args)
            return ("var", t)
        raise ValueError(f"hlsl: unexpected token {t!r}")


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def bilinear_rows(p, y0, x0, y1, x1, ax, ay):
    """The bilinear blend of four gathered texels as XLA's plan rounds it,
    read from its results: each row's lerp contracts its right product,
    t0 * (1 - ax) + t1 * ax = fma(t1, ax, t0 * (1 - ax)), and the blend of
    the rows its left one (a lerp of two computed values contracts its
    left product, as every other add of two products here)."""
    top = fma32(p[..., y0, x1], ax, p[..., y0, x0] * (1 - ax))
    bot = fma32(p[..., y1, x1], ax, p[..., y1, x0] * (1 - ax))
    return fma32(top, 1 - ay, bot * ay)


def _bilinear(tex, u, v, wrap, dev):
    """tex (3,H,W) f32, u/v (h,w) in [0,1] -> list of 3 (h,w) tensors
    (`milkshader.py:358`)."""
    H, W = tex.shape[-2:]
    u, v = to_t(u, dev), to_t(v, dev)
    if wrap:
        u = u - torch.floor(u)
        v = v - torch.floor(v)
    fu = torch.clamp(u * float(W - 1), 0.0, W - 1.0)
    fv = torch.clamp(v * float(H - 1), 0.0, H - 1.0)
    x0 = torch.floor(fu).to(torch.int64)
    y0 = torch.floor(fv).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    ax = fu - x0.to(torch.float32)
    ay = fv - y0.to(torch.float32)
    return [bilinear_rows(tex[ch], y0, x0, y1, x1, ax, ay)
            for ch in range(tex.shape[0])]


def _wrap32(h: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced to the int32 it wraps to, as int64."""
    h = h & 0xFFFFFFFF
    return torch.where(h >= 1 << 31, h - (1 << 32), h)


def _i32(c: int) -> int:
    """A 32-bit constant as the signed int32 value."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= 1 << 31 else c


def _hash01(ix, iy, iz, seed):
    """Integer-hash value noise lattice in [0,1) (`milkshader.py:381`):
    int32 arithmetic that wraps, on int64 tensors."""
    h = (_wrap32(ix * _i32(0x27D4EB2F)) ^ _wrap32(iy * _i32(0x165667B1))
         ^ _wrap32(iz * _i32(0x9E3779B1)) ^ _i32(seed))
    h = h ^ (h >> 15)
    h = _wrap32(h * _i32(0x85EBCA6B))
    h = h ^ (h >> 13)
    return (h & 0x7FFFFF).to(torch.float32) * f32(1.0 / 0x800000)


def _value_noise(u, v, wcells, dev, t3=None, seed=0):
    """Bilinear value noise over a wcells-periodic lattice; 4 channels
    (`milkshader.py:394`)."""
    gu = to_t(u, dev) * float(wcells)
    gv = to_t(v, dev) * float(wcells)
    x0 = torch.floor(gu)
    y0 = torch.floor(gv)
    ax = gu - x0
    ay = gv - y0
    iz = torch.zeros_like(x0, dtype=torch.int64) if t3 is None \
        else torch.floor(to_t(t3, dev) * float(wcells)).to(torch.int64)
    # int32 conversions of floor values: jnp's f32 -> int32 cast
    xi, yi = x0.to(torch.int32).to(torch.int64), \
        y0.to(torch.int32).to(torch.int64)
    out = []
    for ch in range(4):
        s = seed * 4 + ch

        def lat(dx, dy):
            ix = _wrap32(xi + dx) % int(wcells)
            iy = _wrap32(yi + dy) % int(wcells)
            return _hash01(ix, iy, iz, s)
        top = fma32(lat(1, 0), ax, lat(0, 0) * (1 - ax))
        bot = fma32(lat(1, 1), ax, lat(0, 1) * (1 - ax))
        out.append(fma32(top, 1 - ay, bot * ay))
    return out


def _box_blur(tex, r):
    """Separable box blur of radius r (`milkshader.py:420`), edge-padded.
    The prefix sums run in float64 and each window's sum rounds once to
    float32 after its division by 2r+1."""
    k = 2 * r + 1
    p = F.pad(tex.to(torch.float64)[None], (r, r, r, r),
              mode="replicate")[0]
    c = torch.cumsum(p, dim=1)
    c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
    v = (c[:, k:] - c[:, :-k]) / k
    c = torch.cumsum(v, dim=2)
    c = torch.cat([torch.zeros_like(c[:, :, :1]), c], dim=2)
    return ((c[:, :, k:] - c[:, :, :-k]) / k).to(torch.float32)


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------

def _truthy(v, dev):
    return _map1(lambda x: (torch.abs(to_t(x, dev)) > 1e-30)
                 .to(torch.float32), v)


def _where(c, a, b):
    """select(c, a, b) over components that may be Python floats."""
    return torch.where(c, val(a), val(b))


#: 1 / float32(ln 2): jnp.log2 is log(x) / log(2), a product in XLA's plan
_RLN2 = recip(f32(np.log(2.0)))

#: intrinsics of one argument: a float32 tensor -> a float32 tensor
_F1 = {
    "sin": sinf, "cos": cosf, "tan": f64fn(torch.tan),
    "asin": f64fn(torch.asin), "acos": f64fn(torch.acos),
    "atan": f64fn(torch.atan),
    "sqrt": lambda x: torch.sqrt(torch.clamp(x, min=0.0)),
    "rsqrt": f64fn(lambda x: torch.rsqrt(torch.clamp(x, min=1e-30))),
    "exp": expf, "exp2": f64fn(torch.exp2),
    "log": lambda x: logf(torch.clamp(x, min=f32(1e-38))),
    "log2": lambda x: logf(torch.clamp(x, min=f32(1e-38))) * _RLN2,
    "abs": torch.abs, "sign": torch.sign, "floor": torch.floor,
    "ceil": torch.ceil, "frac": lambda x: x - torch.floor(x),
    "saturate": lambda x: torch.clamp(x, 0.0, 1.0),
}


class _Eval:
    def __init__(self, env, textures, dev):
        self.env = env          # name -> Vec | scalar
        self.tex = textures     # sampler name -> (3,H,W)
        self.dev = dev

    def t(self, x):
        return to_t(x, self.dev)

    # -- expression dispatch --

    def ev(self, node):
        k = node[0]
        if k == "num":
            return node[1]
        if k == "var":
            name = node[1]
            if name in self.env:
                return self.env[name]
            if name.startswith("sampler_"):
                return ("sampler", name)
            raise ValueError(f"hlsl: unknown identifier {name}")
        if k == "neg":
            return _map1(lambda x: -x, self.ev(node[1]))
        if k == "not":
            return _map1(lambda x: (torch.abs(self.t(x)) <= 1e-30)
                         .to(torch.float32), self.ev(node[1]))
        if k == "swz":
            base = self.ev(node[1])
            comps = _comps(base)
            try:
                idx = [_SWZ[ch] for ch in node[2]]
            except (KeyError, TypeError):
                raise ValueError(f"hlsl: bad swizzle .{node[2]}")
            if any(i >= len(comps) for i in idx):
                raise ValueError(f"hlsl: swizzle .{node[2]} out of range")
            return _mkvec([comps[i] for i in idx])
        if k == "tern":
            c = self.ev(node[1])
            a = self.ev(node[2])
            b = self.ev(node[3])
            ca, cb = _broadcast2(a, b)
            cc = _comps(_truthy(c, self.dev))
            n = max(len(cc), len(ca))
            if len(cc) == 1:
                cc = cc * n
            if len(ca) == 1:
                ca, cb = ca * n, cb * n
            if not len(cc) == len(ca) == len(cb):
                raise ValueError(
                    f"hlsl: ?: size mismatch {len(cc)} vs {len(ca)}")
            return _mkvec([_where(ci > 0.5, x, y)
                           for ci, x, y in zip(cc, ca, cb)])
        if k == "bin":
            return self.binop(node[1], self.ev(node[2]), self.ev(node[3]))
        if k == "call":
            return self.call(node[1], node[2])
        raise ValueError(f"hlsl: bad node {node!r}")

    def _div(self, x, y):
        if not isinstance(val(y), torch.Tensor):
            y = val(y)
            if not isinstance(val(x), torch.Tensor):
                if y == 0.0:
                    raise ValueError("hlsl: division by zero")
                return x / y
            return div_const(x, y)
        x, y = val(x), val(y)
        ok = torch.abs(y) > 1e-30
        return torch.where(ok, x / torch.where(ok, y, 1.0), 0.0)

    def binop(self, op, a, b):
        if op == "+":
            return _map2(add, a, b)
        if op == "-":
            return _map2(sub, a, b)
        if op == "*":
            return _map2(mul, a, b)
        if op == "/":
            return _map2(self._div, a, b)
        if op == "%":
            def mod(x, y):
                x, y = self.t(x), self.t(y)
                y = torch.where(torch.abs(y) > 1e-30, y, 1.0)
                r = torch.fmod(x, y)     # jnp.mod: the divisor's sign
                return torch.where((r != 0) & ((r < 0) != (y < 0)),
                                   r + y, r)
            return _map2(mod, a, b)
        if op in ("==", "!=", "<", ">", "<=", ">="):
            f = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
                 ">": torch.gt, "<=": torch.le, ">=": torch.ge}[op]
            return _map2(lambda x, y: f(self.t(x), self.t(y))
                         .to(torch.float32), a, b)
        if op == "&&":
            return _map2(lambda x, y: _comps(_truthy(x, self.dev))[0]
                         * _comps(_truthy(y, self.dev))[0], a, b)
        if op == "||":
            def f_or(x, y):
                tx = _comps(_truthy(x, self.dev))[0]
                ty = _comps(_truthy(y, self.dev))[0]
                return tx + ty - tx * ty
            return _map2(f_or, a, b)
        raise ValueError(f"hlsl: bad op {op}")

    # -- intrinsics --

    def _f1(self, name, x):
        if isinstance(x, float):
            # a constant: the float32 function on the host, as the JAX
            # package evaluates `F1[name](np.float32(x))`
            return float(_F1[name](torch.tensor(f32(x))))
        return _F1[name](self.t(x))

    def call(self, name, argn):
        if name in _TYPES:                       # constructor, flattening
            comps = []
            for a in argn:
                comps.extend(_comps(self.ev(a)))
            n = _TYPES[name]
            if len(comps) == 1:
                comps = comps * n
            if len(comps) < n:
                raise ValueError(f"hlsl: {name} needs {n} components")
            return _mkvec(comps[:n])
        if name in ("tex2D", "tex3D"):
            return self.sample(argn)
        if name == "GetPixel":
            return self.sample([("var", "sampler_main")] + argn, rgb=True)
        if name in ("GetBlur1", "GetBlur2", "GetBlur3"):
            return self.sample(
                [("var", f"sampler_blur{name[-1]}")] + argn, rgb=True)
        args = [self.ev(a) for a in argn]

        def need(n):
            if len(args) < n:
                raise ValueError(f"hlsl: {name} needs {n} arguments")
        if name in _F1:
            need(1)
            return _map1(lambda x: self._f1(name, val(x)), args[0])
        t = self.t
        if name == "pow":
            need(2)
            return _map2(lambda x, y: expf(val(mul(logf(
                torch.clamp(torch.abs(t(x)), min=f32(1e-38))), y))),
                args[0], args[1])
        if name == "atan2":
            need(2)
            return _map2(lambda x, y: atan2(t(x), t(y)), args[0], args[1])
        if name == "fmod":
            need(2)

            def fmod(x, y):
                x, y = t(x), val(y)
                if isinstance(y, torch.Tensor):
                    q = x / torch.where(torch.abs(y) > 1e-30, y, 1.0)
                else:
                    q = val(div_const(x, y if abs(y) > 1e-30 else 1.0))
                return sub(x, mul(torch.trunc(q), y))
            return _map2(fmod, args[0], args[1])
        if name in ("min", "max"):
            need(2)
            f = torch.minimum if name == "min" else torch.maximum
            return _map2(lambda x, y: f(t(x), t(y)), args[0], args[1])
        if name == "clamp":
            need(3)
            lo_ed = _map2(lambda x, y: torch.maximum(t(x), t(y)),
                          args[0], args[1])
            return _map2(lambda x, y: torch.minimum(t(x), t(y)),
                         lo_ed, args[2])
        if name == "lerp":
            need(3)
            return self._lerp(args[0], args[1], args[2])
        if name == "step":
            need(2)
            return _map2(lambda e, x: (t(x) >= val(e)).to(torch.float32),
                         args[0], args[1])
        if name == "smoothstep":
            if len(args) != 3:
                raise ValueError("hlsl: smoothstep needs 3 arguments")
            a, b, x = args
            tt = self._lerpt(a, b, x)
            return _map1(lambda u: mul(mul(u, u), sub(3.0, mul(2.0, u))),
                         tt)
        if name == "dot":
            need(2)
            ca, cb = _broadcast2(args[0], args[1])
            s = 0.0
            for x, y in zip(ca, cb):
                s = add(s, mul(t(x), y))
            return val(s)
        if name == "cross":
            need(2)
            a, b = _comps(args[0]), _comps(args[1])
            if len(a) != 3 or len(b) != 3:
                raise ValueError("hlsl: cross needs float3")
            return Vec([sub(mul(a[1], b[2]), mul(a[2], b[1])),
                        sub(mul(a[2], b[0]), mul(a[0], b[2])),
                        sub(mul(a[0], b[1]), mul(a[1], b[0]))])
        if name in ("length", "distance"):
            need(1 if name == "length" else 2)
            d = args[0] if name == "length" else \
                _map2(sub, args[0], args[1])
            s = 0.0
            for x in _comps(d):
                x = t(x)
                s = add(s, mul(x, x))
            return torch.sqrt(t(s))
        if name == "normalize":
            need(1)
            s = 0.0
            for x in _comps(args[0]):
                x = t(x)
                s = add(s, mul(x, x))
            inv = f64fn(torch.rsqrt)(torch.clamp(t(s), min=1e-30))
            return _map1(lambda x: mul(x, inv), args[0])
        if name == "mul":                        # matrix-free: scale only
            need(2)
            return _map2(mul, args[0], args[1])
        if name == "lum":
            need(1)
            c = _comps(args[0])
            return add(add(mul(0.32, c[0]), mul(0.49, c[1])),
                       mul(0.29, c[2])) if len(c) >= 3 else c[0]
        raise ValueError(f"hlsl: unknown function {name}")

    @staticmethod
    def _lerp(a, b, tt):
        d = _map2(lambda x, y: sub(y, x), a, b)
        return _map2(lambda x, dt: add(x, dt), a, _map2(mul, d, tt))

    def _lerpt(self, a, b, x):
        t = self.t

        def den(p, q):
            d = sub(t(q), p)
            d = val(d)
            return torch.where(torch.abs(t(d)) > 1e-30, d, 1.0)
        dn = _map2(den, a, b)
        tt = _map2(lambda u, d: val(u) / d, _map2(lambda p, q: sub(q, p),
                                                   a, x), dn)
        return _map1(lambda u: torch.clamp(t(u), 0.0, 1.0), tt)

    def sample(self, argn, rgb=False):
        if len(argn) < 2:
            raise ValueError("hlsl: a sampler call needs a sampler and uv")
        sam = self.ev(argn[0])
        if not (isinstance(sam, tuple) and sam[0] == "sampler"):
            raise ValueError("hlsl: tex2D needs a sampler")
        name = sam[1]
        cu = _comps(self.ev(argn[1]))
        if len(cu) < 2:
            raise ValueError("hlsl: a sampler needs 2-component uv")
        u, v = val(cu[0]), val(cu[1])
        t3 = val(cu[2]) if len(cu) > 2 else None
        if name.startswith("sampler_noise"):
            cells = {"lq": 32, "mq": 64, "hq": 256}.get(
                name.rsplit("_", 1)[-1], 32)
            # stable seed (python hash() is per-process salted)
            seed = sum(ord(ch) * (i + 7) for i, ch in enumerate(name))
            comps = _value_noise(u, v, cells, self.dev, t3=t3,
                                 seed=seed & 0x7FFF)
        else:
            # MilkDrop sampler addressing: fw_/pw_ wrap, fc_/pc_ and the
            # blur pyramid clamp, unprefixed samplers follow bTexWrap
            if name.startswith(("sampler_fw_", "sampler_pw_")) \
                    or name.endswith("_wrap"):
                wrap = True
            elif name.startswith(("sampler_fc_", "sampler_pc_")) \
                    or "blur" in name:
                wrap = False
            else:
                wrap = float(self.env.get("_texwrap", 1.0)) > 0.5
            comps = _bilinear(self.tex(name), u, v, wrap, self.dev)
        if rgb:
            return Vec(comps[:3])
        while len(comps) < 4:
            comps.append(torch.ones_like(comps[0]))
        return Vec(comps[:4])


# ---------------------------------------------------------------------------
# program object
# ---------------------------------------------------------------------------

class ShaderProgram:
    """A compiled shader body. run(env, textures) -> (3, h, w) rgb
    (`milkshader.py:705`).

    `env`: uniform name -> scalar / Vec. `textures`: callable (sampler
    name) -> (3, H, W) float32 canvas. The frame's device is uv's."""

    def __init__(self, stmts, src):
        self.stmts = stmts
        self.src = src

    def run(self, env, textures):
        ref = next((x for x in _comps(env["uv"])
                    if isinstance(x, torch.Tensor)), None)
        dev = ref.device if ref is not None else torch.device("cpu")
        ev = _Eval(dict(env), textures, dev)
        e = ev.env
        e.setdefault("ret", Vec(_comps(e["uv"])[:1] * 3))
        self._exec(ev, self.stmts)
        c = _comps(e["ret"])
        if len(c) < 3:
            c = (c * 3)[:3]
        ref = next((val(x) for x in _comps(e["uv"])
                    if isinstance(val(x), torch.Tensor)), None)
        out = [torch.broadcast_to(to_t(x, dev), ref.shape)
               if ref is not None else to_t(x, dev) for x in c[:3]]
        return torch.stack(out)

    def _exec(self, ev, stmts):
        e = ev.env
        for st in stmts:
            k = st[0]
            if k == "decl":
                _, n, decls = st
                for name, init in decls:
                    if init is None:
                        z = val(_comps(e.get("uv"))[0])
                        zero = torch.zeros_like(z) \
                            if isinstance(z, torch.Tensor) else 0.0
                        e[name] = _mkvec([zero] * n)
                    else:
                        v = _comps(ev.ev(init))
                        if len(v) == 1:
                            v = v * n
                        if len(v) != n:
                            raise ValueError(
                                f"hlsl: {name}: init size {len(v)} != {n}")
                        e[name] = _mkvec(v)
            elif k == "set":
                _, name, swz, op, valn = st
                v = ev.ev(valn)
                if name not in e:
                    raise ValueError(f"hlsl: assign to undeclared {name}")
                cur = e[name]
                cc = _comps(cur)
                if swz is not None:
                    if not isinstance(swz, str) or any(
                            ch not in _SWZ or _SWZ[ch] >= len(cc)
                            for ch in swz):
                        raise ValueError(f"hlsl: bad swizzle .{swz}")
                if op != "=":
                    base = _mkvec([cc[_SWZ[ch]] for ch in swz]) \
                        if swz else cur
                    v = ev.binop(op[0], base, v)
                if swz is None:
                    cv = _comps(v)
                    if len(cv) == 1:
                        cv = cv * len(cc)
                    if len(cv) != len(cc):
                        raise ValueError(
                            f"hlsl: assign size mismatch on {name}")
                    e[name] = _mkvec(cv)
                else:
                    cc = cc[:]
                    cv = _comps(v)
                    if len(cv) == 1:
                        cv = cv * len(swz)
                    for ch, x in zip(swz, cv):
                        cc[_SWZ[ch]] = x
                    e[name] = _mkvec(cc)
            elif k == "expr":
                ev.ev(st[1])
            elif k == "if":
                self._exec_if(ev, st)
            elif k == "for":
                _, var, start, stop, cmpop, step, body, scoped = st
                had = var in e
                prev = e.get(var)
                i = start
                while (i < stop) if cmpop == "<" else (i <= stop):
                    e[var] = i
                    self._exec(ev, body)
                    # the header owns the induction variable
                    i += step
                if scoped:                   # `for (int i=...)` scoping
                    if had:
                        e[var] = prev
                    else:
                        e.pop(var, None)
            else:
                raise ValueError(f"hlsl: bad statement {k!r}")

    def _exec_if(self, ev, st):
        """`if` without data-dependent control flow (`milkshader.py:799`):
        both branches run on copies of the environment and a select
        merges every variable either branch touched."""
        _, condn, then, els = st
        cond = _comps(_truthy(ev.ev(condn), ev.dev))
        if len(cond) != 1:
            raise ValueError("hlsl: if condition must be scalar")
        c0 = cond[0]
        orig = ev.env
        et = dict(orig)
        ev.env = et
        self._exec(ev, then)
        ee = dict(orig)
        ev.env = ee
        self._exec(ev, els)
        ev.env = orig
        for name in set(et) | set(ee):
            a, b = et.get(name), ee.get(name)
            if a is None or b is None:       # touched in one branch only
                if name not in orig:
                    continue                 # branch-scoped declaration
                a = orig[name] if a is None else a
                b = orig[name] if b is None else b
            if a is b:                       # untouched: keep as-is
                orig[name] = a
                continue
            ca, cb = _broadcast2(a, b)
            orig[name] = _mkvec([_where(c0 > 0.5, x, y)
                                 for x, y in zip(ca, cb)])


def compile_hlsl(src: str) -> ShaderProgram | None:
    """Compile a MilkDrop warp/comp shader body (`milkshader.py:837`).
    Returns None for empty input; raises ValueError when the code is out
    of subset."""
    if not src or not src.strip():
        return None
    body = src
    m = re.search(r"shader_body\s*\{", body)
    if m:
        body = body[m.end():]
        depth = 1
        for i, ch in enumerate(body):
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    body = body[:i]
                    break
    if re.search(r"^\s*#", body, re.M):
        raise ValueError("hlsl: preprocessor out of subset")
    stmts = _Parser(_tokenize(body)).block()
    cost = _unrolled_cost(stmts)
    if cost > 4096:
        raise ValueError(
            f"hlsl: unrolled statement count {cost} out of subset "
            "(static-unroll budget 4096)")
    return ShaderProgram(stmts, src)


def _unrolled_cost(stmts):
    """Statement count after static loop unrolling (`milkshader.py:866`)."""
    total = 0
    for st in stmts:
        if st[0] == "if":
            total += 1 + _unrolled_cost(st[2]) + _unrolled_cost(st[3])
        elif st[0] == "for":
            _, _var, start, stop, cmpop, step, body, _sc = st
            n, i = 0, start
            while ((i < stop) if cmpop == "<" else (i <= stop)) \
                    and n <= 4096:
                n += 1
                i += step
            total += 1 + n * max(1, _unrolled_cost(body))
        else:
            total += 1
    return total

