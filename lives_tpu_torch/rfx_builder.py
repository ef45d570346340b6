"""User-authored rendered effects: the RFX builder successor.

Counterpart of `lives_tpu/rfx_builder.py:1-399`, host Python copied; a
registered script runs on the port's engine (`rfx_scripts.apply_script`,
on an explicit device), and a directory scan's refusals are warnings
(`warnings.warn`) where the JAX package prints to its console.

The reference's rfx-builder (`src/rfx-builder.c`, saved through
`build-lives-rfx-plugin`) lets a user define a NEW rendered effect: name,
parameters (with window layout), and per-frame loop code, persisted as an
RFX `.script` file. The twist: the "loop code" is an existing
registered realtime filter (a device function of the port); a user script
binds its own parameters to the filter's parameters through small
arithmetic mapping expressions evaluated per frame.

Mapping expressions may reference the script's params plus:
  ``t``        0..1 across the applied frame range
  ``frame``    absolute frame number
  ``n_frames`` range length
and the functions sin/cos/abs/min/max/floor/sqrt/exp/log/clip. They are
evaluated by a whitelisted AST walker — .script files can come from
anywhere, so no raw eval (RFX scripts are the reference's classic
user-content vector).

Files round-trip in the reference `.script` DSL (sections <name>,
<description>, <params>, <param_window>, ...; RFX.spec). Our dialect adds
a `<filter>` section carrying ``filter_name`` plus ``param=expr`` mapping
lines, under ``<language_code>`` 0xF6 (the reference reserves 0xF0 for
LiVES-perl). Reference scripts without a <filter> section load their
param specs but cannot execute (their loop code is Perl+ImageMagick);
`load_script_file` reports that explicitly.
"""

from __future__ import annotations

import ast
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

LANGUAGE_CODE = "0xF6"   # lives_tpu filter-binding dialect

_ALLOWED_CALLS = {
    "sin": math.sin, "cos": math.cos, "abs": abs, "min": min, "max": max,
    "floor": math.floor, "sqrt": math.sqrt, "exp": math.exp,
    "log": math.log,
    "clip": lambda v, lo, hi: min(max(v, lo), hi),
}

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.Name,
    ast.Call, ast.IfExp, ast.Compare, ast.BoolOp, ast.Load,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd, ast.Not, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.Eq, ast.NotEq, ast.And, ast.Or,
)


def _safe_pow(base, exp):
    """Bounded ** for untrusted expressions: 9**9**9 must not hang the
    host. Plenty for gamma curves and polynomial ramps."""
    base = float(base)
    exp = float(exp)
    if abs(exp) > 64 or abs(base) > 1e9:
        raise ValueError("pow out of range in RFX mapping expression")
    return base ** exp


class _PowGuard(ast.NodeTransformer):
    def visit_BinOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Pow):
            return ast.copy_location(
                ast.Call(func=ast.Name(id="_safe_pow", ctx=ast.Load()),
                         args=[node.left, node.right], keywords=[]), node)
        return node


def compile_mapping_expr(expr: str) -> Callable[[dict], float]:
    """Compile one mapping expression into fn(names) -> value through a
    whitelisted-AST evaluator (scripts are untrusted user content).
    The returned fn carries the referenced variable names in `.names`."""
    if len(expr) > 1024:
        raise ValueError("RFX mapping expression too long")
    try:
        tree = ast.parse(expr, mode="eval")
    except (SyntaxError, RecursionError, MemoryError) as e:
        raise ValueError(f"unparseable RFX mapping expression: {e}")
    names = set()
    n_nodes = 0
    for node in ast.walk(tree):
        n_nodes += 1
        if n_nodes > 200:
            raise ValueError(f"RFX mapping expression too complex: "
                             f"{expr!r}")
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(
                f"disallowed syntax {type(node).__name__!r} in RFX "
                f"mapping expression {expr!r}")
        if isinstance(node, ast.Constant) and \
                not isinstance(node.value, (int, float, bool)):
            raise ValueError(f"non-numeric constant in {expr!r}")
        if isinstance(node, ast.Constant) and \
                abs(float(node.value)) > 1e9:
            raise ValueError(f"constant out of range in {expr!r}")
        if isinstance(node, ast.Name):
            names.add(node.id)
        if isinstance(node, ast.Call):
            if not (isinstance(node.func, ast.Name)
                    and node.func.id in _ALLOWED_CALLS):
                raise ValueError(f"disallowed call in {expr!r}")
            if node.keywords:
                raise ValueError(f"keyword args not allowed in {expr!r}")
    tree = ast.fix_missing_locations(_PowGuard().visit(tree))
    code = compile(tree, "<rfx-mapping>", "eval")

    def run(names: dict):
        scope = {"__builtins__": {}, "_safe_pow": _safe_pow}
        scope.update(_ALLOWED_CALLS)
        scope.update(names)
        return eval(code, scope)  # noqa: S307 — AST whitelisted above

    run.names = frozenset(names - set(_ALLOWED_CALLS))
    return run


@dataclass
class UserParam:
    name: str
    kind: str = "num2"         # num0..num4 / bool / string / colRGB24 /
    default: object = 0.0      # string_list (RFX.spec types)
    min: float = 0.0
    max: float = 1.0
    label: str = ""
    choices: tuple = ()

    def script_line(self) -> str:
        lbl = self.label or ("_" + self.name.replace("_", " ").title())
        if self.kind.startswith("num"):
            return (f"{self.name}|{lbl}|{self.kind}|{self.default}|"
                    f"{self.min}|{self.max}|")
        if self.kind == "bool":
            return f"{self.name}|{lbl}|bool|{1 if self.default else 0}|0|"
        if self.kind == "colRGB24":
            r, g, b = self.default if isinstance(self.default, tuple) \
                else (0, 0, 0)
            return f"{self.name}|{lbl}|colRGB24|{r}|{g}|{b}|"
        if self.kind == "string_list":
            items = "|".join(str(c) for c in self.choices)
            return f"{self.name}|{lbl}|string_list|{self.default}|{items}|"
        return f"{self.name}|{lbl}|string|{self.default}|1024|"


class RFXBuilder:
    """Author a rendered effect: params + a filter binding, then
    `register()` it live and/or `save()` it as a .script file
    (rfx-builder.c "New Test RFX" flow)."""

    def __init__(self, name: str, description: str = "",
                 author: str = "lives_tpu", min_frames: int = 1,
                 num_channels: int = 1):
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
            raise ValueError(f"bad RFX name {name!r}")
        self.name = name
        self.description = description or name
        self.author = author
        self.min_frames = min_frames
        self.num_channels = num_channels
        self.params: list[UserParam] = []
        self.filter_name: Optional[str] = None
        self.mapping: dict[str, str] = {}
        self.layout_rows: list[str] = []

    def add_param(self, name: str, kind: str = "num2", default=0.0,
                  min: float = 0.0, max: float = 1.0, label: str = "",
                  choices: tuple = ()) -> "RFXBuilder":
        if any(p.name == name for p in self.params):
            raise ValueError(f"duplicate param {name!r}")
        if name in ("t", "frame", "n_frames"):
            raise ValueError(f"{name!r} is a reserved mapping variable")
        self.params.append(UserParam(name, kind, default, min, max,
                                     label, tuple(choices)))
        return self

    def set_filter(self, filter_name: str, **mapping: str) -> "RFXBuilder":
        """Bind the loop code: an existing registered filter, with
        `filter_param="expression"` mappings (unmapped filter params keep
        their defaults). Expressions are validated now."""
        from .effects.host import get_filter
        filt = get_filter(filter_name)   # raises on unknown
        known = {p.name for p in filt.params}
        for fparam, expr in mapping.items():
            if fparam not in known:
                raise ValueError(
                    f"{filter_name!r} has no param {fparam!r}")
            compile_mapping_expr(str(expr))
        self.filter_name = filter_name
        self.mapping = {k: str(v) for k, v in mapping.items()}
        return self

    def layout(self, *rows: str) -> "RFXBuilder":
        """<param_window> layout lines (e.g. "layout|p0|p1|")."""
        self.layout_rows.extend(rows)
        return self

    # -- registration -------------------------------------------------------
    def register(self) -> str:
        """Register with the RFX script registry: the new effect is
        immediately appliable via apply_script / cli rfx / OSC
        /rfx/apply / the web UI list."""
        if self.filter_name is None:
            raise ValueError("set_filter() first: a script needs loop code")
        register_user_script(self.name, self.filter_name,
                             list(self.params), dict(self.mapping))
        return self.name

    # -- persistence (reference .script DSL) --------------------------------
    def to_script(self) -> str:
        if self.filter_name is None:
            raise ValueError(
                "set_filter() first: a saved script without a <filter> "
                "binding could never load back")
        params = "\n".join(p.script_line() for p in self.params)
        window = "\n".join(self.layout_rows) or "\n".join(
            f"layout|p{i}|" for i in range(len(self.params)))
        filt = "\n".join([self.filter_name or ""]
                         + [f"{k}={v}" for k, v in self.mapping.items()])
        return f"""LiVES rendered effect plugin script
------------------------------------

<define>
|1.7
</define>

<name>
{self.name}
</name>

<version>
1
</version>

<author>
{self.author}|
</author>

# Menu entry|Action description|min_frames|num_channels|
<description>
{self.name}|{self.description}|{self.min_frames}|{self.num_channels}|
</description>

<requires>
</requires>

# parameters Label|group|type|default|min|max|      (list)
<params>
{params}
</params>

<param_window>
{window}
</param_window>

<properties>
0x0000
</properties>

# 0xF6 == lives_tpu filter binding (filter_name, then param=expr lines)
<language_code>
{LANGUAGE_CODE}
</language_code>

<filter>
{filt}
</filter>
"""

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_script())
        return path


# ---------------------------------------------------------------------------
# Registration + reload
# ---------------------------------------------------------------------------

def _make_mapping_fn(params: list[UserParam], mapping: dict[str, str]):
    compiled = {fp: compile_mapping_expr(expr)
                for fp, expr in mapping.items()}
    defaults = {p.name: p.default for p in params}

    def mapping_fn(user_values: dict, n_frames: int) -> dict:
        base = dict(defaults)
        base.update({k: v for k, v in user_values.items()
                     if k in defaults})
        out = {}
        for fp, fn in compiled.items():
            animated = bool({"t", "frame"} & fn.names)
            if animated:
                def per_frame(frame, fn=fn, base=base):
                    t = frame / max(n_frames - 1, 1)
                    return fn({**base, "t": t, "frame": frame,
                               "n_frames": n_frames})
                out[fp] = per_frame
            else:
                out[fp] = fn({**base, "t": 0.0, "frame": 0,
                              "n_frames": n_frames})
        return out

    return mapping_fn


def register_user_script(name: str, filter_name: str,
                         params: list[UserParam],
                         mapping: dict[str, str]) -> None:
    from . import rfx_scripts
    defaults = {p.name: p.default for p in params}
    sd = rfx_scripts.ScriptDef(
        name, filter_name, _make_mapping_fn(params, mapping), defaults)
    # user scripts advertise their own param specs (there is no file in
    # the reference script dir to read them from)
    spec = []
    for p in params:
        kind = ("int" if p.kind == "num0" else
                "num" if p.kind.startswith("num") else
                "color" if p.kind == "colRGB24" else p.kind)
        d = {"name": p.name, "kind": kind, "default": p.default,
             "label": p.label or p.name}
        if kind in ("num", "int"):
            d.update(min=p.min, max=p.max)
        if p.choices:
            d["choices"] = p.choices
        spec.append(d)
    object.__setattr__(sd, "user_spec", spec)
    rfx_scripts._SCRIPTS[name] = sd


def load_script_file(path: str | Path) -> str:
    """Load a .script file and register it. Our dialect (<filter>
    section) binds and executes; a plain reference script has Perl loop
    code we cannot run — reported explicitly rather than registering a
    broken effect."""
    text = Path(path).read_text(errors="replace")

    def section(tag):
        m = re.search(rf"<{tag}>\s*(.*?)\s*</{tag}>", text, re.S)
        return m.group(1).strip() if m else ""

    name = section("name").split()[0] if section("name") else ""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name or ""):
        raise ValueError(f"{path}: bad or missing <name>")
    filt_sec = section("filter")
    if not filt_sec:
        raise ValueError(
            f"{path}: no <filter> binding — reference Perl loop code "
            f"is not executable here (rfx-builder scripts re-authored "
            f"with RFXBuilder.set_filter run on device)")
    lines = [ln.strip() for ln in filt_sec.splitlines() if ln.strip()]
    filter_name, map_lines = lines[0], lines[1:]
    mapping = {}
    for ln in map_lines:
        if "=" not in ln:
            raise ValueError(f"{path}: bad mapping line {ln!r}")
        k, v = ln.split("=", 1)
        mapping[k.strip()] = v.strip()

    from .rfx import parse_rfx_params
    spec = parse_rfx_params(text)
    # validates params (reserved names, duplicates), the filter, and the
    # expressions before anything registers
    b = RFXBuilder(name)
    for d in spec:
        kind = {"int": "num0", "num": "num2", "color": "colRGB24"}.get(
            d["kind"], d["kind"])
        b.add_param(d["name"], kind, d.get("default", 0.0),
                    d.get("min", 0.0), d.get("max", 1.0),
                    d.get("label", ""),
                    tuple(c for c in d.get("choices", ()) if c))
    b.set_filter(filter_name, **mapping)
    register_user_script(name, filter_name, b.params, mapping)
    return name


def load_user_scripts(dirpath: str | Path) -> list[str]:
    """Load every loadable .script in a directory (the reference scans
    ~/.lives-dir for user RFX). Returns registered names; files without
    a <filter> binding are skipped."""
    out = []
    d = Path(dirpath)
    if not d.is_dir():
        return out
    for p in sorted(d.glob("*.script")):
        try:
            out.append(load_script_file(p))
        except (ValueError, KeyError, SyntaxError, RecursionError,
                OSError) as e:
            # one bad file must not abort the scan
            import warnings
            warnings.warn(f"rfx script {p.name} not loaded: {e}",
                          stacklevel=2)
    return out
