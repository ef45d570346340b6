"""Auto-generated parameter UI specs (reference `src/paramwindow.c`, 4,248
LoC of GTK widget synthesis, + the RFX `<param_window>` layout DSL).

Counterpart of `lives_tpu/paramui.py:18-120` (`widget_for`,
`FRAMEDRAW_SPECIALS`, `framedraw_special`, `param_window_spec`,
`apply_ui_values`): host Python, copied, over the port's effect host
(`effects.host`).

Headless-first: a filter's Param templates compile into a declarative widget
spec (JSON-able) that any front-end — the CLI, a web panel, a future GTK/Qt
shell — can render. Mirrors the reference's widget choice rules: num ->
slider+spin, int -> spin, bool -> checkbox, string_list -> combo, color ->
colour button, string -> entry.
"""

from __future__ import annotations

from typing import Any

from .effects.host import Filter, Instance, get_filter


def widget_for(param) -> dict[str, Any]:
    """One widget spec (paramwindow.c add_param_to_box equivalents)."""
    w: dict[str, Any] = {"name": param.name,
                         "label": param.label or
                         param.name.replace("_", " ").title()}
    if param.kind == "num":
        w.update(widget="slider", min=param.min, max=param.max,
                 default=param.default,
                 step=(param.max - param.min) / 100.0)
    elif param.kind == "int":
        w.update(widget="spin", min=int(param.min), max=int(param.max),
                 default=int(param.default), step=1)
    elif param.kind == "bool":
        w.update(widget="checkbox", default=bool(param.default))
    elif param.kind == "string_list":
        w.update(widget="combo", choices=list(param.choices),
                 default=int(param.default) if not isinstance(
                     param.default, str) else param.default)
    elif param.kind == "color":
        w.update(widget="color", default=list(param.default)
                 if isinstance(param.default, (tuple, list)) else [0, 0, 0])
    else:
        w.update(widget="entry", default=str(param.default))
    return w


#: Framedraw special-widget hints (reference `src/paramspecial.c:93-112`:
#: RFX `special|framedraw|<type>|<params>` lines become interactive
#: widgets drawn over the preview, `src/framedraw.c`). Types:
#: scaledpoint — one x/y pair in 0..1 (the reference's singlepoint /
#: scaledpoint collapse: all our coordinate params are normalised);
#: multipoint — several x/y pairs (one per input of a compositor-style
#: filter), the UI picks the nearest point to drag. Filters not listed
#: fall back to auto-detection (both "x" and "y" num params ->
#: scaledpoint).
FRAMEDRAW_SPECIALS: dict[str, dict] = {
    "compositor": {"type": "multipoint",
                   "points": [["x0", "y0"], ["x1", "y1"],
                              ["x2", "y2"], ["x3", "y3"]]},
    "picture_in_picture": {"type": "scaledpoint", "points": [["x", "y"]]},
    "targeted_zoom": {"type": "scaledpoint", "points": [["x", "y"]]},
    "template_tracker": {"type": "scaledpoint", "points": [["x", "y"]]},
}


def framedraw_special(f: "Filter") -> dict | None:
    """The framedraw hint for a filter, explicit or auto-detected."""
    hint = FRAMEDRAW_SPECIALS.get(f.name)
    if hint is not None:
        return dict(hint)
    names = {p.name for p in f.params if p.kind in ("num", "int")}
    if {"x", "y"} <= names:
        return {"type": "scaledpoint", "points": [["x", "y"]]}
    return None


def param_window_spec(filter_or_name) -> dict[str, Any]:
    """Full parameter-window spec for a filter (make_param_box successor).
    Colour triplets named red/green/blue collapse into one colour widget
    (the reference groups RGB params the same way)."""
    f: Filter = filter_or_name if isinstance(filter_or_name, Filter) \
        else get_filter(filter_or_name)
    widgets = []
    params = list(f.params)
    i = 0
    while i < len(params):
        p = params[i]
        names = [q.name for q in params[i:i + 3]]
        if names[:3] == ["red", "green", "blue"] or \
                (p.name.endswith("red") and len(names) == 3):
            widgets.append({"name": "colour", "label": "Colour",
                            "widget": "color",
                            "default": [params[i].default,
                                        params[i + 1].default,
                                        params[i + 2].default],
                            "maps_to": names[:3]})
            i += 3
            continue
        widgets.append(widget_for(p))
        i += 1
    return {"filter": f.name, "title": f.name.replace("_", " ").title(),
            "description": f.description, "widgets": widgets,
            "is_transition": f.is_transition,
            "n_inputs": f.n_in,
            "special": framedraw_special(f),
            "out_params": [q.name for q in f.out_params]}


def apply_ui_values(inst: Instance, values: dict[str, Any]):
    """Push widget values back onto an instance (colour widgets expand
    to their mapped params)."""
    spec = param_window_spec(inst.filter)
    for w in spec["widgets"]:
        if w["name"] not in values and w["name"] != "colour":
            continue
        if w.get("maps_to"):
            rgb = values.get("colour")
            if rgb is not None:
                for name, v in zip(w["maps_to"], rgb):
                    inst.set(**{name: v})
        elif w["name"] in values:
            inst.set(**{w["name"]: values[w["name"]]})
    return inst
