"""The port's parameter-window specs (`lives_tpu_torch.paramui`) against
lives_tpu's, on the CPU: `param_window_spec` equals the JAX package's for
every filter the port registers (widgets, colour triplets, framedraw
specials, out-params; a description may drop the JAX package's TPU
wording, so it is held to the port's own registry), and `apply_ui_values`
leaves an instance with the JAX instance's values for the same seeded
widget values."""

import numpy as np
import pytest

from lives_tpu import paramui as jui
from lives_tpu.effects import instantiate as j_instantiate
from lives_tpu_torch import paramui as tui
from lives_tpu_torch.effects.host import get_filter, instantiate, \
    list_filters

FILTERS = list_filters()


@pytest.mark.parametrize("name", FILTERS)
def test_param_window_spec_equals_jax(name):
    got, ref = tui.param_window_spec(name), jui.param_window_spec(name)
    assert got.pop("description") == get_filter(name).description
    ref.pop("description")
    assert got == ref
    # by Filter object too
    assert tui.param_window_spec(get_filter(name))["widgets"] == \
        ref["widgets"]


def ui_values(spec, rng):
    """A seeded value for every widget of `spec`, within its range."""
    out = {}
    for w in spec["widgets"]:
        kind = w["widget"]
        if kind == "slider":
            out[w["name"]] = float(np.float32(rng.uniform(w["min"],
                                                          w["max"])))
        elif kind == "spin":
            out[w["name"]] = int(rng.integers(w["min"], w["max"] + 1))
        elif kind == "checkbox":
            out[w["name"]] = bool(rng.integers(0, 2))
        elif kind == "combo":
            out[w["name"]] = int(rng.integers(0, len(w["choices"])))
        elif kind == "color":
            out[w["name"]] = [float(np.float32(v))
                              for v in rng.uniform(0, 1, 3)]
    return out


@pytest.mark.parametrize("name", FILTERS)
def test_apply_ui_values_equals_jax(name):
    spec = tui.param_window_spec(name)
    values = ui_values(spec, np.random.default_rng(
        sum(map(ord, name))))
    got = tui.apply_ui_values(instantiate(name), values)
    ref = jui.apply_ui_values(j_instantiate(name), values)
    assert got.values == ref.values
    assert got.values or not values


def test_framedraw_specials_and_widgets_equal_jax():
    assert tui.FRAMEDRAW_SPECIALS == jui.FRAMEDRAW_SPECIALS
    for name in FILTERS:
        f = get_filter(name)
        for p in f.params:
            assert tui.widget_for(p) == jui.widget_for(p)
