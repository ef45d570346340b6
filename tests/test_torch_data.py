"""`effects/data.py` of lives_tpu_torch against lives_tpu: the datacons
map's validation and edits, `chain_data` (autoscale, ACTIVATE, values on
the device), `datacons.map` byte for byte both ways, and
`apply_chain_connected` over pconx and cconx.

Tolerances: values pushed by `chain_data` exact (the same float32
operations); frames +/-1 LSB; the saved maps byte-identical."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lives_tpu.constants import Palette as JPalette
from lives_tpu.effects import data as jd
from lives_tpu.effects.host import FrameContext as JContext
from lives_tpu.effects.host import instantiate as j_inst
from lives_tpu.layer import Layer as JLayer
from lives_tpu.player.player import KeyMap as JKeyMap
from lives_tpu_torch.constants import Palette
from lives_tpu_torch.effects import data as td
from lives_tpu_torch.effects.host import FrameContext as TContext
from lives_tpu_torch.effects.host import instantiate as t_inst
from lives_tpu_torch.layer import Layer as TLayer
from lives_tpu_torch.player.player import KeyMap as TKeyMap

PKGS = {"jax": (jd, j_inst), "torch": (td, t_inst)}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_add_channel_validates_endpoints(pkg):
    d, inst = PKGS[pkg]
    mm, mo = inst("motion_mask"), inst("mask_overlay")
    dc = d.DataConnections()
    with pytest.raises(KeyError):
        dc.add_channel(mm, "nope", mo, 0)
    with pytest.raises(IndexError):
        dc.add_channel(mm, "mask", mo, 3)
    with pytest.raises(KeyError):
        dc.add(mm, "motion", mo, "no_such_param")
    dc.add_channel(mm, "mask", mo, 0)
    assert len(dc.chan_conns) == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_add_channel_replaces_existing_slot(pkg):
    """An in-channel takes one source: reconnecting replaces."""
    d, inst = PKGS[pkg]
    mm, fg, mo = inst("motion_mask"), inst("fg_bg_removal"), \
        inst("mask_overlay")
    dc = d.DataConnections()
    dc.add_channel(mm, "mask", mo, 0)
    c = dc.add_channel(fg, "mask", mo, 0)
    assert len(dc.chan_conns) == 1 and dc.chan_conns[0].src is fg
    p = dc.add(mm, "motion", mo, "threshold")
    assert dc.prune({id(mm), id(mo)}) == 1       # fg's edge goes
    dc.remove(p)
    assert (dc.conns, dc.chan_conns) == ([], [])
    dc.chan_conns.append(c)
    dc.remove(c)
    assert dc.chan_conns == []


def _pushed(pkg, v, autoscale, in_param="amount"):
    """`chain_data` of one connection carrying out-value `v` (a number or
    a float32 array) from alpha_means' mean_r into vignette."""
    d, inst = PKGS[pkg]
    src, dst = inst("alpha_means"), inst("vignette", amount=0.3)
    dc = d.DataConnections()
    dc.add(src, "mean_r", dst, in_param, autoscale=autoscale)
    if isinstance(v, np.ndarray):
        v = jnp.asarray(v) if pkg == "jax" else torch.from_numpy(v)
    src.out_values = {"mean_r": v}
    dc.chain_data(dst)
    return dst


@pytest.mark.parametrize("autoscale", [False, True])
@pytest.mark.parametrize("v", [0.25, 1.7, -0.5,
                               np.float32(0.123456), "array"])
def test_chain_data_matches_jax(v, autoscale):
    vals = np.asarray([0.0, 0.4, 0.77, 1.0, 1.3], np.float32) \
        if v == "array" else v
    got = _pushed("torch", vals, autoscale).values["amount"]
    ref = _pushed("jax", vals, autoscale).values["amount"]
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(ref, np.float32))


def test_chain_data_autoscale_maps_ranges():
    """farneback's mean_flow_x in [-64, 64] onto vignette's amount in
    [0, 1]: -64 -> 0, 0 -> 0.5, 64 -> 1, clamped outside."""
    src, dst = t_inst("farneback_analyser"), t_inst("vignette")
    dc = td.DataConnections()
    dc.add(src, "mean_flow_x", dst, "amount", autoscale=True)
    src.out_values = {"mean_flow_x": torch.tensor([-64.0, 0.0, 64.0, 99.0])}
    dc.chain_data(dst)
    assert dst.values["amount"].tolist() == [0.0, 0.5, 1.0, 1.0]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_chain_data_activate(pkg):
    """An ACTIVATE destination toggles the instance from a host value; a
    device value (an array) leaves it as it is, with no read-back."""
    d, inst = PKGS[pkg]
    src, dst = inst("blank_frame_detector"), inst("vignette")
    dc = d.DataConnections()
    dc.add(src, "blank", dst, d.ACTIVATE)
    src.out_values = {"blank": 0.0}
    dc.chain_data(dst)
    assert dst.enabled is False
    src.out_values = {"blank": 1.0}
    dc.chain_data(dst)
    assert dst.enabled is True
    arr = jnp.zeros(()) if pkg == "jax" else torch.zeros(())
    src.out_values = {"blank": arr}
    dc.chain_data(dst)
    assert dst.enabled is True
    assert dst.values == {}


def test_chain_data_stays_on_the_values_device(monkeypatch):
    """A tensor out-value is pushed with tensor operations: no float(),
    item() or bool() of a tensor (each a device-to-host copy on a card)."""
    def refuse(self, *a, **kw):
        raise AssertionError("chain_data read a tensor back")
    for name in ("__float__", "__bool__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    src, dst = t_inst("alpha_means"), t_inst("vignette")
    act = t_inst("edge_analyser")
    dc = td.DataConnections()
    dc.add(src, "mean_r", dst, "amount", autoscale=True)
    dc.add(src, "mean_g", dst, "strength")
    dc.add(act, "edge_energy", dst, td.ACTIVATE)
    src.out_values = {"mean_r": torch.tensor([0.3]),
                      "mean_g": torch.tensor([9.0])}
    act.out_values = {"edge_energy": torch.tensor([1.0])}
    dc.chain_data(dst)
    monkeypatch.undo()
    assert dst.values["amount"].tolist() == [np.float32(0.3)]
    # clamped to the param's max
    assert dst.values["strength"].tolist() == \
        [dst.filter.param("strength").max]


def _keymaps():
    kms = {"jax": JKeyMap(), "torch": TKeyMap()}
    for km in kms.values():
        for k, name in ((0, "motion_mask"), (1, "mask_overlay"),
                        (2, "alpha_means"), (3, "vignette")):
            km.set_key(k, 0, name)
        km.set_key(3, 1, "saturation")
        km.next_mode(3)
        for k in range(4):
            km.toggle(k, True)
    return kms


def _wire(pkg, km):
    d, _ = PKGS[pkg]
    i = km.instances
    dc = d.DataConnections()
    dc.add_channel(i[0], "mask", i[1], 0)
    dc.add_channel(i[0], "mask", i[2], 0)
    dc.add(i[0], "motion", i[1], "threshold", autoscale=True)
    dc.add(i[2], "mean_a", i[3], "saturation")
    dc.add(i[2], "mean_r", i[1], d.ACTIVATE)
    dc.add(t_inst("alpha_means") if pkg == "torch" else j_inst(
        "alpha_means"), "mean_r", i[3], "saturation")   # not in the map
    return dc


def test_save_datacons_byte_identical(tmp_path):
    kms = _keymaps()
    paths = {}
    for pkg, km in kms.items():
        paths[pkg] = tmp_path / f"{pkg}.map"
        PKGS[pkg][0].save_datacons(_wire(pkg, km), km, paths[pkg])
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    d = json.loads(paths["torch"].read_text())
    assert (d["format"], d["version"]) == ("lives_tpu_datacons", 2)
    # the connection whose source is not a keymap instance is left out
    assert len(d["connections"]) == 3 and len(d["channel_connections"]) == 2


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_load_datacons_either_way(tmp_path, writer, reader):
    """A map one package writes loads in the other against a fresh keymap
    whose slots have no instances yet, and saves back byte for byte."""
    kms = _keymaps()
    path = tmp_path / "datacons.map"
    PKGS[writer][0].save_datacons(_wire(writer, kms[writer]), kms[writer],
                                  path)
    km = TKeyMap() if reader == "torch" else JKeyMap()
    for k, name in ((0, "motion_mask"), (1, "mask_overlay"),
                    (2, "alpha_means"), (3, "vignette")):
        km.set_key(k, 0, name)
    km.set_key(3, 1, "saturation")
    km.next_mode(3)
    dc = PKGS[reader][0].load_datacons(km, path)
    assert [c.src is km.instances[0] for c in dc.chan_conns] == [True, True]
    assert [c.in_slot for c in dc.chan_conns] == [0, 0]
    assert len(dc.conns) == 3
    assert not any(km.active[:4])   # instantiated, not enabled
    again = tmp_path / "again.map"
    PKGS[reader][0].save_datacons(dc, km, again)
    assert again.read_bytes() == path.read_bytes()


def _bright_red(pkg, h=16, w=32):
    a = np.zeros((3, h, w), np.uint8)
    a[0] = 255
    if pkg == "jax":
        return JLayer(planes=(jnp.asarray(a),), palette=int(JPalette.RGB24))
    return TLayer(planes=(torch.from_numpy(a)[None],),
                  palette=int(Palette.RGB24))


def test_apply_chain_connected_pconx_matches_jax():
    """alpha_means drives vignette's amount through autoscale
    (tests/test_rendered_fx.py:135-152) in both packages."""
    outs = {}
    for pkg in PKGS:
        d, inst = PKGS[pkg]
        src, dst = inst("alpha_means"), inst("vignette", amount=0.0)
        dc = d.DataConnections()
        dc.add(src, "mean_r", dst, "amount", autoscale=True)
        out = d.apply_chain_connected([src, dst], [_bright_red(pkg)],
                                      connections=dc)
        outs[pkg] = (np.asarray(out.planes[0]).reshape(3, 16, 32),
                     np.asarray(dst.values["amount"], np.float32).ravel())
    np.testing.assert_array_equal(outs["torch"][1], outs["jax"][1])
    assert outs["torch"][1][0] == pytest.approx(1.0, abs=0.01)
    diff = np.abs(outs["torch"][0].astype(int) - outs["jax"][0].astype(int))
    assert diff.max() <= 1
    assert outs["torch"][0][0, 0, 0] < 255   # corners vignetted


def test_apply_chain_connected_cconx_matches_jax():
    """motion_mask's mask into mask_overlay (cconx) and alpha_means
    (cconx, then pconx into vignette), frame by frame."""
    rng = np.random.default_rng(50)
    frames = rng.integers(0, 256, (3, 3, 24, 40), np.uint8)
    res = {}
    for pkg in PKGS:
        d, inst = PKGS[pkg]
        mm = inst("motion_mask", threshold=0.02)
        mo = inst("mask_overlay")
        mo.in_tracks = (0, 0)
        am = inst("alpha_means")
        vg = inst("vignette")
        dc = d.DataConnections()
        dc.add_channel(mm, "mask", mo, 0)
        dc.add_channel(mm, "mask", am, 0)
        dc.add(am, "mean_a", vg, "amount")
        outs, means = [], []
        for i, f in enumerate(frames):
            lay = (JLayer(planes=(jnp.asarray(f),), palette=4) if pkg == "jax"
                   else TLayer(planes=(torch.from_numpy(f)[None],),
                               palette=int(Palette.RGB24)))
            ctx = JContext(frame=i) if pkg == "jax" else TContext(
                frame=torch.tensor([i]))
            out = d.apply_chain_connected([mm, mo, am, vg], [lay], ctx, dc)
            outs.append(np.asarray(out.planes[0]).reshape(3, 24, 40))
            means.append(float(np.asarray(am.out_values["mean_a"]).ravel()[0]))
        res[pkg] = outs, means, np.asarray(mm.out_channels["mask"].planes[0])
    for a, b in zip(res["torch"][0], res["jax"][0]):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    np.testing.assert_allclose(res["torch"][1], res["jax"][1], atol=1e-5)
    assert res["torch"][1][-1] > 0.25       # noise moves: the mask is on
    assert np.abs(res["torch"][2].reshape(24, 40).astype(int)
                  - res["jax"][2].astype(int)).max() <= 1
