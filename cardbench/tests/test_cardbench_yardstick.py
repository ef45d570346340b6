"""The frozen yardstick: the work count against a hand count, and the
guard against JAX and the JAX package."""

from __future__ import annotations

import subprocess
import sys

import pytest

from conftest import CHECKOUT

from cardbench import guard, work


def test_two_op_render_chain_by_hand():
    # two tracks, a crossfade and a saturation, a 4x2 frame: a pixel is two
    # tracks generated (12 each) and brought in (3 each), the crossfade
    # (16), the saturation (20) and the quantise (15)
    ops, nbytes = work.render_frame(2, ["crossfade"], [["saturation", {}]],
                                    4, 2)
    assert ops == 8 * (2 * (12 + 3) + 16 + 20 + 15) == 648
    assert nbytes == 8 * 3
    t, by = work.least_seconds(ops, nbytes)
    assert by == "operations" and t == pytest.approx(648 / 67e12)


def test_blur_counts_two_separable_passes():
    r = 3
    assert work.op_cost("gaussian_blur", {"radius": r}) == \
        2 * 3 * 2 * (2 * r + 1) + 15


def test_live_frame_by_hand():
    # plasma (44), the two layers brought in (3 each), the luma key (25),
    # the chain, the quantise (15); the colour bars add nothing a pixel
    assert work.live_frame("luma_key", [], 2, 2) == \
        (4 * (44 + 6 + 25 + 15), 12)
    assert work.live_frame("luma_key", ["negate", "saturation"], 2, 2) == \
        (4 * (44 + 6 + 25 + 9 + 20 + 15), 12)


def test_bytes_bound_where_work_is_light():
    t, by = work.least_seconds(10, 1e6)
    assert by == "bytes" and t == pytest.approx(1e6 / 3.35e12)


@pytest.mark.parametrize("names,found", [
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["lives_tpu", "lives_tpu.graph.nodemodel"], ["lives_tpu"]),
    (["lives_tpu_torch", "lives_tpu_torch.graph"], []),
    (["jaxtyping", "lives_tpu_tools", "numpy"], []),
])
def test_guard_compares_top_level_names_whole(names, found):
    assert guard.forbidden(names) == found


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, cardbench.reference.render, "
            "cardbench.reference.live, cardbench.work, cardbench.trace; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'lives_tpu_torch', 'lives_tpu', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_harness_reads_neither_old_benchmark():
    for path in (CHECKOUT / "cardbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in ("import jax", "from jax", "lives_tpu.", "bench.py",
                     "benchmarks/", "import lives_tpu\n"):
            assert word not in text.replace("lives_tpu_torch", ""), \
                (path, word)


class _Ev:
    def __init__(self, name, start, end, device=False, thread=1,
                 annotation=False):
        import torch
        from types import SimpleNamespace
        self.name, self.thread = name, thread
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = annotation


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_trace_reduction_by_hand():
    """A 100 us window: two kernels (10-30, 50-60 us) and a pageable copy
    (60-65 us) on the device, the window's own span mirrored there; on the
    host an upload op open across the first gap and nothing across the
    second, after a launch that ended at 39 us."""
    from cardbench import trace
    prof = _Prof([
        _Ev(trace.WINDOW, 0, 100),
        _Ev(trace.WINDOW, 0, 100, device=True, annotation=True),
        _Ev("aten::copy_", 2, 9),
        _Ev("cudaLaunchKernel", 35, 39),
        _Ev("other thread", 30, 50, thread=2),
        _Ev("k1", 10, 30, device=True),
        _Ev("k2", 50, 60, device=True),
        _Ev("Memcpy HtoD (Pageable -> Device)", 60, 65, device=True),
    ])
    t = trace.reduce(prof)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(35e-6)
    assert t["kernel_s"] == pytest.approx(30e-6)
    assert t["kernels"] == 2 and t["pageable_htod"] == 1
    assert [n for n, _ in t["device_ops"]] == ["k1", "k2",
                                               "Memcpy HtoD (Pageable -> "
                                               "Device)"]
    gaps = dict(t["idle_gaps"])
    # 0-10 (midpoint 5: the copy op), 30-50 (midpoint 40: after the
    # launch), 65-100 (midpoint 82.5: after the launch)
    assert gaps == pytest.approx({"aten::copy_": 10e-6,
                                  "after cudaLaunchKernel": 55e-6})


def test_sampler_keeps_a_sample_of_the_whole_window():
    """Past its slots the sampler replaces at random, so a window that
    offers ten times its slots keeps frames from its start and its end,
    each once, and the same seed keeps the same ones."""
    import torch
    from cardbench import harness

    def kept(seed):
        s = harness.Sampler(seed, 20, (1,), torch.device("cpu"), 1)
        for unit in range(200):
            s.offer(unit, torch.full((1, 1), unit % 256, dtype=torch.uint8),
                    [unit])
        frames, ids = s.taken()
        assert [int(f) for f in frames.flatten()] == ids
        return ids
    ids = kept(5)
    assert len(ids) == len(set(ids)) == 20
    assert min(ids) < 100 <= max(ids)
    assert kept(5) == ids and kept(6) != ids


def test_sample_buffer_is_left_out_of_the_peak():
    import torch
    from cardbench import harness
    s = harness.Sampler(1, 4, (3, 8, 8), torch.device("cpu"), 1)
    assert s.nbytes == 0
    assert harness.program_peak(torch.device("cpu"), s) == 0


@pytest.mark.parametrize("shape,block", [((3, 1080, 1920), 21),
                                         ((3, 2160, 3840), 5),
                                         ((3, 28, 48), 64)])
def test_check_block_follows_the_frame_size(shape, block):
    from cardbench import harness
    assert harness.block_for(shape) == block


def test_idle_share_reads_the_untraced_window():
    """The traced stretch's busy time a frame, times the window's frames,
    over the window: 2 ms busy a frame over 300 frames of a 1 s window is
    40 % idle, whatever the traced stretch's own length."""
    from cardbench import bench
    read = bench.reader("device_idle_share.live")
    rec = {"frames": 300, "window_s": 1.0,
           "trace": {"busy_s": 0.4, "frames": 200, "window_s": 0.9}}
    assert read(rec) == pytest.approx(40.0)
    assert read({"frames": 300, "window_s": 1.0, "trace": None}) is None


def test_a_dotted_name_falls_back_to_its_reader():
    from cardbench import bench, reading
    assert bench.reader("render_fps.cuts") is reading.frame_rate
    assert bench.reader("live_fps") is reading.frame_rate
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric.cuts")
