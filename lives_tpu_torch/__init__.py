"""lives_tpu_torch: the PyTorch/CUDA port of lives_tpu, for an NVIDIA H100.

Counterpart of `lives_tpu/__init__.py`. The package mirrors `lives_tpu`'s
layout and module names; each module's docstring names its counterpart by
`file:line`. It imports torch and numpy, never jax: the JAX package is the
reference it is tested against (tests/test_torch_*.py).

Ported so far: the multitrack render path (ROADMAP Queue 1, Slices 0-1),
from `scenes.multitrack_timeline` through `events.renderer.render_events`
and `graph.nodemodel.FrameGraph.run_batch` to the fused sweep kernel,
hand-written in CUDA C++ for sm_90a (`csrc/fused_sweep.cu`), and stateful
chains of the EffecTV filters (Slice 4): the sweep's comp-out and comp-in
modes around a frame loop, or the fused stateful sweep
(`csrc/stateful_sweep.cu`), and decoded-clip rendering (Slice 2): the
colour engine (`ops/colorspace.py`, `gamma.py`, `resize.py`, with the
colour kernels of `csrc/yuv420.cu`), YUV4MPEG clip I/O (`io/`),
`events.renderer.ClipFrameSource` and `transcode.render_to_encoder`, with
the composite kernel (`csrc/composite.cu`), and the multi-device layer
(Slice 7, `parallel/`): a mesh of explicit devices for frame-batch DP,
bands, a pipeline, stateful bands and the band sweep (the fused sweep's
band mode), and the single-frame live path (ROADMAP Queue 1 item 12):
`graph.nodemodel.FrameGraph.run` over layers, `io.genclip.GeneratorClip`s
and `GenSlot`s, with the generators of `effects/builtin/generators.py`.
`ops.fma_chain` holds K6, the roofline study's fused-multiply-add probe
(`csrc/fma_chain.cu`), which `chip_smoke.py` runs to read the card's
float32 ceiling. The clip editor's realtime player (ROADMAP Queue 1 item
20) is `player` (`Player`, `KeyMap`, the sinks), with `diagnostics` and
the console `cli` (`python -m lives_tpu_torch.cli play clip.y4m`). The
clip editor's editing half (ROADMAP items 11, 21 and 23) is the clip
store (`io/clips.py`, image and WAV decoders, the PNG, PDF and WAV
encoders), `rfx`, `rfx_scripts`, `rfx_builder`, `clipedit`, `resample`,
`audioedit`, `transcode.transcode` and `io/scrap.py` with the player's
scrap capture. The multitrack workbench (ROADMAP Queue 1 item 23) is
`multitrack` (the headless timeline model: blocks, audio blocks, volume
envelopes, effects, keyframes, undo, layouts), `events.weed_binary` (the
reference's binary layout format), `audio` (`engine`'s mix-down, `fx`'s
filters, sinks and the player's realtime feeder, `analysers`) and the
console's `render` (`python -m lives_tpu_torch.cli render layout.lay`).
The gated backends (ROADMAP Queue 1 item 23 step 5) wrap host libraries
through ctypes and take injected ones: `audio.jack`, `audio.ladspa`,
`audio.fourklives`, `effects.frei0r`, `player.gl`, `player.sdl`,
`io.videodev`, `io.dvgrab`, `io.videojack`, the Kinect camera in
`io.kinect`, and the ffmpeg encoder and decoder. Every entry point takes its device explicitly (a `GeneratorClip`, a
`Player`, the editor's entry points and the console default to "cuda" and
raise without it); nothing picks a device on its own.
"""

from .constants import (Gamma, Palette, YUVClamping, YUVSampling,
                        YUVSubspace)
from .layer import Layer, layer_blank, layer_from_bytes, layer_to_bytes

__version__ = "0.5.0"
