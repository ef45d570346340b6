#!/usr/bin/env python
"""Smoke run of lives_tpu_torch on one NVIDIA GPU: build, check, render.

Drives the port's paths through the entry points a user calls
(`events.renderer.render_events` -> `graph.nodemodel.FrameGraph.run_batch`
-> the kernels, and `transcode.render_to_encoder` over decoded clips) at
1920x1080, 30 fps, in 96-frame chunks, after building the six kernel
libraries from `lives_tpu_torch/csrc/` and holding every kernel against its
plain PyTorch version:

- the main path, the 10-track multitrack timeline (`scenes.
  multitrack_timeline`) through the fused sweep kernel;
- three stateful chains (ROADMAP Slice 4), recorded as init events:
  A "stateful-LED" (benchmarks/render_stateful_led.py:49-60; its 11-step
  tail runs the sweep in comp-in mode), B "stateful prefix"
  (benchmarks/render_stateful.py:33-40; its prefix runs the sweep in
  comp-out mode) and C "alien" (render_stateful_led.py:43-47; the fused
  stateful sweep under LIVES_TPU_FUSED_STATEFUL=1, the 3-phase route
  without it);
- config D, "decoded clips": 10 YUV4MPEG clips (C420jpeg, clamped BT.601)
  rendered through the main path's 13-effect chain into a YUV4MPEG file:
  K2 converts each track's chunk, K4 runs the 9 transitions, the eager
  tail the rest, K3 converts each chunk in the encoder;
- the roofline study (benchmarks/sweep_profile.py's counterpart): four
  chain variants through `render_events`, and the card's float32 ceiling
  read with K6, the fused-multiply-add probe;
- the single-frame live path at 4K60 (BASELINE row 5, as
  benchmarks/latency4k.py:40-80 drives it): `GeneratorClip`s through
  `FrameGraph.run`, eight chain configurations toggled every 25 frames;
- timeline V, the sweep's whole vocabulary: 10 tracks folded by the
  transitions the op table gained (wipe, irises, dissolve, the luma
  overlays, ...), then alpha_over, mask_overlay, a blur and ten grading
  ops, through K1's exact build;
- the realtime player (the clip editor's VJ path): two decoded 1080p30
  YUV4MPEG clips through `Player` (keys, trickplay, precache and upload
  ring, K2 per track and K3 in the Y4M sink's step), recorded and
  re-rendered;
- the VJ filters a reference keymap names (geometry.py, the EffecTV
  warps and feedbacks, threefry's noise and nervous, motion_blur, the
  compounds): each alone against the port on the CPU, a stateful
  timeline through K1's comp-out and comp-in modes, and the player with a
  reference-format keymap;
- text and titles (`text.py`, `extra.py`'s filters, `puretext`): each new
  filter alone against the port on the CPU, a titled edit rendered from
  decoded clips (K2, K4 on its transitions, K3), and the player with the
  reference keymap's text keys and a subtitle track;
- the MJPEG lanes (`io/jpeg_ingest.py`, `io/jpeg_encode.py`, the AVI
  reader and writer): config D from MJPEG AVIs through the compressed
  ingest lane (K2, K4) into `render_to_encoder`'s default "mjpeg"
  encoder, and the player on MJPEG clips through the lane (K2, K3);
- data connections: the 25 filters they carry, each alone against the
  CPU, a wired render (cconx recorded on init events) from decoded clips
  on the frame loop (K2, K3), and the player with a wired keymap loaded
  from datacons.map (K2, K3);
- the clip editor: rendered effects and RFX scripts on decoded clips
  (K2 a batch), clipboard edits and merges with undo, `transcode` (K2 and
  K3 a batch), the encoders, the console's `rfx`, and the player's PNG
  sink and scrap capture.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --config-d   # config D alone (phase 11's render
                                       # and K4's time), no result line
    python3 chip_smoke.py --colour     # K2's and K3's times alone, no
                                       # result line
    python3 chip_smoke.py --roofline   # phase 13 alone, no result line
    python3 chip_smoke.py --live       # phase 14 alone, no result line
    python3 chip_smoke.py --vocabulary # phases 1-2 and 15, no result line
    python3 chip_smoke.py --datacons   # phase 20 alone, no result line
    python3 chip_smoke.py --guard      # K1 u8, K4 and K5 on their main
                                       # paths' chunks and the ptxas report
                                       # of the three, no result line
    python3 chip_smoke.py --player     # phase 16 alone, no result line
    python3 chip_smoke.py --vjfilters  # phases 1-2 and 17, no result line
    python3 chip_smoke.py --titles     # phases 1-2 and 18, no result line
    python3 chip_smoke.py --mjpeg      # phase 19 alone, no result line
    python3 chip_smoke.py --clipedit   # phase 21 alone, no result line

Phases, one line each:
1. require CUDA (exit 1 without it); the card's name and power limit;
2. build the six kernel libraries (one nvcc each, started together; K1
   twice, its core build and its exact one), build times, and each kernel
   entry's ptxas registers and spills;
3. the sweep vs `plain_sweep` on the card, max |diff| <= 1 LSB: the
   13-effect chain at 1920x1080 with 10 tracks (B=4), and a ragged 1000x562
   frame with 3 tracks;
4. `render_to_arrays` of the golden timeline on the card vs
   tests/fixtures/render_golden.npz (lives_tpu, f32 XLA path), <= 1 LSB;
5. the main path through `render_events`: 192 frames in 96-frame chunks;
   the kernel must launch once a chunk, its first frames must match the
   plain route; then a timed pass (frames/s, x realtime), and the kernel's
   and `plain_sweep`'s time on one 96-frame chunk; the geometry K1's
   launch chooses and K1's time at every tile (`fused_sweep.TILES`), and
   on crossfade alone and with one blur of r = 1, 3, 8, 16 at its chosen
   geometry and every tile; K1 on the chain without its blur (R = 0) in
   turns with the whole chain, which shows what the halo costs; a
   profiled pass of the main path (device busy and idle share);
6. the sweep's comp-out and comp-in modes vs their plain versions at
   1920x1080 (B=4) and 1000x562: the f32 comp within 1/255, u8 within
   1 LSB;
7. the fused stateful sweep vs `plain_stateful_sweep` over two chunks on
   config C, on life + gaussian_blur r=2, on gaussian_blur r=2 + fire and
   on the largest summed halo it takes (blur r=16 + fire + blur r=16,
   R = 33): frames within 1 LSB, final states within 1e-5 (f32) or exact
   (u8);
8. configs A, B and C (C with and without the pref) through
   `render_events`, 192 frames in 96-frame chunks: the launch counts of each
   path (C under the pref: one cooperative K5 launch a chunk), its first
   4 frames against the plain route (<= 1 LSB), a warm timed pass, and
   kernel vs plain ms on one 96-frame chunk for each new kernel; K5's
   chosen geometry (tile, run, blocks an SM, grid, rounds of tiles a frame)
   and its time at every tile and run, and on config C's chain with steps
   disabled (where its time goes);
9. the colour kernels K2 (`yuv420_to_rgb`) and K3 (`rgb_to_yuv420`) vs
   their plain versions at 1920x1080 (B=4) and at widths whose rows are no
   multiple of 16 bytes (1000, 1004, 1002, 994), clamped and full range,
   BT.601 and BT.709, K3 on RGB, RGBA and odd heights and widths; then on
   planes that are views at byte offsets 1-3 of one buffer at 1080p: K2
   within 1 LSB, K3 integer-identical, with the share of differing
   values, one line a size;
10. the composite kernel K4 vs `plain_composite`: config D's 9-transition
   prefix at 1920x1080 over 10 tracks (B=4), a 3-track prefix at 1000x562,
   and at 45x37 (H*W no multiple of 16) on tracks that are views at byte
   offsets 0-3 with a prefix that reads one track twice: within 1 LSB;
11. config D, decoded clips: 10 YUV4MPEG clips of 24 frames (synthetic
   frames through K3, written to a temporary directory removed at exit),
   opened with `open_clip`, rendered by `transcode.render_to_encoder(...,
   encoder="yuv4mpeg")` through `ClipFrameSource` under
   LIVES_TPU_PALLAS_COMPOSITE=1, 192 frames in 96-frame chunks: the launch
   counts (K2 10 a chunk, K4 1 a chunk, K3 1 a chunk), the written file
   reopened (192 frames at 1920x1080) and holding the route's first 4
   frames, which match the route on the plain versions (<= 1 LSB) and the
   route without the pref as closely as the JAX package's own two routes
   do (<= 6 LSB, at most 300 values above 2 LSB; it shows 6 and 281,
   tests/test_torch_routes.py), a warm timed pass with the host time in `get_batch` split from the
   rest, a profiled pass (device busy share, device-to-host copies), and
   K2, K3 and K4 vs plain ms on one 96-frame chunk (K2 and K3 at each run
   length of `yuv_kernels.RUNS`, K3 also as 96 one-frame launches, and a
   copy ceiling: `Tensor.copy_` moving K2's bytes, in TB/s; `--colour`
   prints these times alone); K4's geometry (span, staged bytes, blocks an
   SM),
   its time over the first 1, 3, 5 and 9 transitions beside their bytes,
   and over 9 crossfades (what bounds it);
12. the multi-device layer (`lives_tpu_torch.parallel`) on one card, as a
   4-entry mesh on cuda:0 (every band at its true rows):
   a. K1's band mode vs the whole-frame kernel over the main path's chain
      (B=4) at 1920x1080 in bands of 270, 540 and 1080 rows, and at a
      ragged 1000x562 with 3 tracks in bands of 281: every band bit for bit
      the whole frame's rows, and within 1 LSB of `plain_band_sweep`;
   b. `spatial_sweep_fn` over the main path's timeline, 192 frames in
      96-frame chunks (`chunk_of`): 4 band launches a chunk and no
      whole-frame launch, frames bit for bit those of `render_events`; a
      timed pass beside the main path's (in turns), and the 4 band launches
      of a chunk, one band launch and their plain version vs K1's launch;
   c. `sharded_batch_fn` (DP) equal to `run_batch`, and `spatial_batch_fn`
      (SP) within 1 LSB, over 10 RGB24 (8,3,1080,1920) tracks;
   d. `spatial_stateful_fn` on config A's chain over 10 layers at 1080p,
      two calls of 8 frames: frames within 1 LSB of `run_batch`, states
      within 1e-5 (f32) or exact (u8);
   e. `pipeline_chain_fn`, 4 stages of point filters over (8,3,1080,1920)
      f32 frames, within 1e-5 of the sequential chain;
   f. `dryrun_multichip` on the 4 entries (every path at a small size,
      each against the DP render);
13. the roofline study: the variants full, noblur, trans (10 tracks) and
   trans2 (2 tracks) of benchmarks/sweep_profile.py:68-72,102-107 through
   `render_events`, 192 frames in 96-frame chunks after a warm pass, one
   K1 launch a chunk asserted: ms a frame, x realtime, K1's time on one
   chunk; K6 (`ops/fma_chain.py`) against `plain_fma_chain` on
   (3,1080,1920) float32 at K = 32 and 128, within a relative error of
   K * 2^-23; the FFMA, FMUL and FADD count of its SASS (cuobjdump -sass:
   FFMA only); each K of 32, 128, 512 and 2048 timed by CUDA events over
   200 launches in a row queued behind one long launch (so the device, not
   the host's 30-40 us a launch, sets the time), the depths in turns up
   and down, with the host's time a launch; the ceiling, the difference
   in operations over the difference in time, from 32 -> 128 (as the
   reference reads it) and 512 -> 2048; each variant's K1 operations a
   chunk over K1's time, as a share of the measured ceiling and of 67
   TFLOP/s; the library call at K = 128, `x * c` with c = sum M^i for
   i <= K (the chain in closed form, within K * 2^-23 of the plain
   version), timed beside K6;
14. the live path at 3840x2160 and 60 fps: `GeneratorClip("plasma")` over
   `GeneratorClip("colour_bars")` on the card through eight `FrameGraph`s
   (benchmarks/latency4k.py:54-56), each warmed once; 480 frames
   switching configuration every 25: the host's time from the `run` call
   to `torch.cuda.synchronize()` a frame, as p50, p99 and max beside
   BASELINE row 5's target (p99 < 16 ms); the means over windows of 8
   frames (latency4k.py's reading) and frames/s; peak memory; a profiled
   pass (device busy and idle share, eager kernels a frame); checks:
   frame 0 of [saturation, vignette] and of [negate] on the card within
   1 LSB of the same `run` on the CPU at 1920x1080, `run([GenSlot(fg, n),
   bg])` bit for bit `run([fg.get_frame(n), bg])`, a GenSlot around
   beat_rings raises, and traced values that are tensors on the card give
   the host numbers' frame bit for bit, with no synchronizing call in
   either path (torch's sync debug mode).
15. the sweep's whole vocabulary (ROADMAP item 13):
   a. timeline V (`timeline_v`) through `render_events`, 192 frames in
      96-frame chunks: one K1 launch a chunk (its exact build) and no chunk
      on the plain route (`nodemodel.PLAIN_CHUNKS`), its first 4 frames
      within 1 LSB of the plain route (the count of values beyond 1 LSB
      printed), a timed pass, K1 vs plain ms on one chunk beside its bound;
   b. each of the 25 ops the op table gained alone (wipe in each
      direction), reading the source's tracks, through K1 at 1920x1080, 8
      frames, against `plain_sweep`: max |diff| and the values beyond
      1 LSB;
   c. each of them in PALLAS_SAFE through K4 (4 frames), and K4 over 10
      u8 tracks at 1080p with a chain of 9 drawn from them;
   d. each of them through K5 after alien_overlay (4 frames, the state
      within 1e-5), and K5 on config C with dissolve and hue_rotate in its
      tail over two chunks;
   e. V in bands of 270 and 135 rows (odd first rows) bit for bit the
      whole frame's rows, and `spatial_sweep_fn` over V's chunks: 4 band
      launches a chunk, frames bit for bit `render_events`'.
16. the realtime player (`lives_tpu_torch.player`) on two 1080p30
   YUV4MPEG clips of 48 frames (C420jpeg, clamped BT.601, written with
   phase 11's `write_clips`), keys 0-2 gaussian_blur r=3, colour_balance,
   vignette, key 3 the autotransition's crossfade, precache 8, pipeline
   2, display fetches in groups of 4, into a `Y4MSink` (YUV420P), recording
   on, under the default prefs. Pass A, 240 cycles on a scripted clock
   (the player module's `time` a `ScriptedClock`, advanced 1/30 s a
   cycle; a chain change builds its graph in the cycle and a precache miss
   decodes inline, so what is shown is the script's alone): a key toggles
   every 25 frames, the fg switches with a
   1 s autotransition, 30 cycles at -30 fps, 30 in nervous mode from a
   seeded generator (`player_script`); run with K2 and K3 swapped for
   their plain versions, then with the kernels (timed: process_one p50,
   p99, max; frames shown and dropped; inline decodes), then profiled, the
   device's activity only (K2 and K3 launches and device-to-host copies a
   frame, the device's busy share, the profiler's own start and stop);
   K2 and K3 launches equal the design (each run of a graph, a
   served frame or a warm-up, converts each decoded track once and its
   output once), none in the plain run, and the three Y4M files are
   byte-identical. The kernels pass's take through
   `render_last_recording` on the card: frames, launches, frames/s, and
   max |diff| (Y, U, V) against the frames the sink received, at most
   `PLAYER_RERENDER_BOUND` + 1. Pass B: the same performance on the wall
   clock, `play_n_cycles(1, realtime=True)` a cycle, under the realtime
   policies (chain changes warmed off-thread and on one toggle away,
   drops on a precache miss): frames shown and dropped, the miss drops by
   the performance's mode with the worker's backlog and lead
   compensation at each, K2 and K3 launches equal the design. Then `python -m lives_tpu_torch.cli play <clip> --fx
   gaussian_blur --seconds 3` in a subprocess exits 0.
17. the VJ filters (ROADMAP items 14-15) at 1920x1080:
   a. each new filter (`VJ_STATELESS` at B = 2, `VJ_STATEFUL` over 8
      frames threading each side's own state) on the card against the same
      call on the CPU, on the same seeded frames and per-frame values:
      max |diff| <= 1 LSB, 0 for `VJ_EXACT`; noise's frames 0, 1 and
      100,000, threefry's words over 2^21 counts and its Random123 known
      answer, and spread's sin twin on its 1080p arguments, bit for bit;
      each filter's ms a 1080p frame by CUDA events after a warm-up (noise
      also at 3840x2160);
   b. the stateful timeline `CONFIGS["VJ"]` (10 tracks, 9 transitions,
      vertigo, blurzoom, nervous, feedback, saturation, vignette) through
      `render_events`, 192 frames in 96-frame chunks: one K1 comp-out and
      one comp-in launch a chunk, every frame within 1 LSB of the plain
      route (`Materialised`, the state carried across both chunks), then a
      timed pass (frames/s);
   c. phase 16's clips on the player with the reference-format keymap
      `VJ_KEYMAP` (13 lines, every one mapped) and `vj_script` on the
      scripted clock, with K2 and K3 swapped for their plain versions,
      then with the kernels: the two Y4M files byte-identical, K2 and K3
      launches as designed, process_one p50, p99 and max; the take's
      re-render within `PLAYER_RERENDER_BOUND` + 1.
18. text and titles at 1920x1080:
   a. each filter of `TITLES_FILTERS` (extra.py's 15 and puretext) on the
      card against the same call on the CPU at B = 2 (haip and randomiser
      at frames 0, 1 and 100,000): every pixel within 1 LSB; bit for bit
      the analysers' out-values, haip's trails, textfun's glyph indices
      and puretext's letters (all seven modes over 2,001 (tc, speed)
      pairs); each filter's ms a 1080p frame by CUDA events;
   b. the titled edit (`titled_timeline`: five 1080p30 YUV4MPEG clips it
      writes, `TITLED_CHAIN`) through `render_to_encoder` under
      LIVES_TPU_PALLAS_COMPOSITE=1, 192 frames in 96-frame chunks: K2
      five launches a chunk, K4 one, K3 one; the file within 1 LSB of the
      same render with K2, K4 and K3 swapped for their plain versions;
      frames/s;
   c. phase 16's clips on the player with `TITLES_KEYMAP` (the puretext,
      textfun, scribbler and videowall fragments; each line asserted to
      map as the JAX KeyMap maps it) and `titles_script` on the scripted
      clock (livetext, scribbler and videowall toggled every 25 cycles,
      recording on), plain versions then kernels: the Y4M files
      byte-identical, K2 and K3 launches as designed, process_one p50,
      p99 and max, the take's re-render within `PLAYER_RERENDER_BOUND` +
      1; then 60 cycles with `SUB_SRT` loaded through `load_subtitles`
      into an RGB file sink, not recorded: the two files byte-identical,
      each subtitle frame changed only in the rows its mask covers.
19. the MJPEG lanes at 1920x1080 (`jpegcoef` built with g++ first):
   a. four frames of config D's source: `JpegDeviceEncoder`'s
      coefficients on the card against the CPU's (max |diff| <= 1 on under
      `COEF_FLIP_SHARE` of them), the v2 and v3 wires packed on the card
      from the CPU's coefficients byte for byte the CPU's (bytes a frame
      against raw RGB and YUV420), the decoder's planes on the card within
      1 LSB of the CPU's and of `decode_frame_ref`; the lane's block
      products within 2^-23 of float64 with the process's TF32 switch on,
      and the lane's coefficients and planes unchanged by it (a float32
      product under TF32 printed beside them);
   b. config D's 10 clips written as MJPEG AVIs by the "mjpeg" encoder
      (24 frames, q90; encode frames/s, bytes a frame), phase 11's
      192-frame timeline from them through `MJPEGMultiClipSource` under
      LIVES_TPU_PALLAS_COMPOSITE=1 into `render_to_encoder`'s default
      encoder, twice: K2 10 and K4 1 launch a chunk, no host decode,
      capacity fallback or encoder pool overflow, the files
      byte-identical; a third pass split by
      stage with a synchronise around each (host entropy decode and pack,
      HtoD bytes, device decode, chain, device encode, DtoH bytes, host
      entropy encode), its file identical too, each written frame decoded
      back through the ingest lane at PSNR >= `MJPEG_PSNR_DB` against the
      frame the encoder was handed; a pass profiled (device busy and idle
      share, the trace's float64 GEMMs, and the block products timed by
      CUDA events around each call, decoder and encoder apart); the first
      chunk's source batches through the lane against
      the host lane (`AVIDecoder.get_frame`: PIL decode, upload), in turns;
   c. phase 16's player script on two of the AVIs, pass A on the scripted
      clock into a Y4M sink, plain versions, kernels, profiled: every
      decode through `get_frames_device` (counted; no host decode, no lane
      error), K2 and K3 as designed, the three files byte-identical,
      process_one p50, p99 and max, the device's busy share.
20. data connections (`effects/data.py`, cconx through `FrameGraph`, the
   renderer and the player) at 1920x1080:
   a. each of the slice's 25 filters (`DATA_FILTERS`: alpha.py's 6,
      analysers.py's 9, dataplugins.py's 7, depth_key, image_stabilizer,
      neural_net) on the card against the same call on the CPU, on the
      same seeded frames, per-frame values and alpha planes (B = 2; a
      stateful filter two frames, each side carrying its own state):
      frames and A8 channels within 1 LSB, float out-values, AFLOAT
      channels and float state within `DATA_REL` of the larger magnitude,
      the rest bit for bit (`DATA_EXACT`); each filter's ms a 1080p frame
      by CUDA events;
   b. `wired_timeline` (phase 11's clips 1 and 2, `WIRED_CHAIN` with its
      `cconx` props: fg_bg_removal's mask into alpha_means, motion_mask's
      into mask_overlay, farneback's flow into vector_visualiser, then
      image_stabilizer) through `render_to_encoder(..., "yuv4mpeg")`, 192
      frames in 96-frame chunks, twice: K2 two launches a chunk, K3 one,
      K1, K4 and K5 none; its first 4 frames against the same render on
      the CPU port within 1 LSB outside the pixels whose
      vector_visualiser gate flips (counted); frames/s and the
      `get_batch` split;
   c. phase 16's clips on the player with `DATA_KEYS` (motion_mask's mask
      into mask_overlay by cconx, alpha_means' mean_r into vignette's
      amount by pconx with autoscale), the connections saved to
      datacons.map and loaded back, `data_script` (reverse and nervous
      spans, no toggle or switch) on the scripted clock,
      recorded: plain versions, kernels twice, kernels profiled, the four
      Y4M files byte-identical, K2 and K3 launches as designed,
      process_one p50, p99 and max, the device's busy share and its
      device-to-host copies a cycle; the take's re-render (its wired
      init rebuilt from the recorded `cconx` props) within
      `PLAYER_RERENDER_BOUND`.
21. the clip editor at 1920x1080, 30 fps, on two 96-frame YUV4MPEG clips
   (phase 11's `write_clips`) and a seeded 48 kHz stereo WAV ripped into
   them through `WavDecoder`; every step on the card is held against the
   same call with `device="cpu"` on a second opening of the clip, and its
   K2, K3 and K4 launches are counted from 0 just before it:
   a. `apply_rendered_effect` saturation over the 96 frames with a
      per-frame ramp: K2 one launch a batch of 32, the PNGs of its first
      batch within 1 LSB of the CPU's (the same call over those frames)
      and byte-identical where the pixels are equal,
      `undo_rendered_effect` restoring the tree byte for byte; then the
      scripts `EDIT_SCRIPTS` over 12 frames (sepia, swirl, posterize,
      transition_bwthresh with clip 2, jumble with a seed): within 1 LSB,
      0 values more than 1 LSB apart, jumble's frame order the seed's;
   b. `copy_frames` 24 frames of clip 2 (one K2 launch), `paste_insert`
      into clip 1, `merge_clipboard` crossfade over 48 frames under
      LIVES_TPU_PALLAS_COMPOSITE=1 and without it, each against the CPU:
      K4 launches what the route gives (`FrameGraph._composite_len`: 0,
      a one-instance chain is below its three), then `undo_edit` twice,
      the trees byte for byte before and after the merge;
      `resample_clip_fps` 30 -> 25 and `reverse_clip`; fade_in,
      normalize, insert_silence and append_audio sample-exact;
   c. `transcode` into YUV4MPEG through gaussian_blur and vignette with
      the clip's audio: K2 and K3 one launch a batch, the first 16 frames
      within 1 LSB of the CPU's transcode, the WAV beside it byte for
      byte; the pngseq and pdf encoders over 8 frames; `python -m
      lives_tpu_torch.cli rfx sepia <clipdir>` in a subprocess;
   d. the player: 30 cycles of a decoded clip through vignette into a
      `PNGSink` on a scripted clock; a take of the stateful beat_rings
      generator at 1080p with scrap capture (`scrap_take`): every FRAME
      event references the scrap clip, its re-render at least
      `SCRAP_PSNR_DB` from the frames the sink showed;
   frames/s, PIL's share of each step's wall, and the launches, each line
   with the card's name and power limit.
Then a `resources` line for K1 (both builds), K4, K5 and K6 (the path's
entry: ptxas registers and spills, blocks an SM), a JSON line of the kernels
(with each one's bound: the larger of its bytes over 3.35 TB/s and its
float operations over 67 TFLOP/s, the H100 SXM's device memory and
float32 rates; K6's at K = 128, with its largest relative error besides)
and, last, the JSON result line.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, FPS, TRACKS, CHUNK, N_FRAMES = 1920, 1080, 30.0, 10, 96, 192

TRANSITIONS = ["crossfade", "blend_screen", "blend_overlay", "blend_add",
               "blend_multiply", "blend_lighten", "blend_difference",
               "blend_darken", "crossfade"]
RGB_DELAY = ("rgb_delay", {"delay_r": 0.0, "delay_g": 1.0, "delay_b": 2.0})


def led_chain(second):
    """fire + `second` | 9 transitions | saturation + vignette."""
    return ([("fire", {"threshold": 0.6}, [0]), (*second, [0])]
            + [(TRANSITIONS[t - 1], {"amount": 0.5}, [0, t])
               for t in range(1, 10)]
            + [("saturation", {"saturation": 1.2}, [0]),
               ("vignette", {"amount": 0.5}, [0])])


#: name -> (tracks, [(filter, values, in_tracks)])
CONFIGS = {
    "A": (10, led_chain(RGB_DELAY)),
    "B": (4, [("crossfade", {"amount": 0.6}, [0, 1]),
              ("vignette", {"amount": 0.5}, [0]), (*RGB_DELAY, [0]),
              ("fire", {"threshold": 0.6}, [0]),
              ("saturation", {"saturation": 1.2}, [0])]),
    "C": (10, led_chain(("alien_overlay", {}))),
    "life_blur": (1, [("life", {"threshold": 0.15, "amount": 0.5}, [0]),
                      ("gaussian_blur", {"radius": 2}, [0])]),
    "blur_fire": (1, [("gaussian_blur", {"radius": 2}, [0]),
                      ("fire", {"threshold": 0.5}, [0]),
                      ("saturation", {"saturation": 1.2}, [0])]),
    # config C with two ops of the grown vocabulary added to its tail
    "C_vocab": (10, led_chain(("alien_overlay", {}))
                + [("dissolve", {"amount": 0.4}, [0, 3]),
                   ("hue_rotate", {"angle": 0.2}, [0])]),
    # the largest summed halo the stateful sweep takes: 16 + 1 + 16 = 33
    "r33": (2, [("crossfade", {"amount": 0.4}, [0, 1]),
                ("gaussian_blur", {"radius": 16}, [0]),
                ("fire", {"threshold": 0.5}, [0]),
                ("box_blur", {"radius": 16}, [0]),
                ("saturation", {"saturation": 1.2}, [0])]),
    # phase 17b: the main path's 9 transitions (K1 comp-out), four
    # EffecTV filters in the frame loop, two point ops (K1 comp-in)
    "VJ": (10, [(TRANSITIONS[t - 1], {"amount": 0.5}, [0, t])
                for t in range(1, 10)]
           + [("vertigo", {"feedback": 0.7, "speed": 0.6, "zoom": 0.5}, [0]),
              ("blurzoom", {"decay": 0.5, "amount": 0.8}, [0]),
              ("nervous", {}, [0]),
              ("feedback", {"feedback": 0.6, "zoom": 0.4}, [0]),
              ("saturation", {"saturation": 1.2}, [0]),
              ("vignette", {"amount": 0.5}, [0])]),
}


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def diff_stats(a, b):
    """(max |a-b|, share of differing values) of two tensors."""
    d = (a.double() - b.double()).abs()
    return d.max().item(), float((d > 0).float().mean().item())


def timeline(name, n_frames, width=W, height=H):
    """A CONFIGS chain as recorded init events (as lives_tpu/scenes.py:
    105-142 records one): track t plays clip t+1, frame i at frame i."""
    from lives_tpu_torch.events.event_list import (EventList,
                                                   TICKS_PER_SECOND,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event)
    n_tracks, specs = CONFIGS[name]
    el = EventList(fps=FPS, width=width, height=height)
    inits = [filter_init_event(0, f, in_tracks=tr, out_tracks=[0],
                               values=v) for f, v, tr in specs]
    for e in inits:
        el.insert(e)
    el.insert(filter_map_event(0, [e.event_id for e in inits]))
    tpf = int(TICKS_PER_SECOND / FPS)
    for i in range(n_frames):
        el.insert(frame_event(i * tpf, list(range(1, n_tracks + 1)),
                              [i] * n_tracks))
    return el


def config_d_timeline(n_frames):
    """Config D's timeline: the main path's 13-effect chain over 10 tracks
    (`scenes.multitrack_timeline`), track t playing clip t+1 at frame
    i % CLIP_FRAMES."""
    from lives_tpu_torch.scenes import multitrack_timeline
    el = multitrack_timeline(n_tracks=TRACKS, n_frames=n_frames, width=W,
                             height=H, fps=FPS)
    for e in el.frame_events():
        e.props["frames"] = [f % CLIP_FRAMES for f in e.frames]
    return el


def _chain(el):
    """The instances of the timeline's first segment."""
    from lives_tpu_torch.events.renderer import _chain_for, segment_events
    seg = segment_events(el)[0]
    return _chain_for(seg.inits, el, seg.frames[0].tc)[1]


def chunk_of(el, device, n: int, k: int = 0):
    """Frames [k*n, (k+1)*n) of the timeline's first segment, as the
    renderer hands them to FrameGraph.run_batch: (chain spec, src ids,
    packed, rows_key) on the device."""
    import numpy as np
    import torch

    from lives_tpu_torch.events.event_list import TICKS_PER_SECOND
    from lives_tpu_torch.events.renderer import (_chain_for, _interp_arrays,
                                                 segment_events)
    from lives_tpu_torch.graph.nodemodel import chain_spec_of, pack_params
    seg = segment_events(el)[0]
    inits, chain = _chain_for(seg.inits, el, seg.frames[0].tc)
    frames = seg.frames[k * n:(k + 1) * n]
    tcs = [f.tc for f in frames]
    packed, rows = pack_params(
        _interp_arrays(el, inits, chain, tcs),
        np.asarray(tcs, np.float64) / TICKS_PER_SECOND,
        [round(tc * el.fps / TICKS_PER_SECOND) for tc in tcs])
    ids = np.stack([np.array([f.clips for f in frames]).T,
                    np.array([f.frames for f in frames]).T]).astype(np.int32)
    return (chain_spec_of(chain), torch.from_numpy(ids).to(device),
            torch.from_numpy(packed).to(device), rows)


def sweep_plan(el, spec, rows, device, n_tracks, **mode):
    """The fused sweep's plan for `spec` on the timeline's geometry."""
    from lives_tpu_torch.graph import SinkSpec, fused_sweep
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    plan = fused_sweep.build_fused_sweep(
        spec, n_tracks, el.height, el.width, rows, el.fps,
        DeviceSyntheticSource(el.height, el.width, device=device),
        SinkSpec(el.width, el.height), device, **mode)
    assert plan is not None, "the chain must qualify for the kernel"
    return plan


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kern, plain_reps=2, kern_reps=5):
    """(kernel ms, plain ms, text) timed in turns plain, kernel, kernel,
    plain."""
    p1, k1, k2, p2 = (time_ms(plain, plain_reps), time_ms(kern, kern_reps),
                      time_ms(kern, kern_reps), time_ms(plain, plain_reps))
    return ((k1 + k2) / 2, (p1 + p2) / 2,
            f"kernel={k1:.3f},{k2:.3f} plain={p1:.3f},{p2:.3f}")


#: a launch count (MODE_LAUNCHES entry, or the stateful sweep's) -> kernel
KERNEL_OF = {"u8": "fused_sweep", "comp_out": "fused_sweep_comp_out",
             "comp_in": "fused_sweep_comp_in", "stateful": "stateful_sweep",
             "band": "fused_sweep_band"}

#: each kernel of the kernels line: its source and the TPU kernel it
#: replaces
SOURCES = {
    "fused_sweep": ("lives_tpu_torch/csrc/fused_sweep.cu",
                    "lives_tpu/graph/pallas_composite.py:240"),
    "fused_sweep_comp_out": ("lives_tpu_torch/csrc/fused_sweep.cu",
                             "lives_tpu/graph/pallas_composite.py:240"),
    "fused_sweep_comp_in": ("lives_tpu_torch/csrc/fused_sweep.cu",
                            "lives_tpu/graph/pallas_composite.py:240"),
    "stateful_sweep": ("lives_tpu_torch/csrc/stateful_sweep.cu",
                       "lives_tpu/graph/pallas_stateful.py:94"),
    "yuv420_to_rgb": ("lives_tpu_torch/csrc/yuv420.cu",
                      "lives_tpu/ops/pallas_kernels.py:114"),
    "rgb_to_yuv420": ("lives_tpu_torch/csrc/yuv420.cu",
                      "lives_tpu/ops/pallas_kernels.py:185"),
    "composite": ("lives_tpu_torch/csrc/composite.cu",
                  "lives_tpu/graph/pallas_composite.py:120"),
    "fused_sweep_band": ("lives_tpu_torch/csrc/fused_sweep.cu",
                         "lives_tpu/graph/pallas_composite.py:240"),
    "fma_chain": ("lives_tpu_torch/csrc/fma_chain.cu",
                  "benchmarks/sweep_profile.py:146"),
    # K1's exact build (the whole vocabulary) on timeline V, phase 15
    "fused_sweep_vocabulary": ("lives_tpu_torch/csrc/fused_sweep.cu",
                               "lives_tpu/graph/pallas_composite.py:240"),
}
NAMES = tuple(SOURCES)
#: config D's clips: 24 frames each, played at frame i % 24
CLIP_FRAMES = 24

#: the H100 SXM's device memory and float32 (non-tensor-core) rates
#: (NVIDIA's data sheet), for each kernel's bound
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12
#: float operations a pixel of each opcode (graph/fused_sweep.py), counted
#: from csrc/sweep_common.cuh and csrc/stateful_sweep.cu: a multiply, add,
#: min, max, divide, sqrt, exp, pow, cos, floor or compare counts one; the
#: synthetic source's integer formulas and the pixel hash are not counted.
#: A blend adds its mode's cost a channel (_BLEND_MODES order), an iris its
#: shape's (circle, rectangle), a stencil of radius r two passes of 2r+1
#: taps.
BLEND_COST = (1, 1, 1, 4, 1, 1, 2, 4, 5, 5, 3, 4, 2, 2)


def _op_flops():
    from lives_tpu_torch.graph import fused_sweep as fs
    return {fs.OP_CROSSFADE: lambda a: 16,
            fs.OP_BLEND: lambda a: 16 + 3 * BLEND_COST[a],
            fs.OP_LUMA_KEY: lambda a: 25, fs.OP_CHROMA_KEY: lambda a: 31,
            fs.OP_ALPHA_OVER: lambda a: 12, fs.OP_MASK_OVERLAY: lambda a: 15,
            fs.OP_LUMA_SELECT: lambda a: 12, fs.OP_WIPE: lambda a: 3,
            fs.OP_IRIS: lambda a: (24, 21)[a], fs.OP_DISSOLVE: lambda a: 2,
            fs.OP_COLOUR_BALANCE: lambda a: 9,
            fs.OP_SATURATION: lambda a: 20, fs.OP_VIGNETTE: lambda a: 23,
            fs.OP_NEGATE: lambda a: 9, fs.OP_BRIGHTNESS_CONTRAST: lambda a: 18,
            fs.OP_GAMMA_ADJUST: lambda a: 12, fs.OP_LEVELS: lambda a: 21,
            fs.OP_GREYSCALE: lambda a: 11, fs.OP_SEPIA: lambda a: 30,
            fs.OP_POSTERIZE: lambda a: 18, fs.OP_SOLARIZE: lambda a: 12,
            fs.OP_THRESHOLD: lambda a: 12, fs.OP_SOFTLIGHT: lambda a: 30,
            fs.OP_TINT: lambda a: 23, fs.OP_HUE_ROTATE: lambda a: 21,
            fs.OP_MODULATE: lambda a: 59, fs.OP_COLOUR_REPLACE: lambda a: 17,
            fs.OP_STENCIL: lambda r: 12 * (2 * r + 1) + 15,
            fs.OP_FIRE: lambda a: 43, fs.OP_LIFE: lambda a: 30,
            fs.OP_ALIEN: lambda a: 24}


def table_flops(ops, u8_stages=False) -> int:
    """Float operations a pixel of an op table: each op, 3 to bring in each
    track it reads besides track 0 and 3 for track 0, and with `u8_stages`
    (the composite kernel) a quantise (15) and a re-read (3) after each
    op."""
    from lives_tpu_torch.graph.fused_sweep import OP_LAST_TWO_IN
    flops = _op_flops()
    n = 3
    for code, in0, in1, arg, *_ in ops.cpu().tolist():
        n += flops[code](arg) + 3 * (in0 != 0)
        n += 3 * (code <= OP_LAST_TWO_IN and in1 not in (0, in0))
        n += 18 * u8_stages
    return n


def ptxas_entries(log):
    """{kernel entry (mangled, namespace dropped): {registers, spill_stores,
    spill_loads}} from `nvcc -Xptxas -v` output."""
    import re
    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", ln)
        if m:
            entry = m.group(1).replace("_ZN12_GLOBAL__N_1", "")
            out.setdefault(entry, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and entry:
            out[entry].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


def bound(nbytes, flops):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take for `nbytes` of device memory traffic and `flops` float32
    operations."""
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / F32_OPS_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def device_busy(prof):
    """(device ms, the 8 largest by name as text) of a torch.profiler
    trace."""
    import torch
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (sum(by_name.values()),
            repr("; ".join(f"{n[:48]} {t:.1f}" for n, t in top)))


def dtoh_copies(prof) -> int:
    """Device -> host copies in a torch.profiler trace."""
    import torch
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name.startswith("Memcpy DtoH"))


def main_geometry(plan, ids, packed, card):
    """K1 on the main chain's chunk at the geometry its launch chooses, then
    at every tile of `fused_sweep.TILES`: ms each."""
    from lives_tpu_torch.graph import fused_sweep
    B = ids.shape[2]
    chosen = fused_sweep.plan_geometry(plan, B)
    line("5 geometry", tile=f"{chosen.tile_h}x{chosen.tile_w}",
         run=chosen.run, margin=chosen.margin, grid=chosen.grid,
         smem=chosen.smem, blocks_per_sm=fused_sweep.blocks_per_sm(chosen),
         phase1_cells_per_px=f"{fused_sweep.phase1_cells(chosen, plan.halo) / (B * plan.height * plan.width):.3f}")
    for tile in fused_sweep.TILES:
        geom = fused_sweep.plan_geometry(plan, B, tile)
        got = [time_ms(lambda: fused_sweep._launch(plan, ids, packed,
                                                   None, 0, geom), 3)
               for _ in range(2)]
        line("5 geometry_ms", card=repr(card), tile=f"{tile[0]}x{tile[1]}",
             run=geom.run, blocks_per_sm=fused_sweep.blocks_per_sm(geom),
             ms=",".join(f"{x:.3f}" for x in got))


def blur_geometry(el, ids, card):
    """K1 on crossfade alone (r = 0) and with one gaussian blur of radius
    1, 3, 8 and 16 (a cheap phase 1, the stencil's cost growing with r):
    ms at the geometry its launch chooses (runs of 8, of 4 from r = 8 on)
    and at every tile."""
    import torch

    from lives_tpu_torch.effects.host import instantiate
    from lives_tpu_torch.graph import fused_sweep
    from lives_tpu_torch.graph.nodemodel import chain_spec_of
    B = ids.shape[2]
    packed = torch.zeros((2, B), device=ids.device)
    for r in (0, 1, 3, 8, 16):
        fade = instantiate("crossfade", amount=0.5)
        fade.in_tracks = (0, 1)
        chain = [fade, instantiate("gaussian_blur", radius=r, amount=0.6)]
        plan = sweep_plan(el, chain_spec_of(chain[:1 + (r > 0)]), (),
                          ids.device, ids.shape[1])
        chosen = fused_sweep.plan_geometry(plan, B)
        ms = {}
        for tile in (None, *fused_sweep.TILES):
            try:
                geom = fused_sweep.plan_geometry(plan, B, tile)
            except ValueError:  # over a block's shared memory
                continue
            key = "chosen" if tile is None else f"{tile[0]}x{tile[1]}"
            ms[key] = time_ms(lambda: fused_sweep._launch(
                plan, ids, packed, None, 0, geom), 3)
        line("5 blur_ms", card=repr(card), radius=r,
             tile=f"{chosen.tile_h}x{chosen.tile_w}", run=chosen.run,
             blocks_per_sm=fused_sweep.blocks_per_sm(chosen),
             ms=" ".join(f"{k}:{v:.3f}" for k, v in ms.items()))


class Materialised:
    """A source without its LOAD step: run_batch gets layers and takes the
    plain route."""

    def __init__(self, src):
        self.get_batch = src.get_batch


def render_path(el, src, sink, check=True):
    """One pass of `render_events` over `el`, every launch count set to 0
    just before it and read just after: (frames, first 4 frames, the
    non-zero counts by KERNEL_OF key, wall s)."""
    import torch

    from lives_tpu_torch.events.renderer import render_events
    from lives_tpu_torch.graph import fused_sweep, stateful_sweep
    fused_sweep.MODE_LAUNCHES.update(
        dict.fromkeys(fused_sweep.MODE_LAUNCHES, 0))
    stateful_sweep.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rendered, head = 0, None
    for tcs, lay in render_events(el, src, sink, batch_size=CHUNK):
        if check:
            arr = lay.planes[0]
            assert arr.dtype == torch.uint8 and arr.device.type == "cuda"
            assert tuple(arr.shape) == (len(tcs), 3, el.height, el.width)
            if head is None:
                head = arr[:4].clone()
        rendered += len(tcs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**fused_sweep.MODE_LAUNCHES, "stateful": stateful_sweep.LAUNCHES}
    return rendered, head, {k: v for k, v in counts.items() if v}, wall


def phase12(dev, card0, card, el, src, sink, held, ms, bounds, launches):
    """12. the multi-device layer on one card: a 4-entry mesh on `card0`
    (cuda:0)."""
    import numpy as np
    import torch

    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.effects.host import FrameContext, instantiate
    from lives_tpu_torch.layer import Layer
    from lives_tpu_torch.graph import FrameGraph, fused_sweep, stateful_sweep
    from lives_tpu_torch.parallel import (dryrun_multichip, frame_mesh,
                                          pipeline_chain_fn,
                                          sharded_batch_fn, spatial_batch_fn,
                                          spatial_stateful_fn,
                                          spatial_sweep_fn)
    from lives_tpu_torch.scenes import multitrack_timeline

    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"  # the float route
    mesh4 = frame_mesh([card0] * 4)
    n_chunks = -(-N_FRAMES // CHUNK)

    # 12a. the band kernel vs the whole-frame kernel and plain_band_sweep
    for w, h, tracks, bands in ((W, H, TRACKS, (270, 540, 1080)),
                                (1000, 562, 3, (281,))):
        tel = multitrack_timeline(n_tracks=tracks, n_frames=8, width=w,
                                  height=h, fps=FPS)
        spec, ids, packed, rows = chunk_of(tel, dev, 4)
        whole = fused_sweep.fused_sweep(
            sweep_plan(tel, spec, rows, dev, tracks), ids, packed)
        for band_h in bands:
            plan = sweep_plan(tel, spec, rows, card0, tracks, band_h=band_h)
            for y0 in range(0, h, band_h):
                got = fused_sweep.fused_sweep(plan, ids, packed, y0=y0)
                torch.cuda.synchronize()
                same = torch.equal(got, whole[:, :, y0:y0 + band_h])
                line("12a band_vs_whole", size=f"{w}x{h}", band_h=band_h,
                     y0=y0, bit_identical=same)
                assert same, ("band", w, h, band_h, y0)
                held("fused_sweep_band", "12a band_vs_plain", got,
                     fused_sweep.plain_band_sweep(plan, ids, packed, y0), 1,
                     size=f"{w}x{h}", band_h=band_h, y0=y0, frames=4)
        del whole

    # 12b. the band sweep over the main path's timeline
    graph = FrameGraph(_chain(el), sink, fps=FPS)
    sweep = spatial_sweep_fn(graph, frame_mesh([card0] * 4, axis="s"), src,
                             CHUNK, H, W, axis="s")
    assert sweep is not None, "the main path must qualify for the band sweep"
    main = [lay.planes[0].clone() for _, lay in
            render_events_of(el, src, sink)]

    def band_pass():
        """The timeline's chunks as the renderer builds them, each through
        the band sweep."""
        return [sweep(ids, packed) for _, ids, packed, _ in
                (chunk_of(el, dev, CHUNK, k) for k in range(n_chunks))]

    fused_sweep.MODE_LAUNCHES.update(dict.fromkeys(fused_sweep.MODE_LAUNCHES,
                                                   0))
    stateful_sweep.LAUNCHES = 0
    outs = band_pass()
    torch.cuda.synchronize()
    counts = {k: v for k, v in fused_sweep.MODE_LAUNCHES.items() if v}
    counts.update({"stateful": stateful_sweep.LAUNCHES} if
                  stateful_sweep.LAUNCHES else {})
    line("12b band_sweep", frames=sum(o.shape[0] for o in outs),
         chunks=n_chunks, launches=counts)
    assert counts == {"band": 4 * n_chunks}, counts
    launches["fused_sweep_band"] = counts["band"]
    for k, (o, m) in enumerate(zip(outs, main)):
        same = torch.equal(o, m)
        line("12b band_sweep_vs_main_path", chunk=k, bit_identical=same)
        assert same, ("band sweep vs main path", k)
    del outs, main
    walls = {"main": [], "band": []}
    for kind in ("main", "band", "band", "main"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "main":
            for _ in render_events_of(el, src, sink):
                pass
        else:
            band_pass()
        torch.cuda.synchronize()
        walls[kind].append(time.perf_counter() - t0)
    rate = {k: N_FRAMES / (sum(v) / len(v)) for k, v in walls.items()}
    line("12b timed", card=repr(card), frames=N_FRAMES,
         band_wall_s=",".join(f"{x:.4f}" for x in walls["band"]),
         main_wall_s=",".join(f"{x:.4f}" for x in walls["main"]),
         band_frames_per_s=f"{rate['band']:.1f}",
         main_frames_per_s=f"{rate['main']:.1f}",
         band_over_main=f"{rate['band'] / rate['main']:.3f}")
    spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
    whole_plan = sweep_plan(el, spec, rows, dev, TRACKS)
    band_h = H // 4
    band_plan = sweep_plan(el, spec, rows, card0, TRACKS, band_h=band_h)

    def four_bands():
        for i in range(4):
            fused_sweep._launch(band_plan, ids, packed, None, i * band_h)

    def four_plain():
        for i in range(4):
            fused_sweep.plain_band_sweep(band_plan, ids, packed, i * band_h)
    k1 = [time_ms(lambda: fused_sweep._launch(whole_plan, ids, packed,
                                               None), 5)]
    four = [time_ms(four_bands, 5), time_ms(four_bands, 5)]
    k1.append(time_ms(lambda: fused_sweep._launch(whole_plan, ids, packed,
                                                   None), 5))
    one = time_ms(lambda: fused_sweep._launch(band_plan, ids, packed, None,
                                              band_h), 5)
    plain = [time_ms(four_plain, 1), time_ms(four_plain, 1)]
    ms["fused_sweep_band"] = (sum(four) / 2, sum(plain) / 2, "")
    px = CHUNK * H * W
    # the 4 bands write the chunk's frames once: K1's bytes and operations
    bounds["fused_sweep_band"] = bound(
        px * 3, px * (table_flops(band_plan.ops) + 15))
    line("12b chunk_ms", card=repr(card), frames=CHUNK,
         four_bands=",".join(f"{x:.3f}" for x in four),
         whole_frame_k1=",".join(f"{x:.3f}" for x in k1),
         one_band=f"{one:.3f}",
         plain_four_bands=",".join(f"{x:.3f}" for x in plain),
         bound_ms=f"{bounds['fused_sweep_band'][0]:.4f}")

    # 12c. DP and SP over decoded-style layers
    B8 = 8
    tcs, frames = np.arange(B8) / FPS, np.arange(B8)
    layers = [src.get_batch([t + 1] * B8, range(B8)) for t in range(TRACKS)]
    ref = graph.run_batch(layers, tcs, frames).planes[0]
    dp = sharded_batch_fn(graph, mesh4)(layers, tcs, frames).planes[0]
    worst, share = diff_stats(dp, ref)
    line("12c dp_vs_run_batch", frames=B8, max_abs_err=f"{worst:.6g}",
         differing_share=f"{share:.3g}")
    assert worst == 0, ("DP", worst)
    sp = spatial_batch_fn(graph, mesh4)(layers, tcs, frames).planes[0]
    worst, share = diff_stats(sp, ref)
    line("12c sp_vs_run_batch", frames=B8, max_abs_err=f"{worst:.6g}",
         differing_share=f"{share:.3g}")
    assert worst <= 1, ("SP", worst)
    del layers, ref, dp, sp

    # 12d. stateful bands on config A's chain, two calls of 8 frames
    def config_a():
        chain = []
        for name, vals, tr in CONFIGS["A"][1]:
            inst = instantiate(name, **vals)
            inst.in_tracks = tuple(tr)
            chain.append(inst)
        return FrameGraph(chain, sink, fps=FPS)
    g_band, g_ref = config_a(), config_a()
    run = spatial_stateful_fn(g_band, mesh4)
    for k in range(2):
        fr = range(k * B8, (k + 1) * B8)
        layers = [src.get_batch([t + 1] * B8, fr) for t in range(TRACKS)]
        tcs, frames = np.asarray(fr) / FPS, np.asarray(fr)
        got = run(layers, tcs, frames).planes[0]
        ref = g_ref.run_batch(layers, tcs, frames).planes[0]
        worst, share = diff_stats(got, ref)
        line("12d stateful_bands_vs_run_batch", call=k, frames=B8,
             max_abs_err=f"{worst:.6g}", differing_share=f"{share:.3g}")
        assert worst <= 1, ("stateful bands", k, worst)
    for i, (a, b) in enumerate(zip(g_band.states, g_ref.states)):
        for key in (sorted(a) if isinstance(a, dict) else [None]):
            x, y = (a[key], b[key]) if key else (a, b)
            if x is None:
                continue
            worst, _ = diff_stats(x, y)
            tol = 1e-5 if x.is_floating_point() else 0
            line("12d state", step=g_band.chain[i].filter.name,
                 leaf=key or "-", dtype=str(x.dtype).split(".")[-1],
                 max_abs_err=f"{worst:.3g}")
            assert worst <= tol, (i, key, worst)
    del layers, got, ref

    # 12e. the pipeline over 4 point filters
    insts = [instantiate("colour_balance", red=1.1, blue=0.9),
             instantiate("saturation", saturation=1.3),
             instantiate("vignette", amount=0.7),
             instantiate("saturation", saturation=0.8)]
    gen = torch.Generator(device=dev).manual_seed(12)
    batch = torch.rand((B8, 3, H, W), generator=gen, device=dev)
    tcs = np.arange(B8, dtype=np.float32) / FPS
    got = pipeline_chain_fn(insts, mesh4)(batch, tcs)
    seq = batch
    for inst in insts:
        seq = inst.filter.process([Layer(planes=(seq,), palette=int(
            Palette.RGBFLOAT))], inst.param_values(), FrameContext(
                tc=0.0, frame=0, fps=25.0, width=W, height=H)).planes[0]
    worst, _ = diff_stats(got, seq)
    line("12e pipeline_vs_sequential", stages=len(insts), frames=B8,
         max_abs_err=f"{worst:.3g}")
    assert worst <= 1e-5, ("pipeline", worst)

    # 12f. the dry run of every path at a small size
    t0 = time.perf_counter()
    dryrun_multichip([card0] * 4)
    line("12f dryrun_multichip", entries=4,
         seconds=f"{time.perf_counter() - t0:.2f}")
    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "1"


def write_clips(tmp, src, n_clips=TRACKS, frames=CLIP_FRAMES):
    """Config D's clips in directory `tmp`: `n_clips` YUV4MPEG clips of
    `frames` synthetic frames of `src` each (clip c is the source's clip c,
    through K3), opened with `open_clip`: ({c: Clip}, bytes, s)."""
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.io.decoders import write_y4m
    from lives_tpu_torch.ops.colorspace import convert_layer
    t0 = time.perf_counter()
    clips, size = {}, 0
    for c in range(1, n_clips + 1):
        yuv = [p.cpu().numpy() for p in convert_layer(
            src.get_batch([c] * frames, range(frames)),
            Palette.YUV420P).planes]
        path = os.path.join(tmp, f"clip{c}.y4m")
        write_y4m(path, [tuple(p[i] for p in yuv)
                         for i in range(frames)], FPS)
        size += os.path.getsize(path)
        clips[c] = open_clip(path, os.path.join(tmp, "work"))
        clips[c].unique_id = c  # the timeline's clip ids
    return clips, size, time.perf_counter() - t0


def decoded_pass(clips, el, out_path, dev):
    """One render of `el` from `clips` into `out_path` through
    `render_to_encoder`, every launch count set to 0 just before it and
    read just after: (non-zero counts, wall s, s in get_batch: the host
    read, upload and K2, on the host clock ended by a synchronise)."""
    import torch

    from lives_tpu_torch.events.renderer import ClipFrameSource
    from lives_tpu_torch.graph import composite, fused_sweep, stateful_sweep
    from lives_tpu_torch.ops import yuv_kernels
    from lives_tpu_torch.transcode import render_to_encoder

    class TimedSource(ClipFrameSource):
        host_s = 0.0

        def get_batch(self, clip_ids, frame_nums):
            t0 = time.perf_counter()
            out = super().get_batch(clip_ids, frame_nums)
            torch.cuda.synchronize()
            self.host_s += time.perf_counter() - t0
            return out

    fused_sweep.MODE_LAUNCHES.update(
        dict.fromkeys(fused_sweep.MODE_LAUNCHES, 0))
    stateful_sweep.LAUNCHES = 0
    yuv_kernels.LAUNCHES.update(dict.fromkeys(yuv_kernels.LAUNCHES, 0))
    composite.LAUNCHES = 0
    tsrc = TimedSource(clips, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert render_to_encoder(el, tsrc, out_path, encoder="yuv4mpeg",
                             batch_size=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**fused_sweep.MODE_LAUNCHES,
              "stateful": stateful_sweep.LAUNCHES,
              **yuv_kernels.LAUNCHES, "composite": composite.LAUNCHES}
    return {k: v for k, v in counts.items() if v}, wall, tsrc.host_s


def config_d_alone(dev, card, passes=3):
    """`--config-d`: config D alone, as phase 11 renders it (its clips,
    timeline and warm timed passes under LIVES_TPU_PALLAS_COMPOSITE=1, a
    profiled pass with its device-to-host copies), then K4 on one
    96-frame chunk against `plain_composite` and its time.
    It calls only entry points that every version of the port with config
    D has, so a copy of this script placed at the root of another checkout
    times that checkout's package."""
    from lives_tpu_torch import native
    from lives_tpu_torch.graph import composite
    from lives_tpu_torch.graph.nodemodel import composite_prefix
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    native.load_all(["yuv420", "composite"])
    src = DeviceSyntheticSource(H, W, device=dev)
    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "1"
    n_chunks = -(-N_FRAMES // CHUNK)
    want = {"yuv420_to_rgb": TRACKS * n_chunks, "composite": n_chunks}
    el = config_d_timeline(N_FRAMES)
    with tempfile.TemporaryDirectory() as tmp:
        clips, size, secs = write_clips(tmp, src)
        line("d clips", clips=TRACKS, frames=CLIP_FRAMES,
             mb=f"{size / 1e6:.1f}", seconds=f"{secs:.2f}")
        out_path = os.path.join(tmp, "render.y4m")
        for k in range(passes + 1):  # the first pass builds and warms
            counts, wall_s, host_s = decoded_pass(clips, el, out_path, dev)
            # K3: once a chunk here, once a frame in a tree before the
            # encoder took chunks
            k3 = counts.pop("rgb_to_yuv420")
            assert counts == want and k3 in (n_chunks, N_FRAMES), (counts, k3)
            line("d timed", card=repr(card), root=ROOT.name, run=k,
                 frames=N_FRAMES, k3_launches=k3, wall_s=f"{wall_s:.4f}",
                 get_batch_s=f"{host_s:.4f}",
                 rest_s=f"{wall_s - host_s:.4f}",
                 frames_per_s=f"{N_FRAMES / wall_s:.1f}")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_wall, _ = decoded_pass(clips, el, out_path, dev)
        busy, _ = device_busy(prof)
        line("d profiled", card=repr(card), root=ROOT.name,
             wall_ms=f"{prof_wall * 1e3:.1f}", device_busy_ms=f"{busy:.1f}",
             idle_share=f"{1 - busy / (prof_wall * 1e3):.3f}",
             dtoh_copies=dtoh_copies(prof))
        for c in clips.values():
            c.close()
    spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
    prefix, n_t = composite_prefix(spec[:9], TRACKS)
    plan = composite.build_composite(prefix, n_t, rows, FPS, dev)
    trk = [src.traced_layer(ids[0, t], ids[1, t]).planes[0]
           for t in range(n_t)]
    worst, _ = diff_stats(composite._launch(plan, trk, packed, CHUNK, H, W),
                          composite.plain_composite(plan, trk, packed))
    assert worst <= 1, worst
    got = [time_ms(lambda: composite._launch(plan, trk, packed, CHUNK, H, W),
                   5) for _ in range(2)]
    line("d k4", card=repr(card), root=ROOT.name, frames=CHUNK,
         max_abs_err=f"{worst:.6g}", ms=",".join(f"{x:.3f}" for x in got))


def colour_chunk(dev):
    """One 96-frame 1080p chunk of the synthetic source's clip 1 on the
    card, as the RGB24 plane and as the YUV420P planes K3 makes of it."""
    from lives_tpu_torch.ops import yuv_kernels
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    rgb = DeviceSyntheticSource(H, W, device=dev).get_batch(
        [1] * CHUNK, range(CHUNK)).planes[0]
    return (rgb, *yuv_kernels.plain_rgb_to_yuv420(rgb))


def colour_calls(rgb, y, u, v):
    """{label: a call} on one chunk: K2 and K3 at each run length of
    `yuv_kernels.RUNS` (a tree without run lengths: its one kernel), and K3
    as CHUNK one-frame launches, as the encoder launched it before it took
    chunks. Only entry points every version of the port has are called, so
    a copy of this script at the root of another checkout times that
    checkout's kernels."""
    from lives_tpu_torch.ops import yuv_kernels as yk
    calls = {}
    for run in getattr(yk, "RUNS", (None,)):
        kw = {} if run is None else {"run": run}
        calls[f"k2 run={run}"] = lambda kw=kw: yk._launch_k2(y, u, v, 1, 0,
                                                             **kw)
        calls[f"k3 run={run}"] = lambda kw=kw: yk._launch_k3(rgb, 1, 0,
                                                             **kw)
    calls[f"k3 x{CHUNK}"] = lambda: [yk._launch_k3(rgb[k], 1, 0)
                                     for k in range(CHUNK)]
    return calls


def copy_ceiling(dev, nbytes):
    """(ms, TB/s) of `Tensor.copy_` between two u8 tensors of nbytes / 2
    bytes: a streaming pass that reads and writes `nbytes` in all."""
    import torch
    a = torch.empty(int(nbytes) // 2, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    t = time_ms(lambda: b.copy_(a), 20)
    return t, 2 * a.numel() / t / 1e9


def colour_alone(dev, card):
    """`--colour`: K2 and K3 on one 96-frame 1080p chunk, every call of
    `colour_calls` timed twice, K2 checked against its plain version, and
    the copy ceiling; a copy of this script at the root of another
    checkout times that checkout's kernels."""
    from lives_tpu_torch import native
    from lives_tpu_torch.ops import yuv_kernels as yk
    native.load_all(["yuv420"])
    rgb, y, u, v = colour_chunk(dev)
    worst, _ = diff_stats(yk._launch_k2(y, u, v, 1, 0),
                          yk.plain_yuv420_to_rgb(y, u, v))
    assert worst <= 1, worst
    for label, fn in colour_calls(rgb, y, u, v).items():
        reps = 2 if label == f"k3 x{CHUNK}" else 20
        got = [time_ms(fn, reps) for _ in range(2)]
        line("c colour", card=repr(card), root=ROOT.name, kernel=label,
             frames=CHUNK, ms=",".join(f"{x:.4f}" for x in got))
    t, rate = copy_ceiling(dev, CHUNK * H * W * 4.5)
    line("c copy_ceiling", card=repr(card), root=ROOT.name, ms=f"{t:.4f}",
         tb_per_s=f"{rate:.3f}")


#: phase 13's chain variants of the roofline study (benchmarks/
#: sweep_profile.py:68-72,102-107): (name, tracks, suffix effects)
FX_FULL = [("gaussian_blur", {"radius": 3, "amount": 0.6}),
           ("colour_balance", {"red": 1.1, "green": 1.0, "blue": 0.9}),
           ("saturation", {"saturation": 1.3}),
           ("vignette", {"amount": 0.7})]
ROOFLINE = [("full", 10, FX_FULL), ("noblur", 10, FX_FULL[1:]),
            ("trans", 10, []), ("trans2", 2, [])]
#: K6's depths: the reference's two (sweep_profile.py:169), then two that
#: no launch cost can hide; the ceiling is read from each pair
FMA_DEPTHS = (32, 128, 512, 2048)
#: launches a timing of K6 takes in a row
FMA_REPS = 200
#: the depth of K6's lead launch (about 14 ms on an H100): the device is
#: busy with it while the host queues a timing's launches
FMA_LEAD = 65536


#: the transitions of make_timeline's tracks 1..9 (sweep_profile.py:40-42)
TRANS = [("crossfade", {"amount": 0.5}), ("blend_screen", {"amount": 0.5}),
         ("blend_overlay", {"amount": 0.5}), ("luma_key", {}),
         ("blend_add", {"amount": 0.5}), ("blend_multiply", {"amount": 0.5}),
         ("chroma_key", {}), ("blend_lighten", {"amount": 0.5}),
         ("blend_difference", {"amount": 0.5})]


def make_timeline(n_tracks, n_frames, width, height, fps, fx, trans=TRANS,
                  animate=0):
    """`scenes.multitrack_timeline` with a configurable chain: a copy of
    benchmarks/sweep_profile.py:34-65 over the port's event list. Track t
    (1..n_tracks-1) folds into track 0 by trans[(t-1) % len(trans)], (name,
    values); then the effects `fx`, (name, values) on track 0 or (name,
    values, in_tracks); the amount of init `animate` runs 0 -> 1 over the
    timeline."""
    from lives_tpu_torch.events.event_list import (EventList,
                                                   TICKS_PER_SECOND,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event,
                                                   param_change_event)
    el = EventList(fps=fps, width=width, height=height)
    tpf = int(TICKS_PER_SECOND / fps)
    inits = []
    for t in range(1, n_tracks):
        name, vals = trans[(t - 1) % len(trans)]
        init = filter_init_event(0, name, in_tracks=[0, t], out_tracks=[0],
                                 values=vals)
        el.insert(init)
        inits.append(init)
    for name, vals, *tracks in fx:
        init = filter_init_event(0, name, values=vals,
                                 **({"in_tracks": tracks[0],
                                     "out_tracks": [0]} if tracks else {}))
        el.insert(init)
        inits.append(init)
    el.insert(filter_map_event(0, [i.event_id for i in inits]))
    el.insert(param_change_event(0, inits[animate].event_id, "amount", 0.0))
    el.insert(param_change_event((n_frames - 1) * tpf,
                                 inits[animate].event_id, "amount", 1.0))
    for i in range(n_frames):
        el.insert(frame_event(i * tpf, list(range(1, n_tracks + 1)),
                              [i] * n_tracks))
    return el


#: timeline V (phase 15): tracks 1-9 fold into track 0 by the transitions
#: the sweep gained (ROADMAP item 13), then alpha_over and mask_overlay over
#: tracks 1 and 2, the blur, and ten one-input ops; dissolve's amount runs
#: 0 -> 1 over the timeline (V_ANIMATE), the others' amounts are 0.5
V_TRANS = [("chroma_blend", {"amount": 0.5}),
           ("luma_overlay", {"amount": 0.5}),
           ("luma_underlay", {"amount": 0.5}),
           ("negative_luma_overlay", {"amount": 0.5}),
           ("wipe", {"amount": 0.5, "direction": 2}),   # from the top
           ("iris_circle", {"amount": 0.5}),
           ("iris_rectangle", {"amount": 0.5}),
           ("dissolve", {}),
           ("rand_replace", {"amount": 0.5})]
V_ANIMATE = 7
V_FX = [("alpha_over", {"opacity": 0.7}, [0, 1]),
        ("mask_overlay", {"threshold": 0.05, "softness": 0.5, "invert": 0.3},
         [0, 2]),
        ("gaussian_blur", {"radius": 3, "amount": 0.6}),
        ("hue_rotate", {"angle": 0.15}),
        ("modulate", {"brightness": 1.1, "saturation": 1.2, "hue": 0.8}),
        ("levels", {"black": 0.02, "white": 0.9, "gamma": 0.8}),
        ("gamma_adjust", {"gamma": 0.8}),
        ("tint", {"amount": 0.3}),
        ("softlight", {"amount": 0.5}),
        ("colour_replace", {"red": 0.5, "green": 0.5, "blue": 0.5,
                            "red2": 0.9, "green2": 0.4, "blue2": 0.1,
                            "tolerance": 0.1}),
        ("brightness_contrast", {"brightness": 0.05, "contrast": 1.2}),
        ("solarize", {"threshold": 0.9}),
        ("vignette", {"amount": 0.5})]


def timeline_v(n_frames, width=W, height=H, n_tracks=TRACKS):
    """Timeline V at `width` x `height`, 30 fps."""
    return make_timeline(n_tracks, n_frames, width, height, FPS, V_FX,
                         trans=V_TRANS, animate=V_ANIMATE)


def sass_counts(so_path, kernel):
    """{FFMA, FMUL, FADD: count} in `kernel`'s SASS (cuobjdump -sass of the
    built library)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    counts, inside = dict.fromkeys(("FFMA", "FMUL", "FADD"), 0), False
    for ln in out.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside:
            for op in counts:
                counts[op] += len(re.findall(rf"\b{op}\b", ln))
    return counts


def queued_ms(fn, reps: int, lead):
    """(device ms a call, host us a call) of reps calls of fn timed by CUDA
    events behind `lead`, a long launch: the host queues the calls while
    the device runs it, so the events time the device alone, even where a
    call costs the host more than the device (K6 at small K)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    lead()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_us = (time.perf_counter() - t0) * 1e6 / reps
    end.synchronize()
    return start.elapsed_time(end) / reps, host_us


def roofline(dev, card):
    """13. the port's roofline study (benchmarks/sweep_profile.py): the
    four chain variants through `render_events` at 1920x1080, K1's float
    operations over its time, and the card's float32 ceiling read with K6
    (`ops/fma_chain.py`). Returns K6's entry of the kernels line."""
    import numpy as np
    import torch

    from lives_tpu_torch import native
    from lives_tpu_torch.graph import SinkSpec
    from lives_tpu_torch.graph import fused_sweep
    from lives_tpu_torch.ops import fma_chain as fc
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    native.load_all(["fused_sweep", "fma_chain"])
    src = DeviceSyntheticSource(H, W, device=dev)
    sink = SinkSpec(W, H)
    n_chunks = -(-N_FRAMES // CHUNK)
    px = CHUNK * H * W
    k1 = {}
    for name, tracks, fx in ROOFLINE:
        render_path(make_timeline(tracks, CHUNK, W, H, FPS, fx), src, sink,
                    check=False)                                  # warm
        el = make_timeline(tracks, N_FRAMES, W, H, FPS, fx)
        rendered, _, counts, wall = render_path(el, src, sink, check=False)
        assert rendered == N_FRAMES and counts == {"u8": n_chunks}, counts
        ms_frame = wall / rendered * 1e3
        spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
        plan = sweep_plan(el, spec, rows, dev, tracks)
        t = time_ms(lambda: fused_sweep._launch(plan, ids, packed, None), 5)
        k1[name] = (px * (table_flops(plan.ops) + 15), t)
        line("13 variant", card=repr(card), variant=name, tracks=tracks,
             frames=rendered, launches=counts, ms_per_frame=f"{ms_frame:.4f}",
             x_realtime=f"{1000.0 / FPS / ms_frame:.2f}", k1_chunk_ms=f"{t:.3f}")

    # K6 against its plain version at the reference's depths
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.rand((3, H, W), device=dev, generator=g) + 0.5
    n = x.numel()
    worst_abs = worst_rel = 0.0
    for K in FMA_DEPTHS[:2]:
        got = fc.fma_chain(x, K)
        torch.cuda.synchronize()
        ref = fc.plain_fma_chain(x, K)
        d = (got.double() - ref.double()).abs()
        rel = (d / ref.double().abs()).max().item()
        line("13 fma_vs_plain", shape=tuple(x.shape), K=K,
             max_abs_err=f"{d.max().item():.6g}", max_rel_err=f"{rel:.3g}",
             tolerance=f"{fc.tolerance(K):.3g}")
        assert rel <= fc.tolerance(K), (K, rel)
        worst_abs, worst_rel = max(worst_abs, d.max().item()), max(worst_rel,
                                                                   rel)
    counts = sass_counts(fc.build().path, "fma_chain_kernel")
    line("13 sass", kernel="fma_chain_kernel", **counts)
    assert counts["FFMA"] >= 128 and counts["FMUL"] == counts["FADD"] == 0, \
        counts

    # the ceiling: each depth FMA_REPS launches in a row, the depths in
    # turns up and down; the launches of this study are K6's count
    fc.LAUNCHES = 0
    times = {K: [] for K in FMA_DEPTHS}
    host = {K: [] for K in FMA_DEPTHS}
    for order in (FMA_DEPTHS, FMA_DEPTHS[::-1]):
        for K in order:
            t, us = queued_ms(lambda: fc.fma_chain(x, K), FMA_REPS,
                              lambda: fc.fma_chain(x, FMA_LEAD))
            times[K].append(t)
            host[K].append(us)
    launches = fc.LAUNCHES
    mean = {K: sum(v) / len(v) for K, v in times.items()}
    for K in FMA_DEPTHS:
        line("13 fma_ms", card=repr(card), K=K, reps=FMA_REPS,
             ms=",".join(f"{t:.5f}" for t in times[K]),
             host_us_per_launch=",".join(f"{u:.1f}" for u in host[K]),
             tflops=f"{fc.flops(n, K) / mean[K] / 1e9:.2f}",
             bound_ms=f"{bound(8 * n, fc.flops(n, K))[0]:.5f}")
    ceiling = {}
    for lo, hi in (FMA_DEPTHS[:2], FMA_DEPTHS[2:]):
        ceiling[(lo, hi)] = (fc.flops(n, hi) - fc.flops(n, lo)) \
            / (mean[hi] - mean[lo]) / 1e9
        line("13 ceiling", card=repr(card), depths=f"{lo}->{hi}",
             tflops=f"{ceiling[(lo, hi)]:.2f}",
             share_of_67=f"{ceiling[(lo, hi)] / (F32_OPS_S / 1e12):.3f}")
    top = ceiling[FMA_DEPTHS[2:]]
    for name, (ops, t) in k1.items():
        rate = ops / t / 1e9
        line("13 k1_vs_ceiling", card=repr(card), variant=name,
             ops_per_chunk=ops, k1_ms=f"{t:.3f}", tops=f"{rate:.2f}",
             share_of_ceiling=f"{rate / top:.3f}",
             share_of_67=f"{rate / (F32_OPS_S / 1e12):.3f}")
    K = FMA_DEPTHS[1]       # the kernels line's: the reference's deeper K
    plain = time_ms(lambda: fc.plain_fma_chain(x, K), 2)
    # the library call: with acc_0 = a the chain is a * sum_{i<=K} M^i, one
    # multiply by a constant (summed in float64, rounded once); the probe
    # loses to it by design, since it exists to issue K dependent FFMAs
    c = float(np.float32(sum(fc.M ** i for i in range(K + 1))))
    lib = x * c
    ref = fc.plain_fma_chain(x, K)
    rel = ((lib.double() - ref.double()).abs() / ref.double().abs()).max() \
        .item()
    assert rel <= fc.tolerance(K), ("x * c", K, rel)
    library = time_ms(lambda: x * c, FMA_REPS)
    line("13 library", card=repr(card), call="x * c", K=K, c=repr(c),
         max_rel_err=f"{rel:.3g}", tolerance=f"{fc.tolerance(K):.3g}",
         ms=f"{library:.5f}", k6_ms=f"{mean[K]:.5f}")
    return {"launches": launches, "max_abs_err": worst_abs,
            "max_rel_err": worst_rel, "ms": mean[K], "plain_ms": plain,
            "library_ms": library, "bound": bound(8 * n, fc.flops(n, K))}


#: phase 14, BASELINE row 5 as benchmarks/latency4k.py:35-80 drives it
LIVE_W, LIVE_H, LIVE_FPS = 3840, 2160, 60.0
LIVE_FRAMES, LIVE_WINDOW, LIVE_TOGGLE = 480, 8, 25
LIVE_CONFIGS = [["saturation"], ["saturation", "vignette"], ["vignette"],
                ["vignette", "brightness_contrast"], ["brightness_contrast"],
                ["saturation", "brightness_contrast"], [], ["negate"]]
#: BASELINE row 5's target: p99 under 16 ms a frame at 4K60
LIVE_P99_MS = 16.0


def live(dev, card):
    """14. the single-frame live path at 4K60: `GeneratorClip("plasma")`
    over `GeneratorClip("colour_bars")` through the eight configurations,
    one `FrameGraph.run` a frame."""
    import numpy as np
    import torch

    from lives_tpu_torch.effects.host import instantiate
    from lives_tpu_torch.graph import FrameGraph, GenSlot, SinkSpec
    from lives_tpu_torch.io.genclip import GeneratorClip

    def clips(w, h, device):
        return (GeneratorClip("plasma", w, h, fps=LIVE_FPS, device=device),
                GeneratorClip("colour_bars", w, h, fps=LIVE_FPS,
                              device=device))

    def graph(names, w, h):
        return FrameGraph([instantiate(n) for n in names],
                          SinkSpec(width=w, height=h), fps=LIVE_FPS)

    fg, bg = clips(LIVE_W, LIVE_H, dev)
    graphs = [graph(names, LIVE_W, LIVE_H) for names in LIVE_CONFIGS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for g in graphs:                                              # warm
        out = g.run([fg, bg], 0.0, 0)
        torch.cuda.synchronize()
        arr = out.planes[0]
        assert arr.dtype == torch.uint8 and arr.device.type == fg.device.type
        assert tuple(arr.shape) == (3, LIVE_H, LIVE_W)

    def pick(i):
        return graphs[(i // LIVE_TOGGLE) % len(graphs)]

    lat = []
    for i in range(LIVE_FRAMES):
        g = pick(i)
        t0 = time.perf_counter()
        g.run([fg, bg], i / LIVE_FPS, i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat)
    p = {q: float(np.percentile(lat, q)) for q in (50, 99)}
    line("14 latency", card=repr(card), size=f"{LIVE_W}x{LIVE_H}",
         frames=LIVE_FRAMES, configs=len(graphs), toggle_every=LIVE_TOGGLE,
         p50_ms=f"{p[50]:.3f}", p99_ms=f"{p[99]:.3f}",
         max_ms=f"{lat.max():.3f}", mean_ms=f"{lat.mean():.3f}",
         target_p99_ms=LIVE_P99_MS, meets_target=p[99] < LIVE_P99_MS)
    win = []
    t_all = t_win = time.perf_counter()
    for i in range(LIVE_FRAMES):
        pick(i).run([fg, bg], i / LIVE_FPS, i)
        if (i + 1) % LIVE_WINDOW == 0:
            torch.cuda.synchronize()
            now = time.perf_counter()
            win.append((now - t_win) / LIVE_WINDOW * 1e3)
            t_win = now
    win = np.asarray(win)
    line("14 windows", card=repr(card), window=LIVE_WINDOW,
         mean_ms=f"{win.mean():.3f}",
         p50_ms=f"{np.percentile(win, 50):.3f}",
         p99_ms=f"{np.percentile(win, 99):.3f}", max_ms=f"{win.max():.3f}",
         frames_per_s=f"{LIVE_FRAMES / (t_win - t_all):.1f}")
    line("14 peak", gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

    # a profiled pass: the device's busy share and its kernels a frame
    from torch.profiler import ProfilerActivity, profile
    n_prof = 2 * LIVE_TOGGLE
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_prof):
            pick(i).run([fg, bg], i / LIVE_FPS, i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, top = device_busy(prof)
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    line("14 profiled", card=repr(card), frames=n_prof,
         wall_ms=f"{wall * 1e3:.1f}", device_busy_ms=f"{busy:.1f}",
         idle_share=f"{1 - busy / (wall * 1e3):.3f}",
         kernels_per_frame=f"{kernels / n_prof:.1f}", top=top)

    # checks: the card against the CPU at 1080p; GenSlot against get_frame;
    # a GenSlot around a stateful clip raises
    on = {d: clips(W, H, d) for d in ("cpu", dev)}
    for names in (["saturation", "vignette"], ["negate"]):
        got = graph(names, W, H).run(list(on[dev]), 0.0, 0).planes[0]
        ref = graph(names, W, H).run(list(on["cpu"]), 0.0, 0).planes[0]
        worst, share = diff_stats(got.cpu(), ref)
        line("14 card_vs_cpu", chain="+".join(names), size=f"{W}x{H}",
             frame=0, max_abs_err=f"{worst:.6g}",
             differing_share=f"{share:.3g}")
        assert worst <= 1, (names, worst)
    g = graphs[1]
    n = 1234
    slot = g.run([GenSlot(fg, n), bg], 0.5, 30).planes[0]
    pulled = g.run([fg.get_frame(n), bg], 0.5, 30).planes[0]
    assert torch.equal(slot, pulled), "GenSlot differs from get_frame"
    line("14 genslot", n=n, bit_for_bit=True)
    rings = GeneratorClip("beat_rings", LIVE_W, LIVE_H, fps=LIVE_FPS,
                          device=dev)
    try:
        g.run([GenSlot(rings, 0), bg])
    except ValueError:
        line("14 genslot_stateful", raises="ValueError")
    else:
        raise AssertionError("a GenSlot around beat_rings must raise")

    # the unpacked path: traced values that are tensors on the card (the
    # chain's and plasma's) copied into the column there, bit for bit the
    # host numbers' frame; neither path makes a synchronizing call
    from lives_tpu_torch.effects.host import split_params
    cf, cb = clips(LIVE_W, LIVE_H, dev)
    g = graph(LIVE_CONFIGS[1], LIVE_W, LIVE_H)
    g.run([cf, cb], 0.0, 0)
    torch.cuda.synchronize()
    host, host_syncs = synced_calls(
        lambda: g.run([cf, cb], 0.5, 30).planes[0])
    for inst in (*g.chain, cf.inst):
        for k, v in split_params(inst)[1].items():
            inst.values[k] = torch.tensor(float(v), device=dev)
    got, dev_syncs = synced_calls(lambda: g.run([cf, cb], 0.5, 30).planes[0])
    _, control = synced_calls(lambda: got.sum().item())   # one sync, seen
    line("14 unpacked", chain="+".join(LIVE_CONFIGS[1]), keys=len(g.stats),
         bit_for_bit=bool(torch.equal(got, host)),
         syncs_packed=len(host_syncs), syncs_unpacked=len(dev_syncs),
         syncs_of_an_item_call=len(control))
    assert len(g.stats) == 2 and torch.equal(got, host)
    assert control and not host_syncs and not dev_syncs, \
        (control, host_syncs, dev_syncs)
    return p


def new_ops():
    """The 25 ops the sweep's op table gained (ROADMAP item 13): its whole
    vocabulary less the core and the stencils."""
    from lives_tpu_torch.graph import fused_sweep as fs
    return sorted(fs.VOCABULARY - fs.CORE - fs.STENCILS)


def op_cases():
    """(label, name, static values) of each new op alone: wipe in each of
    its four directions."""
    return [(f"wipe[{d}]" if n == "wipe" else n, n,
             {"direction": d} if n == "wipe" else {})
            for n in new_ops() for d in (range(4) if n == "wipe" else [0])]


def lone_op(name, static, n_tracks, rng, B, lead=()):
    """(chain spec, packed (host), rows_key) of op `name` alone (after the
    specs `lead`), reading tracks 0 and 1 where it reads two, with
    per-frame values drawn in each traced parameter's range."""
    import numpy as np

    from lives_tpu_torch.effects.host import instantiate
    from lives_tpu_torch.graph.nodemodel import (_split_params,
                                                 chain_spec_of, pack_params)
    chain = [instantiate(n, **v) for n, v in lead]
    inst = instantiate(name, **static)
    inst.in_tracks = (0, 1 % n_tracks) if inst.filter.n_in == 2 else (0,)
    chain.append(inst)
    params = [{k: rng.uniform(i.filter.param(k).min, i.filter.param(k).max,
                              B).astype(np.float32)
               for k in _split_params(i)[1]} for i in chain]
    packed, rows = pack_params(params, np.arange(B) / FPS,
                               np.arange(B) + 1000003)
    return chain_spec_of(chain), packed, rows


def vocabulary(dev, card, held, ms, bounds, launches):
    """15. the sweep's whole vocabulary (ROADMAP item 13): timeline V through
    the main path's entry points; each op the op table gained alone in K1,
    K4 (PALLAS_SAFE) and K5; K4 on a chain of them over 10 tracks; K5 on
    config C with two of them; V in bands."""
    import numpy as np
    import torch

    from lives_tpu_torch.events.renderer import render_events
    from lives_tpu_torch.graph import (SinkSpec, composite, fused_sweep,
                                       nodemodel, stateful_sweep)
    from lives_tpu_torch.graph.nodemodel import chain_spec_of
    from lives_tpu_torch.parallel import frame_mesh, spatial_sweep_fn
    from lives_tpu_torch.scenes import (DeviceSyntheticSource,
                                        multitrack_timeline)
    from lives_tpu_torch.effects.host import instantiate
    src = DeviceSyntheticSource(H, W, device=dev)
    sink = SinkSpec(W, H)
    n_chunks = -(-N_FRAMES // CHUNK)
    px = CHUNK * H * W
    # the plain route is the float route, the one K1 computes (an earlier
    # phase leaves the composite route's pref set)
    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"

    # 15a. timeline V through render_events
    el = timeline_v(N_FRAMES)
    nodemodel.PLAIN_CHUNKS = 0
    rendered, head, counts, first_s = render_path(el, src, sink)
    plain_chunks = nodemodel.PLAIN_CHUNKS
    line("15a timeline_v", frames=rendered, chunks=n_chunks, launches=counts,
         plain_route_chunks=plain_chunks, first_pass_s=f"{first_s:.3f}")
    assert rendered == N_FRAMES and counts == {"u8": n_chunks} \
        and plain_chunks == 0, (rendered, counts, plain_chunks)
    launches["fused_sweep_vocabulary"] = counts["u8"]
    _, plain_head = next(iter(render_events(el, Materialised(src), sink,
                                            batch_size=4)))
    ref = plain_head.planes[0]
    held("fused_sweep_vocabulary", "15a v_vs_plain_route", head, ref, 1,
         frames=4, beyond_1_lsb=int(((head.int() - ref.int()).abs() > 1)
                                    .sum()))
    rendered, _, _, wall_s = render_path(el, src, sink, check=False)
    line("15a timed", card=repr(card), frames=rendered,
         wall_s=f"{wall_s:.4f}", frames_per_s=f"{rendered / wall_s:.1f}",
         x_realtime=f"{rendered / wall_s / FPS:.2f}")
    spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
    plan = sweep_plan(el, spec, rows, dev, TRACKS)
    assert plan.full, "V holds ops past the core: K1's exact build"
    ms["fused_sweep_vocabulary"] = in_turns(
        lambda: fused_sweep.plain_sweep(plan, ids, packed),
        lambda: fused_sweep._launch(plan, ids, packed, None))
    bounds["fused_sweep_vocabulary"] = bound(
        px * 3, px * (table_flops(plan.ops) + 15))
    geom = fused_sweep.plan_geometry(plan, CHUNK)
    line("15a chunk_ms", card=repr(card), frames=CHUNK,
         times=ms["fused_sweep_vocabulary"][2], ops=plan.ops.shape[0],
         bound_ms=f"{bounds['fused_sweep_vocabulary'][0]:.4f} "
                  f"({bounds['fused_sweep_vocabulary'][1]})",
         tile=f"{geom.tile_h}x{geom.tile_w}", run=geom.run, smem=geom.smem,
         blocks_per_sm=fused_sweep.blocks_per_sm(geom))
    # the exact build's entry of runs of 8 spills (phase 2's ptxas lines):
    # V's chunk at runs of 4 beside the chosen runs, in turns
    g4 = fused_sweep.plan_geometry(plan, CHUNK, (geom.tile_h, geom.tile_w),
                                   4)
    times = {geom.run: [], 4: []}
    for run in (geom.run, 4, 4, geom.run):
        g = geom if run == geom.run else g4
        times[run].append(time_ms(
            lambda: fused_sweep._launch(plan, ids, packed, None, 0, g), 5))
    line("15a run_ms", card=repr(card), chain="V", frames=CHUNK,
         tile=f"{geom.tile_h}x{geom.tile_w}",
         **{f"run{r}_ms": ",".join(f"{x:.3f}" for x in t)
            for r, t in times.items()})

    # 15a. what the exact build costs: the main chain's chunk on K1's core
    # build and on its exact one (whole vocabulary, -fmad=false), in turns
    import dataclasses
    mel = multitrack_timeline(n_tracks=TRACKS, n_frames=N_FRAMES, width=W,
                              height=H, fps=FPS)
    mspec, mids, mpacked, mrows = chunk_of(mel, dev, CHUNK)
    core = sweep_plan(mel, mspec, mrows, dev, TRACKS)
    exact = dataclasses.replace(core, full=True)
    times = {id(core): [], id(exact): []}
    for p in (core, exact, exact, core):
        times[id(p)].append(time_ms(
            lambda: fused_sweep._launch(p, mids, mpacked, None), 5))
    line("15a exact_cost", card=repr(card), chain="main", frames=CHUNK,
         core_ms=",".join(f"{x:.3f}" for x in times[id(core)]),
         exact_ms=",".join(f"{x:.3f}" for x in times[id(exact)]))
    del mids, mpacked

    # 15b-d. each new op alone: K1 (8 frames), K4 over decoded-like u8
    # tracks and K5 after alien_overlay (4 frames), all at 1920x1080
    rng = np.random.default_rng(15)
    b8 = 8
    ids8 = torch.tensor([[[1] * b8, [2] * b8], [list(range(b8))] * 2],
                        dtype=torch.int32, device=dev)
    trk = [src.traced_layer(ids8[0, t, :4], ids8[1, t, :4]).planes[0]
           for t in range(2)]
    for label, name, static in op_cases():
        spec1, packed1, rows1 = lone_op(name, static, 2, rng, b8)
        packed1 = torch.from_numpy(packed1).to(dev)
        plan = fused_sweep.build_fused_sweep(spec1, 2, H, W, rows1, FPS, src,
                                             sink, dev)
        got = fused_sweep.fused_sweep(plan, ids8, packed1)
        torch.cuda.synchronize()
        ref = fused_sweep.plain_sweep(plan, ids8, packed1)
        held("fused_sweep_vocabulary", "15b k1_op_vs_plain", got, ref, 1,
             op=label, frames=b8,
             beyond_1_lsb=int(((got.int() - ref.int()).abs() > 1).sum()))
        if name in composite.VOCABULARY:
            cplan = composite.build_composite(spec1, 2, rows1, FPS, dev)
            got = composite.composite(cplan, trk, packed1[:, :4])
            torch.cuda.synchronize()
            held("composite", "15c k4_op_vs_plain", got,
                 composite.plain_composite(cplan, trk, packed1[:, :4]), 1,
                 op=label, frames=4)
        spec5, packed5, rows5 = lone_op(name, static, 2, rng, 4,
                                        lead=[("alien_overlay", {})])
        packed5 = torch.from_numpy(packed5).to(dev)
        splan = stateful_sweep.build_stateful_sweep(spec5, 2, H, W, rows5,
                                                    FPS, src, sink, dev)
        assert splan is not None and splan.full, label
        st = [f.init_state(W, H, None, dev) if f.init_state else None
              for f, *_ in spec5]
        got, st_k = stateful_sweep.stateful_sweep(splan, ids8[:, :, :4],
                                                  packed5, st)
        torch.cuda.synchronize()
        ref, st_p = stateful_sweep.plain_stateful_sweep(
            splan, ids8[:, :, :4], packed5,
            [x.clone() if x is not None else None for x in st])
        held("stateful_sweep", "15d k5_op_vs_plain", got, ref, 1, op=label,
             frames=4, state_err=f"{diff_stats(st_k[0], st_p[0])[0]:.3g}")
        assert diff_stats(st_k[0], st_p[0])[0] <= 1e-5, label

    # 15c. K4 over 10 u8 tracks with a chain of 9 drawn from the new
    # PALLAS_SAFE ops, each reading random tracks
    pool = sorted(set(new_ops()) & composite.VOCABULARY)
    chain = []
    for _ in range(9):
        inst = instantiate(pool[rng.integers(len(pool))])
        inst.in_tracks = tuple(int(t) for t in
                               rng.integers(0, TRACKS, inst.filter.n_in))
        chain.append(inst)
    from lives_tpu_torch.graph.nodemodel import _split_params, pack_params
    params = [{k: rng.uniform(i.filter.param(k).min, i.filter.param(k).max,
                              b8).astype(np.float32)
               for k in _split_params(i)[1]} for i in chain]
    packed9, rows9 = pack_params(params, np.arange(b8) / FPS, np.arange(b8))
    packed9 = torch.from_numpy(packed9).to(dev)
    cplan = composite.build_composite(chain_spec_of(chain), TRACKS, rows9,
                                      FPS, dev)
    trk10 = [src.traced_layer(torch.full((b8,), t + 1, dtype=torch.int32,
                                         device=dev),
                              torch.arange(b8, dtype=torch.int32,
                                           device=dev)).planes[0]
             for t in range(TRACKS)]
    got = composite.composite(cplan, trk10, packed9)
    torch.cuda.synchronize()
    held("composite", "15c k4_chain_vs_plain", got,
         composite.plain_composite(cplan, trk10, packed9), 1,
         chain="+".join(i.filter.name for i in chain), tracks=TRACKS,
         frames=b8)
    del trk10, got

    # 15d. K5 on config C with dissolve and hue_rotate in its tail, two
    # chunks
    tel = timeline("C_vocab", 8)
    spec5, _, _, rows5 = chunk_of(tel, dev, 4)
    splan = stateful_sweep.build_stateful_sweep(spec5, TRACKS, H, W, rows5,
                                                FPS, src, sink, dev)
    assert splan is not None and splan.full
    st_k = [f.init_state(W, H, None, dev) if f.init_state else None
            for f, *_ in spec5]
    st_p = list(st_k)
    for k in range(2):
        _, ids4, packed4, _ = chunk_of(tel, dev, 4, k)
        got, st_k = stateful_sweep.stateful_sweep(splan, ids4, packed4, st_k)
        torch.cuda.synchronize()
        ref, st_p = stateful_sweep.plain_stateful_sweep(splan, ids4, packed4,
                                                        st_p)
        held("stateful_sweep", "15d k5_c_vocab_vs_plain", got, ref, 1,
             chunk=k, frames=4)
    for i, step, kind in splan.state_steps:
        worst, _ = diff_stats(st_k[i], st_p[i])
        line("15d state", step=step, kind=kind, max_abs_err=f"{worst:.3g}")
        assert worst <= 1e-5, (step, worst)

    # 15e. V in bands: the band kernel bit for bit the whole frame's rows,
    # and spatial_sweep_fn over V's chunks bit for bit render_events'
    spec, ids, packed, rows = chunk_of(el, dev, 4)
    whole = fused_sweep.fused_sweep(sweep_plan(el, spec, rows, dev, TRACKS),
                                    ids, packed)
    for band_h in (H // 4, H // 8):  # 270 and 135 rows at 1080p
        bplan = sweep_plan(el, spec, rows, dev, TRACKS, band_h=band_h)
        same = all(torch.equal(fused_sweep.fused_sweep(bplan, ids, packed,
                                                       y0=y0),
                               whole[:, :, y0:y0 + band_h])
                   for y0 in range(0, H, band_h))
        line("15e v_band_vs_whole", band_h=band_h, bands=H // band_h,
             bit_identical=same)
        assert same, band_h
    del whole
    graph = nodemodel.FrameGraph(_chain(el), sink, fps=FPS)
    sweep = spatial_sweep_fn(graph, frame_mesh([torch.device("cuda", 0)] * 4,
                                               axis="s"), src, CHUNK, H, W,
                             axis="s")
    assert sweep is not None, "V must qualify for the band sweep"
    fused_sweep.MODE_LAUNCHES.update(dict.fromkeys(fused_sweep.MODE_LAUNCHES,
                                                   0))
    outs = [sweep(ids_k, packed_k) for _, ids_k, packed_k, _ in
            (chunk_of(el, dev, CHUNK, k) for k in range(n_chunks))]
    torch.cuda.synchronize()
    counts = {k: v for k, v in fused_sweep.MODE_LAUNCHES.items() if v}
    assert counts == {"band": 4 * n_chunks}, counts
    for k, (o, (_, lay)) in enumerate(zip(outs, render_events_of(el, src,
                                                                  sink))):
        same = torch.equal(o, lay.planes[0])
        line("15e v_band_sweep_vs_render_events", chunk=k, launches=counts,
             bit_identical=same)
        assert same, k
    del outs


def guard(dev, card):
    """`--guard`: K1 u8 on the main chain's chunk (phase 5's), K4 on config
    D's 9-transition prefix over 10 tracks and K5 on config C, one 96-frame
    chunk each, alone, and the ptxas report of K1, K4 and K5, calling only
    entry points every version of the port since its K1 redesign has: a
    copy of the script at the root of another checkout times that
    checkout."""
    import torch

    from lives_tpu_torch import native
    from lives_tpu_torch.graph import composite, fused_sweep, stateful_sweep
    from lives_tpu_torch.graph.nodemodel import composite_prefix
    from lives_tpu_torch.graph import SinkSpec
    from lives_tpu_torch.scenes import (DeviceSyntheticSource,
                                        multitrack_timeline)
    native.load_all(["fused_sweep", "composite", "stateful_sweep"])
    for mod in (fused_sweep, composite, stateful_sweep):
        built = mod.build()
        for entry, res in ptxas_entries(built.log).items():
            line("guard ptxas", root=ROOT.name,
                 lib=built.path.name.split("-")[0], entry=entry, **res)
    src = DeviceSyntheticSource(H, W, device=dev)
    el = multitrack_timeline(n_tracks=TRACKS, n_frames=N_FRAMES, width=W,
                             height=H, fps=FPS)
    spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
    plan = sweep_plan(el, spec, rows, dev, TRACKS)
    calls = {"k1_u8": lambda: fused_sweep._launch(plan, ids, packed, None)}
    prefix, n_t = composite_prefix(spec[:9], TRACKS)
    cplan = composite.build_composite(prefix, n_t, rows, FPS, dev)
    trk = [src.traced_layer(ids[0, t], ids[1, t]).planes[0]
           for t in range(n_t)]
    calls["k4"] = lambda: composite._launch(cplan, trk, packed, CHUNK, H, W)
    cspec, cids, cpacked, crows = chunk_of(timeline("C", CHUNK), dev, CHUNK)
    splan = stateful_sweep.build_stateful_sweep(cspec, TRACKS, H, W, crows,
                                                FPS, src, SinkSpec(W, H), dev)
    states = [f.init_state(W, H, None, dev) if f.init_state else None
              for f, *_ in cspec]
    calls["k5"] = lambda: stateful_sweep._launch(splan, cids, cpacked, states)
    for name, fn in calls.items():
        got = [time_ms(fn, 5) for _ in range(4)]
        line(f"guard {name}_ms", card=repr(card), root=ROOT.name,
             frames=CHUNK, ms=",".join(f"{x:.3f}" for x in got))
    torch.cuda.synchronize()


# -- phase 16: the realtime player ------------------------------------------

#: phase 16's keys: key -> (filter, per-key defaults); key 3 holds the
#: autotransition's crossfade
PLAYER_KEYS = {0: ("gaussian_blur", {"radius": 3}), 1: ("colour_balance", {}),
               2: ("vignette", {}), 3: ("crossfade", {})}
AUTOTRANS_KEY = 3
#: the player's clips (two, 48 frames each), cycles a pass, the cycles
#: between key toggles (BASELINE row 5's rhythm) and nervous mode's seed
PLAYER_CLIP_FRAMES, PLAYER_CYCLES, PLAYER_EVERY = 48, 240, 25
PLAYER_SEED = 16
#: max |diff| over the Y, U and V planes between what the JAX package's
#: own player showed and its re-render of the take, on phase 16's
#: performance at 64x36 (measured by tests/test_torch_player.py
#: `test_jax_player_vs_its_rerender`); phase 16 holds the port's player
#: on the card to it plus 1 LSB
PLAYER_RERENDER_BOUND = 1


class ScriptedClock:
    """A stand-in for the `time` module inside a player module:
    `monotonic()` reads `now`, which the script advances; `sleep` sleeps."""

    def __init__(self, now=0.0):
        self.now = now

    def monotonic(self):
        return self.now

    @staticmethod
    def sleep(seconds):
        time.sleep(seconds)


def player_script(cycles, every):
    """{cycle: [action, ...]} of phase 16's performance, before that
    cycle's `process_one`: key (j + 1) % 3 toggles at cycle every * (j +
    1) (keys 1, 2 on, 0, 1, 2 off, 0, 1, 2 on, 0 off from key 0 on: a key
    goes on only above every key that is on, so the live chain's key order
    and the recorded filter map's agree); the fg switches at 2.88 * every
    with an autotransition of 1.2 * every cycles (over key releases only);
    play runs reversed for 1.2 * every cycles from 5.2 * every and nervous
    for as long from 7.2 * every."""
    acts, span = {}, round(1.2 * every)

    def at(c, *act):
        acts.setdefault(c, []).append(act)
    for c in range(every, cycles, every):
        at(c, "toggle", (c // every) % 3)
    at(round(2.88 * every), "switch")
    r0, n0 = round(5.2 * every), round(7.2 * every)
    at(r0, "fps", -1)
    at(r0 + span, "fps", 1)
    at(n0, "nervous", True)
    at(n0 + span, "nervous", False)
    return acts


def player_setup(p, clips, fps, every):
    """Phase 16's player set-up on either package's Player: the keys, the
    autotransition, clips a (fg) and b (bg), precache 8, pipeline 2, fetch
    groups of 4, the seeded nervous generator, key 0 on, recording on,
    playing."""
    import numpy as np
    for k, (name, vals) in PLAYER_KEYS.items():
        p.keymap.set_key(k, 0, name)
        if vals:
            p.keymap.set_key_defaults(k, 0, **vals)
    p.set_autotrans(AUTOTRANS_KEY, duration=round(1.2 * every) / fps)
    p.state.fg_clip, p.state.bg_clip = clips
    p.precache_depth, p.pipeline_depth, p.fetch_batch = 8, 2, 4
    p._nervous_rng = np.random.default_rng(PLAYER_SEED)
    p.key_toggle(0, True)
    p.record_start(clips[0].width, clips[0].height)
    p.start()


def perform(p, clips, fps, cycles, every, clock=None, realtime=False,
            script=None):
    """Drive phase 16's performance (`player_script`, or `script`) on a
    set-up player.
    With `clock` (a ScriptedClock standing in for the player module's
    `time`), each cycle sees the clock advanced by 1 / fps; without it the
    cycles run on the wall clock, `play_n_cycles(1, realtime=True)` each.
    Returns each cycle's host ms. When the autotransition releases the bg
    track, the next cycle selects the other clip as bg again."""
    a, b = clips
    acts = (script or player_script)(cycles, every)
    ms = []
    for c in range(cycles):
        for act in acts.get(c, ()):
            if act[0] == "toggle":
                p.key_toggle(act[1])
            elif act[0] == "switch":
                p.switch_fg(b if p.state.fg_clip is a else a)
            elif act[0] == "fps":
                p.set_pb_fps(act[1] * fps)
            else:
                p.state.nervous = act[1]
        if p.state.bg_clip is None:
            p.state.bg_clip = a if p.state.fg_clip is b else b
        t0 = time.perf_counter()
        if realtime:
            p.play_n_cycles(1, realtime=True)
        else:
            p.process_one()
        ms.append((time.perf_counter() - t0) * 1e3)
        if clock is not None:
            clock.now = (c + 1) / fps
    return ms


#: the least PSNR of a scrap take's re-render against the frames the sink
#: showed (phase 21d); the JAX player's own take of `scrap_take` at 64x36
#: shows 32.2 dB (tests/test_torch_scrap.py holds it and the port's to
#: this bound)
SCRAP_PSNR_DB = 30.0


def scrap_take(p, gen, cycles, fps, clock=None, beat_every=6, ms=None):
    """Record `cycles` cycles of `gen` (a stateful beat_rings
    GeneratorClip of either package) as the fg of a started-fresh player
    with scrap capture on, a beat every `beat_every` cycles; with `clock`
    (a ScriptedClock) each cycle sees it advanced 1 / fps; `ms`, a list,
    gets each cycle's host ms. Returns the take (the recorded
    EventList)."""
    p.state.fg_clip = gen
    p.set_pb_fps(fps)
    p.start()
    p.record_start(gen.width, gen.height, scrap_generators=True)
    for c in range(cycles):
        gen.inst.values["beat"] = 1.0 if c % beat_every == 0 else 0.0
        t0 = time.perf_counter()
        p.process_one()
        if ms is not None:
            ms.append((time.perf_counter() - t0) * 1e3)
        if clock is not None:
            clock.now = (c + 1) / fps
    el = p.record_stop()
    p.stop()
    return el


def rerender_index(el, fps):
    """Each FRAME event's frame in the take's re-render: its slot on the
    fps grid `EventList.quantise` lays from the first FRAME event."""
    frames = [e for e in el.events if e.type.name == "FRAME"]
    tpf = 100_000_000 / fps
    return [round((e.tc - frames[0].tc) / tpf) for e in frames]


def yuv_gap(shown, rendered, index):
    """max |diff| over the Y, U and V planes (tensors) between shown frame
    j and rendered frame index[j], on the rendered frame's device."""
    import torch
    return max(int((a.to(b.device, torch.int16)
                    - b.to(torch.int16)).abs().max())
               for j, g in enumerate(index)
               for a, b in zip(shown[j], rendered[g]))


def player_pass(dev, clips, path, setup, script=None, clock=None,
                plain=False, prof=False, cycles=PLAYER_CYCLES, rgb=False):
    """A pass of a performance on a `Player` into a Y4MSink at `path` (the
    sink step YUV420P, as cli.build_player; with `rgb` an `RGBFileSink`,
    the sink step RGB24), `setup(p)` first (phase 16's `player_setup`,
    phase 17c's `vj_setup` or phase 18c's `titles_setup`), then `perform`
    with `script` for `cycles`; K2 and K3 launch counts set to 0 just
    before it and read after `stop`. Returns (player, per-cycle ms, {launches, runs},
    [inline decodes, frames dropped on a precache miss, those drops by
    mode, (s into the pass, backlog, farthest-first) at each], profile)."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.graph import FrameGraph, SinkSpec
    from lives_tpu_torch.layer import Layer
    from lives_tpu_torch.ops import yuv_kernels as yk
    from lives_tpu_torch.player import Player, Y4MSink
    from lives_tpu_torch.player import player as player_mod

    # as cli.build_player
    spec = SinkSpec(palette=int(Palette.RGB24 if rgb else Palette.YUV420P))
    runs = []
    run = FrameGraph.run

    def counted(self, layers, *a, **kw):
        # the decoded tracks this run's chain reads before a generator
        # writes over them (a track past the stack reads track 0), and
        # whether it converts an output
        n = sum(isinstance(lay, Layer) for lay in layers)
        read, written = set(), set()
        for i in self.chain:
            read |= {t if t < n else 0
                     for t in i.in_tracks[:i.filter.n_in]} - written
            if not i.filter.n_in:
                written |= set(i.out_tracks)
        runs.append((threading.current_thread() is
                     threading.main_thread(),
                     len(read) if self.chain else 0, bool(self.chain)))
        return run(self, layers, *a, **kw)
    kernels = (yk.yuv420_to_rgb, yk.rgb_to_yuv420)
    saved_time = player_mod.time
    misses = [0, 0, {}, []]
    t_pass = [0.0]
    p = Player(RGBFileSink(path) if rgb else Y4MSink(path), spec, fps=FPS,
               device=dev)
    if clock is not None:
        # what is shown is a function of the script alone: a chain
        # change builds its graph in the cycle (no warm-up thread
        # serving the old graph meanwhile), a precache miss decodes
        # inline (no drop)
        player_mod.time = clock
        p.async_compile = False
        p.drop_on_miss = False
    decode, pull = p._decode_frame, p._pull

    def counted_decode(clip, n):
        if threading.current_thread() is threading.main_thread():
            misses[0] += 1
        return decode(clip, n)

    def counted_pull(clip, n):
        try:
            return pull(clip, n)
        except player_mod._PrecacheMiss:
            # the performance's mode at the drop, and the frames the
            # worker had still to decode
            st = p.state
            mode = ("nervous" if st.nervous else "reverse"
                    if st.pb_fps < 0 else "autotrans"
                    if p._autotrans_t0 is not None else "forward")
            misses[1] += 1
            misses[2][mode] = misses[2].get(mode, 0) + 1
            misses[3].append((time.perf_counter() - t_pass[0],
                              len(p._inflight), p._pc_behind))
            raise
    p._decode_frame, p._pull = counted_decode, counted_pull
    FrameGraph.run = counted
    if plain:
        yk.yuv420_to_rgb = yk.plain_yuv420_to_rgb
        yk.rgb_to_yuv420 = yk.plain_rgb_to_yuv420
    yk.LAUNCHES.update(dict.fromkeys(yk.LAUNCHES, 0))
    trace = None
    try:
        setup(p)
        t_pass[0] = time.perf_counter()
        if clock is not None:
            p._frame0 += 0.5   # mid-frame: floor never lands a frame off
        if prof:
            # the device's activity only: its kernels and copies are
            # all the pass reads, and a trace of every host op of 240
            # cycles takes seconds to read back
            t_in = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as trace:
                t0 = time.perf_counter()
                ms = perform(p, clips, FPS, cycles, PLAYER_EVERY,
                             clock=clock, script=script)
                p.record_stop()
                p.stop()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                trace.wall_ms = (t1 - t0) * 1e3
            # the profiler's own cost: starting it, and stopping it
            # with the trace read back
            trace.own_s = (t0 - t_in, time.perf_counter() - t1)
        else:
            ms = perform(p, clips, FPS, cycles, PLAYER_EVERY,
                         clock=clock, realtime=clock is None, script=script)
            p.record_stop()
            p.stop()
    finally:
        FrameGraph.run = run
        yk.yuv420_to_rgb, yk.rgb_to_yuv420 = kernels
        player_mod.time = saved_time
    counts = dict(yk.LAUNCHES)
    counts["runs"] = runs
    return p, ms, counts, misses, trace


def player_design(runs):
    """K2 and K3 launches the design gives: every run of a graph converts
    each decoded track its chain reads once and its output once (in a
    pass on the scripted clock: fg + bg a frame, fg alone in the frame the
    autotransition releases the bg, 1 K3 a frame)."""
    return {"yuv420_to_rgb": sum(n for _, n, _ in runs),
            "rgb_to_yuv420": sum(out for _, _, out in runs)}


def y4m_planes(path, device):
    """A YUV4MPEG file's frames as (Y, U, V) views of one upload to
    `device`."""
    import numpy as np
    import torch

    from lives_tpu_torch.io.decoders import try_decoders
    cd = try_decoders(path)
    dec = cd.decoder
    buf = np.fromfile(path, np.uint8)
    flat = torch.from_numpy(np.stack(
        [buf[dec._offset(n):dec._offset(n) + dec.frame_size]
         for n in range(cd.nframes)])).to(device)
    dec.close()
    ny, nc = cd.height * cd.width, (cd.height // 2) * (cd.width // 2)
    return [(f[:ny].view(cd.height, cd.width),
             f[ny:ny + nc].view(cd.height // 2, cd.width // 2),
             f[ny + nc:].view(cd.height // 2, cd.width // 2))
            for f in flat]


def rerender_gap(take_shown, take, clips, shown_path, dev):
    """The kernels pass's take re-rendered on the card
    (`render_last_recording`) against the frames its Y4M file holds:
    (frames, non-zero K2/K3 launches, seconds, max |diff| over Y, U and
    V)."""
    import torch

    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.layer import Layer
    from lives_tpu_torch.ops import yuv_kernels as yk
    from lives_tpu_torch.ops.colorspace import convert_layer
    yk.LAUNCHES.update(dict.fromkeys(yk.LAUNCHES, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, _ = take_shown.render_last_recording(
        take_shown.recording_uid_map(clips), batch_size=CHUNK)
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in yk.LAUNCHES.items() if v}
    rendered = []   # the re-render as YUV420P, on the card
    for k in range(0, len(frames), CHUNK):
        yuv = convert_layer(Layer(planes=(torch.from_numpy(
            frames[k:k + CHUNK]).to(dev),)), Palette.YUV420P).planes
        rendered += [tuple(q[i] for q in yuv) for i in range(len(yuv[0]))]
    shown = y4m_planes(shown_path, dev)
    return (len(frames), counts, secs,
            yuv_gap(shown, rendered, rerender_index(take, FPS)))


def player_phase(dev, card, launches):
    """16. the realtime player on two decoded 1080p30 YUV4MPEG clips: keys,
    clock and trickplay, precache and upload ring, the Y4M sink (K3),
    recording and the re-render."""
    import numpy as np
    import torch

    from lives_tpu_torch.io.decoders import try_decoders
    from lives_tpu_torch.ops import yuv_kernels as yk
    from lives_tpu_torch.scenes import DeviceSyntheticSource

    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"   # the default prefs
    os.environ["LIVES_TPU_FUSED_STATEFUL"] = "0"

    def one_pass(clips, path, clock=None, plain=False, prof=False):
        return player_pass(
            dev, clips, path,
            lambda p: player_setup(p, clips, FPS, PLAYER_EVERY),
            clock=clock, plain=plain, prof=prof)

    yk.build()
    t_phase = time.perf_counter()
    steps = {}   # step -> the host clock at its end
    src = DeviceSyntheticSource(H, W, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        allc, size, secs = write_clips(tmp, src, 2, PLAYER_CLIP_FRAMES)
        clips = (allc[1], allc[2])
        line("16 clips", clips=2, frames=PLAYER_CLIP_FRAMES,
             size=f"{W}x{H}", mb=f"{size / 1e6:.1f}", seconds=f"{secs:.2f}")
        steps["clips"] = time.perf_counter()
        # pass A, scripted clock: plain versions first (they warm the
        # allocator), then the kernels timed, then the kernels profiled
        files = {}
        for label, plain, prof in (("plain", True, False),
                                   ("kernels", False, False),
                                   ("profiled", False, True)):
            path = os.path.join(tmp, f"{label}.y4m")
            p, ms, counts, misses, trace = one_pass(
                clips, path, clock=ScriptedClock(), plain=plain, prof=prof)
            files[label] = path
            runs = counts.pop("runs")
            served = sum(1 for main, _, _ in runs if main)
            want = {k: 0 for k in counts} if plain else player_design(runs)
            assert counts == want, (label, counts, want)
            assert served == p.frames_shown, (served, p.frames_shown)
            cd = try_decoders(path)
            n_file = cd.nframes
            cd.decoder.close()
            assert n_file == p.frames_shown, (n_file, p.frames_shown)
            lat = np.asarray(ms)
            line("16 pass_a", card=repr(card), run=label,
                 cycles=PLAYER_CYCLES, frames_shown=p.frames_shown,
                 frames_dropped=p.frames_dropped, precache_misses=misses[0],
                 warm_runs=len(runs) - served,
                 k2_launches=counts["yuv420_to_rgb"],
                 k3_launches=counts["rgb_to_yuv420"],
                 p50_ms=f"{np.percentile(lat, 50):.3f}",
                 p99_ms=f"{np.percentile(lat, 99):.3f}",
                 max_ms=f"{lat.max():.3f}",
                 file_bytes=os.path.getsize(path))
            if label == "kernels":
                take, take_shown = p.last_recording, p
                take_counts = counts
            if prof:
                busy, top = device_busy(trace)
                names = [e.name for e in trace.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
                n_k2 = sum("yuv420_to_rgb" in n for n in names)
                n_k3 = sum("rgb_to_yuv420" in n for n in names)
                assert (n_k2, n_k3) == (counts["yuv420_to_rgb"],
                                        counts["rgb_to_yuv420"]), \
                    (n_k2, n_k3, counts)
                line("16 profiled", card=repr(card),
                     frames=p.frames_shown,
                     k2_per_frame=f"{n_k2 / p.frames_shown:.3f}",
                     k3_per_frame=f"{n_k3 / p.frames_shown:.3f}",
                     dtoh_per_frame=f"{dtoh_copies(trace) / p.frames_shown:.3f}",
                     wall_ms=f"{trace.wall_ms:.1f}",
                     device_busy_ms=f"{busy:.1f}",
                     busy_share=f"{busy / trace.wall_ms:.3f}",
                     profiler_start_stop_s="{:.2f},{:.2f}".format(
                         *trace.own_s), top=top)
            steps[label] = time.perf_counter()
        plain_bytes = np.fromfile(files["plain"], np.uint8)
        same = {label: np.array_equal(plain_bytes,
                                      np.fromfile(path, np.uint8))
                for label, path in files.items() if label != "plain"}
        del plain_bytes
        line("16 bit_identity", against="plain", **same)
        assert all(same.values()), same
        steps["identity"] = time.perf_counter()
        for k in ("yuv420_to_rgb", "rgb_to_yuv420"):
            launches[k] += take_counts[k]
        # the re-render of the kernels pass's take, on the card
        n, rerender_counts, secs, gap = rerender_gap(
            take_shown, take, clips, files["kernels"], dev)
        line("16 rerender", card=repr(card), frames=n,
             launches=rerender_counts, seconds=f"{secs:.3f}",
             frames_per_s=f"{n / secs:.1f}", max_abs_err=gap,
             bound=PLAYER_RERENDER_BOUND + 1)
        assert gap <= PLAYER_RERENDER_BOUND + 1, gap
        steps["rerender"] = time.perf_counter()
        # pass B: the same performance on the wall clock
        p, _, counts, misses, _ = one_pass(
            clips, os.path.join(tmp, "wall.y4m"))
        runs = counts.pop("runs")
        assert counts == player_design(runs), (counts, player_design(runs))
        ft = np.asarray(p._frame_times) * 1e3
        line("16 pass_b", card=repr(card), cycles=PLAYER_CYCLES,
             frames_shown=p.frames_shown, frames_dropped=p.frames_dropped,
             miss_drops=misses[1], miss_drops_by_mode=misses[2],
             drops_at_s=(f"{misses[3][0][0]:.2f}-{misses[3][-1][0]:.2f}"
                         if misses[3] else "-"),
             backlog_at_drop=(
                 f"p50={np.median([b for _, b, _ in misses[3]]):.0f},"
                 f"max={max(b for _, b, _ in misses[3])}"
                 if misses[3] else "-"),
             farthest_first_drops=sum(f for _, _, f in misses[3]),
             precache_misses=misses[0],
             warm_runs=sum(1 for main, _, _ in runs if not main),
             p50_ms=f"{np.percentile(ft, 50):.3f}",
             p99_ms=f"{np.percentile(ft, 99):.3f}",
             max_ms=f"{ft.max():.3f}")
        steps["pass_b"] = time.perf_counter()
        # the console: a clip played for 3 s into a null sink
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "lives_tpu_torch.cli", "play",
             os.path.join(tmp, "clip1.y4m"), "--fx", "gaussian_blur",
             "--seconds", "3"], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=300)
        status = r.stderr.strip().splitlines()[-1].strip()
        line("16 cli", rc=r.returncode,
             seconds=f"{time.perf_counter() - t0:.1f}", status=repr(status))
        assert r.returncode == 0, r.stderr[-2000:]
        steps["cli"] = time.perf_counter()
        for c in allc.values():
            c.close()
    marks = [t_phase, *steps.values()]
    line("16 wall", seconds=f"{time.perf_counter() - t_phase:.1f}",
         **{k: f"{b - a:.1f}" for k, a, b in zip(steps, marks, marks[1:])})


# -- phase 17: the VJ filters ----------------------------------------------

#: phase 17c's reference-format keymap: (key, Weed hashname, the filter
#: it maps to) lines, keys from 1, each hashname holding its
#: REF_FILTER_MAP fragment first; key 13's crossfade is the
#: autotransition. Keys 1-6 are played. The other six are mapped, not
#: played, because the take would not re-render within the bound in the
#: JAX player either: ripple, warptv and nervous read the clock or the
#: clip's frame number, which the live player and the re-render give them
#: differently, and blurzoom's edge threshold, revtv's trace band and
#: comic's posterize levels are hard selects that turn the 1 LSB between
#: the live path and its re-render (PLAYER_RERENDER_BOUND) into tens of
#: LSB.
VJ_KEYMAP = [(1, "vertigoeffecttv", "vertigo"),
             (2, "rotozoomsalsaman", "rotozoom"),
             (3, "kaleidoscopesalsaman", "kaleidoscope"),
             (4, "bump2dsalsaman", "bump2d"),
             (5, "bumpmapsalsaman", "lens"),
             (6, "tvpicsalsaman", "tvpic"),
             (7, "blurzoomeffecttv", "blurzoom"),
             (8, "revtvsalsaman", "revtv"),
             (9, "comicsalsaman", "comic"),
             (10, "rippletveffecttv", "ripple"),
             (11, "warptveffecttv", "warptv"),
             (12, "nervouseffecttv", "nervous"),
             (13, "simple_blendsalsaman", "crossfade")]
VJ_PLAYED, VJ_AUTOTRANS_KEY = 6, 12
#: the played keys whose filter carries state (vertigo): a take's
#: re-render starts every filter's state afresh at each change of the
#: filter map, where the live player carries it (both packages), so it is
#: on from the start to the first toggle, over no other change
VJ_STATEFUL_KEYS = (0,)
#: phase 17c's toggles, one every PLAYER_EVERY cycles from keys 0-2 on:
#: every played key goes on, only above every key that is on; the
#: toggles inside the autotransition (cycles 72-102) are releases
VJ_ON_AT_START = (0, 1, 2)
VJ_TOGGLES = (0, 3, 1, 2, 4, 5, 3, 4, 5)
#: per-key defaults of phase 17c (key from 0): vertigo, a zoomed and
#: turned rotozoom
VJ_DEFAULTS = {0: {"feedback": 0.6, "speed": 0.7},
               1: {"angle": 0.05, "zoom": 1.25}}


def vj_script(cycles, every):
    """{cycle: [action, ...]} of phase 17c's performance: phase 16's fg
    switch, reversed and nervous spans (`player_script`), and at each
    every-th cycle the next toggle of VJ_TOGGLES (up to three keys on)."""
    acts = {c: [a for a in v if a[0] != "toggle"]
            for c, v in player_script(cycles, every).items()}
    for c, k in zip(range(every, cycles, every), VJ_TOGGLES):
        acts.setdefault(c, []).append(("toggle", k))
    return {c: v for c, v in acts.items() if v}


def write_vj_keymap(path):
    with open(path, "w") as fh:
        fh.writelines(f"{k}|{h}\n" for k, h, _ in VJ_KEYMAP)


def vj_setup(p, clips, fps, every, keymap_path):
    """Phase 17c's set-up on either package's Player: the reference keymap
    loaded (every line mapped), the per-key defaults, the autotransition,
    clips a (fg) and b (bg), precache 8, pipeline 2, fetch groups of 4,
    the seeded nervous generator, VJ_ON_AT_START's keys on, recording on,
    playing.
    Returns the mapped count."""
    import numpy as np
    n = p.keymap.load_reference_keymap(keymap_path)
    for k, vals in VJ_DEFAULTS.items():
        p.keymap.set_key_defaults(k, 0, **vals)
    p.set_autotrans(VJ_AUTOTRANS_KEY, duration=round(1.2 * every) / fps)
    p.state.fg_clip, p.state.bg_clip = clips
    p.precache_depth, p.pipeline_depth, p.fetch_batch = 8, 2, 4
    p._nervous_rng = np.random.default_rng(PLAYER_SEED)
    for k in VJ_ON_AT_START:
        p.key_toggle(k, True)
    p.record_start(clips[0].width, clips[0].height)
    p.start()
    return n


#: phase 17a's stateless filters: geometry.py's 21, motion_blur, edge and
#: the three stateless compounds; the stateful ones, over 8 frames; those
#: whose output is a permutation of the input's pixels (or a copy of a
#: stored one): 0 LSB
VJ_STATELESS = ("flip_horizontal", "flip_vertical", "rotate180", "mirror",
                "pixelate", "rotozoom", "kaleidoscope", "ripple", "lens",
                "rotate", "wave", "swirl", "spread", "shift", "bump2d",
                "tvpic", "emboss", "charcoal", "warptv", "targeted_zoom",
                "revtv", "motion_blur", "edge", "dream", "night_vision",
                "comic")
VJ_STATEFUL = ("blurzoom", "onedtv", "nervous", "feedback", "vertigo", "vhs")
VJ_EXACT = ("flip_horizontal", "flip_vertical", "rotate180", "mirror",
            "shift", "onedtv", "nervous", "noise")


def _vj_params(filt, rng, B, device):
    """Seeded per-frame values of a filter's traced params ((B,) float32
    on `device`), its static params at their defaults."""
    import torch
    return {p.name: (torch.from_numpy(rng.uniform(p.min, p.max, B)
                                      .astype("float32")).to(device)
                     if p.kind == "num" else p.default)
            for p in filt.params}


def vj_filters(dev, card, launches):
    """17. the VJ filters (ROADMAP items 14-15) at 1920x1080 on the card:
    each new filter against the port on the CPU, phase 17b's stateful
    timeline through `render_events`, phase 17c's performance with a
    reference keymap."""
    import numpy as np
    import torch

    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.effects.builtin.geometry import spread_hash
    from lives_tpu_torch.effects.host import (FrameContext, Instance,
                                              apply_instance, get_filter)
    from lives_tpu_torch.events.renderer import render_events
    from lives_tpu_torch.graph import SinkSpec, fused_sweep
    from lives_tpu_torch.io.decoders import try_decoders
    from lives_tpu_torch.layer import Layer
    from lives_tpu_torch.ops import yuv_kernels as yk
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    from lives_tpu_torch.utils import prng
    from lives_tpu_torch.utils.sinf import sinf

    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"   # the default prefs
    os.environ["LIVES_TPU_FUSED_STATEFUL"] = "0"
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    steps = {}

    def ctx_on(device, B, frame0=0, h=H, w=W):
        fr = torch.arange(B, dtype=torch.int32) * 7 + frame0
        return FrameContext(tc=(fr.float() / FPS).to(device),
                            frame=fr.to(device), fps=FPS, width=w,
                            height=h, device=device)

    def gap(a, b):
        return int((a.cpu().int() - b.int()).abs().max())

    # 17a. each filter alone, the card against the CPU
    for name in VJ_STATELESS:
        f = get_filter(name)
        rng = np.random.default_rng(sum(map(ord, name)))
        fr = torch.from_numpy(rng.integers(0, 256, (2, 3, H, W),
                                           dtype=np.uint8))
        pars = _vj_params(f, rng, 2, cpu)
        ins = {d: (fr.to(d), {k: v.to(d) if isinstance(v, torch.Tensor)
                              else v for k, v in pars.items()})
               for d in (dev, cpu)}

        def run(device, B=2):
            frames, p = ins[device]
            lay = Layer(planes=(frames[:B],), palette=int(Palette.RGB24))
            p = {k: v[:B] if isinstance(v, torch.Tensor) else v
                 for k, v in p.items()}
            return f.process([lay], p, ctx_on(device, B)).planes[0]
        err = gap(run(dev), run(cpu))
        ms = time_ms(lambda: run(dev, 1), 5)
        line("17a filter", name=name, frames=2, max_abs_err=err,
             bound=0 if name in VJ_EXACT else 1, card=repr(card),
             ms_per_1080p_frame=f"{ms:.3f}")
        assert err <= (0 if name in VJ_EXACT else 1), (name, err)
    steps["stateless"] = time.perf_counter()
    for name in VJ_STATEFUL:
        f = get_filter(name)
        rng = np.random.default_rng(sum(map(ord, name)))
        fr = torch.from_numpy(rng.integers(0, 256, (8, 3, H, W),
                                           dtype=np.uint8))
        pars = _vj_params(f, rng, 8, cpu)
        # each side its own instance, so its own state
        ins = {side: (d, fr.to(d), {k: v.to(d)
                                    if isinstance(v, torch.Tensor) else v
                                    for k, v in pars.items()},
                      Instance(filter=f))
               for side, d in (("card", dev), ("cpu", cpu))}

        def step(side, b):
            device, frames, p, inst = ins[side]
            inst.values = {k: v[b:b + 1] if isinstance(v, torch.Tensor)
                           else v for k, v in p.items()}
            lay = Layer(planes=(frames[b:b + 1],),
                        palette=int(Palette.RGB24))
            return apply_instance(inst, [lay], ctx_on(device, 1, b))[0] \
                .planes[0]
        err = max(gap(step("card", b), step("cpu", b)) for b in range(8))
        ms = time_ms(lambda: step("card", 7), 5)
        line("17a filter", name=name, frames=8, max_abs_err=err,
             bound=0 if name in VJ_EXACT else 1, card=repr(card),
             ms_per_1080p_frame=f"{ms:.3f}")
        assert err <= (0 if name in VJ_EXACT else 1), (name, err)
    steps["stateful"] = time.perf_counter()
    # noise: frames 0, 1 and 100,000, then its time at 1080p and 4K
    f = get_filter("noise")
    rng = np.random.default_rng(42)
    mono = torch.from_numpy(rng.uniform(0, 1, 3).astype(np.float32))

    def noise(device, frames, h=H, w=W):
        fr = torch.tensor(frames, dtype=torch.int32)
        ctx = FrameContext(tc=(fr.float() / FPS).to(device),
                           frame=fr.to(device), fps=FPS, width=w, height=h,
                           device=device)
        return f.process([], {"mono": mono[:len(frames)].to(device)},
                         ctx).planes[0]
    err = gap(noise(dev, [0, 1, 100_000]), noise(cpu, [0, 1, 100_000]))
    ms = time_ms(lambda: noise(dev, [100_000]), 5)
    ms4k = time_ms(lambda: noise(dev, [100_000], 2160, 3840), 5)
    line("17a filter", name="noise", frames="0,1,100000", max_abs_err=err,
         bound=0, card=repr(card), ms_per_1080p_frame=f"{ms:.3f}",
         ms_per_4k_frame=f"{ms4k:.3f}")
    assert err == 0, err
    # the threefry words and spread's sin twin, bit for bit the CPU's
    g = torch.Generator().manual_seed(17)
    words = torch.randint(0, 2 ** 32, (4, 1 << 20), generator=g,
                          dtype=torch.int64)
    got = prng.threefry_2x32(*words.to(dev))
    ref = prng.threefry_2x32(*words)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
    (k1, k2), (x1, x2), want = ((0x13198A2E, 0x03707344),
                                (0x243F6A88, 0x85A308D3),
                                (0xC4923A9C, 0x483DF7A0))
    kat = tuple(int(v) for v in prng.threefry_2x32(*(
        torch.tensor(v, device=dev) for v in (k1, k2, x1, x2))))
    line("17a threefry", words=2 * words.shape[1], equal_cpu=same,
         known_answer=kat == want)
    assert same and kat == want, (same, kat)
    y = torch.arange(H, dtype=torch.float32)[:, None]
    x = torch.arange(W, dtype=torch.float32)[None, :]
    seed = torch.tensor([[[7.0]]])
    twin = [spread_hash(x.to(d), y.to(d), k, seed.to(d))
            for d in (dev, cpu) for k in (1.0, 2.0)]
    same = all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
               for a, b in zip(twin[:2], twin[2:]))
    arg = (x.to(dev) * 12.9898 + y.to(dev) * 78.233 + 7.317).contiguous()
    ms = time_ms(lambda: sinf(arg), 5)
    line("17a sin_twin", values=2 * H * W, equal_cpu=same, card=repr(card),
         sinf_ms_per_1080p_plane=f"{ms:.3f}")
    assert same
    steps["twins"] = time.perf_counter()

    # 17b. the stateful timeline through render_events
    src = DeviceSyntheticSource(H, W, device=dev)
    sink = SinkSpec(W, H)
    n_chunks = -(-N_FRAMES // CHUNK)
    el = timeline("VJ", N_FRAMES)

    def all_frames(source):
        return torch.cat([lay.planes[0] for _, lay in render_events(
            el, source, sink, batch_size=CHUNK)])
    fused_sweep.MODE_LAUNCHES.update(
        dict.fromkeys(fused_sweep.MODE_LAUNCHES, 0))
    got = all_frames(src)
    counts = {k: v for k, v in fused_sweep.MODE_LAUNCHES.items() if v}
    ref = all_frames(Materialised(src))
    err = gap(got, ref.cpu())
    line("17b vj_timeline", frames=len(got), chunks=n_chunks,
         launches=counts, max_abs_err=err, bound=1,
         beyond_1_lsb=int(((got.int() - ref.int()).abs() > 1).sum()))
    assert counts == {"comp_out": n_chunks, "comp_in": n_chunks}, counts
    assert len(got) == N_FRAMES and err <= 1, err
    del got, ref
    for k in ("comp_out", "comp_in"):
        launches[KERNEL_OF[k]] += counts[k]
    rendered, _, _, wall_s = render_path(el, src, sink, check=False)
    line("17b timed", card=repr(card), frames=rendered,
         wall_s=f"{wall_s:.4f}", frames_per_s=f"{rendered / wall_s:.1f}",
         x_realtime=f"{rendered / wall_s / FPS:.2f}")
    steps["timeline"] = time.perf_counter()

    # 17c. the player with a reference keymap
    yk.build()
    with tempfile.TemporaryDirectory() as tmp:
        allc, size, secs = write_clips(tmp, src, 2, PLAYER_CLIP_FRAMES)
        clips = (allc[1], allc[2])
        keymap = os.path.join(tmp, "default.keymap")
        write_vj_keymap(keymap)
        mapped = []

        def setup(p):
            mapped.append(vj_setup(p, clips, FPS, PLAYER_EVERY, keymap))
        files, res = {}, {}
        for label, plain in (("plain", True), ("kernels", False)):
            path = os.path.join(tmp, f"{label}.y4m")
            p, ms, counts, _, _ = player_pass(
                dev, clips, path, setup, script=vj_script,
                clock=ScriptedClock(), plain=plain)
            files[label], res[label] = path, (p, counts)
            runs = counts.pop("runs")
            want = {k: 0 for k in counts} if plain else player_design(runs)
            assert counts == want, (label, counts, want)
            cd = try_decoders(path)
            assert cd.nframes == p.frames_shown, (cd.nframes, p.frames_shown)
            cd.decoder.close()
            lat = np.asarray(ms)
            line("17c pass", card=repr(card), run=label,
                 keymap_lines=len(VJ_KEYMAP), mapped=mapped[-1],
                 cycles=PLAYER_CYCLES, frames_shown=p.frames_shown,
                 k2_launches=counts["yuv420_to_rgb"],
                 k3_launches=counts["rgb_to_yuv420"],
                 p50_ms=f"{np.percentile(lat, 50):.3f}",
                 p99_ms=f"{np.percentile(lat, 99):.3f}",
                 max_ms=f"{lat.max():.3f}")
            assert mapped[-1] == len(VJ_KEYMAP), mapped
        same = np.array_equal(np.fromfile(files["plain"], np.uint8),
                              np.fromfile(files["kernels"], np.uint8))
        line("17c bit_identity", against="plain", kernels=same)
        assert same
        p, counts = res["kernels"]
        for k in ("yuv420_to_rgb", "rgb_to_yuv420"):
            launches[k] += counts[k]
        n, rerender_counts, secs, err = rerender_gap(
            p, p.last_recording, clips, files["kernels"], dev)
        line("17c rerender", card=repr(card), frames=n,
             launches=rerender_counts, seconds=f"{secs:.3f}",
             frames_per_s=f"{n / secs:.1f}", max_abs_err=err,
             bound=PLAYER_RERENDER_BOUND + 1)
        assert err <= PLAYER_RERENDER_BOUND + 1, err
        for c in allc.values():
            c.close()
    steps["player"] = time.perf_counter()
    marks = [t_phase, *steps.values()]
    line("17 wall", seconds=f"{time.perf_counter() - t_phase:.1f}",
         **{k: f"{b - a:.1f}" for k, a, b in zip(steps, marks, marks[1:])})


# -- phase 18: text and titles ---------------------------------------------

#: phase 18b's titled edit over five decoded tracks: three transitions over
#: tracks 0-3 (K4's prefix), push with track 4 (its amount runs 0 -> 1 over
#: the edit: TITLED_ANIMATE), deinterlace, a censored corner, a title
#: with a background box, a paraffin wash and the grade
TITLED_CHAIN = [
    ("crossfade", {"amount": 0.5}, [0, 1]),
    ("blend_screen", {"amount": 0.5}, [0, 2]),
    ("blend_overlay", {"amount": 0.5}, [0, 3]),
    ("push", {"amount": 0.0}, [0, 4]),
    ("deinterlace", {"amount": 1.0}, [0]),
    ("photo_censor", {"left": 0.62, "top": 0.08, "right": 0.92,
                      "bottom": 0.34, "mode": 0, "block": 16}, [0]),
    ("scribbler", {"text": "LiVES on a GPU\ntitles and subtitles",
                   "size": 64, "mode": 2, "bg_alpha": 0.6}, [0]),
    ("toonz_paraffin", {"angle": 0.25, "offset": 0.3, "softness": 0.4,
                        "density": 0.4}, [0]),
    ("saturation", {"saturation": 1.2}, [0]),
    ("vignette", {"amount": 0.5}, [0])]
TITLED_ANIMATE = 3
TITLED_TRACKS = 5

#: phase 18a's filters at B = 2 with their static values; haip and
#: randomiser at frames 0, 1 and 100,000; puretext, deferred, through its
#: unregistered filter
TITLES_FILTERS = [
    ("livetext", {"text": "live text", "size": 96}),
    ("videowall", {"tiles": 3}), ("push", {}), ("data_processor", {}),
    ("randomiser", {}), ("toonz_light_bloom", {}), ("toonz_paraffin", {}),
    ("toonz_pencil_hatching", {}), ("toonz_coherent_noise", {}),
    ("deinterlace", {}),
    ("scribbler", {"text": "a title\nin two lines", "size": 64, "mode": 2}),
    ("textfun", {}), ("photo_censor", {"block": 24}), ("xeffect", {}),
    ("haip", {}), ("puretext", {"text": "pure text on a card", "mode": 0})]

#: phase 18c's reference-format keymap (key, Weed hashname, the filter it
#: maps to): the four text and wall fragments, and key 5's crossfade as
#: the autotransition. Keys 1-3 are played; textfun (key 4) is a hard
#: select, held in 18a and not played, as revtv and comic are left out
#: of 17c
TITLES_KEYMAP = [(1, "scribblersalsaman", "scribbler"),
                 (2, "videowallsalsaman", "videowall"),
                 (3, "puretextsalsaman", "livetext"),
                 (4, "textfunsalsaman", "textfun"),
                 (5, "simple_blendsalsaman", "crossfade")]
TITLES_AUTOTRANS_KEY = 4
#: toggles every PLAYER_EVERY cycles from key 0 on (a key goes on only
#: above every key that is on; the two inside the autotransition,
#: cycles 72-102, are releases)
TITLES_ON_AT_START = (0,)
TITLES_TOGGLES = (1, 2, 2, 1, 0, 0, 1, 2, 1)
TITLES_DEFAULTS = {0: {"text": "live titles", "size": 72, "mode": 2},
                   2: {"text": "livetext", "size": 120, "red": 1.0,
                       "green": 0.8, "blue": 0.2}}
#: the subtitle pass: its cycles and its .srt (clip time)
SUB_CYCLES = 60
SUB_SRT = ("1\n00:00:00,300 --> 00:00:00,900\nFirst subtitle\n\n"
           "2\n00:00:01,200 --> 00:00:01,800\nSecond subtitle\n"
           "in two lines\n")


class RGBFileSink:
    """A sink that appends each RGB24 frame's bytes to a file (phase 18c's
    subtitle pass: the overlay composites on RGB frames)."""

    def __init__(self, path):
        from lives_tpu_torch.constants import Palette
        self.palette_list = (int(Palette.RGB24),)
        self.path = path
        self._fh = None

    def init_screen(self, width, height, fps):
        self._fh = open(self.path, "wb")

    def play_frame(self, layer, tc):
        from lives_tpu_torch.player.sinks import host_planes
        self._fh.write(host_planes(layer)[0].tobytes())
        return True

    def exit_screen(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def titled_timeline(n_frames, width=W, height=H):
    """Phase 18b's edit: TITLED_CHAIN over TITLED_TRACKS tracks, track t
    playing clip t+1 at frame i % CLIP_FRAMES, push's amount 0 -> 1."""
    from lives_tpu_torch.events.event_list import (EventList,
                                                   TICKS_PER_SECOND,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event,
                                                   param_change_event)
    el = EventList(fps=FPS, width=width, height=height)
    inits = [filter_init_event(0, f, in_tracks=tr, out_tracks=[0],
                               values=v) for f, v, tr in TITLED_CHAIN]
    for e in inits:
        el.insert(e)
    el.insert(filter_map_event(0, [e.event_id for e in inits]))
    tpf = int(TICKS_PER_SECOND / FPS)
    anim = inits[TITLED_ANIMATE].event_id
    el.insert(param_change_event(0, anim, "amount", 0.0))
    el.insert(param_change_event((n_frames - 1) * tpf, anim, "amount", 1.0))
    for i in range(n_frames):
        el.insert(frame_event(i * tpf, list(range(1, TITLED_TRACKS + 1)),
                              [i % CLIP_FRAMES] * TITLED_TRACKS))
    return el


def write_titles_keymap(path):
    with open(path, "w") as fh:
        fh.writelines(f"{k}|{h}\n" for k, h, _ in TITLES_KEYMAP)


def titles_script(cycles, every):
    """{cycle: [action, ...]} of phase 18c: phase 16's fg switch, reversed
    and nervous spans, and TITLES_TOGGLES every `every` cycles."""
    acts = {c: [a for a in v if a[0] != "toggle"]
            for c, v in player_script(cycles, every).items()}
    for c, k in zip(range(every, cycles, every), TITLES_TOGGLES):
        acts.setdefault(c, []).append(("toggle", k))
    return {c: v for c, v in acts.items() if v}


def titles_setup(p, clips, fps, every, keymap_path, record=True):
    """Phase 18c's set-up, as `vj_setup`: the keymap loaded, the per-key
    defaults, the autotransition, clips a (fg) and b (bg), precache 8,
    pipeline 2, fetch groups of 4, the seeded nervous generator, key 0 on,
    recording on (unless not `record`), playing. Returns the mapped
    count."""
    import numpy as np
    n = p.keymap.load_reference_keymap(keymap_path)
    for k, vals in TITLES_DEFAULTS.items():
        # scribbler's "mode" param shares its name with the key's mode
        p.keymap.set_key_defaults(k, 0)
        p.keymap.defaults[(k, 0)].update(vals)
    p.set_autotrans(TITLES_AUTOTRANS_KEY, duration=round(1.2 * every) / fps)
    p.state.fg_clip, p.state.bg_clip = clips
    p.precache_depth, p.pipeline_depth, p.fetch_batch = 8, 2, 4
    p._nervous_rng = np.random.default_rng(PLAYER_SEED)
    for k in TITLES_ON_AT_START:
        p.key_toggle(k, True)
    if record:
        p.record_start(clips[0].width, clips[0].height)
    p.start()
    return n


def _title_params(filt, rng, B, device):
    """Seeded per-frame values of a filter's num params ((B,) float32 on
    `device`; toonz_light_bloom's as numbers, its eager form), the static
    ones at their defaults; a censor rectangle's edges in order."""
    import torch
    out = {}
    for p in filt.params:
        if p.kind != "num":
            out[p.name] = p.default
        elif filt.name == "toonz_light_bloom":
            out[p.name] = float(rng.uniform(p.min, p.max))
        else:
            out[p.name] = torch.from_numpy(
                rng.uniform(p.min, p.max, B).astype("float32")).to(device)
    if filt.name == "photo_censor":
        for lo, hi in (("left", "right"), ("top", "bottom")):
            a, b = out[lo], out[hi]
            out[lo], out[hi] = torch.minimum(a, b), torch.maximum(a, b)
    return out


def titles(dev, card, launches):
    """18. text and titles at 1920x1080 on the card: each new filter
    against the port on the CPU, a titled edit rendered from decoded clips
    under the composite route, the player with the reference keymap's
    text keys and a subtitle pass."""
    import numpy as np
    import torch

    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.effects.builtin import extra, puretext
    from lives_tpu_torch.effects.host import (FrameContext, Instance,
                                              apply_instance, get_filter)
    from lives_tpu_torch.graph import composite
    from lives_tpu_torch.io.decoders import try_decoders
    from lives_tpu_torch.layer import Layer
    from lives_tpu_torch.ops import yuv_kernels as yk
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    from lives_tpu_torch.text import render_text_mask

    os.environ["LIVES_TPU_FUSED_STATEFUL"] = "0"
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    steps = {}

    def ctx_on(device, frames):
        fr = torch.tensor(frames, dtype=torch.int32)
        return FrameContext(tc=(fr.float() / FPS).to(device),
                            frame=fr.to(device), fps=FPS, width=W, height=H,
                            device=device)

    def gap(a, b):
        return int((a.cpu().int() - b.cpu().int()).abs().max())

    def same(a, b):
        return torch.equal(a.cpu(), b.cpu())

    # 18a. each filter alone, the card against the CPU
    for name, static in TITLES_FILTERS:
        # puretext is written and deferred: its filter, unregistered
        f = puretext.FILTER if name == "puretext" else get_filter(name)
        rng = np.random.default_rng(sum(map(ord, name)))
        frames = [0, 1, 100_000] if name in ("haip", "randomiser") else [0, 7]
        B = len(frames)
        fr = [torch.from_numpy(rng.integers(0, 256, (B, 3, H, W),
                                            dtype=np.uint8))
              for _ in range(f.n_in)]
        pars = {**_title_params(f, rng, B, cpu), **static}
        ins = {d: ([x.to(d) for x in fr],
                   {k: v.to(d) if isinstance(v, torch.Tensor) else v
                    for k, v in pars.items()}) for d in (dev, cpu)}

        def run(device, B=B):
            lays, p = ins[device]
            lays = [Layer(planes=(x[:B],), palette=int(Palette.RGB24))
                    for x in lays]
            p = {k: v[:B] if isinstance(v, torch.Tensor) else v
                 for k, v in p.items()}
            inst = Instance(filter=f, values=p,
                            in_tracks=tuple(range(f.n_in)))
            out = apply_instance(inst, lays, ctx_on(device, frames[:B]))
            return out[0].planes[0], inst.out_values
        (a, av), (b, bv) = run(dev), run(cpu)
        err = gap(a, b)
        exact = {}
        if av or bv:   # the analysers' out-values, bit for bit
            exact["out_values"] = av.keys() == bv.keys() and all(
                same(torch.as_tensor(av[k]).float().view(torch.int32),
                     torch.as_tensor(bv[k]).float().view(torch.int32))
                for k in av)
        if name == "haip":
            tr = [extra.haip_trails(torch.tensor(frames).to(d), H, W, d)
                  for d in (dev, cpu)]
            exact["trails"] = all(same(x, y) for x, y in zip(*tr))
        if name == "textfun":
            gl = [extra.textfun_glyphs(
                Layer(planes=(ins[d][0][0],), palette=int(Palette.RGB24)),
                8, len(extra.glyph_atlas(8)))[2] for d in (dev, cpu)]
            exact["glyphs"] = same(*gl)
        if name == "puretext":
            t = torch.linspace(0, 20, 2001).reshape(-1, 1)
            s = torch.linspace(0.05, 10, 2001).reshape(-1, 1)
            exact["letters"] = all(
                all(same(x, y) for x, y in zip(*[puretext.letters(
                    m, t.to(d), s.to(d), puretext._atlas_on(
                        static["text"], 48, W, H, m == 1, str(d)), W, H)
                    for d in (dev, cpu)]))
                for m in range(len(puretext.MODES)))
        ms = time_ms(lambda: run(dev, 1), 5)
        line("18a filter", name=name, frames=",".join(map(str, frames)),
             max_abs_err=err, bound=1, **exact, card=repr(card),
             ms_per_1080p_frame=f"{ms:.3f}")
        assert err <= 1 and all(exact.values()), (name, err, exact)
    steps["filters"] = time.perf_counter()

    # 18b. the titled edit from decoded clips, K4 on its transitions
    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "1"
    src = DeviceSyntheticSource(H, W, device=dev)
    n_chunks = -(-N_FRAMES // CHUNK)
    want = {"yuv420_to_rgb": TITLED_TRACKS * n_chunks,
            "composite": n_chunks, "rgb_to_yuv420": n_chunks}
    el = titled_timeline(N_FRAMES)
    kernels = (yk.yuv420_to_rgb, yk.rgb_to_yuv420, composite.composite)
    with tempfile.TemporaryDirectory() as tmp:
        clips, size, secs = write_clips(tmp, src, TITLED_TRACKS)
        line("18b clips", clips=TITLED_TRACKS, frames=CLIP_FRAMES,
             mb=f"{size / 1e6:.1f}", seconds=f"{secs:.2f}")
        paths = {k: os.path.join(tmp, f"{k}.y4m") for k in ("plain", "kern")}
        yk.yuv420_to_rgb = yk.plain_yuv420_to_rgb
        yk.rgb_to_yuv420 = yk.plain_rgb_to_yuv420
        composite.composite = composite.plain_composite
        try:
            counts, _, _ = decoded_pass(clips, el, paths["plain"], dev)
        finally:
            yk.yuv420_to_rgb, yk.rgb_to_yuv420, composite.composite = \
                kernels
        assert not counts, counts
        for k in range(2):   # the first builds and warms
            counts, wall_s, host_s = decoded_pass(clips, el, paths["kern"],
                                                  dev)
            assert counts == want, (counts, want)
        line("18b titled_edit", card=repr(card), frames=N_FRAMES,
             chunks=n_chunks, launches=counts, wall_s=f"{wall_s:.4f}",
             get_batch_s=f"{host_s:.4f}",
             frames_per_s=f"{N_FRAMES / wall_s:.1f}",
             x_realtime=f"{N_FRAMES / wall_s / FPS:.2f}")
        got, ref = (y4m_planes(paths[k], dev) for k in ("kern", "plain"))
        assert len(got) == len(ref) == N_FRAMES
        err = max(gap(a, b) for x, y in zip(got, ref) for a, b in zip(x, y))
        line("18b vs_plain", frames=N_FRAMES, max_abs_err=err, bound=1)
        assert err <= 1, err
        del got, ref
        for k in ("yuv420_to_rgb", "rgb_to_yuv420", "composite"):
            launches[k] += counts[k]
        for c in clips.values():
            c.close()
    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"   # the default prefs
    steps["titled_edit"] = time.perf_counter()

    # 18c. the player with the reference keymap's text keys
    yk.build()
    with tempfile.TemporaryDirectory() as tmp:
        allc, size, secs = write_clips(tmp, src, 2, PLAYER_CLIP_FRAMES)
        clips = (allc[1], allc[2])
        keymap = os.path.join(tmp, "default.keymap")
        write_titles_keymap(keymap)
        mapped = []

        def setup(p, record=True):
            mapped.append(titles_setup(p, clips, FPS, PLAYER_EVERY, keymap,
                                       record))
            assert [p.keymap.current_filter(k - 1)
                    for k, _, _ in TITLES_KEYMAP] == \
                [name for _, _, name in TITLES_KEYMAP]
        files, res = {}, {}
        for label, plain in (("plain", True), ("kernels", False)):
            path = os.path.join(tmp, f"{label}.y4m")
            p, ms, counts, _, _ = player_pass(
                dev, clips, path, setup, script=titles_script,
                clock=ScriptedClock(), plain=plain)
            files[label], res[label] = path, (p, counts)
            runs = counts.pop("runs")
            want = {k: 0 for k in counts} if plain else player_design(runs)
            assert counts == want, (label, counts, want)
            cd = try_decoders(path)
            assert cd.nframes == p.frames_shown, (cd.nframes, p.frames_shown)
            cd.decoder.close()
            lat = np.asarray(ms)
            line("18c pass", card=repr(card), run=label,
                 keymap_lines=len(TITLES_KEYMAP), mapped=mapped[-1],
                 cycles=PLAYER_CYCLES, frames_shown=p.frames_shown,
                 k2_launches=counts["yuv420_to_rgb"],
                 k3_launches=counts["rgb_to_yuv420"],
                 p50_ms=f"{np.percentile(lat, 50):.3f}",
                 p99_ms=f"{np.percentile(lat, 99):.3f}",
                 max_ms=f"{lat.max():.3f}")
            assert mapped[-1] == len(TITLES_KEYMAP), mapped
        ident = np.array_equal(np.fromfile(files["plain"], np.uint8),
                               np.fromfile(files["kernels"], np.uint8))
        line("18c bit_identity", against="plain", kernels=ident)
        assert ident
        p, counts = res["kernels"]
        for k in ("yuv420_to_rgb", "rgb_to_yuv420"):
            launches[k] += counts[k]
        n, rerender_counts, secs, err = rerender_gap(
            p, p.last_recording, clips, files["kernels"], dev)
        line("18c rerender", card=repr(card), frames=n,
             launches=rerender_counts, seconds=f"{secs:.3f}",
             frames_per_s=f"{n / secs:.1f}", max_abs_err=err,
             bound=PLAYER_RERENDER_BOUND + 1)
        assert err <= PLAYER_RERENDER_BOUND + 1, err
        steps["player"] = time.perf_counter()
        # the subtitle pass: RGB frames, not recorded; each composite
        # changes only rows its mask covers
        srt = os.path.join(tmp, "titles.srt")
        with open(srt, "w") as fh:
            fh.write(SUB_SRT)
        sub_files, outside = {}, {}

        def sub_setup(p):
            setup(p, record=False)
            ov = p.load_subtitles(srt, size=48)
            apply = ov.apply

            def checked(layer, t):
                out = apply(layer, t)
                if out is not layer:
                    text = ov.subs[0].text if t < 1.0 else ov.subs[1].text
                    rows = torch.from_numpy(render_text_mask(
                        text, layer.width, layer.height, size=48)[3]
                        .any(1)).to(dev)
                    moved = (out.planes[0] != layer.planes[0]).any(0).any(1)
                    outside[label].append(int((moved & ~rows).sum()))
                return out
            ov.apply = checked
        for label, plain in (("plain", True), ("kernels", False)):
            path = os.path.join(tmp, f"sub_{label}.rgb")
            outside[label] = []
            p, _, counts, _, _ = player_pass(
                dev, clips, path, sub_setup, script=titles_script,
                clock=ScriptedClock(), plain=plain, cycles=SUB_CYCLES,
                rgb=True)
            sub_files[label] = path
            line("18c subtitles", run=label, cycles=SUB_CYCLES,
                 frames_shown=p.frames_shown,
                 subtitle_frames=len(outside[label]),
                 mask_uploads=p.subtitles.uploads,
                 rows_changed_outside_mask=sum(outside[label]),
                 k2_launches=counts["yuv420_to_rgb"])
            assert outside[label] and not any(outside[label]), outside
        ident = np.array_equal(np.fromfile(sub_files["plain"], np.uint8),
                               np.fromfile(sub_files["kernels"], np.uint8))
        line("18c subtitle_identity", against="plain", kernels=ident)
        assert ident
        for c in allc.values():
            c.close()
    steps["subtitles"] = time.perf_counter()
    marks = [t_phase, *steps.values()]
    line("18 wall", seconds=f"{time.perf_counter() - t_phase:.1f}",
         **{k: f"{b - a:.1f}" for k, a, b in zip(steps, marks, marks[1:])})


# -- phase 19: the MJPEG lanes ---------------------------------------------

#: the PSNR the JAX package holds its q90 round trip to
#: (tests/test_jpeg_encode.py:92-104), and the share of coefficients that
#: may flip by 1 between two computations of the coefficient stage (its
#: bound against its float64 twin, tests/test_jpeg_encode.py:56-57)
MJPEG_PSNR_DB, COEF_FLIP_SHARE = 30.0, 2e-3


def sync(dev):
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def write_mjpeg_clips(tmp, src, n_clips=TRACKS, frames=CLIP_FRAMES):
    """Config D's clips as MJPEG AVIs in `tmp`, each written by the
    "mjpeg" encoder (`MJPEGDeviceEncoder`, q90) from one (frames, 3, H, W)
    chunk of the source's clip c on its device, opened with `open_clip`:
    ({c: Clip}, bytes, s in the encoder). No frame may be written with its
    ACs cut at the encoder's pool."""
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.io.encoders import get_encoder
    clips, size, secs = {}, 0, 0.0
    for c in range(1, n_clips + 1):
        rgb = src.get_batch([c] * frames, range(frames)).planes[0]
        path = os.path.join(tmp, f"clip{c}.avi")
        enc = get_encoder("mjpeg")
        sync(rgb.device)
        t0 = time.perf_counter()
        assert enc.encode(path, [rgb], FPS)
        secs += time.perf_counter() - t0
        assert enc.overflows == 0, (path, enc.overflows)
        size += os.path.getsize(path)
        clips[c] = open_clip(path, os.path.join(tmp, "work"))
        clips[c].unique_id = c  # the timeline's clip ids
    return clips, size, secs


def product_events():
    """The decoder's and the encoder's block products (the lanes' two
    float64 GEMMs between two casts, `jpeg_ingest.block_products`, which
    `jpeg_encode` imports), each call bracketed by CUDA events on the
    current stream: (the pairs by stage, a function that restores the
    two)."""
    import torch

    from lives_tpu_torch.io import jpeg_encode as je
    from lives_tpu_torch.io import jpeg_ingest as ji
    pairs = {"decode": [], "encode": []}
    saved = ji.block_products, je.block_products

    def timed(key, fn):
        def run(*a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a)
            ev[1].record()
            pairs[key].append(ev)
            return out
        return run

    def restore():
        ji.block_products, je.block_products = saved
    ji.block_products = timed("decode", saved[0])
    je.block_products = timed("encode", saved[1])
    return pairs, restore


def mjpeg_pass(clips, el, out_path, dev):
    """One render of `el` from MJPEG `clips` through `MJPEGMultiClipSource`
    into `out_path` by `render_to_encoder` with its default encoder (an
    MJPEG AVI), every launch count set to 0 just before it and read just
    after: (non-zero counts, wall s, the source, the encoder
    `render_to_encoder` made)."""
    from lives_tpu_torch import transcode
    from lives_tpu_torch.graph import composite, fused_sweep, stateful_sweep
    from lives_tpu_torch.io.jpeg_ingest import MJPEGMultiClipSource
    from lives_tpu_torch.ops import yuv_kernels
    made, get_encoder = [], transcode.get_encoder

    def keep(name):
        made.append(get_encoder(name))
        return made[-1]
    fused_sweep.MODE_LAUNCHES.update(
        dict.fromkeys(fused_sweep.MODE_LAUNCHES, 0))
    stateful_sweep.LAUNCHES = 0
    yuv_kernels.LAUNCHES.update(dict.fromkeys(yuv_kernels.LAUNCHES, 0))
    composite.LAUNCHES = 0
    msrc = MJPEGMultiClipSource(clips, el.width, el.height, device=dev)
    transcode.get_encoder = keep
    try:
        sync(dev)
        t0 = time.perf_counter()
        assert transcode.render_to_encoder(el, msrc, out_path,
                                           batch_size=CHUNK)
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        transcode.get_encoder = get_encoder
    counts = {**fused_sweep.MODE_LAUNCHES,
              "stateful": stateful_sweep.LAUNCHES,
              **yuv_kernels.LAUNCHES, "composite": composite.LAUNCHES}
    (enc,) = made
    assert enc.name == "mjpeg", enc.name
    return {k: v for k, v in counts.items() if v}, wall, msrc, enc


def source_batches(src, el, dev, n_frames) -> float:
    """s to fetch the source batches of the timeline's first `n_frames`
    frames as the renderer asks for them: one `get_batch` a track a chunk
    of CHUNK frames."""
    import numpy as np
    evs = el.frame_events()[:n_frames]
    sync(dev)
    t0 = time.perf_counter()
    for k in range(0, len(evs), CHUNK):
        ids = np.array([e.clips for e in evs[k:k + CHUNK]])
        nums = np.array([e.frames for e in evs[k:k + CHUNK]])
        for t in range(ids.shape[1]):
            src.get_batch(ids[:, t].tolist(), nums[:, t].tolist())
    sync(dev)
    return time.perf_counter() - t0


def avi_frames_rgb(path, dev, k, n):
    """Frames [k, k + n) of an MJPEG AVI decoded back through the port's
    ingest lane onto `dev`, as (n, 3, H, W) RGB24."""
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.io.decoders import try_decoders
    from lives_tpu_torch.io.jpeg_ingest import JpegStreamSource
    from lives_tpu_torch.ops.colorspace import convert_layer
    dec = try_decoders(path).decoder
    try:
        jsrc = JpegStreamSource([dec.get_frame_bytes(i)
                                 for i in range(k, k + n)], device=dev)
        lay = jsrc.get_batch_planes(range(n))
        assert jsrc.fallbacks == 0, jsrc.fallbacks
    finally:
        dec.close()
    return convert_layer(lay, Palette.RGB24).planes[0]


def psnr(a, b):
    """PSNR in dB of each frame of two (B, C, H, W) u8 tensors."""
    mse = ((a.double() - b.double()) ** 2).mean(dim=(1, 2, 3))
    return 10 * (255.0 ** 2 / mse.clamp(min=1e-12)).log10()


def mjpeg_card_vs_cpu(dev, card):
    """19a: the encoder and the decoder on the card against the CPU on
    four 1080p frames of config D's source; the wires packed on the card
    from the CPU's coefficients against the CPU's; the lane's products in
    full precision whatever the process's TF32 switch."""
    import numpy as np
    import torch

    from lives_tpu_torch.io import jpeg_encode as je
    from lives_tpu_torch.io import jpeg_ingest as ji
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    cpu = torch.device("cpu")
    B = 4
    rgb = DeviceSyntheticSource(H, W, device=dev).get_batch(
        [1, 2, 3, 4], [0, 5, 10, 15]).planes[0]
    encs = {d: je.JpegDeviceEncoder(W, H, quality=90, batch=B, device=d)
            for d in (dev, cpu)}
    (dcd, acd), (dcc, acc) = (encs[d].coefs(rgb.to(d)) for d in (dev, cpu))
    d = torch.cat([(dcd.cpu().int() - dcc.int()).abs().reshape(-1),
                   (acd.cpu() - acc).abs().reshape(-1)])
    flips, worst = int((d > 0).sum()), int(d.max())
    wires, lay3 = {}, encs[cpu].clayout
    lay2 = je.WireLayout(lay3.nb, lay3.capacity, lay3.esc_cap)
    for v, pack, lay in (("v2", je.pack_wire, lay2),
                         ("v3", je.pack_compact, lay3)):
        got = pack(dcc.to(dev), acc.to(dev), lay).cpu()
        wires[v] = pack(dcc, acc, lay)
        assert torch.equal(got, wires[v]), f"{v} wire differs on the card"
    head = wires["v3"][:8 * B].numpy()
    v3_used = encs[cpu].clayout.used(int(head[:4 * B].view(np.int32).sum()),
                                     int(head[4 * B:].view(np.int32).sum()))
    line("19a encoder", card=repr(card), size=f"{W}x{H}", frames=B,
         quality=90, coefficients=d.numel(), flips=flips,
         flip_share=f"{flips / d.numel():.3g}", max_abs_err=worst,
         wires_identical="v2,v3", v2_bytes_per_frame=lay2.total,
         v3_bytes_per_frame=v3_used // B, raw_rgb_bytes=W * H * 3,
         raw_yuv420_bytes=W * H * 3 // 2)
    assert worst <= 1 and flips / d.numel() < COEF_FLIP_SHARE, (worst, flips)
    # the decoder, on the CPU encoder's JPEG frames
    jpegs = encs[cpu].encode_batch(rgb.cpu())
    srcs = {dd: ji.JpegStreamSource(jpegs, device=dd) for dd in (dev, cpu)}
    lays = {dd: s.get_batch_planes(range(B)) for dd, s in srcs.items()}
    refs = [ji.decode_frame_ref(ji.read_coefficients(j)) for j in jpegs]
    gaps = []
    for k, (pd, pc) in enumerate(zip(lays[dev].planes, lays[cpu].planes)):
        ref = torch.from_numpy(np.stack(
            [r[k][:pd.shape[1], :pd.shape[2]] for r in refs]))
        gaps.append((int((pd.cpu().int() - pc.int()).abs().max()),
                     int((pd.cpu().int() - ref.int()).abs().max())))
    line("19a decoder", card=repr(card), frames=B,
         jpeg_bytes_per_frame=sum(map(len, jpegs)) // B,
         wire_bytes_per_frame=srcs[dev].wire_bytes_per_frame(),
         card_vs_cpu=max(g for g, _ in gaps),
         card_vs_twin=max(g for _, g in gaps),
         fallbacks=srcs[dev].fallbacks)
    assert max(max(g) for g in gaps) <= 1 and srcs[dev].fallbacks == 0, gaps
    # full precision: the lane is the same with the process's TF32 switch
    # on, where a float32 product would move
    A64 = torch.from_numpy(ji._idct_basis(np.float64)).to(dev)
    co = encs[dev].coefs(rgb)[1][0, :512].float()     # up to 512 blocks
    blocks = torch.cat([co.new_full((co.shape[0], 1), 100.0), co], 1) \
        .view(-1, 8, 8) * 16.0
    exact = A64 @ blocks.double() @ A64.T
    torch.set_float32_matmul_precision("high")
    try:
        lane = ji.block_products(A64, blocks, A64.T)
        f32 = A64.float() @ blocks @ A64.float().T
        tf32_lays = srcs[dev].get_batch_planes(range(B))
        tf32_co = encs[dev].coefs(rgb)
    finally:
        torch.set_float32_matmul_precision("highest")
    rel = float(((lane.double() - exact).abs() / exact.abs().max()).max())
    rel32 = float(((f32.double() - exact).abs() / exact.abs().max()).max())
    same = all(torch.equal(a, b) for a, b in
               zip(tf32_lays.planes, lays[dev].planes)) and \
        torch.equal(tf32_co[1], acd) and torch.equal(tf32_co[0], dcd)
    line("19a precision", card=repr(card), tf32_switch="on",
         lane_rel_err=f"{rel:.3g}", float32_product_rel_err=f"{rel32:.3g}",
         bound=f"{2 ** -23:.3g}", lane_unchanged=same)
    assert rel <= 2 ** -23 and same, (rel, same)


def mjpeg_phase(dev, card, launches):
    """19. the MJPEG lanes at 1920x1080: card against CPU per module;
    config D from MJPEG clips into the default encoder's AVI; the player on
    MJPEG clips through the compressed lane."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lives_tpu_torch import native
    from lives_tpu_torch.events.renderer import ClipFrameSource
    from lives_tpu_torch.io import jpeg_encode as je
    from lives_tpu_torch.io import jpeg_ingest as ji
    from lives_tpu_torch.io.decoders import try_decoders
    from lives_tpu_torch.ops import yuv_kernels as yk
    from lives_tpu_torch.scenes import DeviceSyntheticSource

    native.load_all(["yuv420", "composite"])
    t0 = time.perf_counter()
    native.load_jpegcoef()
    built = native._LOADED["jpegcoef"]
    line("19 jpegcoef", lib=built.path.name, libjpeg=repr(built.libjpeg),
         seconds=f"{built.seconds:.2f}",
         load_s=f"{time.perf_counter() - t0:.2f}")
    os.environ["LIVES_TPU_FUSED_STATEFUL"] = "0"
    t_phase = time.perf_counter()
    steps = {}
    mjpeg_card_vs_cpu(dev, card)
    steps["card_vs_cpu"] = time.perf_counter()

    # 19b. config D from MJPEG clips into the default encoder's AVI
    src = DeviceSyntheticSource(H, W, device=dev)
    n_chunks = -(-N_FRAMES // CHUNK)
    want = {"yuv420_to_rgb": TRACKS * n_chunks, "composite": n_chunks}
    el = config_d_timeline(N_FRAMES)
    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        clips, size, secs = write_mjpeg_clips(tmp, src)
        n_enc = TRACKS * CLIP_FRAMES
        line("19b clips", card=repr(card), clips=TRACKS, frames=CLIP_FRAMES,
             mb=f"{size / 1e6:.1f}", bytes_per_frame=size // n_enc,
             encode_s=f"{secs:.3f}", encode_frames_per_s=f"{n_enc / secs:.1f}")
        steps["clips"] = time.perf_counter()
        paths, walls = [], []
        for run in range(2):
            paths.append(os.path.join(tmp, f"render{run}.avi"))
            counts, wall, msrc, enc = mjpeg_pass(clips, el, paths[-1], dev)
            walls.append(wall)
            line("19b render", card=repr(card), run=run, frames=N_FRAMES,
                 launches=counts, host_decoded=msrc.host_decoded,
                 fallbacks=msrc.fallbacks, encoder_overflows=enc.overflows,
                 wall_s=f"{wall:.4f}", frames_per_s=f"{N_FRAMES / wall:.1f}",
                 bytes=os.path.getsize(paths[-1]))
            assert counts == want, counts
            assert msrc.host_decoded == msrc.fallbacks == enc.overflows == 0
        for k in want:
            launches[k] += counts[k]
        cd = try_decoders(paths[0])
        assert (cd.nframes, cd.width, cd.height, cd.decoder.fourcc) == \
            (N_FRAMES, W, H, "MJPG"), (cd.nframes, cd.width, cd.height)
        cd.decoder.close()
        steps["render"] = time.perf_counter()
        # the wall split: each stage timed with a synchronise around it
        split = dict.fromkeys(("entropy_s", "decode_s", "source_s",
                               "encode_s", "dtoh_s", "host_encode_s",
                               "htod_bytes", "dtoh_bytes"), 0.0)
        rendered = []
        saved = (ji.JpegStreamSource.entropy_pack, ji.build_device_decoder,
                 ji.MJPEGMultiClipSource.get_batch,
                 je.JpegDeviceEncoder.encode_batch, je.JpegDeviceEncoder._fetch,
                 je.write_jpeg_packed)

        def timed(key, fn, before=False):
            def run(*a, **kw):
                if before:
                    sync(dev)
                t = time.perf_counter()
                out = fn(*a, **kw)
                sync(dev)
                split[key] += time.perf_counter() - t
                return out
            return run

        def entropy(self, idx):
            out = saved[0](self, idx)
            split["htod_bytes"] += sum(t.nbytes for t in out[0])
            return out

        def decoder(*a, **kw):
            return timed("decode_s", saved[1](*a, **kw), before=True)

        def encode_batch(self, frames):
            if int(frames.shape[0]) == self.batch:
                rendered.append(frames.clone())
            return saved[3](self, frames)

        def fetch(self, buf):
            raw = saved[4](self, buf)
            split["dtoh_bytes"] += raw.nbytes + 8 * self.clayout.B
            return raw
        ji.JpegStreamSource.entropy_pack = timed("entropy_s", entropy)
        ji.build_device_decoder = decoder
        ji.MJPEGMultiClipSource.get_batch = timed("source_s", saved[2])
        je.JpegDeviceEncoder.encode_batch = timed("encode_s", encode_batch)
        je.JpegDeviceEncoder._fetch = timed("dtoh_s", fetch, before=True)
        je.write_jpeg_packed = timed("host_encode_s", saved[5])
        try:
            split_path = os.path.join(tmp, "split.avi")
            _, split_wall, msrc, enc = mjpeg_pass(clips, el, split_path,
                                                  dev)
        finally:
            (ji.JpegStreamSource.entropy_pack, ji.build_device_decoder,
             ji.MJPEGMultiClipSource.get_batch,
             je.JpegDeviceEncoder.encode_batch, je.JpegDeviceEncoder._fetch,
             je.write_jpeg_packed) = saved
        assert msrc.host_decoded == msrc.fallbacks == enc.overflows == 0
        blobs = [open(p, "rb").read() for p in (*paths, split_path)]
        line("19b identity", files=len(blobs),
             identical=all(b == blobs[0] for b in blobs))
        assert all(b == blobs[0] for b in blobs)
        s = split
        htod_s = s["source_s"] - s["entropy_s"] - s["decode_s"]
        line("19b split", card=repr(card), frames=N_FRAMES,
             wall_s=f"{split_wall:.4f}", entropy_pack_s=f"{s['entropy_s']:.4f}",
             htod_mb=f"{s['htod_bytes'] / 1e6:.1f}",
             htod_and_convert_s=f"{htod_s:.4f}",
             device_decode_s=f"{s['decode_s']:.4f}",
             chain_s=f"{split_wall - s['source_s'] - s['encode_s']:.4f}",
             device_encode_s=f"{s['encode_s'] - s['dtoh_s'] - s['host_encode_s']:.4f}",
             dtoh_mb=f"{s['dtoh_bytes'] / 1e6:.1f}",
             dtoh_s=f"{s['dtoh_s']:.4f}",
             host_entropy_encode_s=f"{s['host_encode_s']:.4f}")
        # each written frame, decoded back through the ingest lane,
        # against the frame the encoder was handed
        frames = torch.cat(rendered)[:N_FRAMES]
        worst = min(float(psnr(avi_frames_rgb(paths[0], dev, k, CHUNK),
                               frames[k:k + CHUNK]).min())
                    for k in range(0, N_FRAMES, CHUNK))
        del frames, rendered
        line("19b psnr", frames=N_FRAMES, min_db=f"{worst:.2f}",
             bound=MJPEG_PSNR_DB)
        assert worst >= MJPEG_PSNR_DB, worst
        steps["split"] = time.perf_counter()
        # the device's activity only (a host trace of the pass takes
        # longer to read back than the pass)
        pairs, restore = product_events()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, prof_wall, msrc, enc = mjpeg_pass(clips, el, split_path,
                                                     dev)
        finally:
            restore()
        assert msrc.host_decoded == msrc.fallbacks == enc.overflows == 0
        busy, top = device_busy(prof)
        line("19b profiled", card=repr(card), wall_ms=f"{prof_wall * 1e3:.1f}",
             device_busy_ms=f"{busy:.1f}",
             idle_share=f"{1 - busy / (prof_wall * 1e3):.3f}",
             dtoh_copies=dtoh_copies(prof), top=top)
        # the float64 GEMMs of the trace, and the block products split by
        # stage with the events around each call (the GEMMs and casts)
        gemm = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "gemm_f64" in e.name) / 1e3
        stage = {k: sum(a.elapsed_time(b) for a, b in v)
                 for k, v in pairs.items()}
        line("19b products", card=repr(card), trace_f64_gemm_ms=f"{gemm:.1f}",
             decode_ms=f"{stage['decode']:.1f}",
             decode_calls=len(pairs["decode"]),
             encode_ms=f"{stage['encode']:.1f}",
             encode_calls=len(pairs["encode"]))
        assert len(pairs["decode"]) and len(pairs["encode"]), pairs
        steps["profiled"] = time.perf_counter()
        # the compressed lane against the host lane (PIL decode, upload)
        # on the first chunk, in turns lane, host, lane (the host lane is
        # the slow one: a full decode of each frame on the host)
        lane = ji.MJPEGMultiClipSource(clips, W, H, device=dev)
        host = ClipFrameSource(clips, device=dev)
        rates = {}
        for name, s_ in (("lane", lane), ("host", host), ("lane", lane)):
            rates.setdefault(name, []).append(
                CHUNK / source_batches(s_, el, dev, CHUNK))
        line("19b sources", card=repr(card), frames=CHUNK, tracks=TRACKS,
             lane_frames_per_s=",".join(f"{r:.1f}" for r in rates["lane"]),
             host_frames_per_s=",".join(f"{r:.1f}" for r in rates["host"]),
             lane_over_host=f"{min(rates['lane']) / rates['host'][0]:.2f}")
        assert lane.host_decoded == 0
        steps["sources"] = time.perf_counter()
        os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"   # the default prefs

        # 19c. the player on two of the MJPEG clips
        pclips = (clips[1], clips[2])
        decoded = {"lane": 0, "host": 0}

        def count(key, fn, frames):
            def run(*a, **kw):
                decoded[key] += frames(a)
                return fn(*a, **kw)
            return run
        for c in pclips:
            dec = c.cdata.decoder
            dec.get_frames_device = count("lane", dec.get_frames_device,
                                          lambda a: len(a[0]))
            c.get_frame = count("host", c.get_frame, lambda a: 1)
        yk.build()
        files = {}
        for label, plain, prof in (("plain", True, False),
                                   ("kernels", False, False),
                                   ("profiled", False, True)):
            decoded.update(lane=0, host=0)
            path = os.path.join(tmp, f"{label}.y4m")
            p, ms, counts, misses, trace = player_pass(
                dev, pclips, path,
                lambda p: player_setup(p, pclips, FPS, PLAYER_EVERY),
                clock=ScriptedClock(), plain=plain, prof=prof)
            files[label] = path
            runs = counts.pop("runs")
            want = {k: 0 for k in counts} if plain else player_design(runs)
            assert counts == want, (label, counts, want)
            lat = np.asarray(ms)
            extra = {}
            if prof:
                busy, _ = device_busy(trace)
                extra = dict(wall_ms=f"{trace.wall_ms:.1f}",
                             device_busy_ms=f"{busy:.1f}",
                             busy_share=f"{busy / trace.wall_ms:.3f}")
            line("19c pass", card=repr(card), run=label, cycles=PLAYER_CYCLES,
                 frames_shown=p.frames_shown, lane_frames=decoded["lane"],
                 host_decodes=decoded["host"], lane_errors=p.lane_errors,
                 inline_decodes=misses[0],
                 k2_launches=counts["yuv420_to_rgb"],
                 k3_launches=counts["rgb_to_yuv420"],
                 p50_ms=f"{np.percentile(lat, 50):.3f}",
                 p99_ms=f"{np.percentile(lat, 99):.3f}",
                 max_ms=f"{lat.max():.3f}", **extra)
            assert decoded["lane"] > 0 and decoded["host"] == 0 \
                and p.lane_errors == 0, (decoded, p.lane_errors)
            if label == "kernels":
                for k in ("yuv420_to_rgb", "rgb_to_yuv420"):
                    launches[k] += counts[k]
        plain_bytes = np.fromfile(files["plain"], np.uint8)
        same = {label: np.array_equal(plain_bytes, np.fromfile(path, np.uint8))
                for label, path in files.items() if label != "plain"}
        line("19c bit_identity", against="plain", **same)
        assert all(same.values()), same
        steps["player"] = time.perf_counter()
        for c in clips.values():
            c.close()
    marks = [t_phase, *steps.values()]
    line("19 wall", seconds=f"{time.perf_counter() - t_phase:.1f}",
         **{k: f"{b - a:.1f}" for k, a, b in zip(steps, marks, marks[1:])})


# -- phase 20: data connections ----------------------------------------------

#: phase 20a's filters, the slice's 25, with the values fixed in every
#: call (the other num params draw seeded per-frame values in range)
DATA_FILTERS = [
    ("motion_mask", {}), ("farneback_analyser", {}),
    ("fg_bg_removal", {"type": 1}), ("alpha_visualizer", {}),
    ("vector_visualiser", {}), ("alpha_to_grey", {}),
    ("blank_frame_detector", {}), ("alpha_means", {}), ("histogram", {}),
    ("edge_analyser", {}), ("motion_analyser", {}), ("scene_change", {}),
    ("spot_tracker", {}), ("template_tracker", {}),
    ("haar_analyser", {"nco": 40}), ("data_unpacker", {}), ("log_sig", {}),
    ("data_counter", {}), ("nn_programmer", {}), ("smoother", {}),
    ("integrator", {}), ("timer", {}), ("depth_key", {}),
    ("image_stabilizer", {}), ("neural_net", {})]
#: out-values held bit for bit between the card and the CPU (the others
#: within DATA_REL of the larger magnitude); every integer or boolean value
#: and state is exact too
DATA_EXACT = {"blank", "histogram", "cut", "sig_y", "sig_u", "sig_v", "x",
              "y", "out0", "out1", "out2", "out3", "was_reset"}
DATA_REL = 1e-5
#: phase 20b's wired chains, in chain order: (filter, values, in_tracks)
#: and the channel edges between them (src, out-channel, dst, slot)
WIRED_CHAIN = [("fg_bg_removal", {"threshold": 0.05}, [0]),
               ("alpha_means", {}, [0]),
               ("motion_mask", {"threshold": 0.03}, [0]),
               ("mask_overlay", {}, [0, 1]),
               ("farneback_analyser", {"scale": 4.0}, [0]),
               ("vector_visualiser", {"scale": 1.0}, [0]),
               ("image_stabilizer", {"strength": 1.0}, [0])]
WIRED_CCONX = [(0, "mask", 1, 0), (2, "mask", 3, 0), (4, "flow_x", 5, 0),
               (4, "flow_y", 5, 1)]
#: phase 20c's keys: key -> (filter, per-key defaults); key 0's mask
#: feeds key 1 (cconx), key 2's mean_r feeds key 3's amount (pconx,
#: autoscale)
DATA_KEYS = {0: ("motion_mask", {"threshold": 0.04}),
             1: ("mask_overlay", {}), 2: ("alpha_means", {}),
             3: ("vignette", {})}


def wired_timeline(n_frames):
    """Phase 20b's timeline: `WIRED_CHAIN` recorded as init events, the
    channel wiring as `cconx` props on each destination's init (as the
    JAX player's `_annotate_rec_cconx` writes them), tracks 0 and 1
    playing clips 1 and 2 at frame i % CLIP_FRAMES."""
    from lives_tpu_torch.events.event_list import (EventList,
                                                   TICKS_PER_SECOND,
                                                   filter_init_event,
                                                   filter_map_event,
                                                   frame_event)
    el = EventList(fps=FPS, width=W, height=H)
    inits = [filter_init_event(0, f, in_tracks=tr, out_tracks=[0],
                               values=v) for f, v, tr in WIRED_CHAIN]
    for si, name, di, slot in WIRED_CCONX:
        inits[di].props.setdefault("cconx", []).append(
            [inits[si].event_id, name, slot])
    for e in inits:
        el.insert(e)
    el.insert(filter_map_event(0, [e.event_id for e in inits]))
    tpf = int(TICKS_PER_SECOND / FPS)
    for i in range(n_frames):
        el.insert(frame_event(i * tpf, [1, 2], [i % CLIP_FRAMES] * 2))
    return el


def data_script(cycles, every):
    """{cycle: [action, ...]} of phase 20c: phase 16's reversed and
    nervous spans, no key toggle and no fg switch. The renderer starts a
    segment, with fresh instances, where the filter map or the clips a
    frame plays change, so a stateful filter (motion_mask) kept on across
    either re-renders its first frame there from a fresh state, in both
    packages (a hard switch measured 192 LSB at that one frame)."""
    acts = {c: [a for a in v if a[0] not in ("toggle", "switch")]
            for c, v in player_script(cycles, every).items()}
    return {c: v for c, v in acts.items() if v}


def data_setup(p, clips, map_path, record=True, data=None):
    """Phase 20c's set-up: `DATA_KEYS` on and their wiring (mask_overlay
    over the fg and bg tracks), the connections saved to `map_path` with
    `save_datacons` and loaded back with `load_datacons` as the player's
    `datacons`; clips a (fg) and b (bg), precache 8, pipeline 2, fetch
    groups of 4, the seeded nervous generator, recording on, playing.
    `data` is the `effects.data` module of the player's package (the
    port's by default)."""
    import numpy as np
    if data is None:
        from lives_tpu_torch.effects import data
    for k, (name, vals) in DATA_KEYS.items():
        p.keymap.set_key(k, 0, name)
        if vals:
            p.keymap.set_key_defaults(k, 0, **vals)
        p.key_toggle(k, True)
    i = p.keymap.instances
    dc = data.DataConnections()
    dc.add_channel(i[0], "mask", i[1], 0)
    dc.add(i[2], "mean_r", i[3], "amount", autoscale=True)
    data.save_datacons(dc, p.keymap, map_path)
    p.datacons = data.load_datacons(p.keymap, map_path)
    p.state.fg_clip, p.state.bg_clip = clips
    p.precache_depth, p.pipeline_depth, p.fetch_batch = 8, 2, 4
    p._nervous_rng = np.random.default_rng(PLAYER_SEED)
    if record:
        p.record_start(clips[0].width, clips[0].height)
    p.start()


def _data_params(filt, rng, B, device):
    """Seeded per-frame values of a filter's num params ((B,) float32 on
    `device`), the other kinds at their defaults."""
    import torch
    return {p.name: torch.from_numpy(rng.uniform(p.min, p.max, B).astype(
        "float32")).to(device) if p.kind == "num" else p.default
        for p in filt.params}


def _alpha_inputs(name, rng, B):
    """Seeded alpha planes (B, H, W) for a filter's alpha in-slots, with
    their palettes: an A8 mask, or AFLOAT flow or depth."""
    import numpy as np
    import torch

    from lives_tpu_torch.constants import Palette
    if name in ("alpha_visualizer", "alpha_means"):
        return [(torch.from_numpy(rng.integers(0, 256, (B, H, W),
                                               dtype=np.uint8)),
                 int(Palette.A8))]
    if name == "vector_visualiser":
        return [(torch.from_numpy(rng.normal(0, 3, (B, H, W)).astype(
            np.float32)), int(Palette.AFLOAT)) for _ in range(2)]
    if name == "depth_key":
        return [(torch.from_numpy(rng.uniform(0, 1, (B, H, W)).astype(
            np.float32)), int(Palette.AFLOAT))]
    return []


def _values_held(name, got, ref):
    """Every out-value of the card (`got`) against the CPU's (`ref`):
    (worst relative difference of the float ones, all exact ones equal)."""
    import torch
    worst, same = 0.0, True
    assert set(got) == set(ref), (name, sorted(got), sorted(ref))
    for k in ref:
        a, b = torch.as_tensor(got[k]).cpu(), torch.as_tensor(ref[k])
        if k in DATA_EXACT or not b.is_floating_point():
            same = same and torch.equal(a, b)
        else:
            d = (a.double() - b.double()).abs().max().item()
            worst = max(worst, d / max(1.0, b.double().abs().max().item()))
    return worst, same


def _states_held(got, ref):
    """(worst relative float difference, integer leaves equal) of two
    states."""
    import torch
    if got is None:
        return 0.0, ref is None
    if isinstance(got, dict):
        parts = [_states_held(got[k], ref[k]) for k in ref]
    elif isinstance(got, tuple):
        parts = [_states_held(g, r) for g, r in zip(got, ref)]
    else:
        a, b = got.cpu(), ref
        if not b.is_floating_point():
            return 0.0, torch.equal(a, b)
        d = (a.double() - b.double()).abs().max().item()
        return d / max(1.0, b.double().abs().max().item()), True
    return max((w for w, _ in parts), default=0.0), all(s for _, s in parts)


def datacons_phase(dev, card, launches):
    """20. data connections at 1920x1080 on the card: the slice's 25
    filters alone against the port on the CPU, a wired render from
    decoded clips, the player with a wired keymap."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.effects.builtin import alpha as alpha_mod
    from lives_tpu_torch.effects.host import (_REGISTRY, FILTER_STATEFUL,
                                              FrameContext, Instance,
                                              apply_instance, get_filter)
    from lives_tpu_torch.io.decoders import try_decoders
    from lives_tpu_torch.layer import Layer
    from lives_tpu_torch.ops import yuv_kernels as yk
    from lives_tpu_torch.scenes import DeviceSyntheticSource

    os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"   # the default prefs
    os.environ["LIVES_TPU_FUSED_STATEFUL"] = "0"
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    steps = {}

    def ctx_on(device, frames):
        fr = torch.tensor(frames, dtype=torch.int32)
        return FrameContext(tc=(fr.float() / FPS).to(device),
                            frame=fr.to(device), fps=FPS, width=W, height=H,
                            device=device)

    def lsb(a, b):
        return int((a.cpu().int() - b.cpu().int()).abs().max())

    # 20a. each filter alone, the card against the CPU
    for name, static in DATA_FILTERS:
        f = get_filter(name)
        stateful = bool(f.flags & FILTER_STATEFUL)
        rng = np.random.default_rng(sum(map(ord, name)))
        B = 2
        fr = [torch.from_numpy(rng.integers(0, 256, (B, 3, H, W),
                                            dtype=np.uint8))
              for _ in range(max(f.n_in, 1))]
        alphas = _alpha_inputs(name, rng, B)
        pars = {**_data_params(f, rng, B, cpu), **static}
        ins = {d: ([x.to(d) for x in fr],
                   [(a.to(d), pal) for a, pal in alphas],
                   {k: v.to(d) if isinstance(v, torch.Tensor) else v
                    for k, v in pars.items()}) for d in (dev, cpu)}

        def run(device, sel, state=None):
            lays, al, p = ins[device]
            lays = [Layer(planes=(x[sel],), palette=int(Palette.RGB24))
                    for x in lays]
            a = {j: Layer(planes=(x[sel],), palette=pal)
                 for j, (x, pal) in enumerate(al)}
            p = {k: v[sel] if isinstance(v, torch.Tensor) else v
                 for k, v in p.items()}
            inst = Instance(filter=f, values=p, state=state,
                            in_tracks=tuple(range(f.n_in)))
            out = apply_instance(inst, lays, ctx_on(device, list(range(B))[
                sel]), alpha_ins=a or None)
            return out[0].planes[0], inst
        sels = [slice(0, 1), slice(1, 2)] if stateful else [slice(0, B)]
        st = {dev: None, cpu: None}
        err = chan_err = 0
        worst, same = 0.0, True
        for sel in sels:
            (a, ia), (b, ib) = run(dev, sel, st[dev]), run(cpu, sel, st[cpu])
            st[dev], st[cpu] = ia.state, ib.state
            err = max(err, lsb(a, b))
            w, s = _values_held(name, ia.out_values, ib.out_values)
            worst, same = max(worst, w), same and s
            for k, lay in ib.out_channels.items():
                got = ia.out_channels[k].planes[0]
                if lay.palette == int(Palette.A8):
                    chan_err = max(chan_err, lsb(got, lay.planes[0]))
                else:
                    d = (got.cpu() - lay.planes[0]).abs().max().item()
                    chan_err = max(chan_err, d / max(
                        1.0, lay.planes[0].abs().max().item()))
            if stateful:
                w, s = _states_held(st[dev], st[cpu])
                worst, same = max(worst, w), same and s
        state1 = st[dev]
        ms = time_ms(lambda: run(dev, sels[-1], state1 if stateful
                                 else None), 5)
        line("20a filter", name=name, frames=B, max_abs_err=err, bound=1,
             out_values_rel=f"{worst:.3g}", exact_values=same,
             channels_err=f"{chan_err:.3g}", card=repr(card),
             ms_per_1080p_frame=f"{ms * (1 if stateful else 1 / B):.3f}")
        assert err <= 1 and same and worst <= DATA_REL and chan_err <= 1, \
            (name, err, same, worst, chan_err)
    steps["filters"] = time.perf_counter()

    # 20b. the wired render from decoded clips: K2 twice a chunk, K3 once,
    # no K1, K4 or K5; its first frames against the same render on the CPU
    src = DeviceSyntheticSource(H, W, device=dev)
    n_chunks = -(-N_FRAMES // CHUNK)
    want = {"yuv420_to_rgb": 2 * n_chunks, "rgb_to_yuv420": n_chunks}
    el = wired_timeline(N_FRAMES)
    gates = []   # each frame's vector_visualiser gate, (1, H, W) on the host
    vv = _REGISTRY["vector_visualiser"]

    def gated(ins, p, ctx):
        if ins[1] is not None and ins[2] is not None:
            sm_h, sm_w = max(H // 20, 1), max(W // 20, 1)
            sc = torch.as_tensor(p["scale"], dtype=torch.float32,
                                 device=ins[0].device).reshape(-1, 1, 1)
            vx, vy = (alpha_mod._cells(
                (a.planes[0].to(torch.float32) * sc)[
                    :, sm_h::2 * sm_h, sm_w::2 * sm_w],
                2 * sm_h, 2 * sm_w, H, W) for a in ins[1:3])
            gates.append(
                (torch.sqrt(alpha_mod.fma32(vx, vx, vy * vy)) > 0.25).cpu())
        return vv.process(ins, p, ctx)
    with tempfile.TemporaryDirectory() as tmp:
        clips, size, secs = write_clips(tmp, src, 2)
        line("20b clips", clips=2, frames=CLIP_FRAMES, mb=f"{size / 1e6:.1f}",
             seconds=f"{secs:.2f}")
        import dataclasses
        _REGISTRY["vector_visualiser"] = dataclasses.replace(vv,
                                                             process=gated)
        try:
            for k in range(2):   # the first warms
                gates.clear()
                out = os.path.join(tmp, "wired.y4m")
                counts, wall_s, host_s = decoded_pass(clips, el, out, dev)
                assert counts == want, (counts, want)
            line("20b wired_render", card=repr(card), frames=N_FRAMES,
                 chunks=n_chunks, launches=counts, wall_s=f"{wall_s:.4f}",
                 get_batch_s=f"{host_s:.4f}",
                 frames_per_s=f"{N_FRAMES / wall_s:.1f}",
                 x_realtime=f"{N_FRAMES / wall_s / FPS:.2f}")
            for kname in ("yuv420_to_rgb", "rgb_to_yuv420"):
                launches[kname] += counts[kname]
            # the same render's first 4 frames on the CPU port
            from lives_tpu_torch.events.renderer import ClipFrameSource
            from lives_tpu_torch.transcode import render_to_encoder
            card_gates = gates[:4]
            gates.clear()
            short = wired_timeline(4)
            cpu_out = os.path.join(tmp, "wired_cpu.y4m")
            t0 = time.perf_counter()
            assert render_to_encoder(short, ClipFrameSource(clips,
                                                            device=cpu),
                                     cpu_out, encoder="yuv4mpeg",
                                     batch_size=4)
            cpu_s = time.perf_counter() - t0
        finally:
            _REGISTRY["vector_visualiser"] = vv
        got = y4m_planes(out, dev)[:4]
        ref = y4m_planes(cpu_out, dev)
        flips = [(g ^ c)[0] for g, c in zip(card_gates, gates)]
        worst, outside = 0, 0
        for (gp, rp), flip in zip(zip(got, ref), flips):
            for k, (a, b) in enumerate(zip(gp, rp)):
                d = (a.int() - b.int()).abs().cpu()
                m = flip if k == 0 else flip[::2, ::2]
                outside += int(((d > 1) & ~m[:d.shape[0], :d.shape[1]])
                               .sum())
                worst = max(worst, int(d.max()))
        line("20b vs_cpu", frames=4, max_abs_err=worst, bound=1,
             gate_flip_pixels=int(sum(int(f.sum()) for f in flips)),
             beyond_bound_outside_flips=outside, cpu_s=f"{cpu_s:.2f}")
        assert outside == 0, outside
        for c in clips.values():
            c.close()
    steps["wired_render"] = time.perf_counter()

    # 20c. the player with a wired keymap, the connections through
    # datacons.map
    yk.build()
    with tempfile.TemporaryDirectory() as tmp:
        allc, size, secs = write_clips(tmp, src, 2, PLAYER_CLIP_FRAMES)
        clips = (allc[1], allc[2])
        map_path = os.path.join(tmp, "datacons.map")
        files, res = {}, {}
        for label, plain, prof in (("plain", True, False),
                                   ("kernels", False, False),
                                   ("again", False, False),
                                   ("profiled", False, True)):
            path = os.path.join(tmp, f"{label}.y4m")
            p, ms, counts, _, trace = player_pass(
                dev, clips, path, lambda p: data_setup(p, clips, map_path),
                script=data_script, clock=ScriptedClock(), plain=plain,
                prof=prof)
            files[label], res[label] = path, (p, counts)
            runs = counts.pop("runs")
            want = {k: 0 for k in counts} if plain else player_design(runs)
            assert counts == want, (label, counts, want)
            assert p.datacons is not None and p._cconx_sig() == \
                ((0, "mask", 1, 0),)
            cd = try_decoders(path)
            assert cd.nframes == p.frames_shown, (cd.nframes, p.frames_shown)
            cd.decoder.close()
            lat = np.asarray(ms)
            extra = {}
            if prof:
                busy, top = device_busy(trace)
                n_dtoh = dtoh_copies(trace)
                pageable = sum(
                    1 for e in trace.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name.startswith("Memcpy HtoD (Pageable"))
                extra = dict(
                    dtoh_copies=n_dtoh, htod_pageable_copies=pageable,
                    dtoh_per_cycle=f"{n_dtoh / PLAYER_CYCLES:.3f}",
                    wall_ms=f"{trace.wall_ms:.1f}",
                    device_busy_ms=f"{busy:.1f}",
                    busy_share=f"{busy / trace.wall_ms:.3f}", top=top)
            line("20c pass", card=repr(card), run=label,
                 cycles=PLAYER_CYCLES, frames_shown=p.frames_shown,
                 k2_launches=counts["yuv420_to_rgb"],
                 k3_launches=counts["rgb_to_yuv420"],
                 p50_ms=f"{np.percentile(lat, 50):.3f}",
                 p99_ms=f"{np.percentile(lat, 99):.3f}",
                 max_ms=f"{lat.max():.3f}", **extra)
        plain_bytes = np.fromfile(files["plain"], np.uint8)
        same = {label: np.array_equal(plain_bytes,
                                      np.fromfile(path, np.uint8))
                for label, path in files.items() if label != "plain"}
        line("20c bit_identity", against="plain", **same)
        assert all(same.values()), same
        p, counts = res["kernels"]
        for k in ("yuv420_to_rgb", "rgb_to_yuv420"):
            launches[k] += counts[k]
        take = p.last_recording
        wired = [e for e in take.events if e.props.get("cconx")]
        n, rerender_counts, secs, err = rerender_gap(
            p, take, clips, files["kernels"], dev)
        line("20c rerender", card=repr(card), frames=n,
             wired_inits=len(wired), launches=rerender_counts,
             seconds=f"{secs:.3f}", frames_per_s=f"{n / secs:.1f}",
             max_abs_err=err, bound=PLAYER_RERENDER_BOUND)
        assert len(wired) == 1 and err <= PLAYER_RERENDER_BOUND, \
            (len(wired), err)
        for c in allc.values():
            c.close()
    steps["player"] = time.perf_counter()
    marks = [t_phase, *steps.values()]
    line("20 wall", seconds=f"{time.perf_counter() - t_phase:.1f}",
         **{k: f"{b - a:.1f}" for k, a, b in zip(steps, marks, marks[1:])})


# ---------------------------------------------------------------------------
# 21. the clip editor
# ---------------------------------------------------------------------------

#: phase 21's clips (frames), each script's range, the frames the CPU
#: renders of the rendered effect and of the transcode (their first
#: batch), the audio rate, the PNG sink's cycles and the scrap take's
EDIT_FRAMES, EDIT_SCRIPT_FRAMES, EDIT_CPU_FRAMES = 96, 12, 32
EDIT_CPU_TRANSCODE = 16
EDIT_ARATE, EDIT_SINK_CYCLES, EDIT_SCRAP_CYCLES = 48000, 30, 60
#: phase 21a's scripts, card against CPU: (name, parameters, flips are
#: values more than 1 LSB apart and must be 0)
EDIT_SCRIPTS = (("sepia", {}), ("swirl", {}), ("posterize", {"levels": 3}),
                ("transition_bwthresh", {"thresh": 0.45}),
                ("jumble", {"seed": 21}))


def dir_tree(d) -> dict:
    """{relative path: bytes} of every file under a directory."""
    d = Path(d)
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def editor_audio(seconds):
    """A seeded 48 kHz stereo track: float32 (n, 2)."""
    import numpy as np
    rng = np.random.default_rng(21)
    t = np.arange(int(seconds * EDIT_ARATE)) / EDIT_ARATE
    tone = 0.4 * np.sin(2 * np.pi * 440.0 * t)
    return np.stack([tone, 0.5 * tone], 1).astype(np.float32) \
        + rng.normal(0.0, 0.02, (len(t), 2)).astype(np.float32)


def editor_clip(path, workdir, wav=None, uid=None):
    """`open_clip` of a YUV4MPEG file into `workdir`, with the audio a WAV
    rips (through `WavDecoder`) and a set unique_id."""
    from lives_tpu_torch.io.clips import open_clip
    from lives_tpu_torch.io.decoders import try_decoders
    c = open_clip(str(path), workdir)
    if wav is not None:
        cd = try_decoders(str(wav))
        assert cd.decoder.rip_audio(str(c.audio_path))
        c.achans, c.arate = cd.achans, cd.arate
    if uid is not None:
        c.unique_id = uid
    c.save_header()
    return c


def png_gap(a, b, frames=None):
    """(max |diff|, values more than 1 LSB apart, frames whose PNG bytes
    differ though their pixels are equal) over the image frames of two
    clips."""
    import numpy as np
    from PIL import Image
    worst, flips, bytes_off = 0, 0, 0
    for n in (range(a.frames) if frames is None else frames):
        if a.is_virtual_frame(n) or b.is_virtual_frame(n):
            assert a.is_virtual_frame(n) == b.is_virtual_frame(n), n
            continue
        x = np.asarray(Image.open(a.image_path(n))).astype(np.int16)
        y = np.asarray(Image.open(b.image_path(n))).astype(np.int16)
        d = np.abs(x - y)
        worst, flips = max(worst, int(d.max())), flips + int((d > 1).sum())
        if not d.any() and a.image_path(n).read_bytes() != \
                b.image_path(n).read_bytes():
            bytes_off += 1
    return worst, flips, bytes_off


def clipedit_phase(dev, card, launches):
    """21. the clip editor at 1920x1080, 30 fps: rendered effects and
    scripts, clip edits with undo, transcode and the encoders, the
    player's PNG sink and scrap capture; card against CPU throughout."""
    import numpy as np
    import torch

    from lives_tpu_torch import audioedit, clipedit, resample, rfx
    from lives_tpu_torch import rfx_scripts
    from lives_tpu_torch.effects.host import instantiate
    from lives_tpu_torch.events.renderer import render_recording
    from lives_tpu_torch.graph import FrameGraph, SinkSpec, composite
    from lives_tpu_torch.io.clips import read_rgb_batch
    from lives_tpu_torch.io.decoders import PIL_SECONDS, try_decoders
    from lives_tpu_torch.io.encoders import get_encoder
    from lives_tpu_torch.io.genclip import GeneratorClip
    from lives_tpu_torch.layer import Layer
    from lives_tpu_torch.ops import yuv_kernels as yk
    from lives_tpu_torch.player import CollectSink, Player
    from lives_tpu_torch.player import player as player_mod
    from lives_tpu_torch.player.sinks import PNGSink
    from lives_tpu_torch.scenes import DeviceSyntheticSource
    from lives_tpu_torch.transcode import transcode

    yk.build()
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    steps = {}
    batches = -(-EDIT_FRAMES // 32)   # the entry points' batch of 32
    at_start = dict(launches)

    def zero():
        yk.LAUNCHES.update(dict.fromkeys(yk.LAUNCHES, 0))
        composite.LAUNCHES = 0
        torch.cuda.synchronize()
        return time.perf_counter(), dict(PIL_SECONDS)

    def read(start):
        """(K2, K3, K4 launches, wall s, PIL share of it) since `start`."""
        torch.cuda.synchronize()
        t0, pil0 = start
        wall = time.perf_counter() - t0
        pil = sum(PIL_SECONDS[k] - pil0[k] for k in PIL_SECONDS)
        return (yk.LAUNCHES["yuv420_to_rgb"], yk.LAUNCHES["rgb_to_yuv420"],
                composite.LAUNCHES, wall, pil / wall)

    src = DeviceSyntheticSource(H, W, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        made, size, secs = write_clips(str(tmp), src, 2, EDIT_FRAMES)
        paths = {c: made[c].source_uri for c in made}
        for c in made.values():
            c.close()
        wav = tmp / "audio.wav"
        assert get_encoder("wav").encode(
            str(wav), [], FPS, editor_audio(EDIT_FRAMES / FPS), EDIT_ARATE)
        line("21 inputs", clips=2, frames=EDIT_FRAMES,
             mb=f"{size / 1e6:.1f}", seconds=f"{secs:.2f}",
             wav_bytes=wav.stat().st_size)

        def pair(k, name, audio=False, uid=None):
            """Clip k opened twice: for the card and for the CPU."""
            return tuple(editor_clip(paths[k], tmp / name / side,
                                     wav if audio else None, uid or k)
                         for side in ("card", "cpu"))

        # 21a. a rendered effect with a per-frame ramp, its undo; scripts
        a, a_cpu = pair(1, "a", audio=True)
        before = dir_tree(a.clip_dir)
        ramp = {"saturation": lambda f: 0.5 + f / EDIT_FRAMES}
        mark = zero()
        assert rfx.apply_rendered_effect(a, "saturation", 0, EDIT_FRAMES,
                                         values=ramp, device=dev) \
            == EDIT_FRAMES
        k2, k3, k4, wall, pil = read(mark)
        assert (k2, k3, k4) == (batches, 0, 0), (k2, k3, k4)
        launches["yuv420_to_rgb"] += k2
        t0 = time.perf_counter()
        rfx.apply_rendered_effect(a_cpu, "saturation", 0, EDIT_CPU_FRAMES,
                                  values=ramp, device=cpu)
        cpu_s = time.perf_counter() - t0
        worst, flips, bytes_off = png_gap(a, a_cpu, range(EDIT_CPU_FRAMES))
        line("21a rendered_effect", card=repr(card), frames=EDIT_FRAMES,
             k2=k2, batches=batches, wall_s=f"{wall:.3f}",
             frames_per_s=f"{EDIT_FRAMES / wall:.1f}",
             pil_share=f"{pil:.3f}", frames_vs_cpu=EDIT_CPU_FRAMES,
             cpu_s=f"{cpu_s:.2f}", max_abs_err=worst, bound=1,
             png_bytes_differing_at_equal_pixels=bytes_off)
        assert worst <= 1 and bytes_off == 0
        assert rfx.undo_rendered_effect(a)
        assert rfx.undo_rendered_effect(a_cpu)
        assert dir_tree(a.clip_dir) == before, "undo changed the tree"
        line("21a undo", files=len(before), tree="byte for byte")
        for name, params in EDIT_SCRIPTS:
            s, s_cpu = pair(1, name)
            kw = dict(params)
            if name == "transition_bwthresh":
                o, o_cpu = pair(2, name + "_other")
            mark = zero()
            n = rfx_scripts.apply_script(
                s, name, 0, EDIT_SCRIPT_FRAMES, device=dev,
                **({"other": o} if name.startswith("transition") else {}),
                **kw)
            k2, _, _, wall, pil = read(mark)
            t0 = time.perf_counter()
            rfx_scripts.apply_script(
                s_cpu, name, 0, EDIT_SCRIPT_FRAMES, device=cpu,
                **({"other": o_cpu} if name.startswith("transition")
                   else {}), **kw)
            cpu_s = time.perf_counter() - t0
            launches["yuv420_to_rgb"] += k2
            worst, flips, bytes_off = png_gap(s, s_cpu,
                                              range(EDIT_SCRIPT_FRAMES))
            order = ""
            if name == "jumble":
                want = np.random.default_rng(kw["seed"]).integers(
                    0, EDIT_SCRIPT_FRAMES, EDIT_SCRIPT_FRAMES)
                fresh, _ = pair(1, "jumble_src")
                ref = read_rgb_batch(fresh, range(EDIT_SCRIPT_FRAMES),
                                     dev).cpu()
                got = read_rgb_batch(s, range(EDIT_SCRIPT_FRAMES),
                                     dev).cpu()
                assert all(torch.equal(got[i], ref[int(j)])
                           for i, j in enumerate(want)), "jumble order"
                order = "equal"
            line("21a script", card=repr(card), name=name, frames=n,
                 k2=k2, wall_s=f"{wall:.3f}", cpu_s=f"{cpu_s:.2f}",
                 max_abs_err=worst, flips=flips,
                 png_bytes_differing_at_equal_pixels=bytes_off,
                 **({"order": order} if order else {}))
            assert worst <= 1 and flips == 0 and bytes_off == 0, name
        steps["rendered_effects"] = time.perf_counter()

        # 21b. copy + paste, merge on both routes, undo and redo, resample,
        # reverse, the audio ops
        b, b_cpu = pair(2, "b", audio=True)
        mark = zero()
        cb = clipedit.copy_frames(b, 0, 24, device=dev)
        k2, _, _, wall, _ = read(mark)
        assert k2 == 1, k2
        launches["yuv420_to_rgb"] += k2
        cb_cpu = clipedit.copy_frames(b_cpu, 0, 24, device=cpu)
        assert all(int(np.abs(x.astype(np.int16) - y).max()) <= 1
                   for x, y in zip(cb.frames, cb_cpu.frames))
        np.testing.assert_array_equal(cb.audio, cb_cpu.audio)
        clipedit.paste_insert(a, 48, cb)
        clipedit.paste_insert(a_cpu, 48, cb_cpu)
        line("21b paste", frames=len(cb), at=48, clip_frames=a.frames,
             k2_copy=k2, copy_s=f"{wall:.3f}")
        for pref in ("1", "0"):
            os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = pref
            probe = FrameGraph([instantiate("crossfade")], SinkSpec())
            comp_n = probe._composite_len(
                [Layer(planes=(torch.zeros((1, 3, H, W), dtype=torch.uint8,
                                           device=dev),))] * 2)
            pre = dir_tree(a.clip_dir)
            mark = zero()
            n = clipedit.merge_clipboard(a, cb, "crossfade", 24, 72,
                                         device=dev)
            k2, _, k4, wall, pil = read(mark)
            merged = dir_tree(a.clip_dir)
            t0 = time.perf_counter()
            clipedit.merge_clipboard(a_cpu, cb_cpu, "crossfade", 24, 72,
                                     device=cpu)
            cpu_s = time.perf_counter() - t0
            worst, flips, bytes_off = png_gap(a, a_cpu, range(24, 72))
            want_k4 = -(-n // 32) if comp_n else 0
            line("21b merge", card=repr(card), pref=pref, frames=n, k2=k2,
                 k4=k4, k4_route=want_k4, composite_prefix=comp_n,
                 wall_s=f"{wall:.3f}", frames_per_s=f"{n / wall:.1f}",
                 pil_share=f"{pil:.3f}", cpu_s=f"{cpu_s:.2f}",
                 max_abs_err=worst, flips=flips,
                 png_bytes_differing_at_equal_pixels=bytes_off)
            assert k4 == want_k4 and worst <= 1 and bytes_off == 0
            launches["yuv420_to_rgb"] += k2
            launches["composite"] += k4
            for want, what in ((pre, "undo"), (merged, "redo")):
                assert clipedit.undo_edit(a)
                keep = {k: v for k, v in dir_tree(a.clip_dir).items()
                        if not k.startswith(clipedit.EDIT_UNDO_DIR)}
                assert keep == {k: v for k, v in want.items()
                                if not k.startswith(clipedit.EDIT_UNDO_DIR)
                                }, what
            line("21b undo_redo", pref=pref, files=len(merged),
                 trees="byte for byte")
        os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"
        for c in (a, a_cpu):
            resample.resample_clip_fps(c, 25.0)
            resample.reverse_clip(c)
        assert (a.frames, a.fps) == (a_cpu.frames, a_cpu.fps)
        np.testing.assert_array_equal(a.frame_index, a_cpu.frame_index)
        worst, flips, _ = png_gap(a, a_cpu)
        line("21b resample_reverse", frames=a.frames, fps=a.fps,
             max_abs_err=worst)
        assert worst <= 1
        extra = editor_audio(0.5)
        for c in (a, a_cpu):
            audioedit.fade_in(c, 1.0)
            audioedit.normalize(c)
            audioedit.insert_silence(c, 0.5, 1.0)
            audioedit.append_audio(c, extra, EDIT_ARATE)
        assert a.audio_path.read_bytes() == a_cpu.audio_path.read_bytes()
        assert (a.clip_dir / "header.lives").read_bytes() == \
            (a_cpu.clip_dir / "header.lives").read_bytes()
        line("21b audioedit", ops=4, samples=len(a.read_audio()),
             audio="sample-exact")
        steps["edits"] = time.perf_counter()

        # 21c. transcode into YUV4MPEG with audio; the PNG and PDF encoders
        t, t_cpu = pair(1, "t", audio=True)
        chain = lambda: [instantiate("gaussian_blur"),   # noqa: E731
                         instantiate("vignette")]
        out = tmp / "out.y4m"
        mark = zero()
        assert transcode(t, str(out), chain=chain(), include_audio=True,
                         device=dev)
        k2, k3, k4, wall, _ = read(mark)
        assert (k2, k3, k4) == (batches, batches, 0), (k2, k3, k4)
        launches["yuv420_to_rgb"] += k2
        launches["rgb_to_yuv420"] += k3
        cpu_out = tmp / "cpu.y4m"
        t0 = time.perf_counter()
        assert transcode(t_cpu, str(cpu_out), chain=chain(),
                         end=EDIT_CPU_TRANSCODE, include_audio=True,
                         batch_size=EDIT_CPU_TRANSCODE, device=cpu)
        cpu_s = time.perf_counter() - t0
        got, ref = y4m_planes(str(out), dev), y4m_planes(str(cpu_out), dev)
        assert len(got) == EDIT_FRAMES and len(ref) == EDIT_CPU_TRANSCODE
        worst = max(int((x.int() - y.int()).abs().max())
                    for g, r in zip(got, ref) for x, y in zip(g, r))
        same_wav = out.with_suffix(".wav").read_bytes() == \
            cpu_out.with_suffix(".wav").read_bytes()
        line("21c transcode", card=repr(card), frames=EDIT_FRAMES,
             batches=batches, k2=k2, k3=k3, wall_s=f"{wall:.3f}",
             frames_per_s=f"{EDIT_FRAMES / wall:.1f}",
             max_abs_err=worst, bound=1, frames_vs_cpu=EDIT_CPU_TRANSCODE,
             cpu_s=f"{cpu_s:.2f}",
             wav="byte for byte" if same_wav else "DIFFERS")
        assert worst <= 1 and same_wav
        for enc, dst in (("pngseq", tmp / "seq"), ("pdf", tmp / "o.pdf")):
            mark = zero()
            assert transcode(t, str(dst), enc, end=8, device=dev)
            k2, _, _, wall, pil = read(mark)
            launches["yuv420_to_rgb"] += k2
            if enc == "pngseq":
                cd = try_decoders(str(dst))
                ok = (cd.nframes, cd.width, cd.height) == (8, W, H)
            else:
                raw = dst.read_bytes()
                ok = raw.startswith(b"%PDF") and \
                    raw.count(b"/Type /Page\n") == 8
            line("21c encoder", card=repr(card), encoder=enc, frames=8,
                 k2=k2, wall_s=f"{wall:.3f}", pil_share=f"{pil:.3f}",
                 ok=ok)
            assert ok, enc
        cli_clip, _ = pair(2, "cli")
        cmd = [sys.executable, "-m", "lives_tpu_torch.cli", "rfx", "sepia",
               str(cli_clip.clip_dir), "--end", "8", "--device", str(dev)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        line("21c cli_rfx", rc=res.returncode, seconds=
             f"{time.perf_counter() - t0:.1f}", out=repr(res.stdout.strip()))
        assert res.returncode == 0 and "sepia: 8 frames" in res.stdout, \
            res.stderr[-2000:]
        steps["transcode"] = time.perf_counter()

        # 21d. the player: a PNG sink; a take of a stateful generator with
        # scrap capture
        saved_time = player_mod.time
        clock = ScriptedClock()
        player_mod.time = clock
        try:
            sink_dir = tmp / "sink"
            p = Player(PNGSink(sink_dir), SinkSpec(), fps=FPS, device=dev)
            p.async_compile = False
            p.state.fg_clip = editor_clip(paths[1], tmp / "play")
            p.keymap.set_key(0, 0, "vignette")
            p.key_toggle(0, True)
            p.start()
            mark = zero()
            for c in range(EDIT_SINK_CYCLES):
                p.process_one()
                clock.now = (c + 1) / FPS
            k2, k3, _, wall, pil = read(mark)
            p.stop()
            written = len(list(sink_dir.glob("*.png")))
            line("21d png_sink", card=repr(card), cycles=EDIT_SINK_CYCLES,
                 frames=written, k2=k2, wall_s=f"{wall:.3f}",
                 pil_share=f"{pil:.3f}")
            assert written == p.sink.n == EDIT_SINK_CYCLES
            launches["yuv420_to_rgb"] += k2
            clock.now = 0.0
            gen = GeneratorClip("beat_rings", W, H, fps=FPS, device=dev)
            sink = CollectSink()
            p = Player(sink, SinkSpec(width=W, height=H), fps=FPS,
                       device=dev)
            p.async_compile = False
            p.scrap_dir = str(tmp / "work")
            cycle_ms = []
            t0 = time.perf_counter()
            el = scrap_take(p, gen, EDIT_SCRAP_CYCLES, FPS, clock,
                            ms=cycle_ms)
            take_s = time.perf_counter() - t0
        finally:
            player_mod.time = saved_time
        cycle_ms.sort()
        uid, scrap = next(iter(p.rec_scrap_clips.items()))
        refs = [e for e in el.events if e.type.name == "FRAME"]
        assert [(e.clips[0], e.frames[0]) for e in refs] == \
            [(uid, i) for i in range(EDIT_SCRAP_CYCLES)]
        assert scrap.frames == EDIT_SCRAP_CYCLES
        frames, _ = render_recording(el, p.recording_uid_map(),
                                     batch_size=8, device=dev)
        shown = torch.from_numpy(np.stack(sink.frames))
        rr = torch.from_numpy(frames[rerender_index(el, FPS)])
        db = float(psnr(rr, shown).min())
        line("21d scrap_take", card=repr(card), cycles=EDIT_SCRAP_CYCLES,
             scrap_frames=scrap.frames, refs=len(refs),
             take_s=f"{take_s:.2f}",
             cycle_ms_p50=f"{cycle_ms[len(cycle_ms) // 2]:.2f}",
             cycle_ms_max=f"{cycle_ms[-1]:.2f}", rerender_min_psnr_db=
             f"{db:.2f}", bound_db=SCRAP_PSNR_DB)
        assert db >= SCRAP_PSNR_DB, db
        scrap.close()
        steps["player"] = time.perf_counter()
    marks = [t_phase, *steps.values()]
    line("21 launches", card=repr(card), **{
        k: launches[k] - at_start[k]
        for k in ("yuv420_to_rgb", "rgb_to_yuv420", "composite")})
    line("21 wall", seconds=f"{time.perf_counter() - t_phase:.1f}",
         **{k: f"{b - a:.1f}" for k, a, b in zip(steps, marks, marks[1:])})


def synced_calls(fn):
    """(fn's result, the synchronizing CUDA calls it made, as the warnings
    of torch's sync debug mode)."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]


def render_events_of(el, src, sink):
    """The main path's chunks through the user's entry point."""
    from lives_tpu_torch.events.renderer import render_events
    return render_events(el, src, sink, batch_size=CHUNK)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from lives_tpu_torch import native
    from lives_tpu_torch.events.event_list import EventList
    from lives_tpu_torch.events.renderer import (render_events,
                                                 render_to_arrays)
    from lives_tpu_torch.graph import (SinkSpec, composite, fused_sweep,
                                       stateful_sweep)
    from lives_tpu_torch.effects.host import FILTER_STATEFUL
    from lives_tpu_torch.ops import fma_chain, yuv_kernels
    from lives_tpu_torch.scenes import (DeviceSyntheticSource,
                                        multitrack_timeline)

    os.environ["LIVES_TPU_FUSED_STATEFUL"] = "0"
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    line("1 device", torch=torch.__version__, cuda=torch.version.cuda,
         name=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count())
    if argv == ["--config-d"]:
        config_d_alone(dev, card)
        return 0
    if argv == ["--colour"]:
        colour_alone(dev, card)
        return 0
    if argv == ["--roofline"]:
        roofline(dev, card)
        return 0
    if argv == ["--live"]:
        live(dev, card)
        return 0
    if argv == ["--guard"]:
        guard(dev, card)
        return 0
    if argv == ["--player"]:
        player_phase(dev, card, dict.fromkeys(NAMES, 0))
        return 0
    if argv == ["--mjpeg"]:
        mjpeg_phase(dev, card, dict.fromkeys(NAMES, 0))
        return 0
    if argv == ["--datacons"]:
        datacons_phase(dev, card, dict.fromkeys(NAMES, 0))
        return 0
    if argv == ["--clipedit"]:
        clipedit_phase(dev, card, dict.fromkeys(NAMES, 0))
        return 0
    if argv and argv not in (["--vocabulary"], ["--vjfilters"],
                             ["--titles"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    # 2. build the six libraries, one nvcc each, started together
    t0 = time.perf_counter()
    native.load_all(["fused_sweep", "fused_sweep_exact", "stateful_sweep",
                     "yuv420", "composite", "fma_chain"])
    wall = time.perf_counter() - t0
    ptxas = {}  # "library:entry" -> its ptxas report
    for built in (fused_sweep.build(), fused_sweep.build(full=True),
                  stateful_sweep.build(), yuv_kernels.build(),
                  composite.build(), fma_chain.build()):
        lib = built.path.name.split("-")[0]
        line("2 build", lib=built.path.name,
             seconds=f"{built.seconds:.2f}")
        for entry, res in ptxas_entries(built.log).items():
            ptxas[f"{lib.removeprefix('lib')}:{entry}"] = res
            line("2 ptxas", lib=lib, entry=entry, **res)
    line("2 build", wall_s=f"{wall:.2f}")
    # kernel -> its main-path entry ("library:entry") and blocks an SM
    resources = {}

    err = dict.fromkeys(NAMES, 0.0)
    # the library call's ms where one PyTorch call computes the same
    # function, and keys a kernel's entry of the kernels line adds
    library = dict.fromkeys(NAMES)
    extra = {name: {} for name in NAMES}
    bounds = {}
    px = CHUNK * H * W  # pixels of a timed 96-frame chunk

    def held(name, what, got, ref, tol, **kw):
        worst, share = diff_stats(got, ref)
        line(what, **kw, max_abs_err=f"{worst:.6g}",
             differing_share=f"{share:.3g}")
        assert worst <= tol, f"{what} {kw}: max |diff| {worst} > {tol}"
        err[name] = max(err[name], worst)

    if argv == ["--vocabulary"]:
        vocabulary(dev, card, held, {}, {}, {})
        return 0
    if argv == ["--vjfilters"]:
        vj_filters(dev, card, dict.fromkeys(NAMES, 0))
        return 0
    if argv == ["--titles"]:
        titles(dev, card, dict.fromkeys(NAMES, 0))
        return 0

    # 3. kernel vs plain_sweep on the card
    for w, h, tracks in ((W, H, TRACKS), (1000, 562, 3)):
        el = multitrack_timeline(n_tracks=tracks, n_frames=N_FRAMES,
                                 width=w, height=h, fps=FPS)
        spec, ids, packed, rows = chunk_of(el, dev, 4)
        plan = sweep_plan(el, spec, rows, dev, tracks)
        got = fused_sweep.fused_sweep(plan, ids, packed)
        torch.cuda.synchronize()
        held("fused_sweep", "3 kernel_vs_plain", got,
             fused_sweep.plain_sweep(plan, ids, packed), 1,
             size=f"{w}x{h}", tracks=tracks, frames=ids.shape[2])

    # 4. the card against the JAX golden
    g = np.load(ROOT / "tests" / "fixtures" / "render_golden.npz")
    gold = g["frames"]
    gel = EventList.from_json(str(g["timeline"]))
    before = fused_sweep.LAUNCHES
    out, _ = render_to_arrays(gel, DeviceSyntheticSource(
        gold.shape[2], gold.shape[3], device=dev),
        SinkSpec(gold.shape[3], gold.shape[2]),
        batch_size=int(g["batch_size"]))
    assert fused_sweep.LAUNCHES > before, "golden render missed the kernel"
    held("fused_sweep", "4 golden", torch.from_numpy(out),
         torch.from_numpy(gold), 1, frames=out.shape[0],
         launches=fused_sweep.LAUNCHES - before)

    src = DeviceSyntheticSource(H, W, device=dev)
    sink = SinkSpec(W, H)
    n_chunks = -(-N_FRAMES // CHUNK)

    # 5. the main path through the user's entry points
    el = multitrack_timeline(n_tracks=TRACKS, n_frames=N_FRAMES, width=W,
                             height=H, fps=FPS)
    rendered, head, counts, first_s = render_path(el, src, sink)
    line("5 main_path", frames=rendered, chunks=n_chunks, launches=counts,
         first_pass_s=f"{first_s:.3f}")
    assert rendered == N_FRAMES
    assert counts == {"u8": n_chunks}, counts
    launches = {"fused_sweep": counts["u8"]}
    _, plain_head = next(iter(render_events(el, Materialised(src), sink,
                                            batch_size=4)))
    held("fused_sweep", "5 main_vs_plain_route", head, plain_head.planes[0],
         1, frames=4)
    rendered, _, _, wall_s = render_path(el, src, sink, check=False)
    line("5 timed", card=repr(card), frames=rendered, wall_s=f"{wall_s:.4f}",
         frames_per_s=f"{rendered / wall_s:.1f}",
         x_realtime=f"{rendered / wall_s / FPS:.2f}")
    main_el = el
    spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
    plan = sweep_plan(el, spec, rows, dev, TRACKS)
    torch.cuda.reset_peak_memory_stats()
    ms = {}
    ms["fused_sweep"] = in_turns(
        lambda: fused_sweep.plain_sweep(plan, ids, packed),
        lambda: fused_sweep._launch(plan, ids, packed, None))
    # the u8 write; the op table's float work with the sink quantise
    bounds["fused_sweep"] = bound(px * 3, px * (table_flops(plan.ops) + 15))
    line("5 chunk_ms", card=repr(card), frames=CHUNK,
         times=ms["fused_sweep"][2],
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    main_geometry(plan, ids, packed, card)
    geom = fused_sweep.plan_geometry(plan, CHUNK)
    resources["fused_sweep"] = (f"fused_sweep:fused_sweep_kernelILi{geom.run}E",
                                fused_sweep.blocks_per_sm(geom))
    blur_geometry(el, ids, card)
    # what the halo costs: the chain without its blur (R = 0), in turns
    flat = sweep_plan(el, [s for s in spec if s[0].name not in
                           fused_sweep.STENCILS], rows, dev, TRACKS)
    times = {id(plan): [], id(flat): []}
    for p in (plan, flat, flat, plan):
        times[id(p)].append(time_ms(
            lambda: fused_sweep._launch(p, ids, packed, None), 5))
    full, r0 = times[id(plan)], times[id(flat)]
    line("5 no_blur", card=repr(card), frames=CHUNK,
         r0_ms=",".join(f"{x:.3f}" for x in r0),
         full_ms=",".join(f"{x:.3f}" for x in full),
         r0_over_full=f"{sum(r0) / sum(full):.3f}",
         r0_bound_ms=f"{bound(px * 3, px * (table_flops(flat.ops) + 15))[0]:.4f}",
         r0_tile=fused_sweep.plan_geometry(flat, CHUNK).tile_h)
    del flat
    # the main path under the profiler: device busy and idle share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, _, prof_wall = render_path(el, src, sink, check=False)
    busy, top = device_busy(prof)
    line("5 profiled", card=repr(card), wall_ms=f"{prof_wall * 1e3:.1f}",
         device_busy_ms=f"{busy:.1f}",
         idle_share=f"{1 - busy / (prof_wall * 1e3):.3f}", top=top)

    # 6. the comp modes vs their plain versions
    gen = torch.Generator(device=dev).manual_seed(6)
    for w, h in ((W, H), (1000, 562)):
        for name, tracks, cut in (("main", TRACKS, 13), ("B", 4, 2)):
            tel = (multitrack_timeline(n_tracks=tracks, n_frames=8, width=w,
                                       height=h, fps=FPS) if name == "main"
                   else timeline(name, 8, w, h))
            spec, ids, packed, rows = chunk_of(tel, dev, 4)
            plan = sweep_plan(tel, spec[:cut], rows, dev, tracks,
                              emit="comp")
            got = fused_sweep.fused_sweep(plan, ids, packed)
            torch.cuda.synchronize()
            held("fused_sweep_comp_out", "6 comp_out_vs_plain", got,
                 fused_sweep.plain_sweep(plan, ids, packed), 1 / 255,
                 chain=f"{name}[:{cut}]", size=f"{w}x{h}", frames=4)
        tel = timeline("A", 8, w, h)
        spec, ids, packed, rows = chunk_of(tel, dev, 4)
        plan = sweep_plan(tel, spec[2:], rows, dev, 10, consume="comp",
                          idx_base=2)
        comp = torch.rand((4, 3, h, w), generator=gen, device=dev)
        got = fused_sweep.fused_sweep(plan, ids, packed, comp)
        torch.cuda.synchronize()
        held("fused_sweep_comp_in", "6 comp_in_vs_plain", got,
             fused_sweep.plain_sweep(plan, ids, packed, comp), 1,
             chain="A[2:]", size=f"{w}x{h}", frames=4)

    # 7. the fused stateful sweep vs its plain version, two chunks
    for name in ("C", "life_blur", "blur_fire", "r33"):
        tel = timeline(name, 8)
        spec, _, _, rows = chunk_of(tel, dev, 4)
        plan = stateful_sweep.build_stateful_sweep(
            spec, CONFIGS[name][0], H, W, rows, FPS, src, sink, dev)
        assert plan is not None, f"{name} must qualify for the kernel"
        geom = stateful_sweep.plan_geometry(plan, 4)
        line("7 geometry", chain=name, halo=plan.halo,
             tile=f"{geom.tile_h}x{geom.tile_w}", run=geom.run,
             smem=geom.smem, blocks_per_sm=stateful_sweep.blocks_per_sm(geom))
        st_k = [f.init_state(W, H, None, dev) if f.init_state else None
                for f, *_ in spec]
        st_p = list(st_k)
        for k in range(2):
            _, ids, packed, _ = chunk_of(tel, dev, 4, k)
            got, st_k = stateful_sweep.stateful_sweep(plan, ids, packed,
                                                      st_k)
            torch.cuda.synchronize()
            ref, st_p = stateful_sweep.plain_stateful_sweep(plan, ids,
                                                            packed, st_p)
            held("stateful_sweep", "7 stateful_vs_plain", got, ref, 1,
                 chain=name, chunk=k, frames=4)
        for i, step, kind in plan.state_steps:
            worst, _ = diff_stats(st_k[i], st_p[i])
            line("7 state", chain=name, step=step, kind=kind,
                 max_abs_err=f"{worst:.3g}")
            assert worst <= (1e-5 if kind != "u8hw" else 0), (name, worst)

    # 8. configs A, B and C through render_events
    want = {"A": {"comp_in": n_chunks}, "B": {"comp_out": n_chunks},
            "C": {"comp_in": n_chunks}, "C+sf": {"stateful": n_chunks}}
    rates = {}
    for path, kinds in want.items():
        os.environ["LIVES_TPU_FUSED_STATEFUL"] = "1" if "sf" in path else "0"
        tel = timeline(path[0], N_FRAMES)
        rendered, head, counts, first_s = render_path(tel, src, sink)
        line("8 path", config=path, frames=rendered, launches=counts,
             first_pass_s=f"{first_s:.3f}")
        assert rendered == N_FRAMES and counts == kinds, (path, counts)
        for k, v in counts.items():
            launches.setdefault(KERNEL_OF[k], v)
        _, plain_head = next(iter(render_events(tel, Materialised(src), sink,
                                                batch_size=4)))
        held(KERNEL_OF[next(iter(kinds))], "8 path_vs_plain_route", head,
             plain_head.planes[0], 1, config=path, frames=4)
        rendered, _, _, wall_s = render_path(tel, src, sink, check=False)
        rates[path] = rendered / wall_s
        line("8 timed", card=repr(card), config=path, frames=rendered,
             wall_s=f"{wall_s:.4f}", frames_per_s=f"{rates[path]:.1f}",
             x_realtime=f"{rates[path] / FPS:.2f}")
    os.environ["LIVES_TPU_FUSED_STATEFUL"] = "0"

    # kernel vs plain ms on one 96-frame chunk for each new kernel
    torch.cuda.reset_peak_memory_stats()
    spec, ids, packed, rows = chunk_of(timeline("B", CHUNK), dev, CHUNK)
    plan = sweep_plan(timeline("B", 1), spec[:2], rows, dev, 4,
                      emit="comp")
    ms["fused_sweep_comp_out"] = in_turns(
        lambda: fused_sweep.plain_sweep(plan, ids, packed),
        lambda: fused_sweep._launch(plan, ids, packed, None))
    bounds["fused_sweep_comp_out"] = bound(px * 12,
                                           px * table_flops(plan.ops))
    spec, ids, packed, rows = chunk_of(timeline("A", CHUNK), dev, CHUNK)
    plan = sweep_plan(timeline("A", 1), spec[2:], rows, dev, 10,
                      consume="comp", idx_base=2)
    comp = torch.rand((CHUNK, 3, H, W), generator=gen, device=dev)
    ms["fused_sweep_comp_in"] = in_turns(
        lambda: fused_sweep.plain_sweep(plan, ids, packed, comp),
        lambda: fused_sweep._launch(plan, ids, packed, comp))
    bounds["fused_sweep_comp_in"] = bound(
        px * 15, px * (table_flops(plan.ops) + 15))
    spec, ids, packed, rows = chunk_of(timeline("C", CHUNK), dev, CHUNK)
    plan = stateful_sweep.build_stateful_sweep(spec, 10, H, W, rows, FPS,
                                               src, sink, dev)
    states = [f.init_state(W, H, None, dev) if f.init_state else None
              for f, *_ in spec]
    ms["stateful_sweep"] = in_turns(
        lambda: stateful_sweep.plain_stateful_sweep(plan, ids, packed,
                                                    states),
        lambda: stateful_sweep._launch(plan, ids, packed, states),
        plain_reps=1, kern_reps=3)
    geom = stateful_sweep.plan_geometry(plan, CHUNK)
    per_sm = stateful_sweep.blocks_per_sm(geom)
    resident = stateful_sweep.resident_blocks(geom)
    tiles = geom.grid[0] * geom.grid[1]
    line("8 k5_geometry", tile=f"{geom.tile_h}x{geom.tile_w}", run=geom.run,
         margin=geom.margin, smem=geom.smem, blocks_per_sm=per_sm,
         tiles_per_frame=tiles, grid=min(resident, tiles),
         rounds=fused_sweep.stateful_rounds(geom, resident))
    resources["stateful_sweep"] = (
        f"stateful_sweep:stateful_sweep_kernelILi{geom.run}ELb0E", per_sm)
    for tile in fused_sweep.TILES:
        for run in (8, 4):
            try:
                g = stateful_sweep.plan_geometry(plan, CHUNK, tile, run)
            except ValueError:  # over a block's shared memory
                continue
            got = [time_ms(lambda: stateful_sweep._launch(
                plan, ids, packed, states, g), 2) for _ in range(2)]
            cost = fused_sweep.stateful_cost(
                g, plan.halo, stateful_sweep.resident_blocks(g))
            line("8 k5_geometry_ms", card=repr(card),
                 tile=f"{tile[0]}x{tile[1]}", run=run,
                 blocks_per_sm=stateful_sweep.blocks_per_sm(g),
                 model_cost=f"{cost:.0f}",
                 ms=",".join(f"{x:.3f}" for x in got))
    # where K5's time goes: config C's chain with steps disabled, at the
    # launch's own geometry (K1 comp-in runs its 11-op tail alone)
    for keep in (("fire", "alien_overlay"), ("fire",), ("alien_overlay",),
                 ("fire", "alien_overlay", "tail"), ("fire", "tail"),
                 ("alien_overlay", "tail")):
        sub = [(f, st_, i_, o_, en and (f.name in keep or (
            "tail" in keep and not f.flags & FILTER_STATEFUL)))
               for f, st_, i_, o_, en in spec]
        sp_ = stateful_sweep.build_stateful_sweep(sub, 10, H, W, rows, FPS,
                                                  src, sink, dev)
        got = time_ms(lambda: stateful_sweep._launch(sp_, ids, packed,
                                                     states), 3)
        line("8 k5_by_steps", card=repr(card), steps="+".join(keep),
             ops=sp_.ops.shape[0], halo=sp_.halo, ms=f"{got:.3f}")
    # the u8 write, and each state plane read and written once a frame
    state_bytes = {"f32hw": 4, "u8hw": 1, "f32chw": 12}
    bounds["stateful_sweep"] = bound(
        px * (3 + sum(2 * state_bytes[k] for *_, k in plan.state_steps)),
        px * (table_flops(plan.ops) + 15))
    for name in ("fused_sweep_comp_out", "fused_sweep_comp_in",
                 "stateful_sweep"):
        line("8 chunk_ms", card=repr(card), kernel=name, frames=CHUNK,
             times=ms[name][2])
    line("8 peak", gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")

    # 9. the colour kernels vs their plain versions on the card
    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def flat(t):
        return t.reshape(-1)

    # rows of 1000, 1004, 1002 and 994 bytes: accesses of 8, 4 and 1 bytes
    for b, h, w in ((4, H, W), (2, 562, 1000), (2, 36, 1004), (2, 34, 1002),
                    (2, 20, 994)):
        k2, k3 = [], []
        for clamping in (0, 1):
            for subspace in (1, 2):
                y, u, v = rand(b, h, w), rand(b, h // 2, w // 2), \
                    rand(b, h // 2, w // 2)
                got = yuv_kernels.yuv420_to_rgb(y, u, v, subspace, clamping)
                torch.cuda.synchronize()
                k2.append((flat(got), flat(yuv_kernels.plain_yuv420_to_rgb(
                    y, u, v, subspace, clamping))))
                # RGB, RGBA, and RGBA with an odd height and width
                for c, hh, ww in ((3, h, w), (4, h, w), (4, h + 1, w + 1)):
                    rgb = rand(b, c, hh, ww)
                    got = yuv_kernels.rgb_to_yuv420(rgb, subspace, clamping)
                    torch.cuda.synchronize()
                    ref = yuv_kernels.plain_rgb_to_yuv420(rgb, subspace,
                                                          clamping)
                    k3.append((torch.cat([flat(p) for p in got]),
                               torch.cat([flat(p) for p in ref])))
        case = dict(size=f"{w}x{h}", frames=b)
        held("yuv420_to_rgb", "9 k2_vs_plain", torch.cat([g for g, _ in k2]),
             torch.cat([r for _, r in k2]), 1, cases=len(k2), **case)
        held("rgb_to_yuv420", "9 k3_vs_plain", torch.cat([g for g, _ in k3]),
             torch.cat([r for _, r in k3]), 0, cases=len(k3),
             channels="3,4,4 (odd +1)", **case)
    del k2, k3
    # planes that are views at byte offsets 1-3 of one buffer: one packed
    # YUV420P upload for K2, one RGBA chunk for K3
    b, fs = 4, H * W * 3 // 2
    for off in (1, 2, 3):
        buf = rand(b * fs + 16)[off:off + b * fs].view(b, fs)
        y = buf[:, :H * W].view(b, H, W)
        u = buf[:, H * W:H * W + fs // 6].view(b, H // 2, W // 2)
        v = buf[:, H * W + fs // 6:].view(b, H // 2, W // 2)
        got = yuv_kernels.yuv420_to_rgb(y, u, v)
        torch.cuda.synchronize()
        held("yuv420_to_rgb", "9 k2_vs_plain", got,
             yuv_kernels.plain_yuv420_to_rgb(y.contiguous(), u.contiguous(),
                                             v.contiguous()), 1,
             size=f"{W}x{H}", frames=b, byte_offset=off)
        rgba = rand(b * 4 * H * W + 16)[off:off + b * 4 * H * W].view(
            b, 4, H, W)
        got = yuv_kernels.rgb_to_yuv420(rgba)
        torch.cuda.synchronize()
        held("rgb_to_yuv420", "9 k3_vs_plain",
             torch.cat([flat(p) for p in got]),
             torch.cat([flat(p) for p in yuv_kernels.plain_rgb_to_yuv420(
                 rgba.contiguous())]), 0,
             size=f"{W}x{H}", frames=b, channels=4, byte_offset=off)
    del buf, y, u, v, rgba, got

    # 10. the composite kernel vs plain_composite on the card
    from lives_tpu_torch.graph.nodemodel import composite_prefix
    for w, h, tracks, n_pre in ((W, H, TRACKS, 9), (1000, 562, 4, 3)):
        tel = multitrack_timeline(n_tracks=tracks, n_frames=8, width=w,
                                  height=h, fps=FPS)
        spec, ids, packed, rows = chunk_of(tel, dev, 4)
        assert composite.splittable_prefix(_chain(tel)) == n_pre
        prefix, n_t = composite_prefix(spec[:n_pre], tracks)
        plan = composite.build_composite(prefix, n_t, rows, FPS, dev)
        tsrc = DeviceSyntheticSource(h, w, device=dev)
        trk = [tsrc.traced_layer(ids[0, t], ids[1, t]).planes[0]
               for t in range(n_t)]
        got = composite.composite(plan, trk, packed)
        torch.cuda.synchronize()
        held("composite", "10 k4_vs_plain", got,
             composite.plain_composite(plan, trk, packed), 1,
             prefix=n_pre, tracks=n_t, size=f"{w}x{h}", frames=4)

    # at 45x37 (H*W = 1665, no multiple of 16) on tracks that are views at
    # byte offsets 0-3, a prefix that reads track 1 three times
    from lives_tpu_torch.effects.host import instantiate
    from lives_tpu_torch.graph.nodemodel import (_split_params,
                                                 chain_spec_of, pack_params)
    w, h, b4 = 45, 37, 4
    chain = []
    for name, tr in (("crossfade", (0, 1)), ("blend_screen", (0, 1)),
                     ("chroma_key", (2, 0)), ("luma_key", (1, 2)),
                     ("saturation", (0,))):
        inst = instantiate(name)
        inst.in_tracks = tr
        chain.append(inst)
    rng = np.random.default_rng(10)
    packed4, rows4 = pack_params(
        [{k: rng.uniform(i.filter.param(k).min, i.filter.param(k).max,
                         b4).astype(np.float32) for k in _split_params(i)[1]}
         for i in chain], np.arange(b4) / FPS, np.arange(b4))
    plan = composite.build_composite(chain_spec_of(chain), 3, rows4, FPS, dev)
    packed4 = torch.from_numpy(packed4).to(dev)
    flat = [torch.randint(0, 256, (b4 * 3 * h * w + 3,), dtype=torch.uint8,
                          device=dev, generator=gen) for _ in range(3)]
    for off in range(4):
        trk = [f[off:off + b4 * 3 * h * w].view(b4, 3, h, w) for f in flat]
        got = composite._launch(plan, trk, packed4, b4, h, w)
        torch.cuda.synchronize()
        held("composite", "10 k4_vs_plain", got,
             composite.plain_composite(plan, trk, packed4), 1,
             size=f"{w}x{h}", offset=off, read=len(plan.tracks_read),
             ops=plan.ops.shape[0], frames=b4)
    del flat, trk

    # 11. config D: decoded clips through render_to_encoder
    from lives_tpu_torch.constants import Palette
    from lives_tpu_torch.events.renderer import ClipFrameSource
    from lives_tpu_torch.io.decoders import try_decoders
    from lives_tpu_torch.ops.colorspace import convert_layer

    def yuv_head(lay):
        """The first 4 frames of an RGB24 layer as host YUV420P planes, as
        the encoder converts them."""
        return [p[:4].cpu() for p in
                convert_layer(lay, Palette.YUV420P).planes]

    with tempfile.TemporaryDirectory() as tmp:
        clips, size, secs = write_clips(tmp, src)
        line("11 clips", clips=TRACKS, frames=CLIP_FRAMES,
             mb=f"{size / 1e6:.1f}", seconds=f"{secs:.2f}")
        el = config_d_timeline(N_FRAMES)
        out_path = os.path.join(tmp, "render.y4m")
        os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "1"
        counts, first_s, _ = decoded_pass(clips, el, out_path, dev)
        want = {"yuv420_to_rgb": TRACKS * n_chunks, "composite": n_chunks,
                "rgb_to_yuv420": n_chunks}
        line("11 config_d", frames=N_FRAMES, chunks=n_chunks,
             launches=counts, first_pass_s=f"{first_s:.3f}")
        assert counts == want, counts
        launches.update(counts)
        cd = try_decoders(out_path)
        assert (cd.nframes, cd.width, cd.height) == (N_FRAMES, W, H), \
            (cd.nframes, cd.width, cd.height)
        head = [torch.stack([cd.decoder.get_frame(n).planes[i]
                             for n in range(4)]) for i in range(3)]
        cd.decoder.close()
        line("11 reopened", frames=cd.nframes, size=f"{cd.width}x{cd.height}")
        # the first 4 frames of the route as RGB; the file holds them
        _, lay = next(iter(render_events(
            el, ClipFrameSource(clips, device=dev), batch_size=4)))
        for plane, g, r in zip("yuv", head, yuv_head(lay)):
            worst, share = diff_stats(g, r)
            line("11 file_vs_route", plane=plane, frames=4,
                 max_abs_err=f"{worst:.6g}", differing_share=f"{share:.3g}")
            assert worst == 0, ("file", plane, worst)
        rgb = lay.planes[0].cpu()
        # the same route on the plain versions (CPU tensors)
        _, plain_lay = next(iter(render_events(
            el, ClipFrameSource(clips, device="cpu"), batch_size=4)))
        worst, share = diff_stats(rgb, plain_lay.planes[0])
        line("11 head_vs_plain_route", frames=4, max_abs_err=f"{worst:.6g}",
             differing_share=f"{share:.3g}")
        assert worst <= 1, ("plain route", worst)
        # the route without the pref (the whole chain in float32): on these
        # 4 frames the JAX package's own two routes differ by up to 6 LSB,
        # in 281 values above 2 LSB (tests/test_torch_routes.py); the bound
        # leaves room for the float route's own 1-LSB noise
        os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "0"
        _, float_lay = next(iter(render_events(
            el, ClipFrameSource(clips, device=dev), batch_size=4)))
        d = (rgb.int() - float_lay.planes[0].cpu().int()).abs()
        over2 = int((d > 2).sum())
        line("11 head_vs_no_pref_route", frames=4,
             max_abs_err=int(d.max()), over_2_lsb=over2,
             differing_share=f"{float((d > 0).float().mean()):.3g}")
        assert int(d.max()) <= 6 and over2 <= 300, (int(d.max()), over2)
        os.environ["LIVES_TPU_PALLAS_COMPOSITE"] = "1"
        # a warm timed pass, then a profiled one
        counts, wall_s, host_s = decoded_pass(clips, el, out_path, dev)
        assert counts == want, counts
        rates["D"] = N_FRAMES / wall_s
        line("11 timed", card=repr(card), frames=N_FRAMES,
             wall_s=f"{wall_s:.4f}", get_batch_s=f"{host_s:.4f}",
             rest_s=f"{wall_s - host_s:.4f}",
             frames_per_s=f"{rates['D']:.1f}",
             x_realtime=f"{rates['D'] / FPS:.2f}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_wall, _ = decoded_pass(clips, el, out_path, dev)
        busy, top = device_busy(prof)
        line("11 profiled", card=repr(card), wall_ms=f"{prof_wall * 1e3:.1f}",
             device_busy_ms=f"{busy:.1f}",
             idle_share=f"{1 - busy / (prof_wall * 1e3):.3f}",
             dtoh_copies=dtoh_copies(prof), top=top)
        for c in clips.values():
            c.close()

    # kernel vs plain ms on one 96-frame chunk for K2, K3 and K4; K2 and
    # K3 at each run length, the launch's own (RUN) in the kernels line
    torch.cuda.reset_peak_memory_stats()
    rgb, y, u, v = colour_chunk(dev)
    calls = colour_calls(rgb, y, u, v)
    plain = {"k2": lambda: yuv_kernels.plain_yuv420_to_rgb(y, u, v),
             "k3": lambda: yuv_kernels.plain_rgb_to_yuv420(rgb)}
    for run in yuv_kernels.RUNS:
        for k, name in (("k2", "yuv420_to_rgb"), ("k3", "rgb_to_yuv420")):
            got = in_turns(plain[k], calls[f"{k} run={run}"], kern_reps=20)
            line("11 colour_run", card=repr(card), kernel=name, run=run,
                 frames=CHUNK, times=got[2])
            if run == yuv_kernels.RUN:
                ms[name] = got
    got = [time_ms(calls[f"k3 x{CHUNK}"], 2) for _ in range(2)]
    line("11 k3_per_frame", card=repr(card), launches=CHUNK,
         ms=",".join(f"{x:.4f}" for x in got))
    bounds["yuv420_to_rgb"] = bound(px * 4.5, px * 21)
    bounds["rgb_to_yuv420"] = bound(px * 4.5, px * 30)
    t, rate = copy_ceiling(dev, px * 4.5)
    line("11 copy_ceiling", card=repr(card), bytes=int(px * 4.5),
         ms=f"{t:.4f}", tb_per_s=f"{rate:.3f}")
    for name in ("yuv420_to_rgb", "rgb_to_yuv420"):
        resources[name] = (f"yuv420:{name}_kernelILi{yuv_kernels.RUN}E",
                           "not queried")
    del rgb, y, u, v, calls, plain
    spec, ids, packed, rows = chunk_of(el, dev, CHUNK)
    prefix, n_t = composite_prefix(spec[:9], TRACKS)
    plan = composite.build_composite(prefix, n_t, rows, FPS, dev)
    trk = [src.traced_layer(ids[0, t], ids[1, t]).planes[0]
           for t in range(n_t)]
    ms["composite"] = in_turns(
        lambda: composite.plain_composite(plan, trk, packed),
        lambda: composite._launch(plan, trk, packed, CHUNK, H, W),
        plain_reps=1, kern_reps=5)
    bounds["composite"] = bound(px * 3 * (n_t + 1),
                                px * table_flops(plan.ops, u8_stages=True))
    geom = composite.plan_geometry(plan, CHUNK, H, W)
    line("11 k4_geometry", span=geom.span,
         tracks_read=len(plan.tracks_read), smem=geom.smem, grid=geom.grid,
         blocks_per_sm=composite.blocks_per_sm(geom))
    resources["composite"] = ("composite:composite_kernel",
                              composite.blocks_per_sm(geom))
    # the same 10 tracks through 9 crossfades: one op body in the loop
    xf = composite.build_composite(
        [(spec[0][0], {"amount": 0.5}, (0, t), (0,), True)
         for t in range(1, 10)], TRACKS, (), FPS, dev)
    assert spec[0][0].name == "crossfade"
    no_rows = torch.zeros((2, CHUNK), device=dev)
    got = time_ms(lambda: composite._launch(xf, trk, no_rows, CHUNK, H, W),
                  5)
    line("11 k4_crossfades", card=repr(card), ops=9, ms=f"{got:.3f}")
    # what bounds K4: its time over the first 1, 3, 5 and 9 transitions
    # (2 to 10 tracks staged) beside the bytes each moves
    for k in (1, 3, 5, 9):
        pre, nk = composite_prefix(spec[:k], TRACKS)
        pk = composite.build_composite(pre, nk, rows, FPS, dev)
        got = time_ms(lambda: composite._launch(pk, trk[:nk], packed, CHUNK,
                                                H, W), 5)
        nb = px * 3 * (len(pk.tracks_read) + 1)
        line("11 k4_by_ops", card=repr(card), ops=k,
             tracks_read=len(pk.tracks_read), ms=f"{got:.3f}",
             bytes_bound_ms=f"{bound(nb, 0)[0]:.3f}",
             tb_per_s=f"{nb / got / 1e9:.2f}")
    for name in ("yuv420_to_rgb", "rgb_to_yuv420", "composite"):
        line("11 chunk_ms", card=repr(card), kernel=name, frames=CHUNK,
             times=ms[name][2],
             bound_ms=f"{bounds[name][0]:.4f} ({bounds[name][1]})")
    line("11 peak", gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    del trk

    phase12(dev, torch.device("cuda", 0), card, main_el, src, sink, held,
            ms, bounds, launches)

    k6 = roofline(dev, card)
    assert k6["launches"] > 0, "the roofline study missed K6"
    launches["fma_chain"] = k6["launches"]
    err["fma_chain"] = k6["max_abs_err"]
    extra["fma_chain"] = {"max_rel_err": k6["max_rel_err"]}
    library["fma_chain"] = round(k6["library_ms"], 6)
    ms["fma_chain"] = (k6["ms"], k6["plain_ms"])
    bounds["fma_chain"] = k6["bound"]
    resources["fma_chain"] = ("fma_chain:fma_chain_kernel", "not queried")
    live(dev, card)
    vocabulary(dev, card, held, ms, bounds, launches)
    player_phase(dev, card, launches)
    vj_filters(dev, card, launches)
    titles(dev, card, launches)
    mjpeg_phase(dev, card, launches)
    datacons_phase(dev, card, launches)
    clipedit_phase(dev, card, launches)
    vel = timeline_v(1)
    vspec, _, _, vrows = chunk_of(vel, dev, 1)
    v_geom = fused_sweep.plan_geometry(
        sweep_plan(vel, vspec, vrows, dev, TRACKS), CHUNK)
    resources["fused_sweep_vocabulary"] = (
        f"fused_sweep_exact:fused_sweep_kernelILi{v_geom.run}E",
        fused_sweep.blocks_per_sm(v_geom))

    for name, (entry, per_sm) in resources.items():
        lib, fn = entry.split(":")
        res = next((v for k, v in ptxas.items()
                    if k.startswith(lib + ":") and fn in k),
                   {"ptxas": "not in the build log"})
        line("resources", kernel=name, entry=entry, **res,
             blocks_per_sm=per_sm)
    for name in NAMES:
        line("bound", kernel=name, ms=f"{ms[name][0]:.4f}",
             bound_ms=f"{bounds[name][0]:.4f}", bound_by=bounds[name][1])
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches[name],
        "max_abs_err": err[name], "ms": round(ms[name][0], 6),
        "plain_ms": round(ms[name][1], 6),
        "bound_ms": round(bounds[name][0], 6), "bound_by": bounds[name][1],
        "library_ms": library[name], **extra[name]} for name in NAMES]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
