// Device code shared by the sweep kernels and the composite kernel: the op
// table's opcodes, the op records, the synthetic source, the point ops, and
// the tile machinery of the two sweeps.
//
// fused_sweep.cu (the JAX package's build_fused_sweep), stateful_sweep.cu
// (build_fused_stateful_sweep) and composite.cu (build_composite) include
// it, so the kernels evaluate one definition of every op: `point_run` over
// a run of P adjacent pixels. The two sweeps also share one tile: runs of P
// pixels starting on multiples of P, shared rows of TW + 2M columns (the
// margin M), a (row, run) mapping with no division a cell (`for_runs`), the
// one-channel stencil buffer V in skewed rows (`stencil_pass`) and the edge
// fix-up between steps. The op table is encoded by
// lives_tpu_torch/graph/fused_sweep.py (_encode, `encode_point`); keep the
// constants in step with it.
//
// The vocabulary comes in two parts: the core (crossfade, the blends, the
// keys, colour_balance, saturation, vignette: what the main chains hold)
// and the rest of the JAX package's band-safe filters (`PALLAS_SAFE |
// COORD_SAFE`). `point_run<P, FULL>` compiles the rest in only for FULL,
// so a kernel instantiated for a core plan runs the code it ran before the
// vocabulary grew: K1 (one instantiation a build, fused_sweep.cu) and K5
// pick theirs from the plan (`full`); K4 runs the whole vocabulary's,
// which cost it nothing on an H100 (PERF.md).

#pragma once

#include <cuda_runtime.h>

namespace lives {

constexpr int NTHREADS = 256;
constexpr int MAX_SLOTS = 256;
constexpr int OP_FIELDS = 7;

enum OpCode {
  // two-input ops, fg in0 over bg in1: code <= OP_LAST_TWO_IN
  OP_CROSSFADE = 0,     // arg 1: chroma_blend (the weights swapped)
  OP_BLEND = 1,         // arg: the blend mode
  OP_LUMA_KEY = 2,
  OP_CHROMA_KEY = 3,
  OP_ALPHA_OVER = 4,    // a fg without alpha: opaque
  OP_MASK_OVERLAY = 5,
  OP_LUMA_SELECT = 6,   // arg: 0 luma_overlay, 1 luma_underlay, 2 negative
  OP_WIPE = 7,          // arg: the direction (left, right, top, bottom)
  OP_IRIS = 8,          // arg: 0 iris_circle, 1 iris_rectangle
  OP_DISSOLVE = 9,      // arg: 0 dissolve, 1 rand_replace (salted a frame)
  // one-input point ops
  OP_COLOUR_BALANCE = 10,
  OP_SATURATION = 11,
  OP_VIGNETTE = 12,
  OP_NEGATE = 13,
  OP_BRIGHTNESS_CONTRAST = 14,
  OP_GAMMA_ADJUST = 15,
  OP_LEVELS = 16,
  OP_GREYSCALE = 17,
  OP_SEPIA = 18,
  OP_POSTERIZE = 19,
  OP_SOLARIZE = 20,
  OP_THRESHOLD = 21,
  OP_SOFTLIGHT = 22,
  OP_TINT = 23,
  OP_HUE_ROTATE = 24,
  OP_MODULATE = 25,
  OP_COLOUR_REPLACE = 26,
  // the steps that are not point ops: each ends a run of point ops
  OP_STENCIL = 27,
  OP_FIRE = 28,
  OP_LIFE = 29,
  OP_ALIEN = 30,
};
constexpr int OP_LAST_TWO_IN = OP_DISSOLVE;
// F_ARG: a stencil's radius, a family's member (a blend's mode, wipe's
// direction, ...), a stateful step's state index; F_TAPS: a stencil's taps,
// or a point op's constants (iris_circle: the frame's aspect and its
// largest radius), in the taps array
enum OpField { F_CODE = 0, F_IN0 = 1, F_IN1 = 2, F_ARG = 3, F_TAPS = 4,
               F_SHARPEN = 5, F_SLOT = 6 };

struct Rgb {
  float r, g, b;
};

// What the source and the coordinate effects read besides the pixel.
struct Frame {
  const int* ids;
  int T, B, b;
  float sx, sy;  // centred-grid scales, float32(2 / max(W-1, 1)) and for H
};

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ Rgb clip01(Rgb v) {
  return {clip01(v.r), clip01(v.g), clip01(v.b)};
}

__device__ __forceinline__ float luma(Rgb v) {
  return 0.299f * v.r + 0.587f * v.g + 0.114f * v.b;
}

// float(v) for 0 <= v < 2^23, exactly, through the mantissa of 2^23
__device__ __forceinline__ float exact_float(unsigned v) {
  return __int_as_float(0x4B000000 | v) - 8388608.0f;
}

// the low byte times float32(1/255), the u8 -> float factor of the reference
__device__ __forceinline__ float chan(unsigned v) {
  return exact_float(v & 0xFFu) * __int_as_float(0x3b808081);
}

// clip(floor(x*255 + 0.5)) to u8, rounded in two steps as the reference
// does (no fused multiply-add), with one rounding conversion: floor to int,
// then the clip (NaN gives 0)
__device__ __forceinline__ unsigned q8(float v) {
  const int q = __float2int_rd(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f));
  return (unsigned)min(max(q, 0), 255);
}

// One track of the synthetic source for a frame: what
// DeviceSyntheticSource._channels (lives_tpu/scenes.py:34) derives from the
// clip id c and frame number f alone.
struct alignas(16) TrackRec {
  int m5, m3;      // 3 + c % 5, 2 + c % 3
  unsigned phase;  // c * 37 + f * 3 (wrapping as int32)
  int blank;       // c < 0
};

__device__ __forceinline__ TrackRec track_rec(const Frame& fr, int t) {
  const int c = fr.ids[t * fr.B + fr.b];
  const int f = fr.ids[(fr.T + t) * fr.B + fr.b];
  TrackRec r;
  r.blank = c < 0;
  r.m5 = c < 0 ? 0 : 3 + c % 5;
  r.m3 = c < 0 ? 0 : 2 + c % 3;
  r.phase = (unsigned)c * 37u + (unsigned)f * 3u;
  return r;
}

// The source over a run of P pixels at columns x (>= 0), row y: only the x-
// and y-dependent integer work (green depends on y alone). Unsigned
// arithmetic wraps as the reference's int32 does; for a non-blank clip the
// operands are non-negative, where a shift equals the reference's floor
// division.
template <int P>
__device__ __forceinline__ void gen_run(const TrackRec& tr, const int (&x)[P],
                                        int y, Rgb (&o)[P]) {
  const TrackRec t = tr;
  if (t.blank) {
#pragma unroll
    for (int j = 0; j < P; ++j) o[j] = {0.0f, 0.0f, 0.0f};
    return;
  }
  const float g = chan(((unsigned)y * (unsigned)t.m3 >> 3) - t.phase * 2u);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    o[j] = {chan(((unsigned)x[j] * (unsigned)t.m5 >> 4) + t.phase), g,
            chan(((unsigned)(x[j] + y) >> 3) + t.phase * 5u)};
  }
}

// One op of the chain with what it reads besides the pixels: its fields,
// the tracks in0 and in1 (when not track 0) and its frame-uniform values,
// which point_run reads in place of the parameter slots. The fused sweep
// keeps one a chain op in shared memory.
struct alignas(16) OpRec {
  int code, in0, in1, arg;  // arg: a family's member, a stencil's radius
  int taps, sharpen, slot, pad;  // slot: the op's first parameter slot
  TrackRec a, b;            // tracks in0 and in1
  float k[12];              // frame-uniform values (make_rec)
};
static_assert(sizeof(OpRec) == 112, "graph/fused_sweep.py OP_REC_BYTES");

// Op row `o` with its clamped parameters `p` (this frame's slots); `fr`
// gives the TrackRecs of the tracks it reads (null where the caller makes
// a track at the op that reads it); `consts` is the taps array, where a
// point op's constants lie at o[F_TAPS] (null for a table that has none).
// Each value is computed by the float expression the op's PyTorch function
// computes it by, once a frame.
__device__ __forceinline__ OpRec make_rec(const int* o, const float* p,
                                          const Frame* fr,
                                          const float* consts) {
  OpRec e;
  e.code = o[F_CODE];
  e.in0 = o[F_IN0];
  e.in1 = o[F_IN1];
  e.arg = o[F_ARG];
  e.taps = o[F_TAPS];
  e.sharpen = o[F_SHARPEN];
  e.slot = o[F_SLOT];
  e.pad = 0;
  e.a = e.b = TrackRec{0, 0, 0u, 1};
  if (fr != nullptr && e.in0 != 0) e.a = track_rec(*fr, e.in0);
  if (fr != nullptr && e.in1 != 0) e.b = track_rec(*fr, e.in1);
  float k[12] = {};
  switch (e.code) {
    case OP_CROSSFADE:  // the weights of fg and bg (chroma_blend: swapped)
    case OP_BLEND:
      k[0] = e.arg == 1 && e.code == OP_CROSSFADE ? 1.0f - p[0] : p[0];
      k[1] = e.arg == 1 && e.code == OP_CROSSFADE ? p[0] : 1.0f - p[0];
      break;
    case OP_LUMA_KEY:  // threshold, softness divisor, invert, 1 - invert
    case OP_MASK_OVERLAY:
      k[0] = p[0];
      k[1] = p[1] + 1e-4f;
      k[2] = p[2];
      k[3] = 1.0f - p[2];
      break;
    case OP_CHROMA_KEY: {  // kr, kg, tolerance, softness divisor
      const float ks = p[0] + p[1] + p[2] + 1e-4f;
      k[0] = p[0] / ks;
      k[1] = p[1] / ks;
      k[2] = p[3];
      k[3] = p[4] + 1e-4f;
      break;
    }
    case OP_LUMA_SELECT:  // t, 1 - t
      k[0] = p[0];
      k[1] = 1.0f - p[0];
      break;
    case OP_IRIS:  // amount (circle: times the largest radius), softness
                   // divisor, the aspect W / H (circle)
      k[0] = e.arg == 0 ? p[0] * consts[e.taps + 1] : p[0];
      k[1] = p[1] + 1e-4f;
      k[2] = e.arg == 0 ? consts[e.taps] : 1.0f;
      break;
    case OP_DISSOLVE:  // amount; rand_replace: the frame number, as int32
      k[0] = p[0];
      k[1] = __int_as_float(e.arg == 1 ? (int)p[1] : 0);
      break;
    case OP_LEVELS:  // black, the range's divisor, gamma
      k[0] = p[0];
      k[1] = fmaxf(p[1] - p[0], 1e-4f);
      k[2] = p[2];
      break;
    case OP_POSTERIZE:  // levels - 1, at least 1
      k[0] = fmaxf(p[0], 2.0f) - 1.0f;
      break;
    case OP_HUE_ROTATE: {  // the 3x3 matrix of this frame's angle
      // m0 + cos * m1 + sin * m2, row i giving output channel i
      // (effects/builtin/colour.py HUE_M0, HUE_M1, HUE_M2)
      const float m0[3] = {0.213f, 0.715f, 0.072f};
      const float m1[9] = {0.787f, -0.715f, -0.072f, -0.213f, 0.285f,
                           -0.072f, -0.213f, -0.715f, 0.928f};
      const float m2[9] = {-0.213f, -0.715f, 0.928f, 0.143f, 0.140f,
                           -0.283f, -0.787f, 0.715f, 0.072f};
      const float th = p[0] * 6.28318548f;  // float32(2 pi)
      const float cs = cosf(th), sn = sinf(th);
#pragma unroll
      for (int i = 0; i < 9; ++i) k[i] = m0[i % 3] + cs * m1[i] + sn * m2[i];
      break;
    }
    case OP_MODULATE: {  // brightness, saturation, cos and sin of the hue
      const float th = (p[2] - 1.0f) * 3.14159274f;  // float32(pi)
      k[0] = p[0];
      k[1] = p[1];
      k[2] = cosf(th);
      k[3] = sinf(th);
      break;
    }
    case OP_COLOUR_REPLACE:  // red, green, blue, red2, green2, blue2, tol
      for (int i = 0; i < 7; ++i) k[i] = p[i];
      break;
    case OP_TINT:  // amount, red, green, blue
      for (int i = 0; i < 4; ++i) k[i] = p[i];
      break;
    case OP_COLOUR_BALANCE:
      for (int i = 0; i < 3; ++i) k[i] = p[i];
      break;
    case OP_VIGNETTE:  // amount, strength
    case OP_BRIGHTNESS_CONTRAST:  // brightness, contrast
      k[0] = p[0];
      k[1] = p[1];
      break;
    case OP_NEGATE:
    case OP_GREYSCALE:
      break;
    default:  // one parameter: saturation, alpha_over, wipe, gamma_adjust,
              // sepia, solarize, threshold, softlight; a stencil's amount
      k[0] = p[0];
  }
  for (int i = 0; i < 12; ++i) e.k[i] = k[i];
  return e;
}

// _BLEND_MODES of effects/builtin/blends.py, in its order
template <int M>
__device__ __forceinline__ float blend_op(float a, float b) {
  if constexpr (M == 0) return a + b;                          // add
  else if constexpr (M == 1) return b - a;                     // subtract
  else if constexpr (M == 2) return a * b;                     // multiply
  else if constexpr (M == 3) return 1.0f - (1.0f - a) * (1.0f - b);  // screen
  else if constexpr (M == 4) return fminf(a, b);               // darken
  else if constexpr (M == 5) return fmaxf(a, b);               // lighten
  else if constexpr (M == 6) return fabsf(a - b);              // difference
  else if constexpr (M == 7) return a + b - 2.0f * a * b;      // exclusion
  else if constexpr (M == 8)                                   // overlay
    return b <= 0.5f ? 2.0f * a * b : 1.0f - 2.0f * (1.0f - a) * (1.0f - b);
  else if constexpr (M == 9)                                   // hardlight
    return a <= 0.5f ? 2.0f * a * b : 1.0f - 2.0f * (1.0f - a) * (1.0f - b);
  else if constexpr (M == 10) return b / fmaxf(1.0f - a, 1e-3f);          // dodge
  else if constexpr (M == 11) return 1.0f - (1.0f - b) / fmaxf(a, 1e-3f);  // burn
  else if constexpr (M == 12) return b - a + 0.5f;             // grain extract
  else return b + a - 0.5f;                                    // grain merge
}

// e at weight t over bg at weight w = 1 - t, clipped
__device__ __forceinline__ Rgb mix(Rgb e, Rgb bg, float t, float w) {
  return clip01({e.r * t + bg.r * w, e.g * t + bg.g * w, e.b * t + bg.b * w});
}

// key fg over bg with a per-pixel alpha (keying.py: no clip)
__device__ __forceinline__ Rgb key(Rgb fg, Rgb bg, float al) {
  return {fg.r * al + bg.r * (1.0f - al), fg.g * al + bg.g * (1.0f - al),
          fg.b * al + bg.b * (1.0f - al)};
}

template <int M, int P>
__device__ __forceinline__ void blend_run(const Rgb (&a)[P],
                                          const Rgb (&bg)[P], float t,
                                          float w, Rgb (&v)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    v[j] = mix({blend_op<M>(a[j].r, bg[j].r), blend_op<M>(a[j].g, bg[j].g),
                blend_op<M>(a[j].b, bg[j].b)}, bg[j], t, w);
  }
}

// blend mode m of a over bg, mixed by t (w = 1 - t), over a run
template <int P>
__device__ __forceinline__ void blend_mode(int m, const Rgb (&a)[P],
                                           const Rgb (&bg)[P], float t,
                                           float w, Rgb (&v)[P]) {
  switch (m) {
    case 0: blend_run<0>(a, bg, t, w, v); break;
    case 1: blend_run<1>(a, bg, t, w, v); break;
    case 2: blend_run<2>(a, bg, t, w, v); break;
    case 3: blend_run<3>(a, bg, t, w, v); break;
    case 4: blend_run<4>(a, bg, t, w, v); break;
    case 5: blend_run<5>(a, bg, t, w, v); break;
    case 6: blend_run<6>(a, bg, t, w, v); break;
    case 7: blend_run<7>(a, bg, t, w, v); break;
    case 8: blend_run<8>(a, bg, t, w, v); break;
    case 9: blend_run<9>(a, bg, t, w, v); break;
    case 10: blend_run<10>(a, bg, t, w, v); break;
    case 11: blend_run<11>(a, bg, t, w, v); break;
    case 12: blend_run<12>(a, bg, t, w, v); break;
    default: blend_run<13>(a, bg, t, w, v);
  }
}

// The hash of `_pixel_hash` (effects/builtin/blends.py) at frame column ix
// and row iy (clamped to the frame), salted by the frame number for
// rand_replace: int32 arithmetic that wraps (multiplied as unsigned) and
// shifts arithmetically, then the low 16 bits times 2^-16.
__device__ __forceinline__ float pixel_hash(int ix, int iy, bool salted,
                                            int salt) {
  int v = (int)((unsigned)ix * 73856093u ^ (unsigned)iy * 19349663u);
  if (salted) v ^= (int)((unsigned)salt * 83492791u);
  v = (int)((unsigned)(v ^ (v >> 13)) * 0x5BD1E995u);
  v ^= v >> 15;
  return exact_float((unsigned)v & 0xFFFFu) * 1.52587890625e-05f;
}

// The two-input ops past the core (record `o`): fg a over bg into v, at
// frame columns x and row y. Each computes what its PyTorch function
// computes, in its order; a 0/1 mask selects (fg * 1 + bg * 0 is fg).
template <int P>
__device__ __forceinline__ void two_in_rest(const OpRec& o, const Rgb (&a)[P],
                                            const Rgb (&bg)[P], Rgb (&v)[P],
                                            const int (&x)[P], int y,
                                            float sx, float sy) {
  const float k0 = o.k[0], k1 = o.k[1], k2 = o.k[2], k3 = o.k[3];
  const int arg = o.arg;
  switch (o.code) {
    case OP_ALPHA_OVER:  // fg opaque: its alpha is the opacity; no clip
#pragma unroll
      for (int j = 0; j < P; ++j) v[j] = key(a[j], bg[j], k0);
      break;
    case OP_MASK_OVERLAY:  // fg times a mask from bg's luma; no clip
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float m = clip01((luma(bg[j]) - k0) / k1);
        m = m * k3 + (1.0f - m) * k2;
        v[j] = {a[j].r * m, a[j].g * m, a[j].b * m};
      }
      break;
    case OP_LUMA_SELECT:  // bg where the luma test holds, then clipped
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const bool to_bg = arg == 0   ? luma(a[j]) < k0
                           : arg == 1 ? luma(bg[j]) > k1
                                      : luma(a[j]) > k1;
        v[j] = clip01(to_bg ? bg[j] : a[j]);
      }
      break;
    case OP_WIPE: {  // fg where the edge has passed; no clip
      // ctx_grid's scales float32(1 / max(n-1, 1)): half the centred ones
      const float yy = exact_float((unsigned)y) * (sy * 0.5f);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float xx = exact_float((unsigned)x[j]) * (sx * 0.5f);
        const bool fg = arg == 0   ? xx < k0
                        : arg == 1 ? 1.0f - xx < k0
                        : arg == 2 ? yy < k0
                                   : 1.0f - yy < k0;
        v[j] = fg ? a[j] : bg[j];
      }
      break;
    }
    case OP_IRIS: {  // a soft mask from the centred radius; no clip
      const float yc = exact_float((unsigned)y) * sy - 1.0f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float xc = exact_float((unsigned)x[j]) * sx - 1.0f;
        float r;
        if (arg == 0) {
          const float xa = xc * k2;
          r = sqrtf(xa * xa + yc * yc);
        } else {
          r = fmaxf(fabsf(xc), fabsf(yc));
        }
        v[j] = key(a[j], bg[j], clip01((k0 - r) / k1 + 0.5f));
      }
      break;
    }
    default: {  // OP_DISSOLVE: fg where the pixel's hash >= amount
      const int salt = __float_as_int(k1);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        v[j] = pixel_hash(x[j], y, arg == 1, salt) >= k0 ? a[j] : bg[j];
      }
    }
  }
}

// The one-input point ops past the core (record `o`) on a into v, each
// clipped to [0, 1] as `_rgb_filter` clips
template <int P>
__device__ __forceinline__ void one_in_rest(const OpRec& o, const Rgb (&a)[P],
                                            Rgb (&v)[P]) {
  const float* k = o.k;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float r = a[j].r, g = a[j].g, b = a[j].b;
    Rgb out;
    switch (o.code) {
      case OP_NEGATE:
        out = {1.0f - r, 1.0f - g, 1.0f - b};
        break;
      case OP_BRIGHTNESS_CONTRAST:
        out = {(r - 0.5f) * k[1] + 0.5f + k[0],
               (g - 0.5f) * k[1] + 0.5f + k[0],
               (b - 0.5f) * k[1] + 0.5f + k[0]};
        break;
      case OP_GAMMA_ADJUST:
        out = {powf(fmaxf(r, 0.0f), k[0]), powf(fmaxf(g, 0.0f), k[0]),
               powf(fmaxf(b, 0.0f), k[0])};
        break;
      case OP_LEVELS:
        out = {powf(clip01((r - k[0]) / k[1]), k[2]),
               powf(clip01((g - k[0]) / k[1]), k[2]),
               powf(clip01((b - k[0]) / k[1]), k[2])};
        break;
      case OP_GREYSCALE: {
        const float y = luma(a[j]);
        out = {y, y, y};
        break;
      }
      case OP_SEPIA: {
        const float tr = r * 0.393f + g * 0.769f + b * 0.189f;
        const float tg = r * 0.349f + g * 0.686f + b * 0.168f;
        const float tb = r * 0.272f + g * 0.534f + b * 0.131f;
        out = {r + (tr - r) * k[0], g + (tg - g) * k[0], b + (tb - b) * k[0]};
        break;
      }
      case OP_POSTERIZE:
        out = {floorf(r * k[0] + 0.5f) / k[0], floorf(g * k[0] + 0.5f) / k[0],
               floorf(b * k[0] + 0.5f) / k[0]};
        break;
      case OP_SOLARIZE:
        out = {r > k[0] ? 1.0f - r : r, g > k[0] ? 1.0f - g : g,
               b > k[0] ? 1.0f - b : b};
        break;
      case OP_THRESHOLD: {
        const float y = luma(a[j]) > k[0] ? 1.0f : 0.0f;
        out = {y, y, y};
        break;
      }
      case OP_SOFTLIGHT: {
        const float y = luma(a[j]);
        const bool dark = y <= 0.5f;
        const float c[3] = {r, g, b};
        float s[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float lit = dark ? c[i] * (y + 0.5f)
                                 : 1.0f - (1.0f - c[i]) * (1.5f - y);
          s[i] = c[i] + (lit - c[i]) * k[0];
        }
        out = {s[0], s[1], s[2]};
        break;
      }
      case OP_TINT: {
        const float y = luma(a[j]);
        out = {r + (y * k[1] - r) * k[0], g + (y * k[2] - g) * k[0],
               b + (y * k[3] - b) * k[0]};
        break;
      }
      case OP_HUE_ROTATE:
        out = {k[0] * r + k[1] * g + k[2] * b, k[3] * r + k[4] * g + k[5] * b,
               k[6] * r + k[7] * g + k[8] * b};
        break;
      case OP_MODULATE: {  // brightness, saturation, then the hue turn
        Rgb m = {r * k[0], g * k[0], b * k[0]};
        const float y0 = luma(m);
        m = {y0 + (m.r - y0) * k[1], y0 + (m.g - y0) * k[1],
             y0 + (m.b - y0) * k[1]};
        const float y = luma(m);
        const float i0 = 0.596f * m.r - 0.274f * m.g - 0.322f * m.b;
        const float q0 = 0.211f * m.r - 0.523f * m.g + 0.312f * m.b;
        const float i = i0 * k[2] - q0 * k[3], q = i0 * k[3] + q0 * k[2];
        out = {y + 0.956f * i + 0.621f * q, y - 0.272f * i - 0.647f * q,
               y - 1.106f * i + 1.703f * q};
        break;
      }
      default: {  // OP_COLOUR_REPLACE: within the tolerance -> colour 2
        const float dr = r - k[0], dg = g - k[1], db = b - k[2];
        const float d2 = (dr * dr + dg * dg + db * db)
                         * __int_as_float(0x3eaaaaab);  // float32(1/3)
        out = sqrtf(d2) <= k[6] ? Rgb{k[3], k[4], k[5]} : a[j];
      }
    }
    v[j] = clip01(out);
  }
}

// One point op (record `o`) on the track-0 values v of a run of P pixels
// at frame columns x, row y, the op decoded once for the run.
// `track(rec, t, out)` gives track t's values over the run (`rec`, its
// TrackRec): the sweeps generate a track where the composite kernel
// (composite.cu) loads it. The centred-grid scales sx, sy serve the
// coordinate ops. FULL: the whole vocabulary; else the core alone, whose
// last cases (chroma_key, vignette) then take every other code.
template <int P, bool FULL, class Track>
__device__ __forceinline__ void point_run(const OpRec& o, Rgb (&v)[P],
                                          const Track& track,
                                          const int (&x)[P], int y, float sx,
                                          float sy) {
  const int code = o.code, in0 = o.in0, in1 = o.in1;
  const float k0 = o.k[0], k1 = o.k[1], k2 = o.k[2], k3 = o.k[3];
  Rgb a[P];
  if (in0 == 0) {
#pragma unroll
    for (int j = 0; j < P; ++j) a[j] = v[j];
  } else {
    track(o.a, in0, a);
  }
  if (code <= OP_LAST_TWO_IN) {  // transitions: fg a over bg
    Rgb bg[P];
    if (in1 == 0) {
#pragma unroll
      for (int j = 0; j < P; ++j) bg[j] = v[j];
    } else if (in1 == in0) {
#pragma unroll
      for (int j = 0; j < P; ++j) bg[j] = a[j];
    } else {
      track(o.b, in1, bg);
    }
    if (code == OP_CROSSFADE) {
#pragma unroll
      for (int j = 0; j < P; ++j) v[j] = mix(a[j], bg[j], k0, k1);
    } else if (code == OP_BLEND) {
      blend_mode<P>(o.arg, a, bg, k0, k1, v);
    } else if (code == OP_LUMA_KEY) {  // threshold, softness, invert
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float al = clip01((luma(a[j]) - k0) / k1);
        al = al * k3 + (1.0f - al) * k2;
        v[j] = key(a[j], bg[j], al);
      }
    } else if (!FULL || code == OP_CHROMA_KEY) {
      // red, green, blue -> kr, kg; tolerance, softness
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float s = a[j].r + a[j].g + a[j].b + 1e-4f;
        const float r = a[j].r / s, g = a[j].g / s;
        const float d = sqrtf((r - k0) * (r - k0) + (g - k1) * (g - k1));
        v[j] = key(a[j], bg[j], clip01((d - k2) / k3));
      }
    } else {
      two_in_rest<P>(o, a, bg, v, x, y, sx, sy);
    }
  } else if (code == OP_COLOUR_BALANCE) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      v[j] = clip01({a[j].r * k0, a[j].g * k1, a[j].b * k2});
    }
  } else if (code == OP_SATURATION) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float g = luma(a[j]);
      v[j] = clip01({g + (a[j].r - g) * k0, g + (a[j].g - g) * k0,
                     g + (a[j].b - g) * k0});
    }
  } else if (!FULL || code == OP_VIGNETTE) {  // amount, strength
    const float yf = exact_float((unsigned)y) * sy - 1.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float xf = exact_float((unsigned)x[j]) * sx - 1.0f;
      const float r2 = xf * xf + yf * yf;
      const float m = 1.0f - k0 * (1.0f - expf(-r2 * k1 * 2.0f));
      v[j] = clip01({a[j].r * m, a[j].g * m, a[j].b * m});
    }
  } else {
    one_in_rest<P>(o, a, v);
  }
}

// point_run with the other tracks generated from the synthetic source
template <int P, bool FULL>
__device__ __forceinline__ void gen_point_run(const OpRec& o, Rgb (&v)[P],
                                              const int (&x)[P], int y,
                                              float sx, float sy) {
  const auto track = [&](const TrackRec& t, int, Rgb (&out)[P]) {
    gen_run<P>(t, x, y, out);
  };
  point_run<P, FULL>(o, v, track, x, y, sx, sy);
}

// This frame's parameter slots, clamped as Param.clamp does.
__device__ __forceinline__ void load_slots(float* sp, const float* packed,
                                           const int* slot_rows,
                                           const float* slot_vals,
                                           int n_slots, int B, int b) {
  for (int j = threadIdx.x; j < n_slots; j += NTHREADS) {
    const int row = slot_rows[j];
    const float v = row >= 0 ? packed[(size_t)row * B + b]
                             : slot_vals[3 * j];
    sp[j] = fminf(fmaxf(v, slot_vals[3 * j + 1]), slot_vals[3 * j + 2]);
  }
}

// ---- The tile of the two sweeps ---------------------------------------------
//
// A block owns a TH x TW tile of output pixels and keeps in shared memory
// the composite A over the tile and its halo R: 3 channels of TH + 2R rows
// by WS = TW + 2M columns, `ch` floats a channel. Halo row 0 is frame row
// ty0 - R; column M is frame column tx0. A thread computes runs of P
// adjacent pixels that start on multiples of P; the margin M (a multiple of
// P, at least R + P - 1 when R > 0) lets every run start so and keeps every
// tap of a run inside the row. Runs that overlap the valid span only in
// part also compute cells outside it; those cells are never read for a
// valid output.

// V, one channel in skewed rows: column c sits at c + c / 32, so the lanes
// of a warp, each reading the window of its own run (P columns apart), hit
// 32 different banks. Rows of VS floats, a multiple of 4.
__host__ __device__ __forceinline__ int v_stride(int WS) {
  return (WS + (WS >> 5) + 3) & ~3;
}

__device__ __forceinline__ int vcol(int c) { return c + (c >> 5); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The first op at or after i that is not a point op (n_ops if none).
__device__ __forceinline__ int next_step(const OpRec* rec, int i, int n_ops) {
  while (i < n_ops && rec[i].code < OP_STENCIL) ++i;
  return i;
}

// Call f(row, run) for every (row, run) of a rows x runs span, each thread
// starting at its own index and stepping NTHREADS cells in (row, run)
// order: one division a span, none a cell.
template <class F>
__device__ __forceinline__ void for_runs(int rows, int runs, F&& f) {
  if (rows <= 0 || runs <= 0) return;
  const int dq = NTHREADS / runs, dr = NTHREADS - dq * runs;
  int row = (int)threadIdx.x / runs;
  int run = (int)threadIdx.x - row * runs;
  while (row < rows) {
    f(row, run);
    run += dr;
    row += dq;
    if (run >= runs) {
      run -= runs;
      ++row;
    }
  }
}

// The P floats of a run of A at float f (a multiple of P), as vectors
template <int P>
__device__ __forceinline__ void lda(const float* A, int f, float (&o)[P]) {
  static_assert(P % 4 == 0, "a run is whole float4s");
#pragma unroll
  for (int h = 0; h < P; h += 4) {
    const float4 t = *reinterpret_cast<const float4*>(A + f + h);
    o[h] = t.x;
    o[h + 1] = t.y;
    o[h + 2] = t.z;
    o[h + 3] = t.w;
  }
}

template <int P>
__device__ __forceinline__ void sta(float* A, int f, const float (&v)[P]) {
#pragma unroll
  for (int h = 0; h < P; h += 4) {
    *reinterpret_cast<float4*>(A + f + h) =
        make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
  }
}

template <int P>
__device__ __forceinline__ void get_run(const float* A, int ch, int at,
                                        Rgb (&v)[P]) {
  float r[P], g[P], b[P];
  lda<P>(A, at, r);
  lda<P>(A + ch, at, g);
  lda<P>(A + 2 * ch, at, b);
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = {r[j], g[j], b[j]};
}

template <int P>
__device__ __forceinline__ void put_run(float* A, int ch, int at,
                                        const Rgb (&v)[P]) {
  float r[P], g[P], b[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    r[j] = v[j].r;
    g[j] = v[j].g;
    b[j] = v[j].b;
  }
  sta<P>(A, at, r);
  sta<P>(A + ch, at, g);
  sta<P>(A + 2 * ch, at, b);
}

// Point ops [from, to) of the chain (records `rec`) on track-0 values v
// of a run at frame columns x and row y
template <int P, bool FULL>
__device__ __forceinline__ void apply_run(const OpRec* rec, int from, int to,
                                          Rgb (&v)[P], const int (&x)[P],
                                          int y, float sx, float sy) {
  for (int i = from; i < to; ++i) {
    gen_point_run<P, FULL>(rec[i], v, x, y, sx, sy);
  }
}

// The chain's result for a run at output offset `at` (frame column gx, a
// multiple of P): quantised to u8, or the f32 comp when cb is not null. A
// whole run of a row whose width is a multiple of 4 stores 32-bit words of
// 4 bytes (float4s of a comp); a ragged run stores the pixels inside the
// frame one by one.
template <int P>
__device__ __forceinline__ void store_run(unsigned char* ob, float* cb,
                                          size_t plane, int W, size_t at,
                                          int gx, const Rgb (&v)[P]) {
  const bool whole = gx + P <= W && W % 4 == 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float c[P];
#pragma unroll
    for (int j = 0; j < P; ++j) c[j] = k == 0 ? v[j].r : k == 1 ? v[j].g : v[j].b;
    if (cb != nullptr) {
      float* d = cb + k * plane + at;
      if (whole) {
        sta<P>(d, 0, c);
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (gx + j < W) d[j] = c[j];
        }
      }
      continue;
    }
    unsigned q[P];
#pragma unroll
    for (int j = 0; j < P; ++j) q[j] = q8(c[j]);
    unsigned char* d = ob + k * plane + at;
    if (whole) {
#pragma unroll
      for (int w = 0; w < P / 4; ++w) {
        reinterpret_cast<unsigned*>(d)[w] =
            q[4 * w] | q[4 * w + 1] << 8 | q[4 * w + 2] << 16 |
            q[4 * w + 3] << 24;
      }
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (gx + j < W) d[j] = (unsigned char)q[j];
      }
    }
  }
}

// One separable stencil (radius r, taps kw) over rows [row0, row0 + rows)
// of the tile, one channel at a time: the vertical pass of that channel of
// A into V over the runs [vlo, vhi) that cover the columns read, then the
// horizontal pass, the mix by `amount` with the stencil's input and the
// clip, written back into that channel of A over the runs [hlo, hhi) that
// cover the columns written. The taps are summed in order, as
// _sep_conv_shifts sums them. Each thread reads V and rewrites only its
// own cells of A.
template <int P>
__device__ __forceinline__ void stencil_pass(float* A, float* V, int ch,
                                             int WS, int VS, int row0,
                                             int rows, int vlo, int vhi,
                                             int hlo, int hhi, int r,
                                             const float* kw, bool sharpen,
                                             float amount) {
  for (int c = 0; c < 3; ++c) {
    float* Ac = A + c * ch;
    __syncthreads();
    for_runs(rows, vhi - vlo, [&](int i, int run) {
      const int row = row0 + i, col = (vlo + run) * P;
      const int at = (row - r) * WS + col;
      float s[P];
#pragma unroll
      for (int j = 0; j < P; ++j) s[j] = 0.0f;
#pragma unroll 4
      for (int k = 0; k <= 2 * r; ++k) {
        float w[P];
        lda<P>(Ac, at + k * WS, w);
        const float t = kw[k];
#pragma unroll
        for (int j = 0; j < P; ++j) s[j] += t * w[j];
      }
      float* d = V + row * VS + col + (col >> 5);  // a run in one bank row
#pragma unroll
      for (int j = 0; j < P; ++j) d[j] = s[j];
    });
    __syncthreads();
    for_runs(rows, hhi - hlo, [&](int i, int run) {
      const int row = row0 + i, col = (hlo + run) * P;
      const float* vrow = V + row * VS;
      const int c0 = col - r;  // the window's first column
      float s[P], w[P];
#pragma unroll
      for (int j = 0; j < P; ++j) s[j] = 0.0f;
#pragma unroll
      for (int j = 1; j < P; ++j) w[j] = vrow[vcol(c0 + j - 1)];
#pragma unroll 4
      for (int k = 0; k <= 2 * r; ++k) {
#pragma unroll
        for (int j = 0; j + 1 < P; ++j) w[j] = w[j + 1];
        w[P - 1] = vrow[vcol(c0 + k + P - 1)];
        const float t = kw[k];
#pragma unroll
        for (int j = 0; j < P; ++j) s[j] += t * w[j];
      }
      float base[P];
      lda<P>(Ac, row * WS + col, base);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        base[j] = clip01(sharpen ? base[j] + (base[j] - s[j]) * amount
                                 : base[j] + (s[j] - base[j]) * amount);
      }
      sta<P>(Ac, row * WS + col, base);
    });
  }
}

// After a step that leaves halo `after` for a later step: outside the
// frame the plain chain pads every stencil's input with its edge value (and
// a stateful step reads the frame at clamped coordinates), so copy each
// outside cell of the span from the nearest frame cell (which lies in the
// span). Nothing to do, and no barrier, for a tile whose span lies inside
// the frame (the test is uniform over the block).
__device__ __forceinline__ void edge_fixup(float* A, int ch, int WS, int R,
                                           int M, int TH, int TW, int after,
                                           int ty0, int tx0, int H, int W) {
  if (!(ty0 - after < 0 || ty0 + TH + after > H || tx0 - after < 0 ||
        tx0 + TW + after > W)) {
    return;
  }
  __syncthreads();
  const int rows = TH + 2 * after, row0 = R - after;
  const int cols = TW + 2 * after, col0 = M - after;
  for_runs(rows, cols, [&](int i, int j) {
    const int row = row0 + i, col = col0 + j;
    const int gy = ty0 - R + row, gx = tx0 - M + col;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) return;
    const int at = row * WS + col;
    const int from = (clampi(gy, 0, H - 1) - ty0 + R) * WS
                     + (clampi(gx, 0, W - 1) - tx0 + M);
    for (int c = 0; c < 3; ++c) A[c * ch + at] = A[c * ch + from];
  });
}

}  // namespace lives
