// Device code shared by the sweep kernels and the composite kernel: the op
// table's opcodes, the synthetic source, the point ops and the separable
// stencil passes over shared memory.
//
// fused_sweep.cu (the JAX package's build_fused_sweep), stateful_sweep.cu
// (build_fused_stateful_sweep) and composite.cu (build_composite) include
// it, so the kernels evaluate one definition of every op. The op table is
// encoded by lives_tpu_torch/graph/fused_sweep.py (_encode, `point_op_row`);
// keep the constants in step with it.

#pragma once

#include <cuda_runtime.h>

namespace lives {

constexpr int TILE_H = 32;
constexpr int TILE_W = 32;
constexpr int NTHREADS = 256;
constexpr int MAX_SLOTS = 256;
constexpr int OP_FIELDS = 7;

enum OpCode {
  OP_CROSSFADE = 0,
  OP_BLEND = 1,
  OP_LUMA_KEY = 2,
  OP_CHROMA_KEY = 3,
  OP_COLOUR_BALANCE = 4,
  OP_SATURATION = 5,
  OP_VIGNETTE = 6,
  // the steps that are not point ops: each ends a run of point ops
  OP_STENCIL = 7,
  OP_FIRE = 8,
  OP_LIFE = 9,
  OP_ALIEN = 10,
};
// F_ARG: a stencil's radius, a blend's mode, a stateful step's state index
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

// float32(1/255), the u8 -> float factor of the reference
__device__ __forceinline__ float chan(unsigned v) {
  return (float)(v & 0xFFu) * __int_as_float(0x3b808081);
}

// DeviceSyntheticSource._channels (lives_tpu/scenes.py:34). Unsigned
// arithmetic wraps as the reference's int32 does; the divisions and
// remainders only see non-negative operands for a non-blank clip, where C's
// truncation equals the reference's floor. A negative clip id is blank.
__device__ Rgb gen(const Frame& fr, int t, int x, int y) {
  const int c = fr.ids[t * fr.B + fr.b];
  const int f = fr.ids[(fr.T + t) * fr.B + fr.b];
  if (c < 0) return {0.0f, 0.0f, 0.0f};
  const unsigned phase = (unsigned)c * 37u + (unsigned)f * 3u;
  const unsigned r = (unsigned)(x * (3 + c % 5) / 16) + phase;
  const unsigned g = (unsigned)(y * (2 + c % 3) / 8) - phase * 2u;
  const unsigned b = (unsigned)((x + y) / 8) + phase * 5u;
  return {chan(r), chan(g), chan(b)};
}

// _BLEND_MODES of effects/builtin/blends.py, in its order
__device__ __forceinline__ float blend(int mode, float a, float b) {
  switch (mode) {
    case 0: return a + b;                                  // add
    case 1: return b - a;                                  // subtract
    case 2: return a * b;                                  // multiply
    case 3: return 1.0f - (1.0f - a) * (1.0f - b);         // screen
    case 4: return fminf(a, b);                            // darken
    case 5: return fmaxf(a, b);                            // lighten
    case 6: return fabsf(a - b);                           // difference
    case 7: return a + b - 2.0f * a * b;                   // exclusion
    case 8: return b <= 0.5f ? 2.0f * a * b                // overlay
                             : 1.0f - 2.0f * (1.0f - a) * (1.0f - b);
    case 9: return a <= 0.5f ? 2.0f * a * b                // hardlight
                             : 1.0f - 2.0f * (1.0f - a) * (1.0f - b);
    case 10: return b / fmaxf(1.0f - a, 1e-3f);            // dodge
    case 11: return 1.0f - (1.0f - b) / fmaxf(a, 1e-3f);   // burn
    case 12: return b - a + 0.5f;                          // grain extract
    default: return b + a - 0.5f;                          // grain merge
  }
}

__device__ __forceinline__ Rgb mix(Rgb e, Rgb bg, float t) {
  return clip01({e.r * t + bg.r * (1.0f - t), e.g * t + bg.g * (1.0f - t),
                 e.b * t + bg.b * (1.0f - t)});
}

// key fg over bg with a per-pixel alpha (keying.py: no clip)
__device__ __forceinline__ Rgb key(Rgb fg, Rgb bg, float al) {
  return {fg.r * al + bg.r * (1.0f - al), fg.g * al + bg.g * (1.0f - al),
          fg.b * al + bg.b * (1.0f - al)};
}

// One point op (op-table row `o`, its parameter slots `p`) on track-0 value
// `v` at frame pixel (x, y); `track(t)` gives another track's value there.
// The centred-grid scales sx, sy serve vignette. The sweeps generate a
// track where the composite kernel (composite.cu) loads it.
template <class Track>
__device__ __forceinline__ Rgb point_op(const int* o, const float* p, Rgb v,
                                        const Track& track, float sx,
                                        float sy, int x, int y) {
  const int code = o[F_CODE];
  const Rgb a = o[F_IN0] == 0 ? v : track(o[F_IN0]);
  if (code <= OP_CHROMA_KEY) {  // transitions: fg a over bg
    const Rgb bg = o[F_IN1] == 0 ? v : track(o[F_IN1]);
    if (code == OP_CROSSFADE) {
      v = mix(a, bg, p[0]);
    } else if (code == OP_BLEND) {
      const int m = o[F_ARG];
      v = mix({blend(m, a.r, bg.r), blend(m, a.g, bg.g),
               blend(m, a.b, bg.b)}, bg, p[0]);
    } else if (code == OP_LUMA_KEY) {
      // threshold, softness, invert
      float al = clip01((luma(a) - p[0]) / (p[1] + 1e-4f));
      al = al * (1.0f - p[2]) + (1.0f - al) * p[2];
      v = key(a, bg, al);
    } else {
      // red, green, blue, tolerance, softness
      const float s = a.r + a.g + a.b + 1e-4f;
      const float r = a.r / s, g = a.g / s;
      const float ks = p[0] + p[1] + p[2] + 1e-4f;
      const float kr = p[0] / ks, kg = p[1] / ks;
      const float d = sqrtf((r - kr) * (r - kr) + (g - kg) * (g - kg));
      v = key(a, bg, clip01((d - p[3]) / (p[4] + 1e-4f)));
    }
  } else if (code == OP_COLOUR_BALANCE) {
    v = clip01({a.r * p[0], a.g * p[1], a.b * p[2]});
  } else if (code == OP_SATURATION) {
    const float g = luma(a);
    v = clip01({g + (a.r - g) * p[0], g + (a.g - g) * p[0],
                g + (a.b - g) * p[0]});
  } else {  // OP_VIGNETTE: amount, strength
    const float xf = (float)x * sx - 1.0f;
    const float yf = (float)y * sy - 1.0f;
    const float r2 = xf * xf + yf * yf;
    const float m = 1.0f - p[0] * (1.0f - expf(-r2 * p[1] * 2.0f));
    v = clip01({a.r * m, a.g * m, a.b * m});
  }
  return v;
}

// Point ops [from, to) of the chain on track-0 value `v` at frame pixel
// (x, y); another track is generated at the op that reads it.
__device__ Rgb apply_ops(const int* ops, int from, int to, const float* sp,
                         Rgb v, const Frame& fr, int x, int y) {
  const auto track = [&](int t) { return gen(fr, t, x, y); };
  for (int i = from; i < to; ++i) {
    const int* o = ops + i * OP_FIELDS;
    v = point_op(o, sp + o[F_SLOT], v, track, fr.sx, fr.sy, x, y);
  }
  return v;
}

// clip(floor(x*255 + 0.5)) to u8, rounded in two steps as the reference
// does (no fused multiply-add)
__device__ __forceinline__ unsigned char q8(float v) {
  const float q = floorf(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f));
  return (unsigned char)fminf(fmaxf(q, 0.0f), 255.0f);
}

// The first op at or after i that is not a point op (n_ops if none).
__device__ __forceinline__ int next_step(const int* ops, int i, int n_ops) {
  while (i < n_ops && ops[i * OP_FIELDS + F_CODE] < OP_STENCIL) ++i;
  return i;
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

// One channel-interleaved staging buffer: channel c of cell `at` of a
// (TILE_H + 2R) x (TILE_W + 2R) tile with halo, `ch` cells a channel.
__device__ __forceinline__ Rgb get(const float* S, int ch, int at) {
  return {S[at], S[ch + at], S[2 * ch + at]};
}

__device__ __forceinline__ void put(float* S, int ch, int at, Rgb v) {
  S[at] = v.r;
  S[ch + at] = v.g;
  S[2 * ch + at] = v.b;
}

// A stencil's vertical pass, A -> V, over rows [R-after, R+TILE_H+after)
// and columns [R-cur, R+TILE_W+cur) in halo coordinates: the taps summed in
// order, as _sep_conv_shifts sums them.
__device__ __forceinline__ void vertical_pass(const float* A, float* V,
                                              int WA, int ch, int R,
                                              int cur, int after, int r,
                                              const float* kw) {
  const int vh = TILE_H + 2 * after, vw = TILE_W + 2 * cur;
  const int n = 2 * r + 1;
  for (int idx = threadIdx.x; idx < vh * vw; idx += NTHREADS) {
    const int ly = R - after + idx / vw, lx = R - cur + idx % vw;
    for (int c = 0; c < 3; ++c) {
      const float* src = A + c * ch + (ly - r) * WA + lx;
      float s = 0.0f;
      for (int k = 0; k < n; ++k) s += kw[k] * src[k * WA];
      V[c * ch + ly * WA + lx] = s;
    }
  }
}

// A stencil's horizontal pass at cell `at` (V -> blurred), then the mix by
// `amount` with the stencil's input A and the clip.
__device__ __forceinline__ Rgb horizontal_mix(const float* A, const float* V,
                                              int ch, int at, int r,
                                              const float* kw, bool sharpen,
                                              float amount) {
  float res[3];
  const int n = 2 * r + 1;
  for (int c = 0; c < 3; ++c) {
    const float* src = V + c * ch + at - r;
    float s = 0.0f;
    for (int k = 0; k < n; ++k) s += kw[k] * src[k];
    const float base = A[c * ch + at];
    res[c] = clip01(sharpen ? base + (base - s) * amount
                            : base + (s - base) * amount);
  }
  return {res[0], res[1], res[2]};
}

// After a stencil with halo `after` still to be read: outside the frame the
// plain chain pads every stencil's input with its edge value, so copy each
// outside cell of the span from the nearest frame cell (which lies in the
// span) instead of keeping a stencil evaluated off the frame.
__device__ __forceinline__ void edge_fixup(float* A, int WA, int ch, int R,
                                           int after, int ty0, int tx0,
                                           int H, int W) {
  const int vh = TILE_H + 2 * after, hw = TILE_W + 2 * after;
  for (int idx = threadIdx.x; idx < vh * hw; idx += NTHREADS) {
    const int ly = R - after + idx / hw, lx = R - after + idx % hw;
    const int gy = ty0 - R + ly, gx = tx0 - R + lx;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) continue;
    const int at = ly * WA + lx;
    const int from = (min(max(gy, 0), H - 1) - ty0 + R) * WA
                     + (min(max(gx, 0), W - 1) - tx0 + R);
    for (int c = 0; c < 3; ++c) A[c * ch + at] = A[c * ch + from];
  }
}

}  // namespace lives
