// Fused render sweep: source generation + a stateless effect chain + the
// RGB24 sink quantise, one kernel per frame chunk.
//
// Replaces the TPU kernel lives_tpu/graph/pallas_composite.py:
// build_fused_sweep (default mode, emit="u8"). It computes what that kernel
// computes, not block by block what it does.
//
// What bounds it on an H100: f32 (and int32) ALU work on the halo'd fold.
// Every track is generated from integer formulas inside the kernel, so the
// only device-memory traffic is the u8 write, 3 bytes a pixel (597 MB for a
// 96-frame 1080p chunk, 0.18 ms at 3.35 TB/s), while each output pixel costs
// hundreds of ALU instructions (10 generated tracks, 9 transitions with
// IEEE divisions and a square root, a 7+7-tap stencil, expf). The design
// keeps everything in registers and shared memory and spends its effort on
// not repeating the fold: the pre-stencil composite of a tile plus its halo
// is computed once, staged in shared memory, and read there by every tap.
// Making it fast (tile shape, op specialisation instead of the interpreted
// op loop, register blocking) is later work.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
// -shared -Xcompiler -fPIC and loaded with ctypes (lives_tpu_torch/native).
// No --use_fast_math: vignette's expf, chroma_key's sqrtf and divisions and
// the round-half-up quantise stay IEEE for the +/-1 LSB contract.
//
// Layout of one launch:
//   grid (ceil(W/TILE_W), ceil(H/TILE_H), B), NTHREADS threads a block;
//   packed (P+2, B) f32 per-frame parameters, rows as the plan encodes them;
//   ids (2, T, B) int32 clip ids then frame numbers of each track;
//   ops (n_ops, OP_FIELDS) int32, the chain as encoded by
//   lives_tpu_torch/graph/fused_sweep.py (_encode); slot_rows/slot_vals map
//   each parameter slot to its packed row (or a constant) and its clamp;
//   taps hold each stencil's renormalised f32 taps;
//   out (B, 3, H, W) u8.
// Phase 1 evaluates, for every pixel of the tile and its halo R (the sum of
// the stencil radii), at coordinates clamped to the frame: track 0, then
// the ops before the first stencil, generating another track only at the
// op that reads it (only track 0 is ever written). Phase 2, per stencil:
// a vertical then a horizontal pass in shared memory, the mix by `amount`,
// the clip, and the ops up to the next stencil (track 0 only); before a
// further stencil the frame edge is copied outward over the halo again, as
// the plain chain pads each stencil's input. The last pass quantises and
// writes the tile, masking the ragged frame edge.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 32;
constexpr int NTHREADS = 256;
constexpr int MAX_SLOTS = 256;
constexpr int OP_FIELDS = 7;

// opcodes and op fields: keep in step with graph/fused_sweep.py
enum OpCode {
  OP_CROSSFADE = 0,
  OP_BLEND = 1,
  OP_LUMA_KEY = 2,
  OP_CHROMA_KEY = 3,
  OP_COLOUR_BALANCE = 4,
  OP_SATURATION = 5,
  OP_VIGNETTE = 6,
  OP_STENCIL = 7,
};
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

// Ops [from, to) of the chain on track-0 value `v` at frame pixel (x, y).
__device__ Rgb apply_ops(const int* ops, int from, int to, const float* sp,
                         Rgb v, const Frame& fr, int x, int y) {
  for (int i = from; i < to; ++i) {
    const int* o = ops + i * OP_FIELDS;
    const float* p = sp + o[F_SLOT];
    const int code = o[F_CODE];
    const Rgb a = o[F_IN0] == 0 ? v : gen(fr, o[F_IN0], x, y);
    if (code <= OP_CHROMA_KEY) {  // transitions: fg a over bg
      const Rgb bg = o[F_IN1] == 0 ? v : gen(fr, o[F_IN1], x, y);
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
      const float xf = (float)x * fr.sx - 1.0f;
      const float yf = (float)y * fr.sy - 1.0f;
      const float r2 = xf * xf + yf * yf;
      const float m = 1.0f - p[0] * (1.0f - expf(-r2 * p[1] * 2.0f));
      v = clip01({a.r * m, a.g * m, a.b * m});
    }
  }
  return v;
}

// clip(floor(x*255 + 0.5)) to u8, rounded in two steps as the reference
// does (no fused multiply-add)
__device__ __forceinline__ unsigned char q8(float v) {
  const float q = floorf(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f));
  return (unsigned char)fminf(fmaxf(q, 0.0f), 255.0f);
}

__device__ __forceinline__ void store(unsigned char* ob, size_t plane,
                                      size_t at, Rgb v) {
  ob[at] = q8(v.r);
  ob[plane + at] = q8(v.g);
  ob[2 * plane + at] = q8(v.b);
}

__device__ __forceinline__ int next_stencil(const int* ops, int i,
                                            int n_ops) {
  while (i < n_ops && ops[i * OP_FIELDS + F_CODE] != OP_STENCIL) ++i;
  return i;
}

__global__ void __launch_bounds__(NTHREADS) fused_sweep_kernel(
    const float* __restrict__ packed, const int* __restrict__ ids,
    const int* __restrict__ ops, int n_ops,
    const int* __restrict__ slot_rows, const float* __restrict__ slot_vals,
    int n_slots, const float* __restrict__ taps,
    unsigned char* __restrict__ out, int T, int B, int H, int W, int R,
    float sx, float sy) {
  __shared__ float sp[MAX_SLOTS];
  extern __shared__ float smem[];
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE_H;
  const int tx0 = blockIdx.x * TILE_W;
  // this frame's parameter slots, clamped as Param.clamp does
  for (int j = threadIdx.x; j < n_slots; j += NTHREADS) {
    const int row = slot_rows[j];
    const float v = row >= 0 ? packed[(size_t)row * B + b]
                             : slot_vals[3 * j];
    sp[j] = fminf(fmaxf(v, slot_vals[3 * j + 1]), slot_vals[3 * j + 2]);
  }
  __syncthreads();

  const Frame fr{ids, T, B, b, sx, sy};
  const size_t plane = (size_t)H * W;
  unsigned char* ob = out + (size_t)b * 3 * plane;
  const int HA = TILE_H + 2 * R, WA = TILE_W + 2 * R;
  const int ch = HA * WA;  // one channel of a staging buffer
  float* A = smem;         // the composite, indexed by halo coordinates
  float* V = smem + 3 * ch;  // a stencil's vertical pass
  const int first = next_stencil(ops, 0, n_ops);

  // phase 1: generate + pre-stencil ops over the tile and its halo
  for (int idx = threadIdx.x; idx < ch; idx += NTHREADS) {
    const int ly = idx / WA, lx = idx - (idx / WA) * WA;
    const int gy = ty0 - R + ly, gx = tx0 - R + lx;
    const int y = min(max(gy, 0), H - 1), x = min(max(gx, 0), W - 1);
    Rgb v = apply_ops(ops, 0, first, sp, gen(fr, 0, x, y), fr, x, y);
    if (first == n_ops) {
      if (gy < H && gx < W) store(ob, plane, (size_t)gy * W + gx, v);
    } else {
      A[idx] = v.r;
      A[ch + idx] = v.g;
      A[2 * ch + idx] = v.b;
    }
  }

  // phase 2: each stencil, then the ops up to the next one
  int cur = R;  // halo still valid in A
  for (int si = first; si < n_ops;) {
    const int* o = ops + si * OP_FIELDS;
    const int r = o[F_ARG];
    const float* kw = taps + o[F_TAPS];
    const bool sharpen = o[F_SHARPEN] != 0;
    const float amount = sp[o[F_SLOT]];
    const int next = next_stencil(ops, si + 1, n_ops);
    const int after = cur - r;
    const int n = 2 * r + 1;
    __syncthreads();
    // vertical: rows [R-after, R+TILE_H+after), columns [R-cur, R+TILE_W+cur)
    const int vh = TILE_H + 2 * after, vw = TILE_W + 2 * cur;
    for (int idx = threadIdx.x; idx < vh * vw; idx += NTHREADS) {
      const int ly = R - after + idx / vw, lx = R - cur + idx % vw;
      for (int c = 0; c < 3; ++c) {
        const float* src = A + c * ch + (ly - r) * WA + lx;
        float s = 0.0f;
        for (int k = 0; k < n; ++k) s += kw[k] * src[k * WA];
        V[c * ch + ly * WA + lx] = s;
      }
    }
    __syncthreads();
    // horizontal + mix + clip + the following ops; each thread reads and
    // writes only its own A cells here, so no barrier is needed inside
    const bool last = next == n_ops;
    const int hw = TILE_W + 2 * after;
    for (int idx = threadIdx.x; idx < vh * hw; idx += NTHREADS) {
      const int ly = R - after + idx / hw, lx = R - after + idx % hw;
      const int gy = ty0 - R + ly, gx = tx0 - R + lx;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      if (!inside && !last) continue;  // replicated from the edge below
      const int at = ly * WA + lx;
      float res[3];
      for (int c = 0; c < 3; ++c) {
        const float* src = V + c * ch + at - r;
        float s = 0.0f;
        for (int k = 0; k < n; ++k) s += kw[k] * src[k];
        const float base = A[c * ch + at];
        res[c] = clip01(sharpen ? base + (base - s) * amount
                                : base + (s - base) * amount);
      }
      const Rgb v = apply_ops(ops, si + 1, next, sp,
                              {res[0], res[1], res[2]}, fr,
                              min(max(gx, 0), W - 1), min(max(gy, 0), H - 1));
      if (last) {
        if (inside) store(ob, plane, (size_t)gy * W + gx, v);
      } else {
        A[at] = v.r;
        A[ch + at] = v.g;
        A[2 * ch + at] = v.b;
      }
    }
    if (!last) {
      // The next stencil reads this result over its halo. Outside the frame
      // the plain chain pads every stencil's input with its edge value, so
      // copy each outside cell from the nearest frame cell (which lies in
      // this region) instead of keeping a stencil evaluated off the frame.
      __syncthreads();
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
    cur = after;
    si = next;
  }
}

}  // namespace

extern "C" {

// Launch one sweep on `stream`; returns cudaGetLastError() (0 = launched).
int lives_fused_sweep(const float* packed, const int* ids, const int* ops,
                      int n_ops, const int* slot_rows,
                      const float* slot_vals, int n_slots, const float* taps,
                      unsigned char* out, int T, int B, int H, int W, int R,
                      int n_stencils, float sx, float sy, void* stream) {
  if (n_slots > MAX_SLOTS || B > 65535 || T < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = n_stencils
      ? (size_t)2 * 3 * (TILE_H + 2 * R) * (TILE_W + 2 * R) * sizeof(float)
      : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  fused_sweep_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      packed, ids, ops, n_ops, slot_rows, slot_vals, n_slots, taps, out, T,
      B, H, W, R, sx, sy);
  return (int)cudaGetLastError();
}

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
