// Live sweep (K7): one live frame of generated tracks, keyed, through a
// chain of point ops and quantised to the RGB24 sink, in a single launch.
//
// Replaces no TPU kernel. The JAX package runs `FrameGraph.run`
// (lives_tpu/graph/nodemodel.py:280-356) as one jitted plan template, so XLA
// fuses the generators, the key and the chain by itself; PyTorch runs the
// same plan eagerly, some 150 elementwise kernels a 4K frame, each reading
// and writing whole float32 planes. This kernel is the port's counterpart
// of that fusion for the plans graph/live_sweep.py takes
// (`build_live_sweep`): every track a stateless plasma or colour_bars
// generator, every enabled instance a point op of the sweep's op table, the
// sink RGB24 at the tracks' geometry.
//
// What bounds it on an H100: issue slots. It reads nothing a pixel from
// device memory and writes the 3 bytes of the u8 frame (24.9 MB at 4K, 7.4
// us at 3.35 TB/s), while each pixel costs six precise sines and cosines,
// a square root, the key's division and the chain (cardbench/work.py
// live_frame). The design:
//
// - Runs. A thread computes a horizontal run of RUN adjacent pixels of one
//   row, so the terms of plasma that depend on the row alone are computed
//   once a run, each op of the chain is decoded once a run (a one-input op
//   past the core too: `live_op`), and the pixels of a run hide each
//   other's latency. A whole run of a row whose width is a multiple of RUN
//   stores each channel as one 4-byte word; a run at a ragged right edge
//   stores byte by byte. No shared tile and no halo: point ops read no
//   neighbour.
// - Block set-up. Once a block, shared memory gets the clamped parameter
//   slots, one OpRec a chain op (sweep_common.cuh make_rec: the op's
//   frame-uniform values, by the float expressions its PyTorch function
//   computes them with) and each track's frame-uniform generator values.
// - The op table is K1's (sweep_common.cuh `point_run`, whole vocabulary),
//   with this kernel's generators standing in for the synthetic source:
//   track 0 is generated at the run's start, another track at the op that
//   reads it.
//
// Numerics: built with -fmad=false (native.EXTRA_FLAGS) and no
// --use_fast_math, so every multiply and add is rounded on its own, as
// PyTorch's eager kernels round them, and sinf, cosf, sqrtf, expf and the
// divisions are CUDA's precise ones, which PyTorch's eager kernels call. A
// generated track is quantised to u8 round-half-up and brought back into
// [0, 1] by float32(1/255), as the eager route's generator output and its
// chain's entry do; the sink quantise is sweep_common.cuh's q8.
//
// Layout of one launch: a 1-D grid of blocks of `threads` threads (at most
// THREADS) over the frame's H * ceil(W / RUN) runs in row order; packed (n,)
// f32, the frame's column (`FrameGraph.run`'s rows); ops (n_ops,
// OP_FIELDS) int32 as graph/fused_sweep.py encode_point writes them;
// slot_rows/slot_vals map each parameter slot to its packed row (or a
// constant) and its clamp; consts hold a point op's constants (iris_circle);
// gens (T, GEN_FIELDS) int32, each track's generator and its packed rows;
// out (3, H, W) u8. Shared memory: the slots and the tracks' GenRecs
// (static), the n_ops OpRecs (dynamic, 112 B each: at most 28 KB).

#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using namespace lives;

constexpr int THREADS = 256;        // the most threads a block takes
// pixels a thread: on an H100 at 4K, runs of 4 took 0.955-0.976x the time of
// runs of 8 on every chain of the live cell at 256 threads a block, and 256
// threads 0.92-0.97x the time of 64 or 128 (PERF.md, K7)
constexpr int RUN = 4;
constexpr int MAX_TRACKS = 16;      // graph/live_sweep.py MAX_TRACKS
constexpr int MAX_OPS = MAX_SLOTS;  // graph/live_sweep.py MAX_OPS

// the generators (graph/live_sweep.py GENERATORS) and their table's fields
enum GenKind { GEN_PLASMA = 0, GEN_COLOUR_BARS = 1 };
enum GenField { G_KIND = 0, G_TC = 1, G_SPEED = 2, G_SCALE = 3 };
constexpr int GEN_FIELDS = 4;

// float32 of pi, cos(2 pi / 3) and sin(2 pi / 3), cos(4 pi / 3) and
// sin(4 pi / 3): effects/builtin/generators.py's np.pi, _COS1, _SIN1,
// _COS2, _SIN2 as a float32 multiply rounds them
__device__ __forceinline__ float pi_f() { return __int_as_float(0x40490fdb); }
constexpr float COS1 = -0.5f, COS2 = -0.5f;
__device__ __forceinline__ float sin1() { return __int_as_float(0x3f5db3d7); }
__device__ __forceinline__ float sin2() { return __int_as_float(0xbf5db3d7); }

// One track's generator for the frame: its kind, and plasma's phase
// t = tc * speed * 3 and spatial scale s = scale * 10 + 1
// (generators.py `_plasma`; a generator's values are not clamped)
struct alignas(16) GenRec {
  int kind;
  float t, s, pad;
};

__device__ __forceinline__ GenRec gen_rec(const int* g, const float* packed) {
  GenRec r;
  r.kind = g[G_KIND];
  r.t = r.s = r.pad = 0.0f;
  if (r.kind == GEN_PLASMA) {
    r.t = packed[g[G_TC]] * packed[g[G_SPEED]] * 3.0f;
    r.s = packed[g[G_SCALE]] * 10.0f + 1.0f;
  }
  return r;
}

// A generated channel value as the chain sees it: quantised to u8 as the
// generator's `_out_layer` does, then times float32(1/255)
__device__ __forceinline__ float gen_chan(float v) { return chan(q8(v)); }

// plasma (generators.py `_plasma`) over a run at columns x, row y, in its
// order of operations; gx, gy: float32(1 / max(n - 1, 1)), `_grid`'s scales
template <int P>
__device__ __forceinline__ void plasma_run(const GenRec& g, const int (&x)[P],
                                           int y, float gx, float gy,
                                           Rgb (&o)[P]) {
  const float t = g.t, s = g.s;
  const float yv = exact_float((unsigned)y) * gy;
  const float ys = yv * s;
  const float a2 = sinf((ys + t) * 0.7f);
  const float dy = yv - 0.5f;
  const float dy2 = dy * dy;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float xv = exact_float((unsigned)x[j]) * gx;
    const float xs = xv * s;
    const float a1 = sinf(xs + t);
    const float a3 = sinf((xs + ys + t) * 0.5f);
    const float dx = xv - 0.5f;
    const float a4 = sinf(sqrtf(dx * dx + dy2) * s * 2.0f + t);
    const float v = (a1 + a2 + a3 + a4) * 0.25f;
    const float ph = v * pi_f();
    const float sv = sinf(ph), cv = cosf(ph);
    o[j] = {gen_chan(0.5f + 0.5f * sv),
            gen_chan(0.5f + 0.5f * (sv * COS1 + cv * sin1())),
            gen_chan(0.5f + 0.5f * (sv * COS2 + cv * sin2()))};
  }
}

// colour_bars (generators.py `_colour_bars`) over a run at columns x: bar
// k = trunc(min(x * 8, 7)); R where bit 1 of k is clear, G bit 2, B bit 0
template <int P>
__device__ __forceinline__ void bars_run(const int (&x)[P], float gx,
                                         Rgb (&o)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float xv = exact_float((unsigned)x[j]) * gx;
    const int bar = __float2int_rz(fminf(xv * 8.0f, 7.0f));
    o[j] = {gen_chan((bar >> 1 & 1) == 0 ? 1.0f : 0.0f),
            gen_chan((bar >> 2 & 1) == 0 ? 1.0f : 0.0f),
            gen_chan((bar & 1) == 0 ? 1.0f : 0.0f)};
  }
}

template <int P>
__device__ __forceinline__ void gen_track(const GenRec& g, const int (&x)[P],
                                          int y, float gx, float gy,
                                          Rgb (&o)[P]) {
  if (g.kind == GEN_PLASMA) {
    plasma_run<P>(g, x, y, gx, gy, o);
  } else {
    bars_run<P>(x, gx, o);
  }
}

// One channel of a run quantised to u8 and stored at d (frame column gx0):
// one 4-byte word where the run is whole and aligned, else byte by byte
template <int P>
__device__ __forceinline__ void store_chan(unsigned char* d, bool word,
                                           int gx0, int W,
                                           const float (&c)[P]) {
  static_assert(P == 4, "a run is one 4-byte word");
  unsigned q[P];
#pragma unroll
  for (int j = 0; j < P; ++j) q[j] = q8(c[j]);
  if (word) {
    *reinterpret_cast<unsigned*>(d) =
        q[0] | q[1] << 8 | q[2] << 16 | q[3] << 24;
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (gx0 + j < W) d[j] = (unsigned char)q[j];
    }
  }
}

// one_in_rest with its opcode a constant C, so that the op's switch folds
// away inside each pixel of the run
template <int C, int P>
__device__ __forceinline__ void one_in_op(const OpRec& o, const Rgb (&a)[P],
                                          Rgb (&v)[P]) {
  OpRec f = o;
  f.code = C;
  one_in_rest<P>(f, a, v);
}

// Op `o` of the chain on track-0 values v of a run: point_run, except that a
// one-input op past the core is dispatched once a run, not once a pixel
template <int P, class Track>
__device__ __forceinline__ void live_op(const OpRec& o, Rgb (&v)[P],
                                        const Track& track,
                                        const int (&x)[P], int y, float sx,
                                        float sy) {
  if (o.code <= OP_VIGNETTE || o.code >= OP_STENCIL) {
    point_run<P, true>(o, v, track, x, y, sx, sy);
    return;
  }
  Rgb a[P];
  if (o.in0 == 0) {
#pragma unroll
    for (int j = 0; j < P; ++j) a[j] = v[j];
  } else {
    track(o.a, o.in0, a);
  }
  switch (o.code) {
    case OP_NEGATE: one_in_op<OP_NEGATE, P>(o, a, v); break;
    case OP_BRIGHTNESS_CONTRAST:
      one_in_op<OP_BRIGHTNESS_CONTRAST, P>(o, a, v);
      break;
    case OP_GAMMA_ADJUST: one_in_op<OP_GAMMA_ADJUST, P>(o, a, v); break;
    case OP_LEVELS: one_in_op<OP_LEVELS, P>(o, a, v); break;
    case OP_GREYSCALE: one_in_op<OP_GREYSCALE, P>(o, a, v); break;
    case OP_SEPIA: one_in_op<OP_SEPIA, P>(o, a, v); break;
    case OP_POSTERIZE: one_in_op<OP_POSTERIZE, P>(o, a, v); break;
    case OP_SOLARIZE: one_in_op<OP_SOLARIZE, P>(o, a, v); break;
    case OP_THRESHOLD: one_in_op<OP_THRESHOLD, P>(o, a, v); break;
    case OP_SOFTLIGHT: one_in_op<OP_SOFTLIGHT, P>(o, a, v); break;
    case OP_TINT: one_in_op<OP_TINT, P>(o, a, v); break;
    case OP_HUE_ROTATE: one_in_op<OP_HUE_ROTATE, P>(o, a, v); break;
    case OP_MODULATE: one_in_op<OP_MODULATE, P>(o, a, v); break;
    default: one_in_op<OP_COLOUR_REPLACE, P>(o, a, v);
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS) live_sweep_kernel(
    const float* __restrict__ packed, const int* __restrict__ ops, int n_ops,
    const int* __restrict__ slot_rows, const float* __restrict__ slot_vals,
    int n_slots, const float* __restrict__ consts,
    const int* __restrict__ gens, int T, unsigned char* __restrict__ out,
    int H, int W, int runs, int word, float sx, float sy, float gx,
    float gy) {
  __shared__ float sp[MAX_SLOTS];
  __shared__ GenRec gr[MAX_TRACKS];
  extern __shared__ float4 smem4[];  // n_ops OpRecs
  OpRec* const rec = reinterpret_cast<OpRec*>(smem4);
  const int nt = blockDim.x;
  // this frame's parameter slots, clamped as Param.clamp does
  for (int j = threadIdx.x; j < n_slots; j += nt) {
    const int row = slot_rows[j];
    const float v = row >= 0 ? packed[row] : slot_vals[3 * j];
    sp[j] = fminf(fmaxf(v, slot_vals[3 * j + 1]), slot_vals[3 * j + 2]);
  }
  for (int t = threadIdx.x; t < T; t += nt) {
    gr[t] = gen_rec(gens + t * GEN_FIELDS, packed);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_ops; i += nt) {
    const int* o = ops + i * OP_FIELDS;
    rec[i] = make_rec(o, sp + o[F_SLOT], nullptr, consts);
  }
  __syncthreads();

  const int idx = blockIdx.x * nt + threadIdx.x;
  if (idx >= H * runs) return;
  const int y = idx / runs;
  const int gx0 = (idx - y * runs) * P;
  int x[P];
#pragma unroll
  for (int j = 0; j < P; ++j) x[j] = min(gx0 + j, W - 1);
  Rgb v[P];
  gen_track<P>(gr[0], x, y, gx, gy, v);
  const auto track = [&](const TrackRec&, int t, Rgb (&o)[P]) {
    gen_track<P>(gr[t], x, y, gx, gy, o);
  };
  for (int i = 0; i < n_ops; ++i) {
    live_op<P>(rec[i], v, track, x, y, sx, sy);
  }
  const size_t plane = (size_t)H * W, at = (size_t)y * W + gx0;
  const bool whole = word != 0 && gx0 + P <= W;
  float c[P];
#pragma unroll
  for (int j = 0; j < P; ++j) c[j] = v[j].r;
  store_chan<P>(out + at, whole, gx0, W, c);
#pragma unroll
  for (int j = 0; j < P; ++j) c[j] = v[j].g;
  store_chan<P>(out + plane + at, whole, gx0, W, c);
#pragma unroll
  for (int j = 0; j < P; ++j) c[j] = v[j].b;
  store_chan<P>(out + 2 * plane + at, whole, gx0, W, c);
}

}  // namespace

extern "C" {

// Launch one live frame on `stream` in blocks of `threads` threads (from
// graph/live_sweep.py); returns cudaGetLastError() (0 = launched). A launch
// the kernel does not take is refused.
int lives_live_sweep(const float* packed, const int* ops, int n_ops,
                     const int* slot_rows, const float* slot_vals,
                     int n_slots, const float* consts, const int* gens,
                     int T, unsigned char* out, int H, int W, float sx,
                     float sy, float gx, float gy, int threads,
                     void* stream) {
  const int runs = (W + RUN - 1) / RUN;
  if (n_slots < 0 || n_slots > MAX_SLOTS || n_ops < 0 || n_ops > MAX_OPS ||
      T < 1 || T > MAX_TRACKS || H < 1 || W < 1 || threads < 32 ||
      threads > THREADS || threads % 32 != 0 ||
      (long long)H * runs > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  // a word a channel: every row starts on a word when W is a multiple of RUN
  const int word = W % RUN == 0 && (uintptr_t)out % RUN == 0;
  const int blocks = (int)(((long long)H * runs + threads - 1) / threads);
  live_sweep_kernel<RUN><<<blocks, threads, n_ops * sizeof(OpRec),
                           (cudaStream_t)stream>>>(
      packed, ops, n_ops, slot_rows, slot_vals, n_slots, consts, gens, T,
      out, H, W, runs, word, sx, sy, gx, gy);
  return (int)cudaGetLastError();
}

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
