// The composite kernel K4: the coordinate-free point-op prefix of a chain
// over N decoded (device-memory) u8 tracks, one launch per frame chunk.
//
// Replaces the TPU kernel lives_tpu/graph/pallas_composite.py:
// build_composite (body :129-157, call :170). That kernel traces each
// filter's `process` on u8 layers, so every stage's result is quantised to
// u8 before the next stage reads it; this kernel computes the same: for
// each op it converts its inputs' u8 values to [0,1] floats (x * 1/255),
// runs the point op of sweep_common.cuh (every member of PALLAS_SAFE: one
// instance, `point_run<RUN, true>`, which ran config D's prefix no slower
// than the core vocabulary's on an H100, PERF.md), and rounds the result
// to u8
// (floor(x*255+0.5), clipped), kept in registers. Only track 0 is ever
// written (the prefix writes track 0 alone). Traced parameters are clamped
// as Param.clamp does (load_slots), and each op's record (sweep_common.cuh
// make_rec: its fields and frame-uniform values) is made once a block in
// shared memory. The TPU kernel's tile pick (w % 128, h % 8) has no
// counterpart: the vocabulary is coordinate-free, so a block owns a span of
// the flattened frame plane and a run of pixels may cross a row's end.
//
// What bounds it on an H100: its bytes would be device memory's: for 10
// tracks it reads 30 B a pixel and writes 3; a 96-frame 1080p chunk is
// 6.57 GB, 1.96 ms at 3.35 TB/s. On the card its arithmetic bounds it
// instead (PERF.md): the time grows with the stages, about 0.85 ms a
// stage of a 1080p chunk (0.75 for a crossfade) whatever the bytes, and
// staging every byte before the ops (below) did not move it. A
// stage's u8 round trip is part of what it computes (the JAX kernel
// quantises after every stage, and -fmad=false keeps each multiply and add
// apart), so what the design can do is spend no instruction it need not:
//
// - Staging. A block owns `span` pixels of frame b's plane. Before any op
//   it issues the copies of every byte it will read (3 planes of each
//   distinct track the prefix reads, `tracks_read` of
//   graph/composite.py, a track read twice staged once) into shared
//   memory with 16-byte cp.async, then waits once. Each segment is placed
//   at the offset that keeps its source's 16-byte alignment, so a plane
//   that does not start on 16 bytes (H*W not a multiple of 16, or a track
//   that is a view at an offset) and the ragged end of the plane are
//   copied in the same kernel: the bytes before the first 16-byte boundary
//   and after the last one with single-byte loads (cp.async copies 4, 8 or
//   16 bytes), the rest 16 bytes at a time. graph/composite.py
//   composite_geometry picks the span so that the staged bytes stay within
//   a budget that keeps two or more blocks on an SM (10 tracks: 2,048
//   pixels, 61,920 B; smaller spans measured slower).
// - Runs. A thread then computes runs of RUN = 4 pixels from shared memory
//   (sweep_common.cuh point_run), the op loop outside and the run inside,
//   reading 32-bit words of 4 pixels where the segment allows, and stores
//   32-bit words where the output is aligned (bytes at the plane's end).
// - No conversions. A stage's u8 value lives as the float 2^23 + q
//   (chan_f, q8f below), exactly the values of chan and q8, so a stage
//   makes no float-to-integer conversion (a quarter-rate instruction).
// - Launch bounds __launch_bounds__(NTHREADS, 4): 56 registers, no spills,
//   3 blocks an SM (shared memory sets it) on an H100. Runs of 8 at
//   (NTHREADS, 2) ran within 1 % of it (PERF.md).
//
// Numerics: built with -fmad=false (native.EXTRA_FLAGS), so every multiply
// and add rounds on its own, as PyTorch's eager ops do. A one-ulp
// difference at a stage can flip that stage's u8 rounding, which the next
// stages carry on; the per-stage quantise of the plain version is matched
// bit for bit where the operations are. No --use_fast_math (chroma_key's
// sqrtf and divisions stay IEEE).
//
// Layout of one launch:
//   grid (ceil(H*W / span), B), NTHREADS threads a block; dynamic shared
//   memory: n_ops op records, then 3 * n_read segments of span + 16 bytes;
//   packed (P+2, B) f32 per-frame parameters; staged: a pointer to each
//   (B, 3, H, W) u8 track read, and each track's segment slot; ops
//   (n_ops, OP_FIELDS) int32 and slot_rows/slot_vals as graph/fused_sweep.py
//   encodes point ops; out (B, 3, H, W) u8.

#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using namespace lives;

constexpr int MAX_TRACKS = 64;
constexpr int RUN = 4;  // pixels a thread computes

struct Staged {
  const unsigned char* p[MAX_TRACKS];  // the tracks read, in slot order
  int slot[MAX_TRACKS];                // a track's slot (-1: not read)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A stage's u8 value q is kept as the float 2^23 + q (bits 0x4B000000 | q),
// which a byte permute makes from a staged byte and the quantise makes by
// one rounded addition, so no stage converts between integer and float:
// chan_f(2^23 + q) is chan(q) of sweep_common.cuh by the same two
// operations, q8f(v) is 2^23 + q8(v).
__device__ __forceinline__ float chan_f(float f) {
  return (f - 8388608.0f) * __int_as_float(0x3b808081);
}

// q8 of sweep_common.cuh as 2^23 + q8(v): x*255 + 0.5 rounded in two steps,
// clipped to [0, 255] before the floor (the same as after it, both bounds
// being integers; NaN gives 0, as q8's conversion does), then the floor by
// adding 2^23 rounded down, exact for 0 <= x < 2^23
__device__ __forceinline__ float q8f(float v) {
  const float x = __fadd_rn(__fmul_rn(v, 255.0f), 0.5f);
  return __fadd_rd(fminf(fmaxf(x, 0.0f), 255.0f), 8388608.0f);
}

// The staged u8 values of a run of P pixels at s as 2^23 + q: 32-bit words
// where s is 4-byte aligned (the same for every run of a segment), each
// byte permuted into the mantissa of 2^23, else bytes
template <int P>
__device__ __forceinline__ void ld_run(const unsigned char* s,
                                       float (&f)[P]) {
  if (((uintptr_t)s & 3) == 0) {
#pragma unroll
    for (int w = 0; w < P / 4; ++w) {
      const unsigned u = reinterpret_cast<const unsigned*>(s)[w];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[4 * w + j] = __uint_as_float(__byte_perm(u, 0x4B000000u,
                                                   0x7540u + j));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) f[j] = __uint_as_float(0x4B000000u | s[j]);
  }
}

// The low bytes of four values 2^23 + q as one 32-bit word
__device__ __forceinline__ unsigned pack4(float a, float b, float c,
                                          float d) {
  return __byte_perm(
      __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x0040u),
      __byte_perm(__float_as_uint(c), __float_as_uint(d), 0x0040u),
      0x5410u);
}

__global__ void __launch_bounds__(NTHREADS, 4) composite_kernel(
    const float* __restrict__ packed, const __grid_constant__ Staged staged,
    int n_read, const int* __restrict__ ops, int n_ops,
    const int* __restrict__ slot_rows, const float* __restrict__ slot_vals,
    int n_slots, unsigned char* __restrict__ out, int B, int H, int W,
    int span) {
  __shared__ float sp[MAX_SLOTS];
  __shared__ int off[3 * MAX_TRACKS];  // a segment's first pixel
  extern __shared__ float4 smem4[];
  OpRec* const rec = reinterpret_cast<OpRec*>(smem4);
  unsigned char* const stage = reinterpret_cast<unsigned char*>(rec + n_ops);
  const int b = blockIdx.y;
  const int seg = span + 16;  // bytes a segment takes (a multiple of 16)
  const size_t plane = (size_t)H * W;
  const size_t p0 = (size_t)blockIdx.x * span;
  const int n = (int)min((size_t)span, plane - p0);  // pixels of this span

  // stage: every byte the block reads in flight at once, one wait
  for (int g = 0; g < 3 * n_read; ++g) {
    const int k = g / 3, c = g - 3 * k;
    const unsigned char* src =
        staged.p[k] + ((size_t)b * 3 + c) * plane + p0;
    const int sh = (int)((uintptr_t)src & 15);
    unsigned char* dst = stage + g * seg + sh;  // congruent to src mod 16
    const int head = min(n, (16 - sh) & 15);
    const int body = (n - head) >> 4;
    const int rest = n - head - 16 * body;  // bytes before and after
    for (int q = threadIdx.x; q < body; q += NTHREADS) {
      cp_async16(dst + head + 16 * q, src + head + 16 * q);
    }
    for (int q = threadIdx.x; q < head + rest; q += NTHREADS) {
      const int at = q < head ? q : q + 16 * body;
      dst[at] = src[at];
    }
    if (threadIdx.x == 0) off[g] = g * seg + sh;
  }
  // the block's set-up while the copies fly
  load_slots(sp, packed, slot_rows, slot_vals, n_slots, B, b);
  __syncthreads();
  for (int i = threadIdx.x; i < n_ops; i += NTHREADS) {
    const int* o = ops + i * OP_FIELDS;
    rec[i] = make_rec(o, sp + o[F_SLOT], nullptr, nullptr);
  }
  cp_async_wait_all();
  __syncthreads();

  const int x[RUN] = {};  // the vocabulary reads no coordinate
  const int s0 = 3 * staged.slot[0];
  unsigned char* ob = out + (size_t)b * 3 * plane + p0;
  for (int i = threadIdx.x * RUN; i < n; i += NTHREADS * RUN) {
    const auto track = [&](const TrackRec&, int t, Rgb (&v)[RUN]) {
      const int s = 3 * staged.slot[t];
      float r[RUN], g[RUN], bl[RUN];
      ld_run<RUN>(stage + off[s] + i, r);
      ld_run<RUN>(stage + off[s + 1] + i, g);
      ld_run<RUN>(stage + off[s + 2] + i, bl);
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        v[j] = {chan_f(r[j]), chan_f(g[j]), chan_f(bl[j])};
      }
    };
    float q[3][RUN];  // track 0's u8 values, as 2^23 + q
    ld_run<RUN>(stage + off[s0] + i, q[0]);
    ld_run<RUN>(stage + off[s0 + 1] + i, q[1]);
    ld_run<RUN>(stage + off[s0 + 2] + i, q[2]);
    for (int k = 0; k < n_ops; ++k) {
      Rgb v[RUN];
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        v[j] = {chan_f(q[0][j]), chan_f(q[1][j]), chan_f(q[2][j])};
      }
      point_run<RUN, true>(rec[k], v, track, x, 0, 0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        q[0][j] = q8f(v[j].r);
        q[1][j] = q8f(v[j].g);
        q[2][j] = q8f(v[j].b);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      unsigned char* d = ob + c * plane + i;
      if (((uintptr_t)d & 3) == 0 && i + RUN <= n) {
#pragma unroll
        for (int w = 0; w < RUN / 4; ++w) {
          reinterpret_cast<unsigned*>(d)[w] =
              pack4(q[c][4 * w], q[c][4 * w + 1], q[c][4 * w + 2],
                    q[c][4 * w + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          if (i + j < n) d[j] = (unsigned char)__float_as_uint(q[c][j]);
        }
      }
    }
  }
}

// Bytes of dynamic shared memory a launch needs (graph/composite.py
// composite_geometry computes the same).
size_t smem_need(int n_ops, int n_read, int span) {
  return (size_t)n_ops * sizeof(OpRec) + (size_t)3 * n_read * (span + 16);
}

}  // namespace

extern "C" {

// Launch one composite on `stream`; returns cudaGetLastError() (0 =
// launched). read: pointers to the n_read (B, 3, H, W) u8 tracks read, in
// slot order; slot: each of the T tracks' slot (-1 when not read; track 0
// is always read). span and smem come from graph/composite.py
// composite_geometry; a launch they do not fit is refused.
int lives_composite(const float* packed, const unsigned char* const* read,
                    int n_read, const int* slot, int T, const int* ops,
                    int n_ops, const int* slot_rows, const float* slot_vals,
                    int n_slots, unsigned char* out, int B, int H, int W,
                    int span, int smem, void* stream) {
  if (T < 1 || T > MAX_TRACKS || n_read < 1 ||
      n_read > T || n_slots > MAX_SLOTS || n_ops < 0 ||
      n_ops > MAX_SLOTS || B < 1 || B > 65535 || H < 1 || W < 1 ||
      span < 16 || span % 16 != 0 || slot[0] < 0 ||
      smem < 0 || (size_t)smem < smem_need(n_ops, n_read, span)) {
    return (int)cudaErrorInvalidValue;
  }
  Staged st{};
  for (int k = 0; k < n_read; ++k) st.p[k] = read[k];
  for (int t = 0; t < T; ++t) {
    if (slot[t] >= n_read) return (int)cudaErrorInvalidValue;
    st.slot[t] = slot[t];
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t plane = (size_t)H * W;
  const dim3 grid((unsigned)((plane + span - 1) / span), B);
  composite_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      packed, st, n_read, ops, n_ops, slot_rows, slot_vals, n_slots, out, B,
      H, W, span);
  return (int)cudaGetLastError();
}

// Blocks of the kernel with `smem` bytes of dynamic shared memory that one
// SM holds, in *per_sm; returns the CUDA error (0 = none).
int lives_composite_blocks_per_sm(int smem, int* per_sm) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, composite_kernel, NTHREADS, smem);
}

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
