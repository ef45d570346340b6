// The composite kernel K4: the coordinate-free point-op prefix of a chain
// over N decoded (device-memory) u8 tracks, one launch per frame chunk.
//
// Replaces the TPU kernel lives_tpu/graph/pallas_composite.py:
// build_composite (body :129-157, call :170). That kernel traces each
// filter's `process` on u8 layers, so every stage's result is quantised to
// u8 before the next stage reads it; this kernel computes the same: for
// each op it converts its inputs' u8 values to [0,1] floats (x * 1/255),
// runs the point op of sweep_common.cuh (crossfade, the 14 blends,
// luma_key, chroma_key, colour_balance, saturation: the members of
// PALLAS_SAFE the port holds), and rounds the result to u8
// (floor(x*255+0.5), clipped), kept in registers. Only track 0 is ever
// written (the prefix writes track 0 alone), so another track is loaded
// from device memory at the op that reads it, each used track once a pixel
// for a prefix that reads each once, and the result is written once.
// Traced parameters are clamped as Param.clamp does (load_slots), and each
// op's record (sweep_common.cuh make_rec: its fields and frame-uniform
// values) is made once a block in shared memory. The TPU
// kernel's tile pick (w % 128, h % 8) has no counterpart: the grid covers
// the frame in runs of NTHREADS pixels and masks the ragged end.
//
// What bounds it on an H100: device memory. For 10 tracks it reads 30 B a
// pixel and writes 3, against some tens of float operations a stage; a
// 96-frame 1080p chunk is 6.57 GB, 1.96 ms at 3.35 TB/s. This first version
// loads and stores single bytes (coalesced across a warp); wider accesses
// and a 2-D tile are later work.
//
// Numerics: built with -fmad=false (native.EXTRA_FLAGS), so every multiply
// and add rounds on its own, as PyTorch's eager ops do. A one-ulp
// difference at a stage can flip that stage's u8 rounding, which the next
// stages carry on; the per-stage quantise of the plain version is matched
// bit for bit where the operations are. No --use_fast_math (chroma_key's
// sqrtf and divisions stay IEEE).
//
// Layout of one launch:
//   grid (ceil(H*W / NTHREADS), B), NTHREADS threads a block, one thread a
//   pixel, n_ops op records of dynamic shared memory; packed (P+2, B) f32
//   per-frame parameters; tracks: a table of T pointers to (B, 3, H, W)
//   u8 tensors, passed by value; ops (n_ops, OP_FIELDS) int32 and
//   slot_rows/slot_vals as graph/fused_sweep.py encodes point ops; out
//   (B, 3, H, W) u8.

#include "sweep_common.cuh"

namespace {

using namespace lives;

constexpr int MAX_TRACKS = 64;
// blocks an SM holds: 8 of NTHREADS fill it, at most 32 registers a thread
constexpr int MIN_BLOCKS = 8;

struct Tracks {
  const unsigned char* p[MAX_TRACKS];
};

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS) composite_kernel(
    const float* __restrict__ packed, Tracks tracks,
    const int* __restrict__ ops, int n_ops,
    const int* __restrict__ slot_rows, const float* __restrict__ slot_vals,
    int n_slots, unsigned char* __restrict__ out, int B, int H, int W) {
  __shared__ float sp[MAX_SLOTS];
  extern __shared__ OpRec rec[];
  const int b = blockIdx.y;
  load_slots(sp, packed, slot_rows, slot_vals, n_slots, B, b);
  __syncthreads();
  for (int i = threadIdx.x; i < n_ops; i += NTHREADS) {
    const int* o = ops + i * OP_FIELDS;
    rec[i] = make_rec(o, sp + o[F_SLOT], nullptr);
  }
  __syncthreads();
  const size_t plane = (size_t)H * W;
  const size_t px = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (px >= plane) return;
  const size_t at = (size_t)b * 3 * plane + px;
  const int y = (int)(px / W);
  const int x[1] = {(int)(px - (size_t)y * W)};
  const auto track = [&](const TrackRec&, int t, Rgb (&v)[1]) {
    const unsigned char* s = tracks.p[t] + at;
    v[0] = Rgb{chan(s[0]), chan(s[plane]), chan(s[2 * plane])};
  };
  unsigned q[3];
  const unsigned char* t0 = tracks.p[0] + at;
  q[0] = t0[0];
  q[1] = t0[plane];
  q[2] = t0[2 * plane];
  for (int i = 0; i < n_ops; ++i) {
    Rgb v[1] = {{chan(q[0]), chan(q[1]), chan(q[2])}};
    point_run<1>(rec[i], v, track, x, y, 0.0f, 0.0f);
    q[0] = q8(v[0].r);
    q[1] = q8(v[0].g);
    q[2] = q8(v[0].b);
  }
  unsigned char* ob = out + at;
  ob[0] = (unsigned char)q[0];
  ob[plane] = (unsigned char)q[1];
  ob[2 * plane] = (unsigned char)q[2];
}

}  // namespace

extern "C" {

// Launch one composite on `stream`; returns cudaGetLastError() (0 =
// launched). tracks: T pointers to (B, 3, H, W) u8 tensors.
int lives_composite(const float* packed, const unsigned char* const* tracks,
                    int T, const int* ops, int n_ops, const int* slot_rows,
                    const float* slot_vals, int n_slots, unsigned char* out,
                    int B, int H, int W, void* stream) {
  if (T < 1 || T > MAX_TRACKS || n_slots > MAX_SLOTS || n_ops < 0
      || n_ops > MAX_SLOTS || B < 1 || B > 65535 || H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Tracks tab{};
  for (int t = 0; t < T; ++t) tab.p[t] = tracks[t];
  const size_t plane = (size_t)H * W;
  const dim3 grid((unsigned)((plane + NTHREADS - 1) / NTHREADS), B);
  const size_t smem = (size_t)n_ops * sizeof(OpRec);  // under 48 KB
  composite_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      packed, tab, ops, n_ops, slot_rows, slot_vals, n_slots, out, B, H, W);
  return (int)cudaGetLastError();
}

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
