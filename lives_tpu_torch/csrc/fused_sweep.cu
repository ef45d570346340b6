// Fused render sweep: source generation + a stateless effect chain + the
// RGB24 sink quantise, one kernel per frame chunk.
//
// Replaces the TPU kernel lives_tpu/graph/pallas_composite.py:
// build_fused_sweep in its four modes: the default (emit="u8"), the prefix
// sweep (emit="comp", an f32 comp out instead of the sink quantise), the
// suffix sweep (consume="comp", track 0 read from an f32 comp instead of
// generated) and the band sweep (band_h: u8 rows [y0, y0+band_h) of the
// frame, the multi-device layer's kernel). It computes what that kernel
// computes, not block by block what it does.
//
// What bounds it on an H100: f32 (and int32) ALU work on the halo'd fold.
// Every track is generated from integer formulas inside the kernel, so the
// only device-memory traffic of the default mode is the u8 write, 3 bytes a
// pixel (597 MB for a 96-frame 1080p chunk, 0.18 ms at 3.35 TB/s), while
// each output pixel costs hundreds of ALU instructions (10 generated
// tracks, 9 transitions with IEEE divisions and a square root, a 7+7-tap
// stencil, expf). The comp modes add 12 bytes a pixel of f32 comp traffic
// (2.39 GB a chunk, 0.7 ms). The design keeps everything in registers and
// shared memory and spends its effort on not repeating the fold: the
// pre-stencil composite of a tile plus its halo is computed once, staged in
// shared memory, and read there by every tap. Making it fast (tile shape,
// op specialisation instead of the interpreted op loop, register blocking)
// is later work.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
// -shared -Xcompiler -fPIC and loaded with ctypes (lives_tpu_torch/native).
// No --use_fast_math: vignette's expf, chroma_key's sqrtf and divisions and
// the round-half-up quantise stay IEEE for the +/-1 LSB contract.
//
// Layout of one launch:
//   grid (ceil(W/TILE_W), ceil(band_h/TILE_H), B), NTHREADS threads a
//   block, tile rows starting at frame row y0 (y0 = 0, band_h = H for a
//   whole frame);
//   packed (P+2, B) f32 per-frame parameters, rows as the plan encodes them;
//   ids (2, T, B) int32 clip ids then frame numbers of each track;
//   ops (n_ops, OP_FIELDS) int32, the chain as encoded by
//   lives_tpu_torch/graph/fused_sweep.py (_encode); slot_rows/slot_vals map
//   each parameter slot to its packed row (or a constant) and its clamp;
//   taps hold each stencil's renormalised f32 taps;
//   comp_in (B, 3, H, W) f32 or null; out (B, 3, band_h, W) u8, or
//   comp_out (B, 3, H, W) f32 when that is not null (the plan refuses a
//   band in the comp modes).
// Phase 1 evaluates, for every pixel of the tile and its halo R (the sum of
// the stencil radii), at coordinates clamped to the frame: track 0 (from
// comp_in, or generated), then the ops before the first stencil,
// generating another track only at the op that reads it (only track 0 is
// ever written). Phase 2, per stencil: a vertical then a horizontal pass in
// shared memory, the mix by `amount`, the clip, and the ops up to the next
// stencil (track 0 only); before a further stencil the frame edge is copied
// outward over the halo again, as the plain chain pads each stencil's
// input. The last pass writes the tile, masking the ragged frame edge. The
// plan refuses stencils in comp_in mode: the comp carries no halo.
//
// A band is the same computation over fewer rows. H stays the frame's
// height everywhere a coordinate is clamped, generated or fixed up at the
// edge, so a tile's halo past the band's edge holds real frame rows (each
// band makes its own halo, and a multi-device sweep needs no exchange) and
// only the frame's own edges replicate. Only the stores see the band: a
// pixel is written when its row lies in [y0, y0+band_h), at row gy - y0 of
// the band's output; the band's last tile is ragged when band_h is not a
// multiple of TILE_H. Every pixel runs the same arithmetic on the same
// values as in a whole-frame launch, so a band is bit-identical to those
// rows of the whole frame.

#include "sweep_common.cuh"

namespace {

using namespace lives;

// The chain's result at output pixel `at`: quantised to u8, or the f32
// comp.
__device__ __forceinline__ void store(unsigned char* ob, float* cb,
                                      size_t plane, size_t at, Rgb v) {
  if (cb != nullptr) {
    cb[at] = v.r;
    cb[plane + at] = v.g;
    cb[2 * plane + at] = v.b;
  } else {
    ob[at] = q8(v.r);
    ob[plane + at] = q8(v.g);
    ob[2 * plane + at] = q8(v.b);
  }
}

__global__ void __launch_bounds__(NTHREADS) fused_sweep_kernel(
    const float* __restrict__ packed, const int* __restrict__ ids,
    const int* __restrict__ ops, int n_ops,
    const int* __restrict__ slot_rows, const float* __restrict__ slot_vals,
    int n_slots, const float* __restrict__ taps,
    const float* __restrict__ comp_in, unsigned char* __restrict__ out,
    float* __restrict__ comp_out, int T, int B, int H, int W, int y0,
    int band_h, int R, float sx, float sy) {
  __shared__ float sp[MAX_SLOTS];
  extern __shared__ float smem[];
  const int b = blockIdx.z;
  const int ty0 = y0 + blockIdx.y * TILE_H;
  const int tx0 = blockIdx.x * TILE_W;
  const int y_end = y0 + band_h;  // the band's rows: [y0, y_end)
  load_slots(sp, packed, slot_rows, slot_vals, n_slots, B, b);
  __syncthreads();

  const Frame fr{ids, T, B, b, sx, sy};
  const size_t plane = (size_t)H * W;        // a frame's channel
  const size_t oplane = (size_t)band_h * W;  // an output channel
  unsigned char* ob = out + (size_t)b * 3 * oplane;
  float* cb = comp_out != nullptr ? comp_out + (size_t)b * 3 * oplane
                                  : nullptr;
  const float* ci = comp_in != nullptr ? comp_in + (size_t)b * 3 * plane
                                       : nullptr;
  const int HA = TILE_H + 2 * R, WA = TILE_W + 2 * R;
  const int ch = HA * WA;  // one channel of a staging buffer
  float* A = smem;         // the composite, indexed by halo coordinates
  float* V = smem + 3 * ch;  // a stencil's vertical pass
  const int first = next_step(ops, 0, n_ops);

  // phase 1: track 0 + pre-stencil ops over the tile and its halo
  for (int idx = threadIdx.x; idx < ch; idx += NTHREADS) {
    const int ly = idx / WA, lx = idx - (idx / WA) * WA;
    const int gy = ty0 - R + ly, gx = tx0 - R + lx;
    const int y = min(max(gy, 0), H - 1), x = min(max(gx, 0), W - 1);
    const size_t px = (size_t)y * W + x;
    const Rgb v0 = ci != nullptr
        ? Rgb{ci[px], ci[plane + px], ci[2 * plane + px]}
        : gen(fr, 0, x, y);
    const Rgb v = apply_ops(ops, 0, first, sp, v0, fr, x, y);
    if (first == n_ops) {
      if (gy >= y0 && gy < y_end && gx >= 0 && gx < W) {
        store(ob, cb, oplane, (size_t)(gy - y0) * W + gx, v);
      }
    } else {
      put(A, ch, idx, v);
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
    const int next = next_step(ops, si + 1, n_ops);
    const int after = cur - r;
    __syncthreads();
    vertical_pass(A, V, WA, ch, R, cur, after, r, kw);
    __syncthreads();
    // horizontal + mix + clip + the following ops; each thread reads and
    // writes only its own A cells here, so no barrier is needed inside
    const bool last = next == n_ops;
    const int vh = TILE_H + 2 * after, hw = TILE_W + 2 * after;
    for (int idx = threadIdx.x; idx < vh * hw; idx += NTHREADS) {
      const int ly = R - after + idx / hw, lx = R - after + idx % hw;
      const int gy = ty0 - R + ly, gx = tx0 - R + lx;
      // inside the frame: cells outside it are replicated from its edge
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      if (!inside && !last) continue;
      const int at = ly * WA + lx;
      const Rgb v = apply_ops(ops, si + 1, next, sp,
                              horizontal_mix(A, V, ch, at, r, kw, sharpen,
                                             amount),
                              fr, min(max(gx, 0), W - 1),
                              min(max(gy, 0), H - 1));
      if (last) {
        // inside the band
        if (gy >= y0 && gy < y_end && gx >= 0 && gx < W) {
          store(ob, cb, oplane, (size_t)(gy - y0) * W + gx, v);
        }
      } else {
        put(A, ch, at, v);
      }
    }
    if (!last) {
      __syncthreads();
      edge_fixup(A, WA, ch, R, after, ty0, tx0, H, W);
    }
    cur = after;
    si = next;
  }
}

}  // namespace

extern "C" {

// Launch one sweep on `stream`; returns cudaGetLastError() (0 = launched).
// comp_in and comp_out may be null; out is unused when comp_out is set.
// Output rows [y0, y0+band_h) of the H-row frame (0 and H for all of it).
int lives_fused_sweep(const float* packed, const int* ids, const int* ops,
                      int n_ops, const int* slot_rows,
                      const float* slot_vals, int n_slots, const float* taps,
                      const float* comp_in, unsigned char* out,
                      float* comp_out, int T, int B, int H, int W, int y0,
                      int band_h, int R, int n_stencils, float sx, float sy,
                      void* stream) {
  if (n_slots > MAX_SLOTS || B > 65535 || T < 1 || band_h < 1 || y0 < 0 ||
      y0 + band_h > H) {
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
  const dim3 grid((W + TILE_W - 1) / TILE_W, (band_h + TILE_H - 1) / TILE_H,
                  B);
  fused_sweep_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      packed, ids, ops, n_ops, slot_rows, slot_vals, n_slots, taps, comp_in,
      out, comp_out, T, B, H, W, y0, band_h, R, sx, sy);
  return (int)cudaGetLastError();
}

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
