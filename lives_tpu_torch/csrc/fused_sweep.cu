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
// What bounds it on an H100: issue slots, not bytes. Every track is
// generated from integer formulas inside the kernel, so the only
// device-memory traffic of the default mode is the u8 write, 3 bytes a
// pixel (597 MB for a 96-frame 1080p chunk, 0.18 ms at 3.35 TB/s), while
// each output pixel costs hundreds of instructions (10 generated tracks, 9
// transitions, a 7+7-tap stencil, expf). The comp modes add 12 bytes a
// pixel of f32 comp traffic. The design spends no slot twice:
//
// - Runs. A thread computes a horizontal run of P adjacent pixels, P = 8,
//   or 4 for a summed stencil radius of 8 or more (a template parameter;
//   graph/fused_sweep.py sweep_run picks it from the plan). The op loop is
//   outside and the run inside (sweep_common.cuh point_run), so each op is
//   decoded once a run, and the P independent chains hide each other's
//   latency. A whole run of a row whose width is a multiple of 4 stores
//   32-bit words of 4 pixels a channel (an f32 comp, float4s); a run at a
//   ragged right edge stores byte by byte.
// - Block set-up. Once a block, shared memory gets the clamped parameter
//   slots, one OpRec a chain op (sweep_common.cuh make_rec: its fields; the
//   3 + c % 5, 2 + c % 3, phase and blank flag of each track it reads; its
//   frame-uniform values, computed by the same float expressions as a pixel
//   would compute them) and the stencil taps. The cell loops read only
//   shared memory and their own coordinates.
// - A 2-D mapping. A thread owns a (row, run) of a span and steps to the
//   next by a fixed (rows, runs) stride, so no cell loop divides by a
//   runtime width.
// - A tile chosen per plan (graph/fused_sweep.py sweep_geometry): the
//   least halo work among a few shapes, a block that fills an SM alone
//   weighing more. Phase 1 evaluates the pre-stencil chain over the tile
//   and its halo R (the sum of the stencil radii) once, into shared
//   memory, and every tap reads it there. A stencil runs one channel at a
//   time: a vertical pass A -> V of that channel, then the horizontal pass
//   and the mix by `amount` written back into that channel of A. So V
//   holds one channel, and two blocks of the main chain's tile fit an SM.
//   The runs, the mapping, the stencil pass and the edge fix-up are
//   sweep_common.cuh's, which stateful_sweep.cu instantiates too.
//
// Built twice with nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -std=c++17 -shared -Xcompiler -fPIC and loaded with ctypes
// (lives_tpu_torch/native):
//
// - `fused_sweep`, the core vocabulary (sweep_common.cuh) with fused
//   multiply-adds: the main chains, whose ops are continuous in their
//   inputs, so an ulp's difference from the plain version moves a pixel by
//   1 LSB at most;
// - `fused_sweep_exact` (-DLIVES_SWEEP_EXACT -fmad=false), the whole
//   vocabulary with every multiply and add rounded on its own, as PyTorch's
//   eager ops round them. The ops past the core compare a float with a
//   threshold (wipe, dissolve, the luma overlays, threshold, solarize,
//   posterize, colour_replace), where one ulp anywhere upstream turns a
//   pixel from fg to bg: a plan that holds any of them (`SweepPlan.full`)
//   runs this build, so each comparison sees the plain version's floats.
//
// No --use_fast_math: expf, sqrtf, powf, cosf, divisions and the
// round-half-up quantise stay IEEE for the +/-1 LSB contract. The
// integer-to-float conversions of the source and the quantise's
// float-to-integer step go through a float's mantissa and one rounding
// conversion, exactly.
//
// Layout of one launch:
//   grid (ceil(W/TW), ceil(band_h/TH), B), THREADS threads a block, tile
//   rows starting at frame row y0 (y0 = 0, band_h = H for a whole frame);
//   packed (P+2, B) f32 per-frame parameters, rows as the plan encodes them;
//   ids (2, T, B) int32 clip ids then frame numbers of each track;
//   ops (n_ops, OP_FIELDS) int32, the chain as encoded by
//   lives_tpu_torch/graph/fused_sweep.py (_encode); slot_rows/slot_vals map
//   each parameter slot to its packed row (or a constant) and its clamp;
//   taps hold each stencil's renormalised f32 taps;
//   comp_in (B, 3, H, W) f32 or null; out (B, 3, band_h, W) u8, or
//   comp_out (B, 3, H, W) f32 when that is not null (the plan refuses a
//   band in the comp modes).
// Shared memory: A, the composite, 3 channels of (TH + 2R) rows by
// WS = TW + 2M columns, and V, one channel in skewed rows (v_stride); then
// the op records and the taps. Halo row 0 is frame row ty0 - R; column M
// is frame column tx0. The margin M (a multiple of P, at least R + P - 1)
// lets every run start on a multiple of P and keeps every tap of a run
// inside the row.
//
// Phase 1 evaluates, for every run covering the tile and its halo, at
// coordinates clamped to the frame: track 0 (from comp_in, or generated),
// then the ops before the first stencil, generating another track only at
// the op that reads it (only track 0 is ever written). Phase 2, per
// stencil: per channel, the vertical and then the horizontal pass and the
// mix and clip; then the ops up to the next stencil over all three
// channels; before a further stencil the frame edge is copied outward over
// the halo again, as the plain chain pads each stencil's input. The last
// pass writes the tile, masking the ragged frame edge. Runs that overlap
// the valid span only in part also compute cells outside it; those cells
// are never read. The plan refuses stencils in comp_in mode: the comp
// carries no halo.
//
// A band is the same computation over fewer rows. H stays the frame's
// height everywhere a coordinate is clamped, generated or fixed up at the
// edge, so a tile's halo past the band's edge holds real frame rows (each
// band makes its own halo, and a multi-device sweep needs no exchange) and
// only the frame's own edges replicate. Only the stores see the band: a
// pixel is written when its row lies in [y0, y0+band_h), at row gy - y0 of
// the band's output. Columns and runs are the same in every band, and a
// pixel's arithmetic does not depend on its tile row, so a band is
// bit-identical to those rows of the whole frame.

#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using namespace lives;

constexpr int THREADS = NTHREADS;  // threads a block (load_slots strides so)
constexpr int MIN_BLOCKS = 2;      // blocks an SM holds: at most 128 registers
constexpr int MAX_OPS = MAX_SLOTS; // every op of the vocabulary has a slot
#ifdef LIVES_SWEEP_EXACT
constexpr bool FULL = true;   // the whole vocabulary (fused_sweep_exact)
#else
constexpr bool FULL = false;  // the core vocabulary (fused_sweep)
#endif

// Track 0 of a run from the f32 comp (row y, columns x; the run starts at
// frame column gx >= 0): vectors along a whole run of an aligned row.
template <int P>
__device__ __forceinline__ void load_comp(const float* ci, size_t plane,
                                          int W, bool vec, int y, int gx,
                                          const int (&x)[P], Rgb (&v)[P]) {
  const float* row = ci + (size_t)y * W;
  if (vec && gx + P <= W) {
    float r[P], g[P], b[P];
    lda<P>(row, gx, r);
    lda<P>(row + plane, gx, g);
    lda<P>(row + 2 * plane, gx, b);
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = {r[j], g[j], b[j]};
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      v[j] = {row[x[j]], row[plane + x[j]], row[2 * plane + x[j]]};
    }
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fused_sweep_kernel(
    const float* __restrict__ packed, const int* __restrict__ ids,
    const int* __restrict__ ops, int n_ops,
    const int* __restrict__ slot_rows, const float* __restrict__ slot_vals,
    int n_slots, const float* __restrict__ taps, int n_taps,
    const float* __restrict__ comp_in, int in_vec,
    unsigned char* __restrict__ out, float* __restrict__ comp_out, int T,
    int B, int H, int W, int y0, int band_h, int R, float sx, float sy,
    int TH, int TW, int M) {
  __shared__ float sp[MAX_SLOTS];
  __shared__ TrackRec t0;
  extern __shared__ float4 smem4[];
  const int b = blockIdx.z;
  const int ty0 = y0 + blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const int y_end = y0 + band_h;  // the band's rows: [y0, y_end)
  const int HA = TH + 2 * R, WS = TW + 2 * M, VS = v_stride(WS);
  const int ch = R > 0 ? HA * WS : 0;  // one channel of A
  float* const A = reinterpret_cast<float*>(smem4);
  float* const V = A + 3 * ch;
  OpRec* const rec = reinterpret_cast<OpRec*>(V + (R > 0 ? HA * VS : 0));
  float* const kw_all = reinterpret_cast<float*>(rec + n_ops);

  const Frame fr{ids, T, B, b, sx, sy};
  load_slots(sp, packed, slot_rows, slot_vals, n_slots, B, b);
  __syncthreads();
  for (int i = threadIdx.x; i < n_ops; i += THREADS) {
    const int* o = ops + i * OP_FIELDS;
    rec[i] = make_rec(o, sp + o[F_SLOT], &fr, taps);
  }
  for (int i = threadIdx.x; i < n_taps; i += THREADS) kw_all[i] = taps[i];
  if (threadIdx.x == 0) t0 = track_rec(fr, 0);
  __syncthreads();

  const size_t plane = (size_t)H * W;        // a frame's channel
  const size_t oplane = (size_t)band_h * W;  // an output channel
  unsigned char* ob = out + (size_t)b * 3 * oplane;
  float* cb = comp_out != nullptr ? comp_out + (size_t)b * 3 * oplane
                                  : nullptr;
  const float* ci = comp_in != nullptr ? comp_in + (size_t)b * 3 * plane
                                       : nullptr;
  const int first = next_step(rec, 0, n_ops);

  // phase 1: track 0 + pre-stencil ops over the tile and its halo
  {
    const int lo = (M - R) / P, hi = (M + TW + R + P - 1) / P;
    for_runs(HA, hi - lo, [&](int row, int run) {
      const int col = (lo + run) * P;
      const int gy = ty0 - R + row, gx = tx0 - M + col;
      const int y = clampi(gy, 0, H - 1);
      int x[P];
#pragma unroll
      for (int j = 0; j < P; ++j) x[j] = clampi(gx + j, 0, W - 1);
      Rgb v[P];
      if (ci != nullptr) {
        load_comp<P>(ci, plane, W, in_vec != 0, y, gx, x, v);
      } else {
        gen_run<P>(t0, x, y, v);
      }
      apply_run<P, FULL>(rec, 0, first, v, x, y, sx, sy);
      if (first == n_ops) {  // no stencil: R = M = 0, the tile itself
        if (gy < y_end) {
          store_run<P>(ob, cb, oplane, W, (size_t)(gy - y0) * W + gx, gx, v);
        }
      } else {
        put_run<P>(A, ch, row * WS + col, v);
      }
    });
  }

  // phase 2: each stencil, then the ops up to the next one
  int cur = R;  // halo still valid in A
  for (int si = first; si < n_ops;) {
    const OpRec& o = rec[si];
    const int r = o.arg;
    const float* kw = kw_all + o.taps;
    const bool sharpen = o.sharpen != 0;
    const float amount = o.k[0];
    const int next = next_step(rec, si + 1, n_ops);
    const bool last = next == n_ops;  // then after = 0: the tile itself
    const int after = cur - r;
    const int row0 = R - after, rows = TH + 2 * after;
    // runs covering the columns read ([M-cur, M+TW+cur)) and written
    const int vlo = (M - cur) / P, vhi = (M + TW + cur + P - 1) / P;
    const int hlo = (M - after) / P, hhi = (M + TW + after + P - 1) / P;
    stencil_pass<P>(A, V, ch, WS, VS, row0, rows, vlo, vhi, hlo, hhi, r, kw,
                    sharpen, amount);
    if (last || next > si + 1) {
      __syncthreads();
      for_runs(rows, hhi - hlo, [&](int i, int run) {
        const int row = row0 + i, col = (hlo + run) * P;
        const int gy = ty0 - R + row, gx = tx0 - M + col;
        const int y = clampi(gy, 0, H - 1);
        int x[P];
#pragma unroll
        for (int j = 0; j < P; ++j) x[j] = clampi(gx + j, 0, W - 1);
        Rgb v[P];
        get_run<P>(A, ch, row * WS + col, v);
        apply_run<P, FULL>(rec, si + 1, next, v, x, y, sx, sy);
        if (last) {
          if (gy < y_end) {  // inside the band
            store_run<P>(ob, cb, oplane, W, (size_t)(gy - y0) * W + gx, gx,
                         v);
          }
        } else {
          put_run<P>(A, ch, row * WS + col, v);
        }
      });
    }
    // before a further stencil: the frame edge copied outward
    if (!last) edge_fixup(A, ch, WS, R, M, TH, TW, after, ty0, tx0, H, W);
    cur = after;
    si = next;
  }
}

// Bytes of dynamic shared memory a launch needs: A and V, the op records,
// the taps (graph/fused_sweep.py sweep_geometry computes the same).
size_t smem_need(int TH, int TW, int M, int R, int n_ops, int n_taps) {
  const size_t rows = R > 0 ? TH + 2 * R : 0, WS = TW + 2 * M;
  return rows * (3 * WS + v_stride(WS)) * sizeof(float) +
         (size_t)n_ops * sizeof(OpRec) + (size_t)n_taps * sizeof(float);
}

template <int P>
int launch(dim3 grid, size_t smem, cudaStream_t stream, const float* packed,
           const int* ids, const int* ops, int n_ops, const int* slot_rows,
           const float* slot_vals, int n_slots, const float* taps, int n_taps,
           const float* comp_in, unsigned char* out, float* comp_out, int T,
           int B, int H, int W, int y0, int band_h, int R, float sx, float sy,
           int TH, int TW, int M) {
  const int in_vec = comp_in != nullptr && W % 4 == 0 &&
                     (uintptr_t)comp_in % 16 == 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_sweep_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_sweep_kernel<P><<<grid, THREADS, smem, stream>>>(
      packed, ids, ops, n_ops, slot_rows, slot_vals, n_slots, taps, n_taps,
      comp_in, in_vec, out, comp_out, T, B, H, W, y0, band_h, R, sx, sy, TH,
      TW, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one sweep on `stream`; returns cudaGetLastError() (0 = launched).
// comp_in and comp_out may be null; out is unused when comp_out is set.
// Output rows [y0, y0+band_h) of the H-row frame (0 and H for all of it).
// The geometry (tile TH x TW, run P, margin M, `smem` bytes) comes from
// graph/fused_sweep.py sweep_geometry; a launch it does not fit is refused.
int lives_fused_sweep(const float* packed, const int* ids, const int* ops,
                      int n_ops, const int* slot_rows,
                      const float* slot_vals, int n_slots, const float* taps,
                      int n_taps, const float* comp_in, unsigned char* out,
                      float* comp_out, int T, int B, int H, int W, int y0,
                      int band_h, int R, float sx, float sy, int TH, int TW,
                      int P, int M, int smem, void* stream) {
  if (n_slots > MAX_SLOTS || n_ops > MAX_OPS || n_ops < 0 || n_taps < 0 ||
      B > 65535 || T < 1 || band_h < 1 || y0 < 0 || y0 + band_h > H ||
      W < 1 || R < 0 || TH < 1 || TW < P || TW % P != 0 || M % P != 0 ||
      (R > 0 ? M < R + P - 1 : M != 0) || (band_h + TH - 1) / TH > 65535 ||
      smem < 0 || (size_t)smem < smem_need(TH, TW, M, R, n_ops, n_taps)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((W + TW - 1) / TW, (band_h + TH - 1) / TH, B);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 4:
      return launch<4>(grid, smem, s, packed, ids, ops, n_ops, slot_rows,
                       slot_vals, n_slots, taps, n_taps, comp_in, out,
                       comp_out, T, B, H, W, y0, band_h, R, sx, sy, TH, TW,
                       M);
    case 8:
      return launch<8>(grid, smem, s, packed, ids, ops, n_ops, slot_rows,
                       slot_vals, n_slots, taps, n_taps, comp_in, out,
                       comp_out, T, B, H, W, y0, band_h, R, sx, sy, TH, TW,
                       M);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
