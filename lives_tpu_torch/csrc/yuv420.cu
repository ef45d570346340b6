// The colour kernels K2 (YUV420P -> RGB) and K3 (RGB -> YUV420P), one
// library.
//
// K2 replaces the TPU kernel lives_tpu/ops/pallas_kernels.py:yuv420_to_rgb
// (bodies _yuv420_rgb_kernel and _yuv_rgb_full_kernel): the 2x nearest
// chroma upsample and the BT.601/709 matrix, clamped or full range, floor,
// clip to u8. On the TPU the horizontal chroma repeat ran in XLA outside
// the kernel (lane interleave does not lower in Mosaic); here one thread
// takes one 2x2 luma quad with its one U and one V sample, so the upsample
// is fused and nothing is materialised, and it writes the Layer's canonical
// (B, 3, H, W) RGB24 tensor directly. H and W must be even (odd geometry has
// no 4:2:0 counterpart in chroma_up); the wrapper refuses odd ones.
//
// K3 replaces pallas_kernels.py:rgb_to_yuv420 (body _rgb_yuv_kernel): the
// matrix and the range clip at full resolution, after which the TPU version
// box-averages U and V in XLA (`(s + 2) // 4` over each 2x2 block,
// lives_tpu/ops/colorspace.py:117-126). Here one thread takes one 2x2 quad:
// four Y values and four U and four V values, each floored and clipped to
// u8 before the integer box average, which is thus fused into the kernel.
// Odd H or W: the last row or column gets Y only, as chroma_down drops it.
//
// What bounds them on an H100: device memory. K2 moves 1.5 B a pixel in and
// 3 B out, K3 3 B in and 1.5 B out, for a handful of float operations a
// pixel; a 96-frame 1080p chunk is 0.90 GB, 0.27 ms at 3.35 TB/s. The first
// version reads and writes single bytes, coalesced across a warp; wider
// accesses are later work.
//
// Numerics: built with -fmad=false (native.EXTRA_FLAGS), so every multiply
// and add rounds on its own, in the order the plain version writes them
// (ops/colorspace.py rgb_to_yuv / yuv_to_rgb); a `floor` after a fused
// multiply-add could land on the other side of an integer. The constants
// arrive as float32 kernel arguments computed by the wrapper.
//
// Layout: grid (ceil(quads / NTHREADS), B), NTHREADS threads a block. Planes
// have contiguous rows; each plane's frame stride (in bytes) is an argument,
// so a chunk's planes may be strided views of one upload.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

struct Yuv2Rgb {
  float ky, kuv;             // 255/219 and 255/224 (clamped range)
  float cr_v, cg_u, cg_v, cb_u;  // yuv2rgb_coeffs [0][1], [1][0], [1][1], [2][0]
  int clamped;
};

struct Rgb2Yuv {
  float m[9];                // rgb2yuv_coeffs, row-major
  float cfy, cfuv, yoff;     // clamp factors and luma offset
  float ymin, ymax, uvmax;   // clip bounds (U and V clip below at ymin)
};

__device__ __forceinline__ unsigned char to8(float x, float lo, float hi) {
  return (unsigned char)fminf(fmaxf(floorf(x), lo), hi);
}

__global__ void __launch_bounds__(NTHREADS) yuv420_to_rgb_kernel(
    const unsigned char* __restrict__ y, const unsigned char* __restrict__ u,
    const unsigned char* __restrict__ v, long long ys, long long us,
    long long vs, unsigned char* __restrict__ out, int H, int W, Yuv2Rgb c) {
  const int Wq = W / 2, Hq = H / 2;
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= (long long)Hq * Wq) return;
  const int b = blockIdx.y;
  const int qy = (int)(i / Wq), qx = (int)(i - (long long)qy * Wq);
  const unsigned char* yb = y + b * ys;
  const float uf = (float)u[b * us + (long long)qy * Wq + qx];
  const float vf = (float)v[b * vs + (long long)qy * Wq + qx];
  float uu, vv;
  if (c.clamped) {
    uu = (fminf(fmaxf(uf, 16.0f), 240.0f) - 16.0f) * c.kuv - 128.0f;
    vv = (fminf(fmaxf(vf, 16.0f), 240.0f) - 16.0f) * c.kuv - 128.0f;
  } else {
    uu = uf - 128.0f;
    vv = vf - 128.0f;
  }
  const float rv = c.cr_v * vv, gu = c.cg_u * uu, gv = c.cg_v * vv,
              bu = c.cb_u * uu;
  const size_t plane = (size_t)H * W;
  unsigned char* ob = out + (size_t)b * 3 * plane;
  for (int dy = 0; dy < 2; ++dy) {
    for (int dx = 0; dx < 2; ++dx) {
      const size_t at = (size_t)(2 * qy + dy) * W + 2 * qx + dx;
      const float yf = (float)yb[at];
      const float yy = c.clamped
          ? (fminf(fmaxf(yf, 16.0f), 235.0f) - 16.0f) * c.ky : yf;
      ob[at] = to8(yy + rv, 0.0f, 255.0f);
      ob[plane + at] = to8(yy + gu + gv, 0.0f, 255.0f);
      ob[2 * plane + at] = to8(yy + bu, 0.0f, 255.0f);
    }
  }
}

__global__ void __launch_bounds__(NTHREADS) rgb_to_yuv420_kernel(
    const unsigned char* __restrict__ rgb, int C,
    unsigned char* __restrict__ y, unsigned char* __restrict__ u,
    unsigned char* __restrict__ v, int H, int W, Rgb2Yuv c) {
  const int Wq = (W + 1) / 2, Hq = (H + 1) / 2;  // quads, ragged included
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= (long long)Hq * Wq) return;
  const int b = blockIdx.y;
  const int qy = (int)(i / Wq), qx = (int)(i - (long long)qy * Wq);
  const size_t plane = (size_t)H * W;
  const unsigned char* in = rgb + (size_t)b * C * plane;
  unsigned char* yb = y + (size_t)b * plane;
  int su = 0, sv = 0;
  for (int dy = 0; dy < 2; ++dy) {
    for (int dx = 0; dx < 2; ++dx) {
      const int py = 2 * qy + dy, px = 2 * qx + dx;
      if (py >= H || px >= W) continue;
      const size_t at = (size_t)py * W + px;
      const float r = (float)in[at], g = (float)in[plane + at],
                  bl = (float)in[2 * plane + at];
      const float yv = (r * c.m[0] + g * c.m[1] + bl * c.m[2]) * c.cfy
                       + c.yoff;
      const float uv = (r * c.m[3] + g * c.m[4] + bl * c.m[5]) * c.cfuv
                       + 128.0f;
      const float vv = (r * c.m[6] + g * c.m[7] + bl * c.m[8]) * c.cfuv
                       + 128.0f;
      yb[at] = to8(yv, c.ymin, c.ymax);
      su += to8(uv, c.ymin, c.uvmax);
      sv += to8(vv, c.ymin, c.uvmax);
    }
  }
  const int Hc = H / 2, Wc = W / 2;  // chroma_down drops a ragged edge
  if (qy < Hc && qx < Wc) {
    const size_t at = (size_t)b * Hc * Wc + (size_t)qy * Wc + qx;
    u[at] = (unsigned char)((su + 2) / 4);
    v[at] = (unsigned char)((sv + 2) / 4);
  }
}

}  // namespace

extern "C" {

// K2 on `stream`; returns cudaGetLastError() (0 = launched). y, u, v: B
// frames of contiguous rows with frame strides ys, us, vs (bytes); out:
// (B, 3, H, W) u8, contiguous. H and W even.
int lives_yuv420_to_rgb(const unsigned char* y, const unsigned char* u,
                        const unsigned char* v, long long ys, long long us,
                        long long vs, unsigned char* out, int B, int H,
                        int W, float ky, float kuv, float cr_v, float cg_u,
                        float cg_v, float cb_u, int clamped, void* stream) {
  if (B < 1 || B > 65535 || H < 2 || W < 2 || (H & 1) || (W & 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long quads = (long long)(H / 2) * (W / 2);
  const dim3 grid((unsigned)((quads + NTHREADS - 1) / NTHREADS), B);
  const Yuv2Rgb c{ky, kuv, cr_v, cg_u, cg_v, cb_u, clamped};
  yuv420_to_rgb_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      y, u, v, ys, us, vs, out, H, W, c);
  return (int)cudaGetLastError();
}

// K3 on `stream`. rgb: (B, C, H, W) u8 contiguous, channels 0-2 read (C is
// 3 or 4); y: (B, H, W), u and v: (B, H/2, W/2), contiguous. m: the 3x3
// matrix, row-major; lim: cfy, cfuv, yoff, ymin, ymax, uvmax.
int lives_rgb_to_yuv420(const unsigned char* rgb, int C, unsigned char* y,
                        unsigned char* u, unsigned char* v, int B, int H,
                        int W, const float* m, const float* lim,
                        void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 3) {
    return (int)cudaErrorInvalidValue;
  }
  Rgb2Yuv c;
  for (int k = 0; k < 9; ++k) c.m[k] = m[k];
  c.cfy = lim[0];
  c.cfuv = lim[1];
  c.yoff = lim[2];
  c.ymin = lim[3];
  c.ymax = lim[4];
  c.uvmax = lim[5];
  const long long quads = (long long)((H + 1) / 2) * ((W + 1) / 2);
  const dim3 grid((unsigned)((quads + NTHREADS - 1) / NTHREADS), B);
  rgb_to_yuv420_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      rgb, C, y, u, v, H, W, c);
  return (int)cudaGetLastError();
}

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
