// The colour kernels K2 (YUV420P -> RGB) and K3 (RGB -> YUV420P), one
// library.
//
// K2 replaces the TPU kernel lives_tpu/ops/pallas_kernels.py:yuv420_to_rgb
// (bodies _yuv420_rgb_kernel and _yuv_rgb_full_kernel): the 2x nearest
// chroma upsample and the BT.601/709 matrix, clamped or full range, floor,
// clip to u8. On the TPU the horizontal chroma repeat ran in XLA outside
// the kernel (lane interleave does not lower in Mosaic); here the upsample
// is fused and nothing is materialised, and the kernel writes the Layer's
// canonical (B, 3, H, W) RGB24 tensor directly. H and W must be even (odd
// geometry has no 4:2:0 counterpart in chroma_up); the wrapper refuses odd
// ones.
//
// K3 replaces pallas_kernels.py:rgb_to_yuv420 (body _rgb_yuv_kernel): the
// matrix and the range clip at full resolution, after which the TPU version
// box-averages U and V in XLA (`(s + 2) // 4` over each 2x2 block,
// lives_tpu/ops/colorspace.py:117-126). Here the box average is fused: the
// four U and four V values of a quad are floored and clipped to u8, summed
// as integers and rounded as (s + 2) / 4. Odd H or W: the last row or
// column gets Y only, as chroma_down drops it.
//
// What bounds them on an H100. Their bytes: K2 moves 1.5 B a pixel in and
// 3 B out, K3 3 B in and 1.5 B out; a 96-frame 1080p chunk is 0.90 GB,
// 0.27 ms at 3.35 TB/s, and a plain copy of as many bytes takes 0.30 ms on
// the card. Their instructions come next: with every multiply and add
// rounded on its own (below) K2 issues about 20 instructions a pixel and
// K3 about 40, and at 128 lanes an SM a clock K3's alone take most of its
// byte time. On the card K2 runs at 95 % of the copy's rate and K3 at 85 %
// (PERF.md). So the design moves wide, spends as few instructions a byte
// as it can, and keeps a block on whole rows:
//
// - Runs. A thread takes a run of P pixels (8 or 16, a template argument;
//   ops/yuv_kernels.py colour_geometry picks it) of a row pair: P/2 quads.
//   K2 reads the run's two luma rows and its P/2 U and V bytes and writes
//   six rows of P bytes (R, G and B of both rows); K3 reads six rows of P
//   bytes (channel 3 of RGBA is not read) and writes two Y rows and P/2 U
//   and V bytes. At P = 16 and a launch whose planes allow 16-byte accesses
//   that is two 16-byte and two 8-byte loads and six 16-byte stores (K2),
//   six 16-byte loads, two 16-byte and two 8-byte stores (K3): a warp moves
//   512 contiguous bytes of a row an instruction.
// - Access width per launch. Planes may be views at any byte offset and
//   rows any width (a 1000-pixel luma row is 1000 B, its chroma row 500 B).
//   colour_geometry takes the largest width of 16, 8, 4 and 1 bytes that
//   divides every base pointer, frame and plane stride and row pitch of the
//   full-resolution planes (`wide`), and of U and V (`narrow`); then every
//   run's start is a multiple of it, and a run moves P bytes a row as P /
//   wide accesses. A run cut by a row's end (W not a multiple of P) moves
//   its bytes one at a time, in the same kernel; so does every run of a
//   launch whose width is 1 (odd rows in K3, a plane at an odd offset).
//   The launch refuses a pointer or stride that is no multiple of its
//   width.
// - A block a row pair, no division a pixel. blockIdx.x is a frame's row
//   pair (frame = blockIdx.x / row pairs, once a thread), threadIdx.x a
//   run along it; a block has the row pair's runs rounded up to a warp
//   (at most 1024 threads, then blockIdx.y takes the next 1024 runs), so
//   a block reads and writes whole rows of each plane: at 1080p and runs of
//   16, 120 runs in 128 threads. colour_geometry picks the block; on the
//   card it ran faster than tiles of 32 runs by 1, 2, 4 or 8 row pairs, 64
//   by 1 or 2, and 16 by 16 (PERF.md). Frames x row pairs lie on grid.x,
//   whose limit is 2^31 - 1 (a 96-frame 2160p chunk is 103,680 blocks);
//   frame offsets are 64-bit (its RGB is 2.39 GB).
// - No conversions. A byte becomes a float by a byte permute into the
//   mantissa of 2^23 (the float 2^23 + q) and one subtraction, or none
//   where the clamp can work on 2^23 + q; a result is clipped to its u8
//   range, floored by adding 2^23 rounded down (exact for 0 <= x < 2^23),
//   and its low byte packed by byte permutes. The clip before the floor is
//   the clip after it, both bounds being integers. No integer <-> float
//   conversion (a quarter-rate instruction) is issued.
//
// Numerics: built with -fmad=false (native.EXTRA_FLAGS), so every multiply
// and add rounds on its own, in the order the plain version writes them
// (ops/colorspace.py rgb_to_yuv / yuv_to_rgb); a `floor` after a fused
// multiply-add could land on the other side of an integer. The constants
// arrive as float32 kernel arguments computed by the wrapper. K2 and K3
// are then bit for bit their plain versions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;  // a block's threads, at most
constexpr float F23 = 8388608.0f;  // 2^23
constexpr uint32_t F23X4 = 0x2C000000u;  // 4 x 2^23's bits, mod 2^32

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

// byte k of w as the float 2^23 + byte
__device__ __forceinline__ float f23(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + k));
}

// 2^23 + floor(clip(x, lo, hi)), for integer bounds 0 <= lo <= hi
__device__ __forceinline__ uint32_t q23(float x, float lo, float hi) {
  return __float_as_uint(__fadd_rd(fminf(fmaxf(x, lo), hi), F23));
}

// the low bytes of four words as one word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u),
                     0x5410u);
}

// N bytes at p into w (byte j in bits 8 (j % 4) of w[j / 4]): by accesses
// of `width` bytes where all N lie in the row (n == N) and width >= 4,
// else the n bytes one at a time and the rest 0. p is a multiple of width.
template <int N>
__device__ __forceinline__ void ld(const unsigned char* p, int width, int n,
                                   uint32_t (&w)[N / 4]) {
  if (n == N && width >= 4) {
    if (N % 16 == 0 && width >= 16) {
#pragma unroll
      for (int k = 0; k < N / 16; ++k) {
        const uint4 t = reinterpret_cast<const uint4*>(p)[k];
        w[4 * k] = t.x, w[4 * k + 1] = t.y, w[4 * k + 2] = t.z,
        w[4 * k + 3] = t.w;
      }
    } else if (N % 8 == 0 && width >= 8) {
#pragma unroll
      for (int k = 0; k < N / 8; ++k) {
        const uint2 t = reinterpret_cast<const uint2*>(p)[k];
        w[2 * k] = t.x, w[2 * k + 1] = t.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        w[k] = reinterpret_cast<const uint32_t*>(p)[k];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) w[k] = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < n) w[j / 4] |= (uint32_t)p[j] << (8 * (j % 4));
    }
  }
}

// The first n of N bytes of w to p, as ld reads them
template <int N>
__device__ __forceinline__ void st(unsigned char* p, int width, int n,
                                   const uint32_t (&w)[N / 4]) {
  if (n == N && width >= 4) {
    if (N % 16 == 0 && width >= 16) {
#pragma unroll
      for (int k = 0; k < N / 16; ++k) {
        reinterpret_cast<uint4*>(p)[k] =
            make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
      }
    } else if (N % 8 == 0 && width >= 8) {
#pragma unroll
      for (int k = 0; k < N / 8; ++k) {
        reinterpret_cast<uint2*>(p)[k] = make_uint2(w[2 * k], w[2 * k + 1]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        reinterpret_cast<uint32_t*>(p)[k] = w[k];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < n) p[j] = (unsigned char)(w[j / 4] >> (8 * (j % 4)));
    }
  }
}

// K2. A thread: frame b, row pair qy, pixels [x0, x0 + P) of both rows.
template <int P>
__global__ void __launch_bounds__(MAX_THREADS) yuv420_to_rgb_kernel(
    const unsigned char* __restrict__ y, const unsigned char* __restrict__ u,
    const unsigned char* __restrict__ v, long long ys, long long us,
    long long vs, unsigned char* __restrict__ out, int H, int W, int wide,
    int narrow, Yuv2Rgb c) {
  const int Hq = H / 2;
  const int b = blockIdx.x / Hq;
  const int qy = blockIdx.x - b * Hq;
  const int x0 = (blockIdx.y * blockDim.x + threadIdx.x) * P;
  if (x0 >= W) return;
  const int n = min(P, W - x0);  // pixels of this run (even)
  uint32_t l[2][P / 4], cu[P / 8], cv[P / 8];
  const unsigned char* yr = y + b * ys + (long long)(2 * qy) * W + x0;
  ld<P>(yr, wide, n, l[0]);
  ld<P>(yr + W, wide, n, l[1]);
  const long long co = (long long)qy * (W / 2) + x0 / 2;
  ld<P / 2>(u + b * us + co, narrow, n / 2, cu);
  ld<P / 2>(v + b * vs + co, narrow, n / 2, cv);

  uint32_t o[3][2][P / 4];  // R, G, B of rows 0 and 1
#pragma unroll
  for (int wd = 0; wd < P / 4; ++wd) {  // 4 pixels: quads 2 wd, 2 wd + 1
    uint32_t q[3][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * wd + h;  // the quad
      const float uf = f23(cu[j / 4], j % 4), vf = f23(cv[j / 4], j % 4);
      float uu, vv;
      if (c.clamped) {  // clamp(q, 16, 240) - 16 on 2^23 + q, exactly
        uu = (fminf(fmaxf(uf, F23 + 16.0f), F23 + 240.0f) - (F23 + 16.0f))
             * c.kuv - 128.0f;
        vv = (fminf(fmaxf(vf, F23 + 16.0f), F23 + 240.0f) - (F23 + 16.0f))
             * c.kuv - 128.0f;
      } else {
        uu = uf - (F23 + 128.0f);
        vv = vf - (F23 + 128.0f);
      }
      const float rv = vv * c.cr_v, gu = uu * c.cg_u, gv = vv * c.cg_v,
                  bu = uu * c.cb_u;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float yf = f23(l[dy][wd], 2 * h + dx);
          const float yy = c.clamped
              ? (fminf(fmaxf(yf, F23 + 16.0f), F23 + 235.0f)
                 - (F23 + 16.0f)) * c.ky
              : yf - F23;
          q[0][dy][2 * h + dx] = q23(yy + rv, 0.0f, 255.0f);
          q[1][dy][2 * h + dx] = q23(yy + gu + gv, 0.0f, 255.0f);
          q[2][dy][2 * h + dx] = q23(yy + bu, 0.0f, 255.0f);
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        o[ch][dy][wd] = pack4(q[ch][dy][0], q[ch][dy][1], q[ch][dy][2],
                              q[ch][dy][3]);
      }
    }
  }
  const size_t plane = (size_t)H * W;
  unsigned char* ob = out + (size_t)b * 3 * plane + (size_t)(2 * qy) * W + x0;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      st<P>(ob + ch * plane + dy * W, wide, n, o[ch][dy]);
    }
  }
}

// K3. A thread: frame b, row pair qy (one row at an odd H's end), pixels
// [x0, x0 + P) of its rows, and their quads' U and V where chroma has them.
template <int P>
__global__ void __launch_bounds__(MAX_THREADS) rgb_to_yuv420_kernel(
    const unsigned char* __restrict__ rgb, long long fs,
    unsigned char* __restrict__ y, unsigned char* __restrict__ u,
    unsigned char* __restrict__ v, int H, int W, int wide, int narrow,
    Rgb2Yuv c) {
  const int Hq = (H + 1) / 2;
  const int b = blockIdx.x / Hq;
  const int qy = blockIdx.x - b * Hq;
  const int x0 = (blockIdx.y * blockDim.x + threadIdx.x) * P;
  if (x0 >= W) return;
  const int n = min(P, W - x0);        // pixels of this run
  const int rows = min(2, H - 2 * qy);  // rows of this row pair
  const size_t plane = (size_t)H * W;
  const unsigned char* in = rgb + b * fs + (size_t)(2 * qy) * W + x0;
  uint32_t px[2][3][P / 4];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      ld<P>(in + ch * plane + dy * W, wide, dy < rows ? n : 0, px[dy][ch]);
    }
  }

  uint32_t yo[2][P / 4], uq[P / 2], vq[P / 2];
#pragma unroll
  for (int wd = 0; wd < P / 4; ++wd) {  // 4 pixels: quads 2 wd, 2 wd + 1
    uint32_t su[2] = {0u, 0u}, sv[2] = {0u, 0u};  // sums of 2^23 + q
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      uint32_t yq[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float r = f23(px[dy][0][wd], k) - F23,
                    g = f23(px[dy][1][wd], k) - F23,
                    bl = f23(px[dy][2][wd], k) - F23;
        const float yv = (r * c.m[0] + g * c.m[1] + bl * c.m[2]) * c.cfy
                         + c.yoff;
        const float uv = (r * c.m[3] + g * c.m[4] + bl * c.m[5]) * c.cfuv
                         + 128.0f;
        const float vv = (r * c.m[6] + g * c.m[7] + bl * c.m[8]) * c.cfuv
                         + 128.0f;
        yq[k] = q23(yv, c.ymin, c.ymax);
        su[k / 2] += q23(uv, c.ymin, c.uvmax);
        sv[k / 2] += q23(vv, c.ymin, c.uvmax);
      }
      yo[dy][wd] = pack4(yq[0], yq[1], yq[2], yq[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the four words' bits sum to F23X4 + s
      uq[2 * wd + h] = (su[h] - F23X4 + 2u) >> 2;
      vq[2 * wd + h] = (sv[h] - F23X4 + 2u) >> 2;
    }
  }
  unsigned char* yb = y + (size_t)b * plane + (size_t)(2 * qy) * W + x0;
  st<P>(yb, wide, n, yo[0]);
  if (rows == 2) st<P>(yb + W, wide, n, yo[1]);
  const int Hc = H / 2, Wc = W / 2;  // chroma_down drops a ragged edge
  if (qy < Hc && x0 / 2 < Wc) {
    uint32_t uw[P / 8], vw[P / 8];
#pragma unroll
    for (int k = 0; k < P / 8; ++k) {
      uw[k] = pack4(uq[4 * k], uq[4 * k + 1], uq[4 * k + 2], uq[4 * k + 3]);
      vw[k] = pack4(vq[4 * k], vq[4 * k + 1], vq[4 * k + 2], vq[4 * k + 3]);
    }
    const size_t at = (size_t)b * Hc * Wc + (size_t)qy * Wc + x0 / 2;
    const int nc = min(P / 2, Wc - x0 / 2);
    st<P / 2>(u + at, narrow, nc, uw);
    st<P / 2>(v + at, narrow, nc, vw);
  }
}

bool multiple(const void* p, long long stride, int width) {
  return (uintptr_t)p % width == 0 && stride % width == 0;
}

// The launch ops/yuv_kernels.py colour_geometry describes: false when it
// refuses (a run other than 8 or 16, a width other than 1, 4, 8 or 16 or
// wider than the run, a block that is not the row pair's runs rounded up
// to a warp and at most MAX_THREADS, a grid over its limits).
bool geometry(int B, int H, int W, int run, int wide, int narrow,
              int threads, dim3* grid) {
  const auto width_ok = [](int w, int cap) {
    return (w == 1 || w == 4 || w == 8 || w == 16) && w <= cap;
  };
  if (B < 1 || H < 1 || W < 1 || (run != 8 && run != 16) ||
      !width_ok(wide, run) || !width_ok(narrow, run / 2)) {
    return false;
  }
  const int runs = (W + run - 1) / run;  // a row pair's
  if (threads != min(MAX_THREADS, (runs + 31) / 32 * 32)) return false;
  const long long gx = (long long)B * ((H + 1) / 2);
  const long long gy = (runs + threads - 1) / threads;
  if (gx > 2147483647LL || gy > 65535) return false;
  *grid = dim3((unsigned)gx, (unsigned)gy);
  return true;
}

}  // namespace

extern "C" {

// K2 on `stream`; returns cudaGetLastError() (0 = launched). y, u, v: B
// frames of contiguous rows with frame strides ys, us, vs (bytes); out:
// (B, 3, H, W) u8, contiguous. H and W even. run, wide, narrow and
// threads (a block's) come from colour_geometry; pointers and strides must
// be multiples of the widths.
int lives_yuv420_to_rgb(const unsigned char* y, const unsigned char* u,
                        const unsigned char* v, long long ys, long long us,
                        long long vs, unsigned char* out, int B, int H,
                        int W, int run, int wide, int narrow, int threads,
                        float ky, float kuv, float cr_v, float cg_u,
                        float cg_v, float cb_u, int clamped, void* stream) {
  dim3 grid;
  if ((H & 1) || (W & 1) ||
      !geometry(B, H, W, run, wide, narrow, threads, &grid) ||
      !multiple(y, ys, wide) || !multiple(y, W, wide) ||
      !multiple(out, (long long)H * W, wide) ||
      !multiple(u, us, narrow) || !multiple(v, vs, narrow) ||
      !multiple(u, W / 2, narrow)) {
    return (int)cudaErrorInvalidValue;
  }
  const Yuv2Rgb c{ky, kuv, cr_v, cg_u, cg_v, cb_u, clamped};
  const dim3 block(threads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (run == 16) {
    yuv420_to_rgb_kernel<16><<<grid, block, 0, s>>>(
        y, u, v, ys, us, vs, out, H, W, wide, narrow, c);
  } else {
    yuv420_to_rgb_kernel<8><<<grid, block, 0, s>>>(
        y, u, v, ys, us, vs, out, H, W, wide, narrow, c);
  }
  return (int)cudaGetLastError();
}

// K3 on `stream`. rgb: B frames of C (3 or 4) contiguous H x W planes,
// frame stride fs (bytes), channels 0-2 read; y: (B, H, W), u and v:
// (B, H/2, W/2), contiguous. m: the 3x3 matrix, row-major; lim: cfy, cfuv,
// yoff, ymin, ymax, uvmax. run, wide, narrow and threads as for K2.
int lives_rgb_to_yuv420(const unsigned char* rgb, long long fs,
                        unsigned char* y, unsigned char* u, unsigned char* v,
                        int B, int H, int W, int run, int wide, int narrow,
                        int threads, const float* m, const float* lim,
                        void* stream) {
  dim3 grid;
  const long long plane = (long long)H * W;
  if (!geometry(B, H, W, run, wide, narrow, threads, &grid) ||
      fs < 3 * plane || !multiple(rgb, fs, wide) ||
      !multiple(rgb, plane, wide) || !multiple(y, plane, wide) ||
      !multiple(y, W, wide) ||
      !multiple(u, (long long)(H / 2) * (W / 2), narrow) ||
      !multiple(v, W / 2, narrow)) {
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
  const dim3 block(threads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (run == 16) {
    rgb_to_yuv420_kernel<16><<<grid, block, 0, s>>>(
        rgb, fs, y, u, v, H, W, wide, narrow, c);
  } else {
    rgb_to_yuv420_kernel<8><<<grid, block, 0, s>>>(
        rgb, fs, y, u, v, H, W, wide, narrow, c);
  }
  return (int)cudaGetLastError();
}

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
