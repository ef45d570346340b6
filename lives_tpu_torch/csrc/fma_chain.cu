// K6, the float32 fused-multiply-add probe of the roofline study.
//
// Replaces the TPU kernel benchmarks/sweep_profile.py:mk(K) (body :147-152,
// pallas_call :155): `acc = a; K times: acc = acc * 1.0000001f + a` over a
// (3, H, W) float32 frame, written back as float32. The study times it at
// two depths K and reads the card's float32 ceiling from the difference:
// 2 operations a step a value over the extra time.
//
// What bounds it on an H100. Its bytes are 8 a value (one float read, one
// written): a 1080p frame's 6.2 M values move 49.8 MB, 15 us at 3.35 TB/s.
// Its operations are one FFMA a step a value, which the data sheet's 67
// TFLOP/s counts as 2: at K = 128 that is 1.59 GFLOP, 24 us. So K = 32 is
// bound by bytes and K >= 128 by the FFMA issue rate (4 schedulers an SM,
// each issuing one warp instruction of 32 lanes a clock). The design does
// what keeps the chain at the issue rate and nothing else:
//
// - Independent work. The chain is K-deep and each step depends on the
//   last, so one accumulator a thread would wait on the FFMA latency
//   (about 4 clocks) at every step. A thread carries 8 accumulators (two
//   float4s, 16-byte loads and stores) and a scheduler has several warps,
//   so an FFMA is always ready to issue.
// - The loop. K is a runtime argument; the steps run in blocks of 16,
//   unrolled, then one at a time for K mod 16: 128 FFMAs a block of steps
//   and no other instruction but the loop's counter and branch.
// - Balance. A thread takes one pair of float4s (the pair i, i + stride of
//   a grid-stride loop whose grid covers the frame once, sized by the
//   wrapper), so every thread does the same work and the blocks, 256
//   threads each, are handed to the SMs as others finish: no thread
//   carries a second round while the card idles.
// - The ragged tail. n need not be a multiple of 4: the last n mod 4
//   values run the same chain one at a time in the same launch, taken by
//   the first threads of the grid.
//
// Numerics: built WITH contraction (not in native.EXTRA_FLAGS' -fmad=false
// list), so `acc * m + a` is one FFMA, rounded once; that one instruction is
// what the probe counts (cuobjdump -sass shows FFMA and no FMUL/FADD pair
// in the loop, chip_smoke.py phase 13 counts them). The plain version
// (ops/fma_chain.py) rounds the multiply and the add on their own, so the
// two agree within a relative error of K * 2^-23, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 16;

__device__ __forceinline__ void step4(float4& p, const float4& a, float m) {
  p.x = p.x * m + a.x;
  p.y = p.y * m + a.y;
  p.z = p.z * m + a.z;
  p.w = p.w * m + a.w;
}

__global__ void __launch_bounds__(THREADS) fma_chain_kernel(
    const float* __restrict__ x, float* __restrict__ y, long long n, int K,
    float m) {
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < n4; i += 2 * stride) {
    const long long j = i + stride;
    const bool two = j < n4;
    const float4 a = x4[i];
    const float4 b = two ? x4[j] : a;
    float4 p = a, q = b;
    int k = 0;
    for (; k + UNROLL <= K; k += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        step4(p, a, m);
        step4(q, b, m);
      }
    }
    for (; k < K; ++k) {
      step4(p, a, m);
      step4(q, b, m);
    }
    y4[i] = p;
    if (two) y4[j] = q;
  }
  // the ragged tail: n mod 4 values, one a thread
  const long long t = n4 * 4 + tid;
  if (t < n) {
    const float a = x[t];
    float p = a;
    for (int k = 0; k < K; ++k) p = p * m + a;
    y[t] = p;
  }
}

}  // namespace

extern "C" {

// K6 on `stream` over n contiguous float32 values (x and y 16-byte
// aligned, checked by the wrapper), `blocks` blocks of THREADS; returns
// cudaGetLastError() (0 = launched).
int lives_fma_chain(const void* x, void* y, long long n, int K, float m,
                    int blocks, void* stream) {
  fma_chain_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n, K, m);
  return (int)cudaGetLastError();
}

int lives_fma_chain_threads() { return THREADS; }

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
