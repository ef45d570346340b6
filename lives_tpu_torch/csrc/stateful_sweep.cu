// Fused stateful sweep: source generation + a whole stateful chain (the
// stateless ops of the fused sweep, separable stencils, and the EffecTV
// steps fire, life and alien_overlay with their state planes) + the RGB24
// sink quantise, one kernel launch per frame.
//
// Replaces the TPU kernel lives_tpu/graph/pallas_stateful.py:
// build_fused_stateful_sweep. It computes what that kernel computes
// (pallas_stateful.py:259-543), not what its blocks do. The TPU kernel
// keeps the state in VMEM and relies on Mosaic running its grid in order,
// frames outer and bands inner; CUDA gives no block order, and a grid-wide
// barrier inside one launch would need every 32x32 tile of a 1080p frame
// (2,040 blocks) resident at once, more than 132 SMs hold. So the wrapper
// launches once a frame on one stream: each launch reads the previous
// frame's state planes and writes the other plane of each pair (ping-pong,
// always correct; the TPU kernel's in-place f32 case only saves VMEM).
//
// What bounds it on an H100: the ALU work of the chain on the halo'd tile,
// as in fused_sweep.cu. Its device-memory traffic is the u8 write plus the
// state planes: fire reads and writes one f32 a pixel (8 B; its neighbour
// reads hit the cache), life one u8 each way, alien_overlay three f32 each
// way (24 B). For the fire + alien_overlay chain that is 35 B a pixel with
// the u8 write, 73 MB a 1080p frame, 2.1 ms a 96-frame chunk at 3.35 TB/s,
// against the hundreds of ALU instructions a pixel. The previous frame's state is read
// straight from device memory at clamped coordinates, so no state staging
// is needed in shared memory.
//
// Numerics: built with -fmad=false (native.load), so every multiply and add
// rounds on its own, as PyTorch's eager elementwise ops do. The stateful
// steps amplify a one-ulp difference: fire turns `luma > threshold` into a
// spark that rises through the following frames, so the threshold paths
// (luma, the life gradient) must match the plain frame loop bit for bit.
// No --use_fast_math, as in fused_sweep.cu.
//
// Layout of one launch (frame b of a chunk of B):
//   grid (ceil(W/TILE_W), ceil(H/TILE_H)), NTHREADS threads a block;
//   packed, ids, ops, slot_rows, slot_vals, taps as in fused_sweep.cu; the
//   stateful ops carry their state index in F_ARG and their parameter slots
//   (fire: threshold, cooling, amount; life: threshold, amount);
//   prev[s]/next[s]: state s of the previous and of this frame, fire
//   (H, W) f32, life (H, W) u8 0/1, alien_overlay (3, H, W) f32;
//   out (B, 3, H, W) u8, frame b written.
// Phase 1 generates track 0 and runs the leading point ops over the tile
// and its halo R (the sum of the stencil radii and of the stateful halos,
// fire 1, life 1, alien_overlay 0) at coordinates clamped to the frame, into
// shared memory. Then each step in order over the span of halo it leaves
// valid: a stencil as in fused_sweep.cu (with the frame edge copied outward
// after it); fire and life evaluate every span cell at its clamped frame
// coordinate (so cells outside the frame come out as edge replicas, which
// is the plain chain's edge padding) into the second buffer, which then
// becomes the composite; alien_overlay updates the composite in place. Each
// step runs the point ops that follow it in the same pass. A stateful step
// writes its new state for the tile's own frame cells.

#include "sweep_common.cuh"

namespace {

using namespace lives;

constexpr int MAX_STATES = 8;
// blocks an SM holds by registers: 5, at most 48 registers a thread
constexpr int MIN_BLOCKS = 5;

struct States {
  const void* prev[MAX_STATES];
  void* next[MAX_STATES];
};

__device__ __forceinline__ float spark(const float* A, int ch, int at,
                                       float threshold) {
  const float g = luma(get(A, ch, at));
  return g > threshold ? g : 0.0f;
}

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS) stateful_sweep_kernel(
    const float* __restrict__ packed, const int* __restrict__ ids,
    const int* __restrict__ ops, int n_ops,
    const int* __restrict__ slot_rows, const float* __restrict__ slot_vals,
    int n_slots, const float* __restrict__ taps, States st,
    unsigned char* __restrict__ out, int T, int B, int b, int H, int W,
    int R, float sx, float sy) {
  __shared__ float sp[MAX_SLOTS];
  extern __shared__ float smem[];
  const int ty0 = blockIdx.y * TILE_H;
  const int tx0 = blockIdx.x * TILE_W;
  load_slots(sp, packed, slot_rows, slot_vals, n_slots, B, b);
  __syncthreads();

  const Frame fr{ids, T, B, b, sx, sy};
  const size_t plane = (size_t)H * W;
  unsigned char* ob = out + (size_t)b * 3 * plane;
  const int HA = TILE_H + 2 * R, WA = TILE_W + 2 * R;
  const int ch = HA * WA;
  float* A = smem;           // the composite, indexed by halo coordinates
  float* V = smem + 3 * ch;  // a stencil's vertical pass; fire/life output
  const int first = next_step(ops, 0, n_ops);  // < n_ops: a stateful step

  // local (halo) index of frame cell (y, x)
  auto cell = [&](int y, int x) { return (y - ty0 + R) * WA + (x - tx0 + R); };

  const TrackRec t0 = track_rec(fr, 0);
  for (int idx = threadIdx.x; idx < ch; idx += NTHREADS) {
    const int ly = idx / WA, lx = idx - (idx / WA) * WA;
    const int y = min(max(ty0 - R + ly, 0), H - 1);
    const int xs[1] = {min(max(tx0 - R + lx, 0), W - 1)};
    Rgb v[1];
    gen_run<1>(t0, xs, y, v);
    put(A, ch, idx, apply_ops(ops, 0, first, sp, v[0], fr, xs[0], y));
  }

  int cur = R;  // halo still valid in A
  for (int si = first; si < n_ops;) {
    const int* o = ops + si * OP_FIELDS;
    const int code = o[F_CODE];
    const float* p = sp + o[F_SLOT];
    const int next = next_step(ops, si + 1, n_ops);
    const bool last = next == n_ops;
    const int after = code == OP_STENCIL ? cur - o[F_ARG]
                      : code == OP_ALIEN ? cur : cur - 1;
    __syncthreads();
    if (code == OP_STENCIL) {
      const int r = o[F_ARG];
      const float* kw = taps + o[F_TAPS];
      vertical_pass(A, V, WA, ch, R, cur, after, r, kw);
      __syncthreads();
      const int vh = TILE_H + 2 * after, hw = TILE_W + 2 * after;
      for (int idx = threadIdx.x; idx < vh * hw; idx += NTHREADS) {
        const int ly = R - after + idx / hw, lx = R - after + idx % hw;
        const int gy = ty0 - R + ly, gx = tx0 - R + lx;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        if (!inside && !last) continue;  // replicated from the edge below
        const int at = ly * WA + lx;
        const Rgb v = apply_ops(
            ops, si + 1, next, sp,
            horizontal_mix(A, V, ch, at, r, kw, o[F_SHARPEN] != 0, p[0]),
            fr, min(max(gx, 0), W - 1), min(max(gy, 0), H - 1));
        if (last) {
          if (inside) {
            const size_t px = (size_t)gy * W + gx;
            ob[px] = q8(v.r);
            ob[plane + px] = q8(v.g);
            ob[2 * plane + px] = q8(v.b);
          }
        } else {
          put(A, ch, at, v);
        }
      }
      if (!last) {
        __syncthreads();
        edge_fixup(A, WA, ch, R, after, ty0, tx0, H, W);
      }
    } else {
      const int s = o[F_ARG];
      const int n = TILE_W + 2 * after;
      float* dst = code == OP_ALIEN ? A : V;
      for (int idx = threadIdx.x; idx < n * (TILE_H + 2 * after);
           idx += NTHREADS) {
        const int ly = R - after + idx / n, lx = R - after + idx % n;
        const int gy = ty0 - R + ly, gx = tx0 - R + lx;
        const int y = min(max(gy, 0), H - 1), x = min(max(gx, 0), W - 1);
        const size_t px = (size_t)y * W + x;
        // the tile's own frame cells write the new state
        const bool own = gy == y && gx == x && ly >= R && ly < R + TILE_H
                         && lx >= R && lx < R + TILE_W;
        // a cell outside the frame holds its edge cell's value, so this is
        // the composite at (y, x); alien_overlay writes this cell in place
        const Rgb rgb = get(A, ch, ly * WA + lx);
        Rgb v;
        if (code == OP_FIRE) {  // threshold, cooling, amount
          // flames rise: mid = max(state, sparks) one row below, averaged
          // with its clamped left and right neighbours, then decayed
          const float* prev = (const float*)st.prev[s];
          const int yb = min(y + 1, H - 1);
          const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
          const float up = fmaxf(prev[(size_t)yb * W + x],
                                 spark(A, ch, cell(yb, x), p[0]));
          const float l = fmaxf(prev[(size_t)yb * W + xl],
                                spark(A, ch, cell(yb, xl), p[0]));
          const float r = fmaxf(prev[(size_t)yb * W + xr],
                                spark(A, ch, cell(yb, xr), p[0]));
          const float buf = (up * 2.0f + l + r) * 0.25f
                            * (0.96f - p[1] * 0.1f);
          if (own) ((float*)st.next[s])[px] = buf;
          const float fl[3] = {clip01(buf * 3.0f), clip01(buf * 3.0f - 1.0f),
                               clip01(buf * 3.0f - 2.0f)};
          const float keep = 1.0f - p[2];
          const float c[3] = {rgb.r, rgb.g, rgb.b};
          float res[3];
          for (int k = 0; k < 3; ++k) {
            const float base = c[k] * keep;
            res[k] = clip01(fmaxf(base, fl[k] * p[2] + base));
          }
          v = {res[0], res[1], res[2]};
        } else if (code == OP_LIFE) {  // threshold, amount
          const unsigned char* prev = (const unsigned char*)st.prev[s];
          const int ya = max(y - 1, 0), yb = min(y + 1, H - 1);
          const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
          const int rows[3] = {ya, y, yb}, cols[3] = {xl, x, xr};
          int nb = 0;
          for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) {
              if (i != 1 || j != 1) nb += prev[(size_t)rows[i] * W + cols[j]];
            }
          }
          const bool alive = prev[px] > 0;
          // seed new life from image edges (clamped luma gradient)
          const float g = luma(rgb);
          const float gx_ = fabsf(g - luma(get(A, ch, cell(y, xl))));
          const float gy_ = fabsf(g - luma(get(A, ch, cell(ya, x))));
          const bool on = nb == 3 || (alive && nb == 2)
                          || gx_ + gy_ > p[0];
          if (own) ((unsigned char*)st.next[s])[px] = on ? 1 : 0;
          const float add = on ? p[1] : 0.0f;
          v = clip01({rgb.r + add, rgb.g + add, rgb.b + add});
        } else {  // OP_ALIEN: a slow exponential ghost of the frame
          const float* prev = (const float*)st.prev[s];
          float* nxt = (float*)st.next[s];
          const float c[3] = {rgb.r, rgb.g, rgb.b};
          float res[3];
          for (int k = 0; k < 3; ++k) {
            const float old = prev[k * plane + px];
            const float ghost = old + (c[k] - old) * 0.1f;
            if (own) nxt[k * plane + px] = ghost;
            res[k] = clip01(c[k] * 0.5f + ghost * 0.5f);
          }
          v = {res[0], res[1], res[2]};
        }
        v = apply_ops(ops, si + 1, next, sp, v, fr, x, y);
        if (last) {
          if (own) {
            ob[px] = q8(v.r);
            ob[plane + px] = q8(v.g);
            ob[2 * plane + px] = q8(v.b);
          }
        } else {
          put(dst, ch, ly * WA + lx, v);
        }
      }
      if (code != OP_ALIEN) {  // the output buffer becomes the composite
        float* t = A;
        A = V;
        V = t;
      }
    }
    cur = after;
    si = next;
  }
}

}  // namespace

extern "C" {

// Launch frame b of a chunk on `stream`; prev/next hold n_states state
// pointers each. Returns cudaGetLastError() (0 = launched).
int lives_stateful_sweep(const float* packed, const int* ids, const int* ops,
                         int n_ops, const int* slot_rows,
                         const float* slot_vals, int n_slots,
                         const float* taps, const void* const* prev,
                         void* const* next, int n_states, unsigned char* out,
                         int T, int B, int b, int H, int W, int R, float sx,
                         float sy, void* stream) {
  if (n_slots > MAX_SLOTS || n_states > MAX_STATES || n_states < 1
      || T < 1 || b < 0 || b >= B) {
    return (int)cudaErrorInvalidValue;
  }
  States st{};
  for (int s = 0; s < n_states; ++s) {
    st.prev[s] = prev[s];
    st.next[s] = next[s];
  }
  const size_t smem =
      (size_t)2 * 3 * (TILE_H + 2 * R) * (TILE_W + 2 * R) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stateful_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, 1);
  stateful_sweep_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      packed, ids, ops, n_ops, slot_rows, slot_vals, n_slots, taps, st, out,
      T, B, b, H, W, R, sx, sy);
  return (int)cudaGetLastError();
}

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
