// Fused stateful sweep K5: source generation + a whole stateful chain (the
// stateless ops of the fused sweep, separable stencils, and the EffecTV
// steps fire, life and alien_overlay with their state planes) + the RGB24
// sink quantise, one cooperative kernel launch per frame chunk.
//
// Replaces the TPU kernel lives_tpu/graph/pallas_stateful.py:
// build_fused_stateful_sweep (body :259-543, call :578). It computes what
// that kernel computes, not what its blocks do. The TPU kernel keeps the
// state in VMEM and relies on Mosaic running its grid in order, frames
// outer and bands inner. CUDA gives no block order, so this kernel is
// persistent and cooperative: its grid is the blocks the card holds at once
// (at most one a tile), each block walks frame b's tiles in a strided loop,
// and every block meets at cooperative_groups' grid barrier before frame
// b + 1. Frame b reads state plane (b - 1) % 2 of each pair (the incoming
// state at b = 0) and writes plane b % 2 (ping-pong; the TPU kernel's
// in-place f32 case only saves VMEM). The state planes are written and read
// inside the one launch, so they are read with ordinary loads, never through
// the non-coherent read-only path (no __ldg, no const __restrict__ pointer),
// which could return a line cached before the barrier.
//
// What bounds it on an H100: its device-memory traffic is the u8 write plus
// the state planes: fire reads and writes one f32 a pixel (8 B; its
// neighbour reads hit the cache), life one u8 each way, alien_overlay three
// f32 each way (24 B). For config C's fire + alien_overlay chain that is
// 35 B a pixel, 2.08 ms a 96-frame 1080p chunk at 3.35 TB/s. The chain's
// arithmetic and the latency of short passes between barriers take longer
// (PERF.md: the 11-op tail alone costs what K1's comp-in mode costs
// for it). The design, shared with fused_sweep.cu where it can be
// (sweep_common.cuh, the tile of the two sweeps):
//
// - Runs. A thread computes a run of P adjacent pixels (P = 4 or 8, a
//   template parameter; graph/fused_sweep.py stateful_geometry picks it
//   with the tile) in phase 1 and in every pass, the op loop outside and the
//   run inside. Within a run, fire, life and alien_overlay are evaluated
//   pixel by pixel with the float expressions of the plain frame loop; a
//   run inside the frame moves its f32 state as float4s.
// - Block set-up. Once a frame, shared memory gets the clamped parameter
//   slots and one OpRec an op (sweep_common.cuh make_rec, with the
//   TrackRec of each track it reads); the taps once a launch. No cell loop
//   makes a record.
// - Shared memory: the composite A (3 channels over the tile and its halo
//   R, the sum of the stencil radii and of the stateful halos: fire 1, life
//   1, alien_overlay 0) and one channel S in skewed rows. A stencil runs one
//   channel at a time through S (stencil_pass). fire and life read the luma
//   of their input's neighbours from S: the pass before them writes it
//   beside A (or a pass of its own does, after a stencil with no op after
//   it); after a barrier each cell reads its own RGB from A and its
//   neighbours' luma from S and updates A in place, so the spark test `luma
//   > threshold` and life's gradient read the same floats as the plain loop.
//   alien_overlay works in place. At R = 33 a 32x32 tile takes 165 KB (the
//   first design's two 3-channel buffers took 230.5 KB), which leaves room
//   for the records.
// - A tile per plan (stateful_geometry): the fewest phase-1 cells times the
//   rounds of tiles a frame takes over the resident blocks, so that no frame
//   ends on a nearly empty wave.
//
// Numerics: built with -fmad=false (native.EXTRA_FLAGS), so every multiply
// and add rounds on its own, as PyTorch's eager elementwise ops do. The
// stateful steps amplify a one-ulp difference: fire turns `luma >
// threshold` into a spark that rises through the following frames, so the
// threshold paths (luma, the life gradient) must match the plain frame loop
// bit for bit. No --use_fast_math, as in fused_sweep.cu.
//
// Layout of the launch (a chunk of B frames):
//   grid min(resident blocks, tiles a frame), NTHREADS threads a block;
//   packed, ids, ops, slot_rows, slot_vals, taps as in fused_sweep.cu; the
//   stateful ops carry their state index in F_ARG and their parameter slots
//   (fire: threshold, cooling, amount; life: threshold, amount);
//   st.first[s]: state s entering the chunk, st.plane[k][s]: its two
//   ping-pong planes, fire (H, W) f32, life (H, W) u8 0/1, alien_overlay
//   (3, H, W) f32; out (B, 3, H, W) u8.
// Phase 1 generates track 0 and runs the leading point ops over the tile
// and its halo at coordinates clamped to the frame. Then each step in order
// over the span of halo it leaves valid, followed by the point ops up to
// the next step in the same pass: a stencil (with the frame edge copied
// outward after it); fire and life evaluate every span cell at its clamped
// frame coordinate, so cells outside the frame come out as edge replicas,
// the plain chain's edge padding; alien_overlay likewise. A stateful step
// writes its new state for the tile's own frame cells. The last pass writes
// the tile's u8 pixels inside the frame. (alien_overlay has no halo, so it
// could run inside the pass before it; on an H100 that pass then spilled
// registers and ran slower, PERF.md.)

#include <cooperative_groups.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using namespace lives;
namespace cg = cooperative_groups;

constexpr int MAX_STATES = 8;
// blocks an SM holds by registers: 2, at most 128 registers a thread (the
// occupancy query that graph/stateful_sweep.py resident_blocks and the
// launch's grid read); 3 (80 registers) spilled and ran slower on an H100
constexpr int MIN_BLOCKS = 2;
constexpr int MAX_OPS = MAX_SLOTS + MAX_STATES;  // alien_overlay has no slot

// The state planes: written and read within the launch, so no const and no
// __restrict__ (see the note above).
struct States {
  void* first[MAX_STATES];
  void* plane[2][MAX_STATES];
};

// The plane of state s that frame b reads (the chunk's incoming state at
// b = 0, else the plane frame b - 1 wrote) and the one it writes
__device__ __forceinline__ void* prev_plane(const States& st, int b, int s) {
  return b == 0 ? st.first[s] : st.plane[(b - 1) & 1][s];
}

__device__ __forceinline__ void* next_plane(const States& st, int b, int s) {
  return st.plane[b & 1][s];
}

// Where a run lies: its clamped frame columns and row; the pixels j of
// the tile inside the frame, whose new state it writes, are own_lo <= j <
// own_hi (none when own_lo == own_hi); `whole`: the run lies inside the
// frame, so an f32 state with rows of whole float4s at 16-byte aligned
// planes moves as float4s.
template <int P>
struct RunAt {
  int x[P];
  int y;
  int own_lo, own_hi;
  bool whole;

  __device__ __forceinline__ bool own(int j) const {
    return j >= own_lo && j < own_hi;
  }
  __device__ __forceinline__ bool all_own() const {
    return own_lo == 0 && own_hi == P;
  }
};

template <int P>
__device__ __forceinline__ RunAt<P> run_at(int gy, int gx, int ty0, int tx0,
                                           int TH, int TW, int H, int W) {
  RunAt<P> r;
  r.y = clampi(gy, 0, H - 1);
#pragma unroll
  for (int j = 0; j < P; ++j) r.x[j] = clampi(gx + j, 0, W - 1);
  const bool own_row = gy < H && gy >= ty0 && gy < ty0 + TH;
  // own columns: [max(tx0, 0), min(tx0 + TW, W)) less gx
  r.own_lo = own_row ? clampi(max(tx0, 0) - gx, 0, P) : 0;
  r.own_hi = own_row ? clampi(min(tx0 + TW, W) - gx, r.own_lo, P) : 0;
  r.whole = gy == r.y && gx >= 0 && gx + P <= W && W % 4 == 0;
  return r;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b))
          & 15) == 0;
}

// fire (threshold, cooling, amount) over a run: flames rise: mid =
// max(state, sparks) one row below, averaged with its clamped left and
// right neighbours, then decayed. The sparks are the luma of the row below
// (`lum`, from S) over the threshold.
template <int P, class Lum>
__device__ __forceinline__ void fire_run(const float* p, const float* prev,
                                         float* nxt, Rgb (&v)[P],
                                         const RunAt<P>& at, int H, int W,
                                         const Lum& lum) {
  const float thr = p[0], decay = 0.96f - p[1] * 0.1f;
  const float amount = p[2], keep = 1.0f - p[2];
  const int y = at.y, yb = min(y + 1, H - 1);
  const float* pr = prev + (size_t)yb * W;
  const bool vec = at.whole && aligned16(prev, nxt);
  // the state one row below at each pixel's clamped column and its
  // clamped left and right neighbours: in a whole run, one float4 load
  // and the two columns beside it
  float sm[P], sl[P], sr[P];
  if (vec) {
    lda<P>(pr + at.x[0], 0, sm);
    const float left = pr[max(at.x[0] - 1, 0)];
    const float right = pr[min(at.x[P - 1] + 1, W - 1)];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      sl[j] = j == 0 ? left : sm[j - 1];
      sr[j] = j == P - 1 ? right : sm[j + 1];
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      sm[j] = pr[at.x[j]];
      sl[j] = pr[max(at.x[j] - 1, 0)];
      sr[j] = pr[min(at.x[j] + 1, W - 1)];
    }
  }
  float bufs[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int x = at.x[j];
    const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
    const float gu = lum(yb, x), gl = lum(yb, xl), gr = lum(yb, xr);
    const float up = fmaxf(sm[j], gu > thr ? gu : 0.0f);
    const float l = fmaxf(sl[j], gl > thr ? gl : 0.0f);
    const float r = fmaxf(sr[j], gr > thr ? gr : 0.0f);
    const float buf = (up * 2.0f + l + r) * 0.25f * decay;
    bufs[j] = buf;
    if (!(vec && at.all_own()) && at.own(j)) nxt[(size_t)y * W + x] = buf;
    const float fl[3] = {clip01(buf * 3.0f), clip01(buf * 3.0f - 1.0f),
                         clip01(buf * 3.0f - 2.0f)};
    const float c[3] = {v[j].r, v[j].g, v[j].b};
    float res[3];
    for (int k = 0; k < 3; ++k) {
      const float base = c[k] * keep;
      res[k] = clip01(fmaxf(base, fl[k] * amount + base));
    }
    v[j] = {res[0], res[1], res[2]};
  }
  if (vec && at.all_own()) sta<P>(nxt + (size_t)y * W + at.x[0], 0, bufs);
}

// life (threshold, amount) over a run: the Game of Life on the previous
// cells, seeded from image edges (the clamped luma gradient, from S)
template <int P, class Lum>
__device__ __forceinline__ void life_run(const float* p,
                                         const unsigned char* prev,
                                         unsigned char* nxt, Rgb (&v)[P],
                                         const RunAt<P>& at, int H, int W,
                                         const Lum& lum) {
  const int y = at.y, ya = max(y - 1, 0), yb = min(y + 1, H - 1);
  const int rows[3] = {ya, y, yb};
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int x = at.x[j];
    const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
    const int cols[3] = {xl, x, xr};
    int nb = 0;
    for (int i = 0; i < 3; ++i) {
      for (int k = 0; k < 3; ++k) {
        if (i != 1 || k != 1) nb += prev[(size_t)rows[i] * W + cols[k]];
      }
    }
    const bool alive = prev[(size_t)y * W + x] > 0;
    const float g = luma(v[j]);
    const float gx_ = fabsf(g - lum(y, xl));
    const float gy_ = fabsf(g - lum(ya, x));
    const bool on = nb == 3 || (alive && nb == 2) || gx_ + gy_ > p[0];
    if (at.own(j)) nxt[(size_t)y * W + x] = on ? 1 : 0;
    const float add = on ? p[1] : 0.0f;
    v[j] = clip01({v[j].r + add, v[j].g + add, v[j].b + add});
  }
}

// alien_overlay over a run: a slow exponential ghost of the frame, per
// pixel, with no halo and no neighbour
template <int P>
__device__ __forceinline__ void alien_run(const float* prev, float* nxt,
                                          Rgb (&v)[P], const RunAt<P>& at,
                                          int H, int W) {
  const size_t plane = (size_t)H * W;
  const bool vec = at.whole && aligned16(prev, nxt);
  // a channel at a time: each is its own state plane
  float c[3][P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    c[0][j] = v[j].r;
    c[1][j] = v[j].g;
    c[2][j] = v[j].b;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t row = k * plane + (size_t)at.y * W;
    float old[P], ghost[P];
    if (vec) {
      lda<P>(prev + row + at.x[0], 0, old);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) old[j] = prev[row + at.x[j]];
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      ghost[j] = old[j] + (c[k][j] - old[j]) * 0.1f;
      c[k][j] = clip01(c[k][j] * 0.5f + ghost[j] * 0.5f);
    }
    if (vec && at.all_own()) {
      sta<P>(nxt + row + at.x[0], 0, ghost);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (at.own(j)) nxt[row + at.x[j]] = ghost[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = {c[0][j], c[1][j], c[2][j]};
}


// The luma of a run of A's values v into S at (row, col), a run in one bank
// row of S's skewed layout
template <int P>
__device__ __forceinline__ void put_luma(float* S, int VS, int row, int col,
                                         const Rgb (&v)[P]) {
  float* d = S + row * VS + col + (col >> 5);
#pragma unroll
  for (int j = 0; j < P; ++j) d[j] = luma(v[j]);
}

// FULL: the whole point-op vocabulary; else the core alone
// (sweep_common.cuh), the code a plan of core ops ran before the
// vocabulary grew: the whole vocabulary's instance spills more (runs of 8)
// and took config C's chunk about 4 % longer on an H100 (PERF.md)
template <int P, bool FULL>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS) stateful_sweep_kernel(
    const float* __restrict__ packed, const int* __restrict__ ids,
    const int* __restrict__ ops, int n_ops,
    const int* __restrict__ slot_rows, const float* __restrict__ slot_vals,
    int n_slots, const float* __restrict__ taps, int n_taps,
    const __grid_constant__ States st, unsigned char* __restrict__ out,
    int T, int B, int H, int W, int R, float sx, float sy, int TH, int TW,
    int M) {
  __shared__ float sp[MAX_SLOTS];
  __shared__ TrackRec t0;
  extern __shared__ float4 smem4[];
  const int HA = TH + 2 * R, WS = TW + 2 * M, VS = v_stride(WS);
  const int ch = HA * WS;  // one channel of A
  float* const A = reinterpret_cast<float*>(smem4);
  float* const S = A + 3 * ch;
  OpRec* const rec = reinterpret_cast<OpRec*>(S + HA * VS);
  float* const kw_all = reinterpret_cast<float*>(rec + n_ops);
  for (int i = threadIdx.x; i < n_taps; i += NTHREADS) kw_all[i] = taps[i];

  const int tiles_x = (W + TW - 1) / TW;
  const int n_tiles = tiles_x * ((H + TH - 1) / TH);
  const size_t plane = (size_t)H * W;
  cg::grid_group grid = cg::this_grid();
  for (int b = 0; b < B; ++b) {
    if (b > 0) grid.sync();  // frame b - 1's state planes are written
    // this frame's records (the barrier above, or none yet, frees them)
    __syncthreads();
    load_slots(sp, packed, slot_rows, slot_vals, n_slots, B, b);
    __syncthreads();
    const Frame fr{ids, T, B, b, sx, sy};
    for (int i = threadIdx.x; i < n_ops; i += NTHREADS) {
      const int* o = ops + i * OP_FIELDS;
      rec[i] = make_rec(o, sp + o[F_SLOT], &fr, taps);
    }
    if (threadIdx.x == 0) t0 = track_rec(fr, 0);
    __syncthreads();
    // each step (stencil, fire, life, alien_overlay) has a pass of its own,
    // which runs the point ops after it
    const int first = next_step(rec, 0, n_ops);  // < n_ops: a stateful step
    unsigned char* ob = out + (size_t)b * 3 * plane;
    // does op i read the luma of its input (fire, life)?
    const auto reads_luma = [&](int i) {
      return i < n_ops && (rec[i].code == OP_FIRE || rec[i].code == OP_LIFE);
    };

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int ty = tile / tiles_x;
      const int ty0 = ty * TH, tx0 = (tile - ty * tiles_x) * TW;
      __syncthreads();  // the previous tile's passes are done with A and S

      // The end of every pass over a run at (row, col) of the shared tile,
      // frame row gy and column gx: the ops [from, to), then the run written
      // to the frame (the last pass, rows inside the frame) or back into A,
      // with its luma into S when `luma` (a fire or life pass next)
      const auto finish = [&](Rgb (&v)[P], const RunAt<P>& at, int row,
                              int col, int gy, int gx, int from, int to,
                              bool luma) {
        apply_run<P, FULL>(rec, from, to, v, at.x, at.y, sx, sy);
        if (to == n_ops) {
          if (gy < H) {
            store_run<P>(ob, nullptr, plane, W, (size_t)gy * W + gx, gx, v);
          }
        } else {
          put_run<P>(A, ch, row * WS + col, v);
          if (luma) put_luma<P>(S, VS, row, col, v);
        }
      };

      // A pass that writes A for a fire or life pass next also writes the
      // luma of what it writes into S, so that step needs no pass of its
      // own for it (the same float: luma of the value written). A fire or
      // life pass reads S, so it never writes it.
      bool luma_ready = reads_luma(first);
      // phase 1: track 0 and the ops before the first step over the tile
      // and its halo
      {
        const int lo = (M - R) / P, hi = (M + TW + R + P - 1) / P;
        for_runs(HA, hi - lo, [&](int row, int run) {
          const int col = (lo + run) * P;
          const int gy = ty0 - R + row, gx = tx0 - M + col;
          const RunAt<P> at = run_at<P>(gy, gx, ty0, tx0, TH, TW, H, W);
          Rgb v[P];
          gen_run<P>(t0, at.x, at.y, v);
          finish(v, at, row, col, gy, gx, 0, first, luma_ready);
        });
      }

      // the luma of frame cell (y, x), written to S for a fire or life pass
      const auto lum = [&](int y, int x) {
        return S[(y - ty0 + R) * VS + vcol(x - tx0 + M)];
      };

      // each step, then the point ops up to the next one
      int cur = R;  // halo still valid in A
      for (int si = first; si < n_ops;) {
        const OpRec& o = rec[si];
        const int code = o.code;
        const int next = next_step(rec, si + 1, n_ops);
        const int after = code == OP_STENCIL ? cur - o.arg
                          : code == OP_ALIEN ? cur : cur - 1;
        const int row0 = R - after, rows = TH + 2 * after;
        // runs covering the columns written ([M-after, M+TW+after))
        const int hlo = (M - after) / P, hhi = (M + TW + after + P - 1) / P;
        if (code == OP_STENCIL) {
          const int vlo = (M - cur) / P, vhi = (M + TW + cur + P - 1) / P;
          stencil_pass<P>(A, S, ch, WS, VS, row0, rows, vlo, vhi, hlo, hhi,
                          o.arg, kw_all + o.taps, o.sharpen != 0, o.k[0]);
        } else if (code != OP_ALIEN && !luma_ready) {
          // fire and life read their neighbours' luma over the span still
          // valid: write it to S first
          const int lo = (M - cur) / P, hi = (M + TW + cur + P - 1) / P;
          __syncthreads();
          for_runs(TH + 2 * cur, hi - lo, [&](int i, int run) {
            const int row = R - cur + i, col = (lo + run) * P;
            Rgb v[P];
            get_run<P>(A, ch, row * WS + col, v);
            put_luma<P>(S, VS, row, col, v);
          });
        }
        // a stencil with no op after it before another pass writes A
        // itself
        const bool pass = code != OP_STENCIL || next > si + 1 || next == n_ops;
        luma_ready = pass && !reads_luma(si) && reads_luma(next);
        if (pass) {
          const float* p = sp + o.slot;
          void* prev = prev_plane(st, b, code == OP_STENCIL ? 0 : o.arg);
          void* nxt = next_plane(st, b, code == OP_STENCIL ? 0 : o.arg);
          __syncthreads();
          for_runs(rows, hhi - hlo, [&](int i, int run) {
            const int row = row0 + i, col = (hlo + run) * P;
            const int gy = ty0 - R + row, gx = tx0 - M + col;
            const RunAt<P> at = run_at<P>(gy, gx, ty0, tx0, TH, TW, H, W);
            Rgb v[P];
            get_run<P>(A, ch, row * WS + col, v);
            if (code == OP_FIRE) {
              fire_run<P>(p, (const float*)prev, (float*)nxt, v, at, H, W,
                          lum);
            } else if (code == OP_LIFE) {
              life_run<P>(p, (const unsigned char*)prev,
                          (unsigned char*)nxt, v, at, H, W, lum);
            } else if (code == OP_ALIEN) {
              alien_run<P>((const float*)prev, (float*)nxt, v, at, H, W);
            }
            finish(v, at, row, col, gy, gx, si + 1, next, luma_ready);
          });
        }
        // before a later step: a stencil's output outside the frame is
        // replaced by the frame edge (a stateful step's already is one)
        if (next < n_ops && code == OP_STENCIL) {
          edge_fixup(A, ch, WS, R, M, TH, TW, after, ty0, tx0, H, W);
        }
        cur = after;
        si = next;
      }
    }
  }
}

// Bytes of dynamic shared memory a launch needs: A and S, the op records,
// the taps (graph/fused_sweep.py stateful_geometry computes the same).
size_t smem_need(int TH, int TW, int M, int R, int n_ops, int n_taps) {
  const size_t rows = TH + 2 * R, WS = TW + 2 * M;
  return rows * (3 * WS + v_stride(WS)) * sizeof(float) +
         (size_t)n_ops * sizeof(OpRec) + (size_t)n_taps * sizeof(float);
}

using Kernel = decltype(&stateful_sweep_kernel<4, false>);

// The kernel of run P (full: the whole vocabulary's), null for a run that
// is not built
Kernel kernel_of(int P, int full) {
  if (full) {
    return P == 4 ? stateful_sweep_kernel<4, true>
           : P == 8 ? stateful_sweep_kernel<8, true> : nullptr;
  }
  return P == 4 ? stateful_sweep_kernel<4, false>
         : P == 8 ? stateful_sweep_kernel<8, false> : nullptr;
}

int blocks_per_sm(Kernel kern, int smem, int* per_sm) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kern, NTHREADS, smem);
}

int launch(Kernel kern, int smem, cudaStream_t stream, const float* packed,
           const int* ids, const int* ops, int n_ops, const int* slot_rows,
           const float* slot_vals, int n_slots, const float* taps, int n_taps,
           States st, unsigned char* out, int T, int B, int H, int W, int R,
           float sx, float sy, int TH, int TW, int M) {
  int per_sm = 0, dev = 0, sms = 0;
  int e = blocks_per_sm(kern, smem, &per_sm);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = (int)cudaGetDevice(&dev);
  if (e != 0) return e;
  e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return e;
  const long tiles = (long)((W + TW - 1) / TW) * ((H + TH - 1) / TH);
  const int grid = (int)(tiles < (long)per_sm * sms ? tiles
                                                    : (long)per_sm * sms);
  void* args[] = {&packed, &ids,  &ops, &n_ops, &slot_rows, &slot_vals,
                  &n_slots, &taps, &n_taps, &st, &out, &T, &B, &H, &W, &R,
                  &sx, &sy, &TH, &TW, &M};
  e = (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                       dim3(NTHREADS), args, (size_t)smem,
                                       stream);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one chunk of B frames on `stream` as one cooperative launch;
// first/plane0/plane1 hold n_states state pointers each. The geometry (tile
// TH x TW, run P, margin M, `smem` bytes) comes from graph/fused_sweep.py
// stateful_geometry; full: the plan holds a point op past the core
// vocabulary. Returns 0 when launched, else the CUDA error: a launch the
// geometry does not fit is refused, and a grid the card cannot hold at once
// fails (cudaErrorCooperativeLaunchTooLarge); nothing falls back.
int lives_stateful_sweep(const float* packed, const int* ids, const int* ops,
                         int n_ops, const int* slot_rows,
                         const float* slot_vals, int n_slots,
                         const float* taps, int n_taps,
                         void* const* first, void* const* plane0,
                         void* const* plane1, int n_states,
                         unsigned char* out, int T, int B, int H, int W,
                         int R, float sx, float sy, int TH, int TW, int P,
                         int M, int smem, int full, void* stream) {
  const Kernel kern = kernel_of(P, full);
  if (kern == nullptr || n_slots > MAX_SLOTS || n_states > MAX_STATES ||
      n_states < 1 || n_ops < 1 || n_ops > MAX_OPS || n_taps < 0 || T < 1 ||
      B < 1 || H < 1 || W < 1 || R < 0 || TH < 1 || TW < P || TW % P != 0 ||
      M % P != 0 || (R > 0 ? M < R + P - 1 : M != 0) || smem < 0 ||
      (size_t)smem < smem_need(TH, TW, M, R, n_ops, n_taps)) {
    return (int)cudaErrorInvalidValue;
  }
  States st{};
  for (int s = 0; s < n_states; ++s) {
    st.first[s] = first[s];
    st.plane[0][s] = plane0[s];
    st.plane[1][s] = plane1[s];
  }
  return launch(kern, smem, (cudaStream_t)stream, packed, ids, ops, n_ops,
                slot_rows, slot_vals, n_slots, taps, n_taps, st, out, T, B,
                H, W, R, sx, sy, TH, TW, M);
}

// Blocks of the kernel at run P (full: the whole vocabulary's) with `smem`
// bytes of dynamic shared memory that one SM holds, in *per_sm; returns the
// CUDA error (0 = none).
int lives_stateful_blocks_per_sm(int P, int full, int smem, int* per_sm) {
  const Kernel kern = kernel_of(P, full);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return blocks_per_sm(kern, smem, per_sm);
}

const char* lives_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
