// One GRU step for Hopper (sm_90a), fp32 state with fp32 or bf16 weights.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/gru_cell/kernel.py:
//   gru_step_fused   (_fused_kernel)    <- gru_step_warp_k (H <= 32),
//                                          gru_step_wide_k (v1, wide H),
//                                          gru_step_fused_k (the rest)
//   gru_step_blocked (_blocked_kernel)  <- gru_step_wide_k (the old route:
//                                          gru_blocked_gates_k + _cand_k)
// Layouts are JAX's: h (B, H), x_proj (B, 3H), u (H, 3H) with gate
// columns [z | r | h] contracted as h @ u, b (3H). h and r*h are rounded
// to u's dtype before each product, as the TPU kernels cast them; sums are
// fp32 and the gate math follows each TPU kernel's order of additions.
// The wrappers pick a route by shape (step_plan in
// kernels/gru_cell/kernel.py); every route stays callable through its C
// entry, so tests and tools/step_tiles.py can force any of them.
//
// Translation. Both TPU kernels keep h resident and stream whole columns
// of U (the paper's row-wise split: each program finishes its own outputs;
// U's rows are the AIE's rows). Three routes here:
//
// * "warp" (gru_step_warp_k; H <= 32, the paper's widths): one warp a
//   batch row, lane c owning column c of the three gates, as the int8
//   step's warp route (gru_cell_q8.cu) and the sequence's at T = 1
//   (gru_sequence.cu). Lane c loads its 3H weights of U in one burst of
//   coherent loads closed by __syncwarp() (ptxas keeps a burst of such
//   loads together; __ldg loads it sinks to their fmas), h[c], b and its
//   xp columns; h_k reaches every lane through a per-warp slot of shared
//   memory (float4 reads; shuffles were slower). v3 is one pass over k;
//   v1 two (z and r, then the candidate on r*h). No block barrier; a
//   warp past B exits whole. H 20 and 32 are compiled as
//   constants (each load an immediate offset, no predicate).
// * "wide" (gru_step_wide_k; the blocked step always, the fused v1 step
//   at large H): one step spread over the whole card. Block x owns
//   columns [x*cw, x*cw + cw) of all three gates; together the blocks
//   cover the card in about one wave. Each block streams its slices of U
//   through a ring of shared-memory stages filled by cp.async (16-byte
//   copies a row where u is aligned): z and r rows first, then the
//   candidate's; the ring runs `stages` chunks ahead across the phase
//   boundary, so the candidate's U_h streams in while z and r are being
//   computed. The candidate needs r*h of EVERY column: z and r*h go to
//   global scratch, then one grid-wide barrier (a cooperative launch, so
//   the grid is resident by contract: at most one block an SM; two
//   kernels chained by programmatic dependent launch were slower at every
//   shape the sweep timed from H = 1000 on). Every block reads all of h before
//   its z/r pass and all of r*h after the barrier, by 16-byte loads (h's
//   started ahead of U's copies; r*h written tile-major by phase 1, so one
//   contiguous block). Inside a block a thread owns 4 output columns of a
//   pass and a k-slice; its sums meet by a butterfly over the lanes of the
//   same columns (reduce-scatter rounds), then over the warps in order.
//   B rows go in tiles of bt <= 8 rows, each tile a pass over the stages.
//   (At B = 8 the all-to-all reads of h and r*h, 128 blocks on the same
//   lines of L2, and the grid barrier are where the time goes; PERF.md.)
// * "tile" (gru_step_fused_k; v3 past H = 32, and v1 between the warp and
//   the wide bounds): the column tile of col_tile.cuh; h of its batch
//   tile (at most 8 rows) staged in shared memory, U streamed.
//   - v3: no gate depends on another column, so the grid spreads column
//     tiles over blocks, each fusing the bias and the gate epilogue into
//     its matvec (the paper's hybrid aggregation).
//   - v1: the block walks all column tiles itself, z and r first (z and
//     r*h kept in shared memory), then one block barrier, then the
//     candidate tiles: "whole state in one program", as on the TPU. One
//     block per batch tile, so one SM streams all of U: 424 us at H = 1000
//     on an H100, the reason for the wide route.
//   The old blocked step (gru_blocked_gates_k, then gru_blocked_cand_k:
//   H / ct blocks of the column tile a launch, z and r*h through global
//   scratch between the two launches) stays callable for comparison.
//
// Bound on an H100 (SXM, 3.35 TB/s): a step reads U once (3H^2 weights)
// and does 6*B*H^2 flops, so at B <= 8 it is bound by bytes: 12.8 MB, 3.8
// us, at H = 1024 fp32; the wide route's design is to keep every SM's
// share of U in flight. At the paper's widths (H = 20, 32) the bound is
// nanoseconds and the step is bound by latency: the launch, the weights'
// load and the dependent chain of fmas, which the warp route keeps out of
// shared memory and barriers.
//
// Orders of summation. The tile route: each thread's k-slice, a butterfly
// over lanes, the 8 warps in order. The warp route: k in order by fma from
// 0 (lanes past H add exact zeros). The wide route: each thread's k's
// (k = s, s + slices, ... for its slice s) by fma from 0, a butterfly over
// the lanes of its column, then the 8 warps in order. No route keeps the
// tile route's order, so they agree with it to rounding, not bit for bit;
// each repeats its own order on every call (no atomics). The update is
// fma(1 - z, h, z * ht) on the warp and wide routes.
//
// Numerics: expf/tanhf, no fast math; fma on the CUDA cores, no TF32.

#include <cooperative_groups.h>

#include "col_tile.cuh"

namespace {

using namespace coltile;

// fused: (H, BT) h operand, the warps' sums, and for v1 the (H, BT) r*h
// operand and (BT, H) z.
size_t fused_smem(int H, int bt, int ct, int v3) {
  const size_t hb = (size_t)H * bt;
  return 4 * (hb + red_floats(v3 ? 3 : 2, bt, ct) + (v3 ? 0 : 2 * hb));
}

// blocked: each of its two kernels holds one (H, BT) operand and the warps'
// sums (two gates in the first, one in the second).
size_t gates_smem(int H, int bt, int ct) {
  return 4 * ((size_t)H * bt + red_floats(2, bt, ct));
}

size_t cand_smem(int H, int bt, int ct) {
  return 4 * ((size_t)H * bt + red_floats(1, bt, ct));
}

template <int BT, typename W>
__global__ void __launch_bounds__(kThreads)
gru_step_fused_k(const float* __restrict__ h, const float* __restrict__ xp,
                 const W* __restrict__ u, const float* __restrict__ b,
                 float* __restrict__ out, int B, int H, int v3, int ct,
                 int vec) {
  extern __shared__ float4 smem_fused[];
  float* sx = reinterpret_cast<float*>(smem_fused);  // (H, BT) h as W
  float* red = sx + (size_t)H * BT;
  float* srh = red + red_floats(v3 ? 3 : 2, BT, ct);  // v1: (H, BT) r*h as W
  float* sz = srh + (size_t)H * BT;                   // v1: (BT, H) z
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const size_t H3 = 3 * (size_t)H;
  const int ntiles = (H + ct - 1) / ct;

  load_operand<BT, W>(sx, h, H, row0, nrow, 0, H);
  __syncthreads();

  if (v3) {                          // ua = h @ u + b, one stacked matvec
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int j = tile * ct + kVec * t.cg;
      const int col[3] = {j, H + j, 2 * H + j};
      float acc[3][BT][kVec] = {};
      accumulate<3, BT>(acc, sx, u, H3, col, H - j, vec, 0, H, t);
      reduce_warps<3, BT>(acc, red, t);
      __syncthreads();
      for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
        const int r = o / ct;
        const int c = o - r * ct;
        const int jj = tile * ct + c;
        if (r >= nrow || jj >= H) continue;
        const size_t row = row0 + r;
        const float* x = xp + row * H3;
        const float uz = tile_sum<3, BT>(red, ct, 0, r, c) + b[jj];
        const float ur = tile_sum<3, BT>(red, ct, 1, r, c) + b[H + jj];
        const float uh = tile_sum<3, BT>(red, ct, 2, r, c) + b[2 * H + jj];
        const float z = sigmoid_f(x[jj] + uz);
        const float rg = sigmoid_f(x[H + jj] + ur);
        const float ht = tanhf(x[2 * H + jj] + rg * uh);
        const float hv = h[row * H + jj];
        out[row * H + jj] = (1.0f - z) * hv + z * ht;
      }
      __syncthreads();               // red is rewritten by the next tile
    }
    return;
  }

  // v1, phase 1: zr = h @ u[:, :2H] + b[:2H]; z, r; r*h staged
  for (int tile = 0; tile < ntiles; ++tile) {
    const int j = tile * ct + kVec * t.cg;
    const int col[2] = {j, H + j};
    float acc[2][BT][kVec] = {};
    accumulate<2, BT>(acc, sx, u, H3, col, H - j, vec, 0, H, t);
    reduce_warps<2, BT>(acc, red, t);
    __syncthreads();
    for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
      const int r = o / ct;
      const int c = o - r * ct;
      const int jj = tile * ct + c;
      if (jj >= H) continue;
      if (r >= nrow) {
        srh[jj * BT + r] = 0.0f;
        continue;
      }
      const size_t row = row0 + r;
      const float* x = xp + row * H3;
      const float zr_z = tile_sum<2, BT>(red, ct, 0, r, c) + b[jj];
      const float zr_r = tile_sum<2, BT>(red, ct, 1, r, c) + b[H + jj];
      const float z = sigmoid_f(x[jj] + zr_z);
      const float rg = sigmoid_f(x[H + jj] + zr_r);
      sz[r * H + jj] = z;
      srh[jj * BT + r] = round_to<W>(rg * h[row * H + jj]);
    }
    __syncthreads();
  }

  // v1, phase 2: ht = tanh(xh + (r*h) @ u[:, 2H:] + b[2H:]); the update
  for (int tile = 0; tile < ntiles; ++tile) {
    const int j = tile * ct + kVec * t.cg;
    const int col[1] = {2 * H + j};
    float acc[1][BT][kVec] = {};
    accumulate<1, BT>(acc, srh, u, H3, col, H - j, vec, 0, H, t);
    reduce_warps<1, BT>(acc, red, t);
    __syncthreads();
    for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
      const int r = o / ct;
      const int c = o - r * ct;
      const int jj = tile * ct + c;
      if (r >= nrow || jj >= H) continue;
      const size_t row = row0 + r;
      const float ht =
          tanhf((xp[row * H3 + 2 * H + jj] + tile_sum<1, BT>(red, ct, 0, r, c))
                + b[2 * H + jj]);
      const float z = sz[r * H + jj];
      const float hv = h[row * H + jj];
      out[row * H + jj] = (1.0f - z) * hv + z * ht;
    }
    __syncthreads();
  }
}

// Blocked step, launch 1 (the TPU kernel's phases 0 and 1): for the block's
// column tile, z = sigmoid(xz + h @ u_z + b_z) and r*h with
// r = sigmoid(xr + h @ u_r + b_r), into the (B, H) scratch zs and rhs.
template <int BT, typename W>
__global__ void __launch_bounds__(kThreads)
gru_blocked_gates_k(const float* __restrict__ h, const float* __restrict__ xp,
                    const W* __restrict__ u, const float* __restrict__ b,
                    float* __restrict__ zs, float* __restrict__ rhs, int B,
                    int H, int ct, int vec) {
  extern __shared__ float4 smem_gates[];
  float* sx = reinterpret_cast<float*>(smem_gates);  // (H, BT) h as W
  float* red = sx + (size_t)H * BT;
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const size_t H3 = 3 * (size_t)H;
  const int tile = blockIdx.x;

  load_operand<BT, W>(sx, h, H, row0, nrow, 0, H);
  __syncthreads();
  const int j = tile * ct + kVec * t.cg;
  const int col[2] = {j, H + j};
  float acc[2][BT][kVec] = {};
  accumulate<2, BT>(acc, sx, u, H3, col, H - j, vec, 0, H, t);
  reduce_warps<2, BT>(acc, red, t);
  __syncthreads();
  for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
    const int r = o / ct;
    const int c = o - r * ct;
    const int jj = tile * ct + c;
    if (r >= nrow || jj >= H) continue;
    const size_t row = row0 + r;
    const float* x = xp + row * H3;
    zs[row * H + jj] =
        sigmoid_f((x[jj] + tile_sum<2, BT>(red, ct, 0, r, c)) + b[jj]);
    const float rg = sigmoid_f((x[H + jj] + tile_sum<2, BT>(red, ct, 1, r, c))
                               + b[H + jj]);
    rhs[row * H + jj] = rg * h[row * H + jj];
  }
}

// Blocked step, launch 2 (phase 2): ht = tanh(xh + (r*h) @ u_h + b_h) over
// ALL of r*h (written by launch 1 for every column tile), then
// h' = (1 - z) * h + z * ht for the block's column tile.
template <int BT, typename W>
__global__ void __launch_bounds__(kThreads)
gru_blocked_cand_k(const float* __restrict__ h, const float* __restrict__ xp,
                   const W* __restrict__ u, const float* __restrict__ b,
                   const float* __restrict__ zs, const float* __restrict__ rhs,
                   float* __restrict__ out, int B, int H, int ct, int vec) {
  extern __shared__ float4 smem_cand[];
  float* sx = reinterpret_cast<float*>(smem_cand);   // (H, BT) r*h as W
  float* red = sx + (size_t)H * BT;
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const size_t H3 = 3 * (size_t)H;
  const int tile = blockIdx.x;

  load_operand<BT, W>(sx, rhs, H, row0, nrow, 0, H);
  __syncthreads();
  const int j = tile * ct + kVec * t.cg;
  const int col[1] = {2 * H + j};
  float acc[1][BT][kVec] = {};
  accumulate<1, BT>(acc, sx, u, H3, col, H - j, vec, 0, H, t);
  reduce_warps<1, BT>(acc, red, t);
  __syncthreads();
  for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
    const int r = o / ct;
    const int c = o - r * ct;
    const int jj = tile * ct + c;
    if (r >= nrow || jj >= H) continue;
    const size_t row = row0 + r;
    const float ht =
        tanhf((xp[row * H3 + 2 * H + jj] + tile_sum<1, BT>(red, ct, 0, r, c))
              + b[2 * H + jj]);
    const float z = zs[row * H + jj];
    const float hv = h[row * H + jj];
    out[row * H + jj] = (1.0f - z) * hv + z * ht;
  }
}

template <int BT, typename W>
int launch_fused(const float* h, const float* xp, const void* u,
                 const float* b, float* out, int B, int H, int v3, int ct,
                 int vec, cudaStream_t stream) {
  static size_t configured[kMaxDevices];
  const size_t bytes = fused_smem(H, BT, ct, v3);
  int err = allow_smem(gru_step_fused_k<BT, W>, bytes, configured);
  if (err) return err;
  const dim3 grid(v3 ? (H + ct - 1) / ct : 1, (B + BT - 1) / BT);
  gru_step_fused_k<BT, W><<<grid, kThreads, bytes, stream>>>(
      h, xp, static_cast<const W*>(u), b, out, B, H, v3, ct, vec);
  return (int)cudaGetLastError();
}

template <int BT, typename W>
int launch_blocked(const float* h, const float* xp, const void* u,
                   const float* b, float* zs, float* rhs, float* out, int B,
                   int H, int ct, int vec, cudaStream_t stream) {
  static size_t gates_configured[kMaxDevices];
  static size_t cand_configured[kMaxDevices];
  const size_t gbytes = gates_smem(H, BT, ct);
  const size_t cbytes = cand_smem(H, BT, ct);
  int err = allow_smem(gru_blocked_gates_k<BT, W>, gbytes, gates_configured);
  if (err) return err;
  err = allow_smem(gru_blocked_cand_k<BT, W>, cbytes, cand_configured);
  if (err) return err;
  const dim3 grid((H + ct - 1) / ct, (B + BT - 1) / BT);
  const W* uw = static_cast<const W*>(u);
  gru_blocked_gates_k<BT, W><<<grid, kThreads, gbytes, stream>>>(
      h, xp, uw, b, zs, rhs, B, H, ct, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  gru_blocked_cand_k<BT, W><<<grid, kThreads, cbytes, stream>>>(
      h, xp, uw, b, zs, rhs, out, B, H, ct, vec);
  return (int)cudaGetLastError();
}

// --- the warp route: one warp a batch row ----------------------------------

constexpr int kWarpMaxH = 32;           // one output column a lane
constexpr unsigned kFullWarp = 0xffffffffu;

// One weight of u as a float, by a plain coherent load (asm volatile, so
// ptxas keeps the burst where it is written; bf16 widened exactly).
__device__ __forceinline__ float ld_weight(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_weight(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float((unsigned)v << 16);
}

// How a pass over k sees lane k's value of the last put(): through the
// warp's 32 floats of shared memory, read as float4 broadcasts (__syncwarp()
// on both sides of the store, so no lane overwrites a value another still
// reads). 32 shuffles a pass were slower at every shape the sweep timed.
struct SlotBcast {
  float* slot;                          // 32 floats, 16-byte aligned
  int lane;
  __device__ __forceinline__ void put(float x) {
    __syncwarp();
    slot[lane] = x;
    __syncwarp();
  }
  __device__ __forceinline__ float at(int k) const {
    const float4 q = reinterpret_cast<const float4*>(slot)[k >> 2];
    return (k & 3) == 0 ? q.x : (k & 3) == 1 ? q.y : (k & 3) == 2 ? q.z : q.w;
  }
};

// One step of row `row` by one warp; lane c < H owns column c of z, r and
// h. HT: H at compile time (20, 32) or 0 (any H <= 32). A lane past H
// reads column 0's weights (unpredicated loads) and stores nothing; every
// lane weighs k >= H by an exact 0, and a lane past H puts h = 0, so the
// sums over all 32 k's equal the sums over k < H.
template <int V3, int HT, typename W>
__global__ void __launch_bounds__(kThreads)
gru_step_warp_k(const float* __restrict__ h, const float* __restrict__ xp,
                const W* __restrict__ u, const float* __restrict__ b,
                float* __restrict__ out, int B, int H) {
  if constexpr (HT) H = HT;
  __shared__ __align__(16) float sbc[kThreads];   // each warp's 32 slots
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B) return;                 // a warp past B
  const bool col = lane < H;
  const int c = col ? lane : 0;
  const int H3 = 3 * H;
  float x[3], bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    x[g] = col ? __ldg(xp + (size_t)row * H3 + g * H + c) : 0.0f;
    bias[g] = col ? __ldg(b + g * H + c) : 0.0f;
  }
  const float hv = col ? __ldg(h + (size_t)row * H + c) : 0.0f;
  float w[3][kWarpMaxH];                // lane c's columns of U
#pragma unroll
  for (int k = 0; k < kWarpMaxH; ++k)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      w[g][k] = k < H ? ld_weight(u + k * H3 + g * H + c) : 0.0f;
  __syncwarp();
  SlotBcast bc{sbc + (threadIdx.x & ~31), lane};

  float az = 0.0f, ar = 0.0f, ah = 0.0f;
  bc.put(round_to<W>(hv));
#pragma unroll
  for (int k = 0; k < kWarpMaxH; ++k) {
    const float hk = bc.at(k);
    az = fmaf(hk, w[0][k], az);
    ar = fmaf(hk, w[1][k], ar);
    if constexpr (V3) ah = fmaf(hk, w[2][k], ah);
  }
  const float z = sigmoid_f(x[0] + (az + bias[0]));
  const float r = sigmoid_f(x[1] + (ar + bias[1]));
  float ht;
  if constexpr (V3) {
    ht = tanhf(x[2] + r * (ah + bias[2]));
  } else {                              // the candidate's pass, on r*h
    bc.put(round_to<W>(r * hv));
#pragma unroll
    for (int k = 0; k < kWarpMaxH; ++k) ah = fmaf(bc.at(k), w[2][k], ah);
    ht = tanhf((x[2] + ah) + bias[2]);
  }
  if (col)
    out[(size_t)row * H + c] = __fmaf_rn(1.0f - z, hv, __fmul_rn(z, ht));
}

// --- the wide route: one step over the whole card --------------------------

constexpr int kWideMaxStages = 32;      // ring stages a block may hold
constexpr int kWideThreads = 256;       // a wide block (512 spilled at the
constexpr int kWideWarps = kWideThreads / 32;   // 128 registers they allow)

// cp.async of one group of kVec weights (16 bytes fp32, 8 bf16)
template <typename W>
__device__ __forceinline__ void cp_group(W* dst, const W* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(W) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most n of this thread's cp.async groups are pending (n is
// a run-time constant of the launch; wait_group takes an immediate).
template <int N = 0>
__device__ __forceinline__ void cp_wait_upto(int n) {
  if constexpr (N + 2 < kWideMaxStages) {
    if (n <= N) {
      asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
      return;
    }
    cp_wait_upto<N + 1>(n);
  } else {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
  }
}

// The wide route streams, for each batch tile, the z/r rows of the block's
// column slices, kc rows a chunk ([k][z cols | r cols], 2*CW weights a
// row), then for each tile the candidate's rows, 2*kc a chunk ([k][CW]):
// every chunk fills one ring stage of 2*kc*CW weights. A cursor walks that
// sequence without a division (integer work per chunk, not the copies,
// set the route's time in its first cut on an H100).
struct WideCursor {
  int phase;         // 1: z and r, 2: the candidate, 0: past the end
  int tile;          // batch tile
  int k0;            // first row of u
  __device__ __forceinline__ int span(int kc) const {
    return phase == 1 ? kc : 2 * kc;
  }
  __device__ __forceinline__ void next(int H, int kc, int nb) {
    k0 += span(kc);
    if (k0 < H) return;
    k0 = 0;
    if (++tile < nb) return;
    tile = 0;
    phase = phase == 1 ? 2 : 0;
  }
};

// Copy `rows` rows of G gates' CW columns from base (u's row k0 at the
// block's first column of the first gate) into a stage laid out [k][G*CW].
// vec: cp.async of kVec weights (16 bytes fp32, 8 bf16), H % 4 == 0 and u
// aligned to kVec elements; else element by element through registers (a
// bf16 element is 2 bytes, below cp.async's smallest copy). Columns past H
// are left as they are (no output reads them).
template <int G, int CW, typename W>
__device__ __forceinline__ void copy_rows(W* st, const W* __restrict__ base,
                                          int rows, size_t H3, int H, int j0,
                                          int vec) {
  constexpr int kRow = G * CW;
  if (vec) {
    constexpr int kGroups = kRow / kVec;
    for (int i = threadIdx.x; i < rows * kGroups; i += kWideThreads) {
      const int k = i / kGroups;
      const int c = (i - k * kGroups) * kVec;   // column within the row
      const int g = c / CW;
      const int jj = c - g * CW;
      if (j0 + jj < H)
        cp_group(st + k * kRow + c, base + k * H3 + g * (size_t)H + jj);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kRow; i += kWideThreads) {
      const int k = i / kRow;
      const int c = i - k * kRow;
      const int g = c / CW;
      const int jj = c - g * CW;
      if (j0 + jj < H) st[i] = base[k * H3 + g * (size_t)H + jj];
    }
  }
}

template <int CW, typename W>
__device__ __forceinline__ void start_chunk(W* st, const W* __restrict__ u,
                                            const WideCursor& c, int H,
                                            int kc, int j0, int vec) {
  const size_t H3 = 3 * (size_t)H;
  const int rows = min(c.span(kc), H - c.k0);
  const W* base = u + c.k0 * H3 + j0;
  if (c.phase == 1)
    copy_rows<2, CW>(st, base, rows, H3, H, j0, vec);
  else
    copy_rows<1, CW>(st, base + 2 * (size_t)H, rows, H3, H, j0, vec);
}

// The (H, BT) operand of a batch tile from h: rows [row0, row0 + nrow)
// rounded to W, zeros past nrow (a tile past the first, or h not 16-byte
// aligned).
template <int BT, typename W>
__device__ __forceinline__ void stage_operand(float* dst,
                                              const float* __restrict__ src,
                                              int H, int row0, int nrow) {
  const int total = BT * H;
  for (int i0 = threadIdx.x; i0 < total; i0 += kWideThreads * kLoadBatch) {
    float v[kLoadBatch];
#pragma unroll
    for (int q = 0; q < kLoadBatch; ++q) {
      const int i = i0 + q * kWideThreads;
      const int k = i / BT;
      const int r = i - k * BT;
      v[q] = i < total && r < nrow ? __ldg(src + (size_t)(row0 + r) * H + k)
                                   : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kLoadBatch; ++q) {
      const int i = i0 + q * kWideThreads;
      if (i < total) dst[i] = round_to<W>(v[q]);
    }
  }
}

// The operands of a pass, (H, BT) floats in shared memory (k major):
// h's rows of the tile for z and r, r*h's for the candidate. Phase 1
// writes r*h in that layout already, tile by tile ((nb, H, BT) scratch,
// rows past B never written and never stored from), so the candidate's
// operand is one contiguous block, read by 16-byte loads through L2 only
// (other blocks wrote it before the grid barrier). h is (B, H) row-major:
// each thread loads 16 bytes (4 k's of one row; the rows of a k group
// vary fastest across the lanes) into registers, and stores them
// transposed, rounded to W, once it has started the pass's first copies of
// U (where vec allows; else element by element, after them).
constexpr int kOperandRegs = 16;        // float4 a thread holds in flight

template <int BT>
__device__ __forceinline__ void load_h4(float4 (&v)[kOperandRegs],
                                        const float* __restrict__ h, int H,
                                        int row0, int nrow) {
  const int total = BT * (H / kVec);
#pragma unroll
  for (int m = 0; m < kOperandRegs; ++m) {
    const int i = threadIdx.x + m * kWideThreads;
    const int k4 = i / BT;
    const int r = i - k4 * BT;
    v[m] = i < total && r < nrow
               ? __ldg(reinterpret_cast<const float4*>(
                     h + (size_t)(row0 + r) * H) + k4)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <int BT, typename W>
__device__ __forceinline__ void store_h4(float* sop,
                                         const float4 (&v)[kOperandRegs],
                                         int H) {
  const int total = BT * (H / kVec);
#pragma unroll
  for (int m = 0; m < kOperandRegs; ++m) {
    const int i = threadIdx.x + m * kWideThreads;
    const int k4 = i / BT;
    const int r = i - k4 * BT;
    if (i < total) {
      float* d = sop + (size_t)kVec * k4 * BT + r;
      d[0] = round_to<W>(v[m].x);
      d[BT] = round_to<W>(v[m].y);
      d[2 * BT] = round_to<W>(v[m].z);
      d[3 * BT] = round_to<W>(v[m].w);
    }
  }
}

// The candidate's operand: tile `tile`'s contiguous (H, BT) block of the
// r*h scratch (vec: 16-byte loads, H * BT a multiple of 4).
template <int BT>
__device__ __forceinline__ void load_rh(float* sop,
                                        const float* __restrict__ rhs,
                                        int H, int tile, int vec) {
  const float* src = rhs + (size_t)tile * H * BT;
  if (vec) {
    const int n4 = H * BT / kVec;
    for (int i0 = threadIdx.x; i0 < n4; i0 += kWideThreads * kOperandRegs) {
      float4 v[kOperandRegs];
#pragma unroll
      for (int m = 0; m < kOperandRegs; ++m) {
        const int i = i0 + m * kWideThreads;
        if (i < n4) v[m] = __ldcg(reinterpret_cast<const float4*>(src) + i);
      }
#pragma unroll
      for (int m = 0; m < kOperandRegs; ++m) {
        const int i = i0 + m * kWideThreads;
        if (i < n4) reinterpret_cast<float4*>(sop)[i] = v[m];
      }
    }
  } else {
    for (int i = threadIdx.x; i < H * BT; i += kWideThreads)
      sop[i] = __ldcg(src + i);
  }
}

// Four neighbouring weights of a stage row (16 bytes fp32, 8 bf16).
__device__ __forceinline__ void lds4(const float* p, float (&v)[kVec]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

__device__ __forceinline__ void lds4(const __nv_bfloat16* p,
                                     float (&v)[kVec]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// A pass over Q columns (2*CW for z and r, CW for the candidate): thread t
// owns the kVec columns 4*(t % (Q/4)) .. +3 and the k-slice s = t / (Q/4);
// of each chunk it takes k = s, s + slices, ... below rows (slices = 2048
// / Q; every span is a multiple of it, so over the pass slice s sums the
// k = s mod slices in order) and adds x[k0 + k][r] * w[k][col] into
// acc[r][i] by fma.
template <int Q, int BT, typename W>
__device__ __forceinline__ void accumulate_chunk(float (&acc)[BT][kVec],
                                                 const W* st,
                                                 const float* sop, int k0,
                                                 int rows) {
  constexpr int kGroups = Q / kVec;
  constexpr int kSlices = kWideThreads / kGroups;
  const W* w = st + kVec * (threadIdx.x % kGroups);
  const float* x = sop + (size_t)k0 * BT;
#pragma unroll 4
  for (int k = threadIdx.x / kGroups; k < rows; k += kSlices) {
    float wv[kVec], xr[BT];
    lds4(w + k * Q, wv);
    load_rows<BT>(x + k * BT, xr);
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[r][i] = fmaf(xr[r], wv[i], acc[r][i]);
  }
}

// One round of the pass's butterfly over the lanes of a column group: the
// pair (lane, lane ^ OFF) adds the first N/2 of the N values (the lane
// without bit OFF keeps them) and the other N/2 (the lane with it), each
// lane sending the half it gives up; base tracks the first value index a
// lane keeps. Once N is 1 both lanes of a pair add (a plain butterfly),
// and only the lane without bit OFF writes. The sums are those of the
// plain butterfly of every value (the same pairs, commutative adds),
// with 28 shuffles a lane where it took 96 (8 rows, 4 column groups).
template <int OFF, int N, int NV>
__device__ __forceinline__ void scatter_rounds(float (&v)[NV], int lane,
                                               int& base, bool& writer) {
  if constexpr (OFF < 32) {
    const bool up = lane & OFF;
    if constexpr (N >= 2) {
      constexpr int H2 = N / 2;
#pragma unroll
      for (int j = 0; j < H2; ++j) {
        const float send = up ? v[j] : v[j + H2];
        const float keep = up ? v[j + H2] : v[j];
        v[j] = keep + __shfl_xor_sync(kFullWarp, send, OFF);
      }
      if (up) base += H2;
      scatter_rounds<OFF * 2, H2>(v, lane, base, writer);
    } else {
      v[0] += __shfl_xor_sync(kFullWarp, v[0], OFF);
      writer = writer && !up;
      scatter_rounds<OFF * 2, 1>(v, lane, base, writer);
    }
  }
}

// The pass's finished sums: the butterfly over the lanes of one column
// group (offsets Q/4, Q/2, ... 16), each warp's sums to red, one block
// barrier, then thread (r, q) (tid = r*Q + q < BT*Q) adds the warps' in
// order.
template <int Q, int BT>
__device__ __forceinline__ float pass_sum(float (&acc)[BT][kVec],
                                          float* red) {
  constexpr int kGroups = Q / kVec;
  constexpr int kN = BT * kVec;         // value e = r*kVec + i
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float v[kN];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[r * kVec + i] = acc[r][i];
  int base = 0;
  bool writer = true;
  scatter_rounds<kGroups, kN>(v, lane, base, writer);
  constexpr int kKept = kN * kGroups >= 32 ? kN * kGroups / 32 : 1;
  if (writer) {
    const int col = kVec * (lane % kGroups);
#pragma unroll
    for (int j = 0; j < kKept; ++j) {
      const int e = base + j;
      red[(warp * BT + e / kVec) * 32 + col + e % kVec] = v[j];
    }
  }
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < BT * Q) {
    const int r = threadIdx.x / Q;
    const int q = threadIdx.x - r * Q;
#pragma unroll
    for (int w = 0; w < kWideWarps; ++w) s += red[(w * BT + r) * 32 + q];
  }
  return s;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Dynamic shared memory of one wide block: the (H, bt) operand (rounded up
// to 16 bytes), the ring, and the warps' sums ((warps, bt, 32) floats).
__host__ __device__ inline size_t wide_smem(int H, int bt, int cw, int kc,
                                            int stages, int wbytes) {
  return 4 * (size_t)round4(H * bt) +
         (size_t)stages * 2 * kc * cw * wbytes +
         4 * (size_t)kWideWarps * bt * 32;
}

// Both phases, one grid barrier between them (a cooperative launch). blk:
// the blocked step's order of additions for z and r ((x + sum) + b; else
// x + (sum + b), the fused step's). CW columns a gate a block (4, 8 or
// 16); kc rows a z/r chunk, a multiple of 2 * kWideThreads / CW (every
// span a multiple of the passes' k-slices); `stages` in the ring
// (2..kWideMaxStages). Each thread finishes at most one output of a pass
// (BT * 2 * CW <= kWideThreads); its xp, b and h are loaded as the pass
// starts, off the pass's end.
template <int BT, int CW, typename W>
__global__ void __launch_bounds__(kWideThreads, 1)
gru_step_wide_k(const float* __restrict__ h, const float* __restrict__ xp,
                const W* __restrict__ u, const float* __restrict__ b,
                float* __restrict__ zs, float* __restrict__ rhs,
                float* __restrict__ out, int B, int H, int kc, int stages,
                int vec, int blk) {
  extern __shared__ float4 smem_wide[];
  float* sop = reinterpret_cast<float*>(smem_wide);          // (H, BT)
  W* ring = reinterpret_cast<W*>(sop + round4(H * BT));
  const int stage_w = 2 * kc * CW;                           // weights
  float* red = reinterpret_cast<float*>(ring + (size_t)stages * stage_w);

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * CW;
  const size_t H3 = 3 * (size_t)H;
  const int nb = (B + BT - 1) / BT;
  const WideCursor start = {1, 0, 0};
  WideCursor fill = start;                // the next chunk to copy
  int fill_stage = 0;
  // the first z/r pass's h, in flight while U's first copies start
  const bool h4 = vec && BT * (H / kVec) <= kOperandRegs * kWideThreads;
  float4 hreg[kOperandRegs];
  if (h4) load_h4<BT>(hreg, h, H, 0, min(BT, B));
  for (; fill_stage + 1 < stages; ++fill_stage) {   // the ring's first stages
    if (fill.phase) {
      start_chunk<CW>(ring + (size_t)fill_stage * stage_w, u, fill, H, kc,
                      j0, vec);
      fill.next(H, kc, nb);
    }
    cp_commit();
  }
  if (h4) store_h4<BT, W>(sop, hreg, H);

  float acc[BT][kVec];
  float xv = 0.0f, bv = 0.0f, hv = 0.0f, zv = 0.0f;   // this thread's output
  bool mine = false;
  size_t orow = 0;
  int oj = 0, og = 0;
  int stage = 0;
  for (WideCursor c = start; c.phase; c.next(H, kc, nb)) {
    if (c.k0 == 0) {                    // a new pass: its operand, its output
      const int row0 = c.tile * BT;
      const int nrow = min(BT, B - row0);
      __syncthreads();                  // the last pass's reads are done
      const int Q = c.phase == 1 ? 2 * CW : CW;
      const int r = tid / Q;
      og = (tid - r * Q) / CW;
      oj = j0 + tid - r * Q - og * CW;
      orow = row0 + r;
      mine = tid < BT * Q && r < nrow && oj < H;
      if (mine) {
        const int g = c.phase == 1 ? og : 2;
        xv = __ldg(xp + orow * H3 + g * (size_t)H + oj);
        bv = __ldg(b + g * H + oj);
        hv = __ldg(h + orow * H + oj);
        if (c.phase == 2) zv = __ldcg(zs + orow * H + oj);
      }
      if (c.phase == 2)
        load_rh<BT>(sop, rhs, H, c.tile, vec);
      else if (c.tile > 0 || !h4)
        stage_operand<BT, W>(sop, h, H, row0, nrow);
#pragma unroll
      for (int r2 = 0; r2 < BT; ++r2)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[r2][i] = 0.0f;
    }
    cp_wait_upto(stages - 2);           // this chunk has landed
    __syncthreads();
    const W* st = ring + (size_t)stage * stage_w;
    const int rows = min(c.span(kc), H - c.k0);
    if (c.phase == 1)
      accumulate_chunk<2 * CW, BT>(acc, st, sop, c.k0, rows);
    else
      accumulate_chunk<CW, BT>(acc, st, sop, c.k0, rows);
    if (fill.phase) {                   // refill the stage read one chunk ago
      start_chunk<CW>(ring + (size_t)fill_stage * stage_w, u, fill, H, kc,
                      j0, vec);
      fill.next(H, kc, nb);
    }
    cp_commit();
    fill_stage = fill_stage + 1 == stages ? 0 : fill_stage + 1;
    stage = stage + 1 == stages ? 0 : stage + 1;
    if (c.k0 + c.span(kc) < H) continue;

    // the pass's end
    if (c.phase == 1) {
      const float sum = pass_sum<2 * CW, BT>(acc, red);
      if (mine) {
        const float v = sigmoid_f(blk ? (xv + sum) + bv : xv + (sum + bv));
        if (og == 0)
          zs[orow * H + oj] = v;
        else                            // (nb, H, BT): tile c.tile, row r
          rhs[((size_t)c.tile * H + oj) * BT + orow - c.tile * BT] =
              round_to<W>(v * hv);
      }
      if (c.tile + 1 == nb)             // every block's z and r*h written
        cooperative_groups::this_grid().sync();
    } else {
      const float sum = pass_sum<CW, BT>(acc, red);
      if (mine)
        out[orow * H + oj] =
            __fmaf_rn(1.0f - zv, hv, __fmul_rn(zv, tanhf((xv + sum) + bv)));
    }
  }
}

template <int V3, int HT, typename W>
int launch_warp(const float* h, const float* xp, const void* u,
                const float* b, float* out, int B, int H, int warps,
                cudaStream_t stream) {
  const int grid = (B + warps - 1) / warps;
  gru_step_warp_k<V3, HT, W><<<grid, 32 * warps, 0, stream>>>(
      h, xp, static_cast<const W*>(u), b, out, B, H);
  return (int)cudaGetLastError();
}

// One cooperative launch: the grid must fit the card at one block an SM
// (the C entry returns cudaErrorCooperativeLaunchTooLarge where not).
template <int BT, int CW, typename W>
int launch_wide(const float* h, const float* xp, const void* u,
                const float* b, float* zs, float* rhs, float* out, int B,
                int H, int kc, int stages, int vec, int blk,
                cudaStream_t stream) {
  static size_t configured[kMaxDevices];
  const size_t bytes = wide_smem(H, BT, CW, kc, stages, sizeof(W));
  int err = allow_smem(gru_step_wide_k<BT, CW, W>, bytes, configured);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((H + CW - 1) / CW);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gru_step_wide_k<BT, CW, W>, h, xp,
                                 static_cast<const W*>(u), b, zs, rhs, out,
                                 B, H, kc, stages, vec, blk);
}

bool valid_wide(int cw, int kc, int stages) {
  return kc > 0 && kc % (2 * kWideThreads / cw) == 0 && stages >= 2 &&
         stages <= kWideMaxStages;
}

template <typename W>
struct WeightTag {
  using type = W;
};

}  // namespace

// C entry points, bound with ctypes. u is float32 (bf16 = 0) or bfloat16;
// bt in {1, 2, 4, 8} rows per block; ct columns per tile (valid_ct); vec:
// H % 4 == 0 and u aligned to four elements. Each launches on `stream` and
// returns cudaGetLastError() (0 = launched).

// Dynamic shared memory of one block: kind 0 fused v1, 1 fused v3, 2 the
// larger of the blocked step's two kernels.
extern "C" size_t gru_cell_smem_bytes(int kind, int H, int bt, int ct) {
  if (kind == 2) {
    const size_t g = gates_smem(H, bt, ct);
    const size_t c = cand_smem(H, bt, ct);
    return g > c ? g : c;
  }
  return fused_smem(H, bt, ct, kind == 1);
}

extern "C" int gru_step_fused_launch(const float* h, const float* xp,
                                     const void* u, const float* b,
                                     float* out, int B, int H, int v3,
                                     int bf16, int bt, int ct, int vec,
                                     void* stream) {
  if (!valid_ct(ct)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    return bf16 ? launch_fused<BT, __nv_bfloat16>(h, xp, u, b, out, B, H, v3,
                                                  ct, vec, s)
                : launch_fused<BT, float>(h, xp, u, b, out, B, H, v3, ct,
                                          vec, s);
  });
}

// Two kernels on `stream`: gates into zs and rhs ((B, H) float32 scratch),
// then the candidate and the update into out.
extern "C" int gru_step_blocked_launch(const float* h, const float* xp,
                                       const void* u, const float* b,
                                       float* zs, float* rhs, float* out,
                                       int B, int H, int bf16, int bt, int ct,
                                       int vec, void* stream) {
  if (!valid_ct(ct)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    return bf16 ? launch_blocked<BT, __nv_bfloat16>(h, xp, u, b, zs, rhs, out,
                                                    B, H, ct, vec, s)
                : launch_blocked<BT, float>(h, xp, u, b, zs, rhs, out, B, H,
                                            ct, vec, s);
  });
}

// The warp route: one warp a batch row, `warps` warps a block; H <= 32.
extern "C" int gru_step_warp_launch(const float* h, const float* xp,
                                    const void* u, const float* b,
                                    float* out, int B, int H, int v3,
                                    int bf16, int warps, void* stream) {
  if (H < 1 || H > kWarpMaxH || warps < 1 || warps > kWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto go = [&](auto v3c, auto wc) {
    constexpr int V3 = decltype(v3c)::value;
    using W = typename decltype(wc)::type;
    if (H == 32)
      return launch_warp<V3, 32, W>(h, xp, u, b, out, B, H, warps, s);
    if (H == 20)
      return launch_warp<V3, 20, W>(h, xp, u, b, out, B, H, warps, s);
    return launch_warp<V3, 0, W>(h, xp, u, b, out, B, H, warps, s);
  };
  const auto by_w = [&](auto v3c) {
    return bf16 ? go(v3c, WeightTag<__nv_bfloat16>())
                : go(v3c, WeightTag<float>());
  };
  return v3 ? by_w(std::integral_constant<int, 1>())
            : by_w(std::integral_constant<int, 0>());
}

// Dynamic shared memory of one block of the wide route.
extern "C" size_t gru_step_wide_smem_bytes(int H, int bt, int cw, int kc,
                                           int stages, int bf16) {
  return wide_smem(H, bt, cw, kc, stages, bf16 ? 2 : 4);
}

// The wide route (v1): ceil(H / cw) blocks of kWideThreads; zs (B, H) and
// rhs (ceil(B / bt) * bt, H) float32 scratch; blk: the blocked step's
// order of additions; one cooperative launch; vec: H % 4 == 0, u aligned to
// 4 elements and h to 16 bytes (16-byte copies of U and loads of h and
// r*h; else element by element).
extern "C" int gru_step_wide_launch(const float* h, const float* xp,
                                    const void* u, const float* b,
                                    float* zs, float* rhs, float* out, int B,
                                    int H, int bf16, int bt, int cw, int kc,
                                    int stages, int vec, int blk,
                                    void* stream) {
  if ((cw != 4 && cw != 8 && cw != 16) || !valid_wide(cw, kc, stages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto by_cw = [&](auto tile, auto cols) {
    constexpr int BT = decltype(tile)::value;
    constexpr int CW = decltype(cols)::value;
    return bf16 ? launch_wide<BT, CW, __nv_bfloat16>(h, xp, u, b, zs, rhs,
                                                     out, B, H, kc, stages,
                                                     vec, blk, s)
                : launch_wide<BT, CW, float>(h, xp, u, b, zs, rhs, out, B, H,
                                             kc, stages, vec, blk, s);
  };
  return by_tile(bt, [&](auto tile) {
    switch (cw) {
      case 4: return by_cw(tile, std::integral_constant<int, 4>());
      case 8: return by_cw(tile, std::integral_constant<int, 8>());
      case 16: return by_cw(tile, std::integral_constant<int, 16>());
      default: return (int)cudaErrorInvalidValue;
    }
  });
}
