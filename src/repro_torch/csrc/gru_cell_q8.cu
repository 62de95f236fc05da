// One int8 (q8) GRU step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gru_step_q8 of
// src/repro/kernels/gru_cell/kernel.py (_q8_step_kernel): one cell update
// of B rows, U resident as (3H, H) int8 rows with per-row dequant scales,
// v1 (z and r, then the candidate from q8(r * h), JAX's op order) or v3.
// It is the decode step of every layer of the per-layer q8 chain
// (cuda_chain_q8): the input projection x_proj = cur @ W_l stays float32
// outside the kernel. The arithmetic, and its rounding discipline, is
// cell_update_q8() of gru_q8_math.cuh, shared with the sequence kernels.
//
// Translation. The TPU kernel is one grid step over the whole (B, H)
// state. Here two routes, picked by shape in Python (step_q8_plan in
// kernels/gru_cell/kernel.py):
// - "warp" (H <= 32, every served width): one warp a batch row; lane c
//   owns column c of z, r and h. Its three int8 rows of U stay in
//   registers (8 words each at H = 32), loaded at entry with its scales,
//   biases, xp and h[c]. Lane c quantizes h[c]; the packed words of q8(h)
//   are built by shuffles (an OR over each group of 4 lanes, then one
//   broadcast per word), in load_rows's layout, and each gate sum is 8
//   __dp4a. v1 packs q8(r * h) the same way for the candidate. No shared
//   memory and no barrier; a warp past B exits whole.
// - "block" (wider H): the grid runs over independent batch tiles of
//   `bt` rows; each block copies the layer's int8 rows (padded to odd
//   word strides), scales and bias into shared memory and updates its
//   rows (cell_update_q8), writing each new state straight to the output.
// The int32 sums are exact in any order and both routes take every
// float32 op from gru_q8_math.cuh, so they agree bit for bit.
//
// Bound on an H100 (SXM): at the serving shapes (H = 20 or 32, 8 rows)
// a few KB of inputs over 3.35 TB/s and a few thousand int8 MACs over
// 1,979 TOP/s take a few nanoseconds; the kernel is bound by latency:
// the launch, the loads and the dependent chain of the gate math (on the
// block route also the copy of the rows into shared memory and the
// barriers of the update: two for v3, three for v1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_q8_math.cuh"

namespace {

// Layouts (row-major):
//   h     (B, H) f32        current state
//   xp    (B, 3H) f32       input projection of this step
//   uq    (3H, H) int8      recurrent weight rows, gates [z | r | h]
//   ueff  (3H) f32          their dequant scales
//   b     (3H) f32
//   out   (B, H) f32        new state
__global__ void __launch_bounds__(kThreads)
gru_step_q8_k(const float* h, const float* xp, const int8_t* uq,
              const float* ueff, const float* b, float* out, int B, int H,
              int v3, int bt) {
  extern __shared__ int smem_step_q8[];
  const int H3 = 3 * H;
  const int nw = words(H);
  const int ld = weight_ld(H);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* su = smem_step_q8;                              // (3H, ld) int8
  float* seff = reinterpret_cast<float*>(su + H3 * ld);  // (3H)
  float* sb = seff + H3;                               // (3H)
  float* sh = sb + H3;                                 // (bt, H) state
  float* sz = sh + bt * H;                             // (bt, H) v1 z gate
  int* sqh = reinterpret_cast<int*>(sz + bt * H);      // (bt, nw) q8(h)
  int* sqr = sqh + bt * nw;                            // (bt, nw) q8(r*h)
  float* slive = reinterpret_cast<float*>(sqr + bt * nw);  // (bt) all 1

  const int row0 = blockIdx.x * bt;
  const int nrow = min(bt, B - row0);

  load_rows(uq, H3, H, su, ld);
  for (int i = tid; i < H3; i += nt) seff[i] = ueff[i];
  for (int i = tid; i < H3; i += nt) sb[i] = b[i];
  for (int i = tid; i < bt * H; i += nt) {
    const int r = i / H;
    sh[i] = r < nrow ? h[(size_t)row0 * H + i] : 0.0f;
  }
  // the pad bytes of each quantized row stay 0
  for (int i = tid; i < 2 * bt * nw; i += nt) sqh[i] = 0;
  if (tid < bt) slive[tid] = 1.0f;      // bt <= kThreads (the wrapper checks)
  __syncthreads();
  cell_update_q8(sh, xp + (size_t)row0 * H3, su, seff, sb, slive, sqh, sqr,
                 sz, out + (size_t)row0 * H, bt, nrow, H, v3);
}

size_t smem_bytes_step_q8(int H, int bt) {
  const size_t H3 = 3 * (size_t)H;
  const size_t nw = words(H);
  const size_t w = H3 * weight_ld(H) + 2 * H3 + 2 * (size_t)bt * H +
                   2 * (size_t)bt * nw + (size_t)bt;
  return 4 * w;
}

size_t step_smem[kMaxDevices];

// --- the warp route (its helpers are gru_q8_math.cuh's) -----------------------

// One q8 step, one warp a batch row (the source note's warp route), lane c
// < H owning column c; the step is warp_step_q8, whose float32 math is
// cell_update_q8's, op for op.
template <bool V3, bool VEC>
__global__ void __launch_bounds__(kThreads)
gru_step_q8_warp_k(const float* __restrict__ h, const float* __restrict__ xp,
                   const int8_t* __restrict__ uq,
                   const float* __restrict__ ueff,
                   const float* __restrict__ b, float* __restrict__ out,
                   int B, int H) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B) return;
  const bool col = lane < H;
  const int c = col ? lane : 0;

  int u[3][kWarpWords];
  float eff[3], bias[3], x[3];
  const float* xr = xp + (size_t)row * 3 * H + c;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    load_row_words<VEC>(u[g], uq + (size_t)(g * H + c) * H, H, col);
    eff[g] = col ? __ldg(ueff + g * H + c) : 0.0f;
    bias[g] = col ? __ldg(b + g * H + c) : 0.0f;
    x[g] = col ? __ldg(xr + g * H) : 0.0f;
  }
  const float hold = col ? __ldg(h + (size_t)row * H + c) : 0.0f;

  int qh[kWarpWords];
  pack_words(qh, col ? q8_act(hold) : (int8_t)0, lane);
  const float hn = warp_step_q8<V3>(qh, u, x, eff, bias, hold, col, lane);
  if (col) out[(size_t)row * H + c] = hn;
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched). The block route, `bt` rows a block:
extern "C" int gru_step_q8_launch(const float* h, const float* xp,
                                  const int8_t* uq, const float* ueff,
                                  const float* b, float* out, int B, int H,
                                  int v3, int bt, void* stream) {
  const size_t bytes = smem_bytes_step_q8(H, bt);
  int err = allow_smem(gru_step_q8_k, bytes, step_smem);
  if (err) return err;
  gru_step_q8_k<<<(B + bt - 1) / bt, kThreads, bytes, (cudaStream_t)stream>>>(
      h, xp, uq, ueff, b, out, B, H, v3, bt);
  return (int)cudaGetLastError();
}

// The warp route (H <= 32): `warps` warps a block, one batch row each;
// `vec`: U's rows load as whole 4-byte words (H % 4 == 0, u_q 4-byte
// aligned), else through the aligned words that cover them.
extern "C" int gru_step_q8_warp_launch(const float* h, const float* xp,
                                       const int8_t* uq, const float* ueff,
                                       const float* b, float* out, int B,
                                       int H, int v3, int warps, int vec,
                                       void* stream) {
  if (H < 1 || H > kWarpMaxH || warps < 1 || warps > kThreads / 32 ||
      (vec && H % 4))
    return (int)cudaErrorInvalidValue;
  const int grid = (B + warps - 1) / warps;
  cudaStream_t st = (cudaStream_t)stream;
  if (v3 && vec)
    gru_step_q8_warp_k<true, true><<<grid, 32 * warps, 0, st>>>(
        h, xp, uq, ueff, b, out, B, H);
  else if (v3)
    gru_step_q8_warp_k<true, false><<<grid, 32 * warps, 0, st>>>(
        h, xp, uq, ueff, b, out, B, H);
  else if (vec)
    gru_step_q8_warp_k<false, true><<<grid, 32 * warps, 0, st>>>(
        h, xp, uq, ueff, b, out, B, H);
  else
    gru_step_q8_warp_k<false, false><<<grid, 32 * warps, 0, st>>>(
        h, xp, uq, ueff, b, out, B, H);
  return (int)cudaGetLastError();
}
