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
// state. Here the grid runs over independent batch tiles of `bt` rows;
// each block copies the layer's int8 rows (padded to odd word strides),
// scales and bias into shared memory and updates its rows, writing each
// new state straight to the output.
//
// Bound on an H100 (SXM): at the serving shapes (H = 20 or 32, 8 rows)
// a few KB of inputs over 3.35 TB/s and a few thousand int8 MACs over
// 1,979 TOP/s take a few nanoseconds; the kernel is bound by latency:
// the launch, the one-time copy of the rows into shared memory and the
// barriers of the update (two for v3, three for v1).

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

}  // namespace

// C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
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
