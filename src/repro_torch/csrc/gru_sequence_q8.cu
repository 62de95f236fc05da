// Int8 (q8) GRU recurrences for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the q8 datapath in
// src/repro/kernels/gru_sequence/kernel.py:
//   gru_stack_sequence_q8_k  <- gru_stack_sequence_q8_kernel  (masked prefill)
//   gru_stack_decode_q8_k    <- gru_stack_decode_q8_kernel    (one token)
//   gru_sequence_q8_k        <- gru_sequence_q8_kernel        (depth 1, masked)
// The two fused kernels run one shared routine, run_stack_q8(), which
// computes _gate_math_q8 for every layer, v1 (two phases) or v3, with the
// deep layers' input projection in int8 too. The depth-1 kernel is one
// layer of the per-layer chain (cuda_chain_q8 prefill): its own (3H, H)
// rows, no deep projection, its input projection float32 from outside.
// Every layer-step is cell_update_q8() of gru_q8_math.cuh, which holds the
// arithmetic and its rounding discipline for all the port's q8 kernels.
//
// Translation, as in gru_sequence.cu: the time and layer loops run inside
// one block; the grid is over independent batch tiles of `bt` rows. Each
// block copies the int8 U and deep W, eff and b into shared memory once
// (gru-jet-deep: 9,216 + 6,144 B of int8, 3 KB of scales and bias; one
// chain layer of H=32: 3,456 B of int8 rows). The per-layer h lives in
// shared memory; layer l+1 reads layer l's new (masked) h from there. The
// optional time-major mask is double-buffered by step parity.
//
// Bound on an H100 (SXM): a few tens of KB of inputs (3.35 TB/s) and
// int8 MACs (1,979 TOP/s on the tensor cores) take tens of nanoseconds at
// the serving shapes; the kernels are bound by latency: the launch, the
// one-time weight copy and the __syncthreads() chain of each layer-step.
// Tensor-core IMMA (mma.sync s8) and a shorter chain are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_q8_math.cuh"

namespace {

// The shared routine of the two fused kernels. Layouts (row-major):
//   h0     (L, B, H) f32        initial per-layer states
//   xp     (T, B, 3H) f32       layer-0 input projection, time-major
//   uq     (L, 3H, H) int8      recurrent weight rows, gates [z | r | h]
//   ueff   (L, 3H) f32          their dequant scales
//   wdq    (L-1, 3H, H) int8    input-projection rows of layers 1..L-1
//   wdeff  (L-1, 3H) f32        (L = 1: placeholders, never read)
//   b      (L, 3H) f32
//   mask   (T, B) f32 or null   nonzero = live step
//   out_seq (T, B, H) or null   last layer's state after every step
//   finals  (L, B, H) or null   every layer's state after step T-1
__device__ void run_stack_q8(const float* h0, const float* xp,
                             const int8_t* uq, const float* ueff,
                             const int8_t* wdq, const float* wdeff,
                             const float* b, const float* mask,
                             float* out_seq, float* finals, int T, int B,
                             int H, int L, int v3, int bt) {
  extern __shared__ int smem_q8[];
  const int H3 = 3 * H;
  const int nw = words(H);
  const int ld = weight_ld(H);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* squ = smem_q8;                                  // (L, 3H, ld) int8
  int* swd = squ + L * H3 * ld;                        // (L-1, 3H, ld) int8
  float* seff = reinterpret_cast<float*>(swd + (L - 1) * H3 * ld);  // (L,3H)
  float* swde = seff + L * H3;                         // (L-1, 3H)
  float* sb = swde + (L - 1) * H3;                     // (L, 3H)
  float* sh = sb + L * H3;                             // (L, bt, H) state
  float* sz = sh + L * bt * H;                         // (bt, H) v1 z gate
  float* sx = sz + bt * H;                             // (bt, 3H) deep Wx
  int* sqh = reinterpret_cast<int*>(sx + bt * H3);     // (bt, nw) q8(h)
  int* sqr = sqh + bt * nw;                            // (bt, nw) q8(r*h)
  float* sm2 = reinterpret_cast<float*>(sqr + bt * nw);  // (2, bt) liveness

  const int row0 = blockIdx.x * bt;
  const int nrow = min(bt, B - row0);

  load_rows(uq, L * H3, H, squ, ld);
  load_rows(wdq, (L - 1) * H3, H, swd, ld);
  for (int i = tid; i < L * H3; i += nt) seff[i] = ueff[i];
  for (int i = tid; i < (L - 1) * H3; i += nt) swde[i] = wdeff[i];
  for (int i = tid; i < L * H3; i += nt) sb[i] = b[i];
  for (int i = tid; i < L * bt * H; i += nt) {
    const int l = i / (bt * H);
    const int rc = i - l * bt * H;
    const int r = rc / H;
    const int c = rc - r * H;
    sh[i] = r < nrow ? h0[((size_t)l * B + row0 + r) * H + c] : 0.0f;
  }
  // the pad bytes of each quantized row stay 0 for the whole launch
  for (int i = tid; i < 2 * bt * nw; i += nt) sqh[i] = 0;

  for (int t = 0; t < T; ++t) {
    // double-buffered: step t+1 writes the other half while step t's last
    // epilogue may still read this one
    float* sm = sm2 + (t & 1) * bt;
    if (tid < bt) {               // bt <= kThreads (the wrapper checks)
      sm[tid] = tid >= nrow ? 0.0f
                : mask == nullptr ? 1.0f
                : mask[(size_t)t * B + row0 + tid];
    }
    const float* xp_t = xp + ((size_t)t * B + row0) * H3;
    for (int l = 0; l < L; ++l) {
      float* hl = sh + l * bt * H;
      const int* ul = squ + l * H3 * ld;
      const float* el = seff + l * H3;
      const float* bl = sb + l * H3;
      const float* xin = l == 0 ? xp_t : sx;    // row stride 3H either way
      __syncthreads();  // weights, h, sm and sx in place; sqh free
      cell_update_q8(hl, xin, ul, el, bl, sm, sqh, sqr, sz, nullptr, bt,
                     nrow, H, v3);
      if (l + 1 < L) {
        // next layer's input projection, same step: q8(h_l) against the
        // int8 rows of W_{l+1}, scaled (no bias: b enters at the gates)
        __syncthreads();
        quantize_rows(hl, bt, H, sqh, nw);
        __syncthreads();
        const int* wl = swd + l * H3 * ld;
        const float* wel = swde + l * H3;
        for (int i = tid; i < bt * H3; i += nt) {
          const int r = i / H3;
          const int j = i - r * H3;
          if (r >= nrow) continue;
          sx[i] = __fmul_rn((float)dot_q8(sqh + r * nw, wl + j * ld, nw),
                            wel[j]);
        }
      }
    }
    if (out_seq != nullptr) {
      __syncthreads();
      const float* hL = sh + (L - 1) * bt * H;
      for (int i = tid; i < nrow * H; i += nt) {
        const int r = i / H;
        const int c = i - r * H;
        out_seq[((size_t)t * B + row0 + r) * H + c] = hL[i];
      }
    }
  }
  if (finals != nullptr) {
    __syncthreads();
    for (int i = tid; i < L * bt * H; i += nt) {
      const int l = i / (bt * H);
      const int rc = i - l * bt * H;
      const int r = rc / H;
      const int c = rc - r * H;
      if (r < nrow) finals[((size_t)l * B + row0 + r) * H + c] = sh[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gru_stack_sequence_q8_k(const float* h0, const float* xp, const int8_t* uq,
                        const float* ueff, const int8_t* wdq,
                        const float* wdeff, const float* b, const float* mask,
                        float* out, float* finals, int T, int B, int H, int L,
                        int v3, int bt) {
  run_stack_q8(h0, xp, uq, ueff, wdq, wdeff, b, mask, out, finals, T, B, H,
               L, v3, bt);
}

__global__ void __launch_bounds__(kThreads)
gru_stack_decode_q8_k(const float* h, const float* xp, const int8_t* uq,
                      const float* ueff, const int8_t* wdq,
                      const float* wdeff, const float* b, float* out, int B,
                      int H, int L, int v3, int bt) {
  run_stack_q8(h, xp, uq, ueff, wdq, wdeff, b, nullptr, nullptr, out, 1, B,
               H, L, v3, bt);
}

size_t smem_bytes_q8(int L, int H, int bt) {
  const size_t H3 = 3 * (size_t)H;
  const size_t nw = (H + 3) / 4;
  const size_t ld = weight_ld(H);
  const size_t w = (2 * (size_t)L - 1) * H3 * ld + (3 * (size_t)L - 1) * H3 +
                   (size_t)L * bt * H + (size_t)bt * H + (size_t)bt * H3 +
                   2 * (size_t)bt * nw + 2 * (size_t)bt;
  return 4 * w;
}

// Depth-1 q8 sequence: one layer of the chain over T steps. Layouts
// (row-major):
//   h0    (B, H) f32          initial state
//   xp    (T, B, 3H) f32      this layer's input projection, time-major
//   uq    (3H, H) int8        recurrent weight rows, gates [z | r | h]
//   ueff  (3H) f32            their dequant scales
//   b     (3H) f32
//   mask  (T, B) f32 or null  nonzero = live step
//   out   (T, B, H)           the state after every step
// Each new state goes to `out` from the update itself, so a step costs
// the update's barriers and no separate output pass.
__global__ void __launch_bounds__(kThreads)
gru_sequence_q8_k(const float* h0, const float* xp, const int8_t* uq,
                  const float* ueff, const float* b, const float* mask,
                  float* out, int T, int B, int H, int v3, int bt) {
  extern __shared__ int smem_seq_q8[];
  const int H3 = 3 * H;
  const int nw = words(H);
  const int ld = weight_ld(H);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* su = smem_seq_q8;                               // (3H, ld) int8
  float* seff = reinterpret_cast<float*>(su + H3 * ld);  // (3H)
  float* sb = seff + H3;                               // (3H)
  float* sh = sb + H3;                                 // (bt, H) state
  float* sz = sh + bt * H;                             // (bt, H) v1 z gate
  int* sqh = reinterpret_cast<int*>(sz + bt * H);      // (bt, nw) q8(h)
  int* sqr = sqh + bt * nw;                            // (bt, nw) q8(r*h)
  float* sm2 = reinterpret_cast<float*>(sqr + bt * nw);  // (2, bt) liveness

  const int row0 = blockIdx.x * bt;
  const int nrow = min(bt, B - row0);

  load_rows(uq, H3, H, su, ld);
  for (int i = tid; i < H3; i += nt) seff[i] = ueff[i];
  for (int i = tid; i < H3; i += nt) sb[i] = b[i];
  for (int i = tid; i < bt * H; i += nt) {
    const int r = i / H;
    sh[i] = r < nrow ? h0[(size_t)row0 * H + i] : 0.0f;
  }
  // the pad bytes of each quantized row stay 0 for the whole launch
  for (int i = tid; i < 2 * bt * nw; i += nt) sqh[i] = 0;

  for (int t = 0; t < T; ++t) {
    // double-buffered: step t+1 writes the other half while step t's
    // update may still read this one
    float* sm = sm2 + (t & 1) * bt;
    if (tid < bt) {               // bt <= kThreads (the wrapper checks)
      sm[tid] = tid >= nrow ? 0.0f
                : mask == nullptr ? 1.0f
                : mask[(size_t)t * B + row0 + tid];
    }
    const size_t tile = (size_t)t * B + row0;
    __syncthreads();  // weights, h and sm in place; sqh free
    cell_update_q8(sh, xp + tile * H3, su, seff, sb, sm, sqh, sqr, sz,
                   out + tile * H, bt, nrow, H, v3);
  }
}

size_t smem_bytes_seq_q8(int H, int bt) {
  const size_t H3 = 3 * (size_t)H;
  const size_t nw = words(H);
  const size_t w = H3 * weight_ld(H) + 2 * H3 + 2 * (size_t)bt * H +
                   2 * (size_t)bt * nw + 2 * (size_t)bt;
  return 4 * w;
}

size_t stack_smem[kMaxDevices];
size_t decode_smem[kMaxDevices];
size_t seq_smem[kMaxDevices];

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int gru_stack_sequence_q8_launch(
    const float* h0, const float* xp, const int8_t* uq, const float* ueff,
    const int8_t* wdq, const float* wdeff, const float* b, const float* mask,
    float* out, float* finals, int T, int B, int H, int L, int v3, int bt,
    void* stream) {
  const size_t bytes = smem_bytes_q8(L, H, bt);
  int err = allow_smem(gru_stack_sequence_q8_k, bytes, stack_smem);
  if (err) return err;
  gru_stack_sequence_q8_k<<<(B + bt - 1) / bt, kThreads, bytes,
                            (cudaStream_t)stream>>>(
      h0, xp, uq, ueff, wdq, wdeff, b, mask, out, finals, T, B, H, L, v3, bt);
  return (int)cudaGetLastError();
}

extern "C" int gru_stack_decode_q8_launch(
    const float* h, const float* xp, const int8_t* uq, const float* ueff,
    const int8_t* wdq, const float* wdeff, const float* b, float* out, int B,
    int H, int L, int v3, int bt, void* stream) {
  const size_t bytes = smem_bytes_q8(L, H, bt);
  int err = allow_smem(gru_stack_decode_q8_k, bytes, decode_smem);
  if (err) return err;
  gru_stack_decode_q8_k<<<(B + bt - 1) / bt, kThreads, bytes,
                          (cudaStream_t)stream>>>(
      h, xp, uq, ueff, wdq, wdeff, b, out, B, H, L, v3, bt);
  return (int)cudaGetLastError();
}

extern "C" int gru_sequence_q8_launch(const float* h0, const float* xp,
                                      const int8_t* uq, const float* ueff,
                                      const float* b, const float* mask,
                                      float* out, int T, int B, int H, int v3,
                                      int bt, void* stream) {
  const size_t bytes = smem_bytes_seq_q8(H, bt);
  int err = allow_smem(gru_sequence_q8_k, bytes, seq_smem);
  if (err) return err;
  gru_sequence_q8_k<<<(B + bt - 1) / bt, kThreads, bytes,
                      (cudaStream_t)stream>>>(h0, xp, uq, ueff, b, mask, out,
                                              T, B, H, v3, bt);
  return (int)cudaGetLastError();
}
