// Int8 (q8) GRU recurrences for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the q8 datapath in
// src/repro/kernels/gru_sequence/kernel.py:
//   gru_stack_sequence_q8_k  <- gru_stack_sequence_q8_kernel  (masked prefill)
//   gru_stack_decode_q8_k (block route),
//   gru_stack_decode_q8_warp_k (warp route) <- gru_stack_decode_q8_kernel
//                                                  (one token)
//   gru_sequence_q8_k        <- gru_sequence_q8_kernel        (depth 1, masked)
// The two fused kernels' block routes run one shared routine,
// run_stack_q8(), which computes _gate_math_q8 for every layer, v1 (two phases) or v3, with the
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
// The decode has a second route, picked by shape (decode_q8_plan in
// kernels/gru_sequence/kernel.py): "warp" (H <= 32 and L <= 3, every
// served shape), gru_stack_decode_q8_warp_k: one warp a batch row, every
// layer's int8 rows in registers, the layers chained in the warp with no
// shared memory or barrier (see its note); "block", the kernel above,
// past that.
//
// Bound on an H100 (SXM): a few tens of KB of inputs (3.35 TB/s) and
// int8 MACs (1,979 TOP/s on the tensor cores) take tens of nanoseconds at
// the serving shapes; the kernels are bound by latency: the launch, the
// one-time weight copy and the __syncthreads() chain of each layer-step
// (the decode's warp route: the launch, the loads at entry and each
// layer's dependent gate math).
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

// --- the decode warp route ---------------------------------------------------

constexpr int kQ8DecodeMaxLayers = 3;  // layers a lane holds in registers

// One token through L <= LMAX layers on int8 rows, one warp a batch row
// (the source note's decode warp route): lane c < H owns column c of each
// gate and holds its three int8 rows of every U_l and of every deep W_l in
// registers as words (load_row_words; H = 32, L = 3: 72 + 48 words),
// loaded at entry with their scales, the biases, the layers' h[c] and its
// xp columns. Each layer is gru_step_q8_warp_k's step: q8(h) packed by
// shuffles, each gate sum __dp4a over the words, v1's q8(r * h) packed the
// same way. The next layer's input projection quantizes the new h the
// same way, in the warp, and scales each row's int32 sum by its eff, as
// run_stack_q8 does; no shared memory and no barrier. A warp past B exits
// whole. Every float32 op is gru_q8_math.cuh's, so the route equals the
// block route bit for bit.
template <bool V3, bool VEC, int LMAX>
__global__ void __launch_bounds__(kThreads)
gru_stack_decode_q8_warp_k(const float* __restrict__ h,
                           const float* __restrict__ xp,
                           const int8_t* __restrict__ uq,
                           const float* __restrict__ ueff,
                           const int8_t* __restrict__ wdq,
                           const float* __restrict__ wdeff,
                           const float* __restrict__ b,
                           float* __restrict__ out, int B, int H, int L) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B) return;
  const bool col = lane < H;
  const int c = col ? lane : 0;
  const int H3 = 3 * H;

  int uw[LMAX][3][kWarpWords];
  float ue[LMAX][3], ub[LMAX][3], hl[LMAX];
  constexpr int LW = LMAX > 1 ? LMAX - 1 : 1;
  int ww[LW][3][kWarpWords];
  float we[LW][3];
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    const bool in = col && l < L;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const size_t j = (size_t)l * H3 + g * H + c;     // row of (L*3H, H)
      load_row_words<VEC>(uw[l][g], uq + j * H, H, in);
      ue[l][g] = in ? __ldg(ueff + j) : 0.0f;
      ub[l][g] = in ? __ldg(b + j) : 0.0f;
    }
    hl[l] = in ? __ldg(h + ((size_t)l * B + row) * H + c) : 0.0f;
  }
#pragma unroll
  for (int l = 0; l + 1 < LMAX; ++l) {
    const bool in = col && l + 1 < L;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const size_t j = (size_t)l * H3 + g * H + c;
      load_row_words<VEC>(ww[l][g], wdq + j * H, H, in);
      we[l][g] = in ? __ldg(wdeff + j) : 0.0f;
    }
  }
  float x[3];
#pragma unroll
  for (int g = 0; g < 3; ++g)
    x[g] = col ? __ldg(xp + (size_t)row * H3 + g * H + c) : 0.0f;

#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (l >= L) break;
    const float hold = hl[l];
    int qh[kWarpWords];
    pack_words(qh, col ? q8_act(hold) : (int8_t)0, lane);
    const float z = sigmoid_f(__fadd_rn(
        x[0], dequant(dot_words(qh, uw[l][0]), ue[l][0], ub[l][0])));
    const float r = sigmoid_f(__fadd_rn(
        x[1], dequant(dot_words(qh, uw[l][1]), ue[l][1], ub[l][1])));
    float ht;
    if constexpr (V3) {
      const float gh = dequant(dot_words(qh, uw[l][2]), ue[l][2], ub[l][2]);
      ht = tanhf(__fadd_rn(x[2], __fmul_rn(r, gh)));
    } else {     // the candidate from q8(r * h), packed the same way
      int qr[kWarpWords];
      pack_words(qr, col ? q8_act(__fmul_rn(r, hold)) : (int8_t)0, lane);
      ht = tanhf(__fadd_rn(
          x[2], dequant(dot_words(qr, uw[l][2]), ue[l][2], ub[l][2])));
    }
    const float hn = update_q8(z, hold, ht);
    if (col) out[((size_t)l * B + row) * H + c] = hn;
    if (l + 1 < L) {         // the next layer's input projection, in-warp
      int qn[kWarpWords];
      pack_words(qn, col ? q8_act(hn) : (int8_t)0, lane);
#pragma unroll
      for (int g = 0; g < 3; ++g)
        x[g] = __fmul_rn((float)dot_words(qn, ww[l < LW ? l : 0][g]),
                         we[l < LW ? l : 0][g]);
    }
  }
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

// The warp route of the fused q8 decode: `warps` warps a block, one batch
// row each; `vec`: the int8 rows load as whole 4-byte words (H % 4 == 0,
// u_q and wd_q 4-byte aligned), else through the aligned words that cover
// them. H at most 32, L at most kQ8DecodeMaxLayers (one layer: its own
// instance, which holds no deep rows).
extern "C" int gru_stack_decode_q8_warp_launch(
    const float* h, const float* xp, const int8_t* uq, const float* ueff,
    const int8_t* wdq, const float* wdeff, const float* b, float* out, int B,
    int H, int L, int v3, int warps, int vec, void* stream) {
  if (H < 1 || H > kWarpMaxH || L < 1 || L > kQ8DecodeMaxLayers ||
      warps < 1 || warps > kThreads / 32 || (vec && H % 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + warps - 1) / warps);
  cudaStream_t st = (cudaStream_t)stream;
  const auto go = [&](auto kernel) {
    kernel<<<grid, 32 * warps, 0, st>>>(h, xp, uq, ueff, wdq, wdeff, b, out,
                                        B, H, L);
    return (int)cudaGetLastError();
  };
  const bool one = L == 1;
  if (v3 && vec)
    return one ? go(gru_stack_decode_q8_warp_k<true, true, 1>)
               : go(gru_stack_decode_q8_warp_k<true, true, kQ8DecodeMaxLayers>);
  if (v3)
    return one ? go(gru_stack_decode_q8_warp_k<true, false, 1>)
               : go(gru_stack_decode_q8_warp_k<true, false,
                                               kQ8DecodeMaxLayers>);
  if (vec)
    return one ? go(gru_stack_decode_q8_warp_k<false, true, 1>)
               : go(gru_stack_decode_q8_warp_k<false, true,
                                               kQ8DecodeMaxLayers>);
  return one ? go(gru_stack_decode_q8_warp_k<false, false, 1>)
             : go(gru_stack_decode_q8_warp_k<false, false,
                                             kQ8DecodeMaxLayers>);
}
