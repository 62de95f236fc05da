// The int8 (q8) GRU arithmetic shared by the port's q8 kernels
// (gru_sequence_q8.cu: fused stack and depth-1 sequence; gru_cell_q8.cu:
// one step), and the warp routes' row loads, packing and sums, so that all
// of them round in one way: the JAX kernels'
// _gate_math_q8 (src/repro/kernels/gru_sequence/kernel.py) and
// _q8_step_kernel (src/repro/kernels/gru_cell/kernel.py).
//
// The arithmetic. Weights are int8 ROWS, (3H, H) per layer: one
// contiguous row per output element, with a per-row dequant scale eff
// (activation scale folded in). Activations use the fixed scale 127:
// q = clip(rint(a * 127), -127, 127), rounding half to even as
// jnp.round/torch.round do (rintf, not roundf), clipped after rounding.
// Dot products accumulate in int32 with __dp4a, exact in any order.
// Dequant is acc * eff + b. The state h stays float32.
//
// Rounding. One float32 ulp in h can move rint(h * 127) across a half and
// change a gate pre-activation by max|row| / 127, so every float32
// expression that feeds a quantization or the state is written with
// __fmul_rn / __fadd_rn / __fsub_rn: nvcc never contracts those into an
// fma, and each op rounds on its own as in the JAX kernels and the plain
// PyTorch version (acc * eff + b; r * h before * 127; (1 - z) * h + z * ht;
// v3's x + r * ua). expf/tanhf without fast math.
//
// Layout. Resident rows are padded to a whole number of 4-byte words for
// __dp4a, and the row stride in words is made odd so the 32 threads of a
// warp, each on its own row, read 32 different banks. Quantized
// activation rows are packed four to a word; their pad bytes stay 0.
//
// Each including .cu file is its own library, so everything here has
// internal linkage (an unnamed namespace).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Fixed-scale activation quantization (_q8_act): f32 in [-1, 1] -> int8.
__device__ __forceinline__ int8_t q8_act(float a) {
  const float v = rintf(__fmul_rn(a, 127.0f));
  return (int8_t)(int)fminf(fmaxf(v, -127.0f), 127.0f);
}

// acc * eff + b, each op rounded on its own
__device__ __forceinline__ float dequant(int acc, float eff, float b) {
  return __fadd_rn(__fmul_rn((float)acc, eff), b);
}

// The state update (1 - z) * h + z * ht, each op rounded on its own.
__device__ __forceinline__ float update_q8(float z, float h, float ht) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), h), __fmul_rn(z, ht));
}

// int32 dot product of two int8 rows packed four to a word. Unrolled by 4
// (H = 32: 8 words); left to the compiler the fused q8 kernels ran slower
// (PERF.md, the chains' findings), and unrolled by 8 the stack prefill
// spills registers.
__device__ __forceinline__ int dot_q8(const int* a, const int* w, int nw) {
  int acc = 0;
#pragma unroll 4
  for (int k = 0; k < nw; ++k) acc = __dp4a(a[k], w[k], acc);
  return acc;
}

__device__ __host__ __forceinline__ int words(int H) { return (H + 3) / 4; }

// Row stride of the resident weights in words: odd, so rows j..j+31 start
// in 32 different banks.
__device__ __host__ __forceinline__ int weight_ld(int H) {
  return ((H + 3) / 4) | 1;
}

// Copy int8 rows (n, H) from device memory into shared rows of `ld` words,
// zero-padded. One word per thread and iteration, its four bytes loaded
// independently (rows of H bytes need not be word-aligned), and unrolled,
// so the loads of several iterations are in flight together: a loop of
// one dependent byte load per iteration waited a device-memory latency
// per iteration (10 us of a 24 us gru-jet-deep decode).
__device__ void load_rows(const int8_t* src, int n, int H, int* dst, int ld) {
#pragma unroll 4
  for (int i = threadIdx.x; i < n * ld; i += blockDim.x) {
    const int row = i / ld;
    const int k = 4 * (i - row * ld);
    const uint8_t* s = reinterpret_cast<const uint8_t*>(src) + (size_t)row * H;
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j) {
      if (k + j < H) w |= (uint32_t)s[k + j] << (8 * j);
    }
    dst[i] = (int)w;
  }
}

// Quantize h (bt, H) f32 into packed int8 rows of `nw` words.
__device__ void quantize_rows(const float* h, int bt, int H, int* q, int nw) {
  int8_t* d = reinterpret_cast<int8_t*>(q);
  for (int i = threadIdx.x; i < bt * H; i += blockDim.x) {
    const int r = i / H;
    const int c = i - r * H;
    d[r * 4 * nw + c] = q8_act(h[i]);
  }
}

// One q8 cell update of a tile of `bt` rows (the first `nrow` real), v1
// (two phases: z and r, then the candidate from q8(r * h)) or v3 (one
// pass), in place:
//   h     (bt, H) f32 state in shared memory; a row that is not live keeps
//         its pre-step value (selected, not recomputed)
//   x     the tile's input projection, row stride 3H (shared or device)
//   u     (3H, ld) resident int8 rows, gates [z | r | h]; eff, b (3H)
//   live  (bt) nonzero = live row; never null (a test for null here
//         slowed the fused stack prefill; PERF.md)
//   qh, qr (bt, nw) packed q8(h) and q8(r * h), pad bytes 0
//   z     (bt, H) v1's z gate
//   out   null, or the tile's first output row (row stride H): each new
//         state is also written there
// The caller synchronizes before the call (h, x, live in place, qh free);
// the call ends without a barrier. Forced inline, so a constant null
// `out` costs nothing.
__device__ __forceinline__ void cell_update_q8(
    float* h, const float* x, const int* u, const float* eff, const float* b,
    const float* live, int* qh, int* qr, float* z, float* out, int bt,
    int nrow, int H, int v3) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nw = words(H);
  const int ld = weight_ld(H);
  const int H3 = 3 * H;
  quantize_rows(h, bt, H, qh, nw);
  __syncthreads();
  if (v3) {
    for (int i = tid; i < bt * H; i += nt) {
      const int r = i / H;
      const int c = i - r * H;
      if (r >= nrow) continue;
      const int* a = qh + r * nw;
      const float* xr = x + r * H3;
      const float gz = dequant(dot_q8(a, u + c * ld, nw), eff[c], b[c]);
      const float gr = dequant(dot_q8(a, u + (H + c) * ld, nw), eff[H + c],
                               b[H + c]);
      const float gh = dequant(dot_q8(a, u + (2 * H + c) * ld, nw),
                               eff[2 * H + c], b[2 * H + c]);
      const float zz = sigmoid_f(__fadd_rn(xr[c], gz));
      const float rr = sigmoid_f(__fadd_rn(xr[H + c], gr));
      const float ht = tanhf(__fadd_rn(xr[2 * H + c], __fmul_rn(rr, gh)));
      const float hold = h[i];
      const float hn = update_q8(zz, hold, ht);
      const float v = live[r] != 0.0f ? hn : hold;
      h[i] = v;
      if (out != nullptr) out[i] = v;
    }
    return;
  }
  // phase 1: z and r, and r*h quantized for the candidate
  for (int i = tid; i < bt * H; i += nt) {
    const int r = i / H;
    const int c = i - r * H;
    if (r >= nrow) continue;
    const int* a = qh + r * nw;
    const float* xr = x + r * H3;
    const float gz = dequant(dot_q8(a, u + c * ld, nw), eff[c], b[c]);
    const float gr = dequant(dot_q8(a, u + (H + c) * ld, nw), eff[H + c],
                             b[H + c]);
    z[i] = sigmoid_f(__fadd_rn(xr[c], gz));
    const float rr = sigmoid_f(__fadd_rn(xr[H + c], gr));
    reinterpret_cast<int8_t*>(qr + r * nw)[c] = q8_act(__fmul_rn(rr, h[i]));
  }
  __syncthreads();
  // phase 2: candidate from q8(r*h), then the update
  for (int i = tid; i < bt * H; i += nt) {
    const int r = i / H;
    const int c = i - r * H;
    if (r >= nrow) continue;
    const float* xr = x + r * H3;
    const float cand = dequant(dot_q8(qr + r * nw, u + (2 * H + c) * ld, nw),
                               eff[2 * H + c], b[2 * H + c]);
    const float ht = tanhf(__fadd_rn(xr[2 * H + c], cand));
    const float zz = z[i];
    const float hold = h[i];
    const float hn = update_q8(zz, hold, ht);
    const float v = live[r] != 0.0f ? hn : hold;
    h[i] = v;
    if (out != nullptr) out[i] = v;
  }
}

// --- the warp routes (gru_cell_q8.cu's step, gru_sequence_q8.cu's decode
// and prefills) ---
//
// One warp a batch row, lane c owning column c of each gate; U's rows in
// registers as words, q8 activations packed by shuffles, __dp4a sums.

constexpr int kWarpMaxH = 32;                // one output column a lane
constexpr int kWarpWords = kWarpMaxH / 4;    // int8 words of a row
constexpr unsigned kFullWarp = 0xffffffffu;

// Lane c's int8 row of U (`row`, H bytes) as words in load_rows's layout:
// byte j of word k is element 4k + j, bytes past H are 0; a lane past H
// (`col` false) holds zeros. VEC: the row is 4-byte aligned and H % 4 ==
// 0, so its words load whole. Otherwise the row is read as the aligned
// words that cover it (at most kWarpWords + 1), each word of the row
// funnel-shifted out of two of them. The cover may reach up to 3 bytes
// before or after the rows, never past an allocation: allocations start
// and end on 4-byte boundaries. (Loading the 32 bytes one by one spilled,
// and took twice as long as words; PERF.md's findings.)
template <bool VEC>
__device__ __forceinline__ void load_row_words(int (&w)[kWarpWords],
                                               const int8_t* row, int H,
                                               bool col) {
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < kWarpWords; ++k)
      w[k] = col && 4 * k < H ? __ldg(reinterpret_cast<const int*>(row) + k)
                              : 0;
  } else {
    const uintptr_t at = reinterpret_cast<uintptr_t>(row);
    const unsigned* cover =
        reinterpret_cast<const unsigned*>(at & ~(uintptr_t)3);
    const int skew = (int)(at & 3);
    const int last = (skew + H - 1) >> 2;        // the cover's last word
    unsigned a[kWarpWords + 1];
#pragma unroll
    for (int k = 0; k <= kWarpWords; ++k)
      a[k] = col && k <= last ? __ldg(cover + k) : 0u;
#pragma unroll
    for (int k = 0; k < kWarpWords; ++k) {
      const unsigned v = __funnelshift_r(a[k], a[k + 1], 8 * skew);
      const int left = H - 4 * k;                // the row's bytes from 4k
      w[k] = (int)(left >= 4 ? v : left > 0 ? v & ((1u << (8 * left)) - 1)
                                            : 0u);
    }
  }
}

// The packed words of an int8 vector whose element c is lane c's `q` (0 on
// lanes past H), in load_rows's layout, in every lane: each lane puts its
// byte in place, an OR over each group of 4 lanes makes word k in lanes
// 4k..4k+3, and lane 4k broadcasts it.
__device__ __forceinline__ void pack_words(int (&w)[kWarpWords], int8_t q,
                                           int lane) {
  uint32_t v = (uint32_t)(uint8_t)q << (8 * (lane & 3));
  v |= __shfl_xor_sync(kFullWarp, v, 1);
  v |= __shfl_xor_sync(kFullWarp, v, 2);
#pragma unroll
  for (int k = 0; k < kWarpWords; ++k)
    w[k] = (int)__shfl_sync(kFullWarp, v, 4 * k);
}

// int32 dot product of two packed int8 rows: exact in any order
__device__ __forceinline__ int dot_words(const int (&a)[kWarpWords],
                                         const int (&w)[kWarpWords]) {
  int acc = 0;
#pragma unroll
  for (int k = 0; k < kWarpWords; ++k) acc = __dp4a(a[k], w[k], acc);
  return acc;
}

// One q8 GRU step of lane c (every q8 warp route's layer step, op for op
// cell_update_q8's): qh the packed q8(h), u lane c's int8 rows of the three
// gates as words, x its input-projection columns, eff and b its scales and
// biases, hold its h[c] (0 past H, where every operand is 0). Returns the
// new h[c], unmasked.
template <bool V3>
__device__ __forceinline__ float warp_step_q8(const int (&qh)[kWarpWords],
                                              const int (&u)[3][kWarpWords],
                                              const float (&x)[3],
                                              const float (&eff)[3],
                                              const float (&b)[3],
                                              float hold, bool col,
                                              int lane) {
  const float z =
      sigmoid_f(__fadd_rn(x[0], dequant(dot_words(qh, u[0]), eff[0], b[0])));
  const float r =
      sigmoid_f(__fadd_rn(x[1], dequant(dot_words(qh, u[1]), eff[1], b[1])));
  float ht;
  if constexpr (V3) {
    const float gh = dequant(dot_words(qh, u[2]), eff[2], b[2]);
    ht = tanhf(__fadd_rn(x[2], __fmul_rn(r, gh)));
  } else {       // the candidate from q8(r * h), packed the same way
    int qr[kWarpWords];
    pack_words(qr, col ? q8_act(__fmul_rn(r, hold)) : (int8_t)0, lane);
    ht = tanhf(__fadd_rn(x[2], dequant(dot_words(qr, u[2]), eff[2], b[2])));
  }
  return update_q8(z, hold, ht);
}

// Above 48 KB a block's shared memory must be opted into per kernel and
// device; `configured` remembers the size already allowed on each device.
constexpr int kMaxDevices = 64;

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t* configured) {
  if (bytes <= kDefaultSmem) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && configured[dev] >= bytes) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < kMaxDevices) configured[dev] = bytes;
  return (int)e;
}

}  // namespace
