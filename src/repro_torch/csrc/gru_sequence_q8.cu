// Int8 (q8) GRU recurrences for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the q8 datapath in
// src/repro/kernels/gru_sequence/kernel.py:
//   gru_stack_sequence_q8_warp_k (warp route),
//   gru_stack_sequence_q8_k (block route) <- gru_stack_sequence_q8_kernel
//                                                  (masked prefill)
//   gru_stack_decode_q8_warp_k (warp route),
//   gru_stack_decode_q8_k (block route) <- gru_stack_decode_q8_kernel
//                                                  (one token)
//   gru_sequence_q8_warp_k (warp route),
//   gru_sequence_q8_k (block route) <- gru_sequence_q8_kernel (depth 1,
//                                                              masked)
// The two fused kernels' block routes run one shared routine,
// run_stack_q8(), which computes _gate_math_q8 for every layer, v1 (two
// phases) or v3, with the deep layers' input projection in int8 too. The
// depth-1 kernel is one layer of the per-layer chain (cuda_chain_q8
// prefill): its own (3H, H) rows, no deep projection, its input
// projection float32 from outside. Every layer-step of the block routes is
// cell_update_q8() of gru_q8_math.cuh, which holds the arithmetic and its
// rounding discipline for all the port's q8 kernels.
//
// Translation, as in gru_sequence.cu: the time and layer loops run inside
// the kernel; the grid is over independent batch rows. Each kernel has two
// routes, picked by shape in Python (seq_q8_plan, stack_seq_q8_plan and
// decode_q8_plan in kernels/gru_sequence/kernel.py):
// - "warp" (H <= 32, every served width; the fused kernels also bound the
//   depth): lane c of a warp owns column c of each gate and holds its int8
//   rows in registers as words (load_row_words); q8 activations are packed
//   by shuffles and each gate sum is __dp4a over the words (row 7's step,
//   gru_cell_q8.cu). The depth-1 sequence (gru_sequence_q8_warp_k) is one
//   warp a batch row with xp and the mask loaded steps ahead, no shared
//   memory and no barrier; the decode (gru_stack_decode_q8_warp_k) chains
//   every layer in one warp; the fused prefill
//   (gru_stack_sequence_q8_warp_k) gives each batch row a block on
//   gru_sequence.cu's layer-skewed wavefront, a gate warp per layer and a
//   projection warp between two layers, one block barrier a tick (see each
//   kernel's note).
// - "block", past those bounds: a block per tile of `bt` rows copies the
//   int8 U and deep W, eff and b into shared memory once (gru-jet-deep:
//   9,216 + 6,144 B of int8, 3 KB of scales and bias; one chain layer of
//   H=32: 3,456 B of int8 rows). The per-layer h lives in shared memory;
//   layer l+1 reads layer l's new (masked) h from there. The optional
//   time-major mask is double-buffered by step parity.
// The int32 sums are exact in any order and every route takes its float32
// ops from gru_q8_math.cuh, so the routes agree bit for bit.
//
// Bound on an H100 (SXM): a few tens of KB of inputs (3.35 TB/s) and
// int8 MACs (1,979 TOP/s on the tensor cores) take tens of nanoseconds at
// the serving shapes; the kernels are bound by latency: on the block
// routes the launch, the one-time weight copy and the __syncthreads()
// chain of each layer-step (three, and two more for each deep projection);
// on the warp routes the launch, the loads at entry and each step's
// dependent gate math (the fused prefill's also one barrier a tick).
// Tensor-core IMMA (mma.sync s8) is later work.

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
// xp columns. Each layer is warp_step_q8, gru_step_q8_warp_k's step: q8(h)
// packed by shuffles, each gate sum __dp4a over the words, v1's q8(r * h)
// packed the same way. The next layer's input projection quantizes the new
// h the same way, in the warp, and scales each row's int32 sum by its eff, as
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
    const float hn =
        warp_step_q8<V3>(qh, uw[l], x, ue[l], ub[l], hold, col, lane);
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

// --- the depth-1 sequence's warp route --------------------------------------

// One lane's operands of step t: its three gate columns of xp and the row's
// liveness.
__device__ __forceinline__ void load_step_q8(float (&x)[3], float& m,
                                             const float* __restrict__ xp,
                                             const float* __restrict__ mask,
                                             int t, int B, int H, int row,
                                             bool col, int c) {
  const size_t r = (size_t)t * B + row;
  const float* xr = xp + r * 3 * H + c;
#pragma unroll
  for (int g = 0; g < 3; ++g) x[g] = col ? __ldg(xr + g * H) : 0.0f;
  m = mask == nullptr ? 1.0f : __ldg(mask + r);
}

// One layer of the q8 chain over T steps, one warp a batch row (the source
// note's depth-1 warp route): lane c < H owns column c of each gate and
// holds its three int8 rows of U in registers as words, with its scales,
// biases and h[c]. Each step is warp_step_q8 (q8(h) packed by shuffles,
// __dp4a sums, v1's q8(r * h) packed the same way), the mask a select (a
// dead step keeps h), and the new h stored to out[t] as the step ends.
// The next step's xp columns and liveness load while the step runs, so
// nothing on the step chain waits for device memory, a barrier or shared
// memory. (Loaded 2, 4 or 8 steps ahead, as row 1's fp32 route does, the
// route was slower on an H100: PERF.md's findings.) A warp past B exits
// whole.
template <bool V3, bool VEC>
__global__ void __launch_bounds__(kThreads)
gru_sequence_q8_warp_k(const float* __restrict__ h0,
                       const float* __restrict__ xp,
                       const int8_t* __restrict__ uq,
                       const float* __restrict__ ueff,
                       const float* __restrict__ b,
                       const float* __restrict__ mask,
                       float* __restrict__ out, int T, int B, int H) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B) return;
  const bool col = lane < H;
  const int c = col ? lane : 0;

  int u[3][kWarpWords];
  float eff[3], bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    load_row_words<VEC>(u[g], uq + (size_t)(g * H + c) * H, H, col);
    eff[g] = col ? __ldg(ueff + g * H + c) : 0.0f;
    bias[g] = col ? __ldg(b + g * H + c) : 0.0f;
  }
  float h = col ? __ldg(h0 + (size_t)row * H + c) : 0.0f;

  float nx[3] = {}, nm = 0.0f;           // step t + 1's operands
  if (T > 0) load_step_q8(nx, nm, xp, mask, 0, B, H, row, col, c);
  for (int t = 0; t < T; ++t) {
    float x[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) x[g] = nx[g];
    const float m = nm;
    if (t + 1 < T)
      load_step_q8(nx, nm, xp, mask, t + 1, B, H, row, col, c);
    int qh[kWarpWords];
    pack_words(qh, col ? q8_act(h) : (int8_t)0, lane);
    const float hn = warp_step_q8<V3>(qh, u, x, eff, bias, h, col, lane);
    h = m != 0.0f ? hn : h;
    if (col) out[((size_t)t * B + row) * H + c] = h;
  }
}

// --- the fused prefill's warp route: a layer-skewed wavefront ---------------

constexpr int kQ8SeqMaxLayers = 4;     // the deepest stack the route takes

// The block's barrier between two ticks. Warps of different roles reach it
// from different places in the code, so it is the non-aligned form (a
// __syncthreads() is bar.sync.aligned, which all threads must reach at the
// same instruction).
__device__ __forceinline__ void tick_barrier() {
  asm volatile("barrier.sync 0;" ::: "memory");
}

// L layers of int8 rows over T steps, one batch row a block, on the
// wavefront of gru_sequence.cu's fp32 prefill route (the source note's
// prefill warp route). Layouts as run_stack_q8's. The block has 2L - 1
// warps: at even positions q = 2l the gate warp of layer l (U_l's int8
// rows in registers as words, with its scales and biases), between two
// layers the projection warp of layer l (q = 2l + 1, W_l's rows and
// wd_eff[l]). Warp q runs step j - q at tick j, and one block barrier
// ends every tick, so the chain is T + 2(L - 1) ticks of one q8 gate step
// each, where the block route's is T x L layer-steps of three barriers
// (and two more for each deep projection).
//
// A gate warp's step is warp_step_q8 on q8(h), which it packs from its own
// h by shuffles; a dead step keeps h. Layer l's new h (the kept value)
// goes to the projection warp as float32 through slot (t & 1) of the
// layer's two in static shared memory. The projection warp does
// run_stack_q8's deep projection: q8(h) packed by shuffles, three __dp4a
// sums against W_l's rows, each times its scale (no bias: b enters at the
// gates), into slot (t & 1) of layer l+1's input, which layer l+1's gate
// warp reads the next tick. A slot is written again two ticks on, after
// its read and a barrier. (Handing over the packed q8(h) words instead,
// which the gate warp makes anyway for its own next step, gave the same
// bits at the same speed over the sweep's shapes: PERF.md's findings.)
// Nothing on the chain goes through device memory: every gate warp loads
// the next tick's mask, and layer 0's its xp, one tick ahead into
// registers; the top layer stores out[t] and each gate warp its layer's
// finals.
//
// As the fp32 route, the launch bounds ask for one block an SM and q
// comes from lane 0 by shuffle, so the slot addresses stay in registers.
template <bool V3, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
gru_stack_sequence_q8_warp_k(const float* __restrict__ h0,
                             const float* __restrict__ xp,
                             const int8_t* __restrict__ uq,
                             const float* __restrict__ ueff,
                             const int8_t* __restrict__ wdq,
                             const float* __restrict__ wdeff,
                             const float* __restrict__ b,
                             const float* __restrict__ mask,
                             float* __restrict__ out,
                             float* __restrict__ finals, int T, int B, int H,
                             int L) {
  constexpr int kProj = kQ8SeqMaxLayers - 1;
  // layer l's new h for its projection warp, by step parity; the
  // projection of layer l into layer l+1's input
  __shared__ __align__(16) float hf[kProj][2][32];
  __shared__ __align__(16) float ps[kProj][2][3][32];
  const int H3 = 3 * H;
  const int lane = threadIdx.x & 31;
  const int q = __shfl_sync(kFullWarp, threadIdx.x >> 5, 0);  // position
  const int row = blockIdx.x;
  const bool proj = q & 1;               // a projection warp
  const int l = q >> 1;                  // its layer (the one it projects)
  const bool col = lane < H;
  const int c = col ? lane : 0;
  const int ticks = T + 2 * L - 2;

  int w[3][kWarpWords];    // lane c's int8 rows of U_l, or of W_l
  float e[3];
  {
    const int8_t* rows = proj ? wdq : uq;
    const float* scale = proj ? wdeff : ueff;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const size_t j = (size_t)l * H3 + g * H + c;     // row of (L*3H, H)
      load_row_words<VEC>(w[g], rows + j * H, H, col);
      e[g] = col ? __ldg(scale + j) : 0.0f;
    }
  }

  if (proj) {                // layer l's new h -> layer l+1's input
    for (int j = 0; j < ticks; ++j) {
      const int t = j - q;
      if (t >= 0 && t < T) {
        int qh[kWarpWords];
        pack_words(qh, col ? q8_act(hf[l][t & 1][lane]) : (int8_t)0, lane);
#pragma unroll
        for (int g = 0; g < 3; ++g)
          ps[l][t & 1][g][lane] =
              __fmul_rn((float)dot_words(qh, w[g]), e[g]);
      }
      tick_barrier();
    }
    return;
  }

  float bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g)
    bias[g] = col ? __ldg(b + (size_t)l * H3 + g * H + c) : 0.0f;
  float hc = col ? __ldg(h0 + ((size_t)l * B + row) * H + c) : 0.0f;
  const bool feeds = l + 1 < L;          // a projection warp reads its h
  int qh[kWarpWords];                    // q8(hc), packed
  pack_words(qh, col ? q8_act(hc) : (int8_t)0, lane);

  // tick j's mask and, in layer 0, its xp columns, loaded a tick ahead
  const auto fetch = [&](float (&x)[3], float& m, int j) {
    const int t = j - q;
    if (t < 0 || t >= T) return;
    const size_t r = (size_t)t * B + row;
    m = mask == nullptr ? 1.0f : __ldg(mask + r);
    if (l == 0) {
#pragma unroll
      for (int g = 0; g < 3; ++g)
        x[g] = col ? __ldg(xp + r * H3 + g * H + c) : 0.0f;
    }
  };
  float nx[3] = {}, nm = 0.0f;
  fetch(nx, nm, 0);

  for (int j = 0; j < ticks; ++j) {
    const int t = j - q;
    const bool act = t >= 0 && t < T;
    float x[3] = {}, m = 0.0f;
    if (act) {
      m = nm;
#pragma unroll
      for (int g = 0; g < 3; ++g) x[g] = nx[g];
    }
    fetch(nx, nm, j + 1);
    if (act) {
      if (l > 0) {
#pragma unroll
        for (int g = 0; g < 3; ++g) x[g] = ps[l - 1][t & 1][g][lane];
      }
      const float hn = warp_step_q8<V3>(qh, w, x, e, bias, hc, col, lane);
      hc = m != 0.0f ? hn : hc;
      pack_words(qh, col ? q8_act(hc) : (int8_t)0, lane);   // next step's
      if (feeds) hf[l][t & 1][lane] = hc;
      if (col && l == L - 1) out[((size_t)t * B + row) * H + c] = hc;
    }
    tick_barrier();
  }
  if (col) finals[((size_t)l * B + row) * H + c] = hc;
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

// The depth-1 sequence's warp route: `warps` warps a block (1 to 8), one
// batch row each; `vec`: U's rows load as whole 4-byte words (H % 4 == 0,
// u_q 4-byte aligned), else through the aligned words that cover them. H
// at most 32.
extern "C" int gru_sequence_q8_warp_launch(
    const float* h0, const float* xp, const int8_t* uq, const float* ueff,
    const float* b, const float* mask, float* out, int T, int B, int H,
    int v3, int warps, int vec, void* stream) {
  if (H < 1 || H > kWarpMaxH || warps < 1 || warps > kThreads / 32 ||
      (vec && H % 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + warps - 1) / warps);
  cudaStream_t st = (cudaStream_t)stream;
  const auto go = [&](auto kernel) {
    kernel<<<grid, 32 * warps, 0, st>>>(h0, xp, uq, ueff, b, mask, out, T, B,
                                        H);
    return (int)cudaGetLastError();
  };
  if (v3 && vec) return go(gru_sequence_q8_warp_k<true, true>);
  if (v3) return go(gru_sequence_q8_warp_k<true, false>);
  if (vec) return go(gru_sequence_q8_warp_k<false, true>);
  return go(gru_sequence_q8_warp_k<false, false>);
}

// The fused prefill's warp route: a block of 2L - 1 warps a batch row. H at
// most 32, L at most kQ8SeqMaxLayers; `vec` as above (u_q and wd_q). Its
// shared memory is static.
extern "C" int gru_stack_sequence_q8_warp_launch(
    const float* h0, const float* xp, const int8_t* uq, const float* ueff,
    const int8_t* wdq, const float* wdeff, const float* b, const float* mask,
    float* out, float* finals, int T, int B, int H, int L, int v3, int vec,
    void* stream) {
  if (H < 1 || H > kWarpMaxH || L < 1 || L > kQ8SeqMaxLayers ||
      (vec && H % 4))
    return (int)cudaErrorInvalidValue;
  const dim3 block(32 * (2 * L - 1));
  cudaStream_t st = (cudaStream_t)stream;
  const auto go = [&](auto kernel) {
    kernel<<<B, block, 0, st>>>(h0, xp, uq, ueff, wdq, wdeff, b, mask, out,
                                finals, T, B, H, L);
    return (int)cudaGetLastError();
  };
  if (v3 && vec) return go(gru_stack_sequence_q8_warp_k<true, true>);
  if (v3) return go(gru_stack_sequence_q8_warp_k<true, false>);
  if (vec) return go(gru_stack_sequence_q8_warp_k<false, true>);
  return go(gru_stack_sequence_q8_warp_k<false, false>);
}
