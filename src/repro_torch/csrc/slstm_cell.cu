// Fused sLSTM stack recurrences for Hopper (sm_90a), fp32.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/slstm_cell/kernel.py:
//   slstm_stack_warp_k (warp route, both),
//   slstm_stack_sequence_k (block route) <- slstm_stack_sequence_kernel
//                                           (masked prefill)
//   slstm_stack_decode_k (block route)   <- slstm_stack_decode_kernel
//                                           (one token)
// They compute what the TPU kernels compute: per layer and step, gates
// [z, i, f, o] = x_proj + h.U + b, the exponential input and forget gates
// under the running log-scale stabilizer m, and the four state leaves c,
// n, m, h.
//
// Translation. The TPU walks a sequential time grid and carries the four
// leaves in VMEM scratch. Here the time loop and the layer loop run INSIDE
// the kernel, and the grid runs over independent batch rows. Two routes
// for each kernel; the wrappers pick one by shape (slstm_decode_plan and
// slstm_stack_seq_plan in kernels/slstm_cell/kernel.py):
// - "warp" (H <= 32, L <= 4: every served width and depth), on the GRU's
//   warp routes (csrc/gru_sequence.cu): lane c of a warp owns unit c of
//   the four gates, columns c, H+c, 2H+c and 3H+c of U (H, 4H), and one
//   pass over k with four accumulators gives its gate sums.
//   slstm_stack_warp_k (see its note) is a block a batch row on row 2's
//   wavefront skewed by layer; the prefill runs it over T steps, the
//   decode at T = 1.
// - "block" (run_stack, shared by both kernels; past the warp routes'
//   bounds and for a nonzero batch_block): a block per tile of `bt` rows
//   copies U, the deep layers' W and b into shared memory once (cp.async,
//   16-byte pieces where aligned) and keeps them for the whole loop. c, n
//   and m of every layer stay in shared memory, each element owned by one
//   thread for the whole launch; h is double-buffered by step parity, so a
//   layer-step is ONE phase ended by ONE barrier: the thread that owns
//   (row, unit) computes all four gate sums of that unit (the U dot over
//   the layer's old h, and for layers above 0 the W dot over the layer
//   below's new h, read from shared memory), applies the update, and
//   writes the new h into the other buffer. The layer-0 x_proj slab and
//   the mask of step t+1 are copied into shared memory (cp.async) while
//   step t runs. Its shared-memory layout: U, W_deep and b dense (16-byte
//   aligned, the copies' unit); each thread reads U[k][g*H + c] for its own
//   c, so a warp reads consecutive words. h rows sit at an odd word stride
//   (H | 1): the threads of one row read the same word (a broadcast), and
//   two rows in one warp then always fall on different banks.
// On both routes a masked row keeps all four leaves (select, never a
// perturbation), and the next layer consumes its frozen h.
//
// Bound on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): per row, layer and
// step 8*H*H flops for U (and 8*H*H for W below the top) over a few to a
// hundred KB of weights, so both bounds are tens of nanoseconds at the
// serving shapes and a launch costs microseconds. The kernels are bound by
// latency: the block route by the weight copy into shared memory before
// any work and a barrier every layer-step; the warp route by one pass of H
// dependent fmas a tick, the cell's epilogue (three expf, a log1pf, a
// tanhf and a division) and one barrier a tick, the decode also by the
// weights' loads at entry.
//
// Numerics: expf/tanhf/log1pf, no fast math; dot products accumulate in k
// order with fma from 0 on both routes; the epilogue is one function,
// slstm_update, for both: g = (x_proj + h.U) + b, log_sigmoid as the
// stable -softplus(-f), the forget term in JAX's order exp((logf + m) -
// m'), so a first step from m = M_INIT = -1e30 gives exactly 0, and c' and
// n' contracted as written there, so the routes round alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// log(sigmoid(f)) = -softplus(-f) = -(max(-f, 0) + log1p(exp(-|f|)))
__device__ __forceinline__ float log_sigmoid_f(float f) {
  return -(fmaxf(-f, 0.0f) + log1pf(expf(-fabsf(f))));
}

// One unit's four leaves.
struct Leaves {
  float c, n, m, h;
};

// One sLSTM update of one unit, on both routes: x its four gates' input
// projection, a their sums over h.U, bb their biases, s the unit's leaves.
// JAX's order throughout. nvcc contracts c' = f_*c + i_*tanh(z) and n' =
// f_*n + i_ into fmas; they are written out here as it contracted them in
// the block route before the warp routes (that route's bits unchanged, on
// an H100; PERF.md, rows 8-9), so no route is left to its own contraction.
__device__ __forceinline__ Leaves slstm_update(const float (&x)[4],
                                               const float (&a)[4],
                                               const float (&bb)[4],
                                               const Leaves& s) {
  const float z = (x[0] + a[0]) + bb[0];
  const float ig = (x[1] + a[1]) + bb[1];
  const float f = (x[2] + a[2]) + bb[2];
  const float o = (x[3] + a[3]) + bb[3];
  const float lm = log_sigmoid_f(f) + s.m;
  const float m_new = fmaxf(lm, ig);
  const float i_ = expf(ig - m_new);
  const float f_ = expf(lm - m_new);
  const float c_new = __fmaf_rn(f_, s.c, __fmul_rn(i_, tanhf(z)));
  const float n_new = __fmaf_rn(f_, s.n, i_);
  return {c_new, n_new, m_new, sigmoid_f(o) * c_new / fmaxf(n_new, 1e-6f)};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// this thread's copies have landed (other threads' after a barrier)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst[0:n] = src[0:n], asynchronously, by the whole block; dst is 16-byte
// aligned by the layout, src is checked.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x)
      cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      cp_async4(dst + i, src + i);
  }
}

// Step t's layer-0 x_proj rows of this tile -> sx (bt, 4H), its liveness
// -> live (bt,): copies in flight, or plain stores for the no-mask case.
__device__ __forceinline__ void stage_step(float* sx, float* live,
                                           const float* xp, const float* mask,
                                           int t, int B, int row0, int nrow,
                                           int H4) {
  copy_async(sx, xp + ((size_t)t * B + row0) * H4, nrow * H4);
  for (int r = threadIdx.x; r < nrow; r += blockDim.x) {
    if (mask == nullptr) {
      live[r] = 1.0f;
    } else {
      cp_async4(live + r, mask + (size_t)t * B + row0 + r);
    }
  }
}

// The shared routine of both kernels. Layouts (row-major, fp32):
//   c0, n0, m0, h0  (L, B, H)     initial per-layer leaves
//   xp      (T, B, 4H)            layer-0 input projection, time-major
//   u       (L, H, 4H)            recurrent matrices, gates [z|i|f|o]
//   wd      (L-1, H, 4H)          input projections of layers 1..L-1
//   b       (L, 4H)
//   mask    (T, B) or null        nonzero = live step
//   out_seq (T, B, H) or null     last layer's h after every step
//   cT, nT, mT, hT  (L, B, H)     every layer's leaves after step T-1
__device__ void run_stack(const float* c0, const float* n0, const float* m0,
                          const float* h0, const float* xp, const float* u,
                          const float* wd, const float* b, const float* mask,
                          float* out_seq, float* cT, float* nT, float* mT,
                          float* hT, int T, int B, int H, int L, int bt) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  const int ldh = H | 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* su = smem;                            // (L, H, 4H)
  float* swd = su + (size_t)L * H * H4;        // (L-1, H, 4H)
  float* sb = swd + (size_t)(L - 1) * H * H4;  // (L, 4H)
  float* sx = sb + L * H4;                     // (2, bt, 4H) by step parity
  float* sh = sx + 2 * bt * H4;                // (2, L, bt, ldh) by parity
  float* sc = sh + 2 * L * bt * ldh;           // (L, bt, H)
  float* sn = sc + L * bt * H;                 // (L, bt, H)
  float* sm = sn + L * bt * H;                 // (L, bt, H)
  float* slive = sm + L * bt * H;              // (2, bt) by step parity

  const int row0 = blockIdx.x * bt;
  const int nrow = min(bt, B - row0);
  const int n_own = nrow * H;                  // (row, unit) pairs per layer

  copy_async(su, u, L * H * H4);
  copy_async(swd, wd, (L - 1) * H * H4);
  copy_async(sb, b, L * H4);
  stage_step(sx, slive, xp, mask, 0, B, row0, nrow, H4);
  cp_async_commit();
  for (int i = tid; i < L * n_own; i += nt) {
    const int l = i / n_own;
    const int e = i - l * n_own;
    const int r = e / H;
    const int c = e - r * H;
    const size_t g = ((size_t)l * B + row0 + r) * H + c;
    const int s = (l * bt + r) * H + c;
    sc[s] = c0[g];
    sn[s] = n0[g];
    sm[s] = m0[g];
    sh[(l * bt + r) * ldh + c] = h0[g];
  }
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    if (t + 1 < T) {  // step t+1's inputs land while step t runs
      stage_step(sx + (1 - p) * bt * H4, slive + (1 - p) * bt, xp, mask,
                 t + 1, B, row0, nrow, H4);
      cp_async_commit();
    }
    const float* xs = sx + p * bt * H4;
    const float* live = slive + p * bt;
    const float* hold = sh + p * L * bt * ldh;
    float* hnew = sh + (1 - p) * L * bt * ldh;
    for (int l = 0; l < L; ++l) {
      const float* ul = su + (size_t)l * H * H4;
      const float* bl = sb + l * H4;
      for (int i = tid; i < n_own; i += nt) {
        const int r = i / H;
        const int c = i - r * H;
        const float* hr = hold + (l * bt + r) * ldh;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        for (int k = 0; k < H; ++k) {
          const float hk = hr[k];
          const float* w = ul + k * H4 + c;
          a0 = fmaf(hk, w[0], a0);
          a1 = fmaf(hk, w[H], a1);
          a2 = fmaf(hk, w[2 * H], a2);
          a3 = fmaf(hk, w[3 * H], a3);
        }
        float x[4];
        if (l == 0) {
          const float* xr = xs + r * H4 + c;
#pragma unroll
          for (int g = 0; g < 4; ++g) x[g] = xr[g * H];
        } else {  // the layer below's new h times its W, from shared memory
          const float* hb = hnew + ((l - 1) * bt + r) * ldh;
          const float* wl = swd + (size_t)(l - 1) * H * H4 + c;
          x[0] = x[1] = x[2] = x[3] = 0.0f;
          for (int k = 0; k < H; ++k) {
            const float hk = hb[k];
            const float* w = wl + k * H4;
#pragma unroll
            for (int g = 0; g < 4; ++g) x[g] = fmaf(hk, w[g * H], x[g]);
          }
        }
        const int s = (l * bt + r) * H + c;
        float hv = hr[c];
        if (live[r] != 0.0f) {
          const float a[4] = {a0, a1, a2, a3};
          const float bb[4] = {bl[c], bl[H + c], bl[2 * H + c],
                               bl[3 * H + c]};
          const Leaves nv = slstm_update(x, a, bb, {sc[s], sn[s], sm[s], hv});
          hv = nv.h;
          sc[s] = nv.c;
          sn[s] = nv.n;
          sm[s] = nv.m;
        }
        hnew[(l * bt + r) * ldh + c] = hv;
        if (l == L - 1 && out_seq != nullptr)
          out_seq[((size_t)t * B + row0 + r) * H + c] = hv;
      }
      if (l == L - 1 && t + 1 < T) cp_async_wait_all();
      __syncthreads();  // the new h (and step t+1's inputs) are in place
    }
  }

  const float* hfin = sh + (T & 1) * L * bt * ldh;
  for (int i = tid; i < L * n_own; i += nt) {
    const int l = i / n_own;
    const int e = i - l * n_own;
    const int r = e / H;
    const int c = e - r * H;
    const size_t g = ((size_t)l * B + row0 + r) * H + c;
    const int s = (l * bt + r) * H + c;
    cT[g] = sc[s];
    nT[g] = sn[s];
    mT[g] = sm[s];
    hT[g] = hfin[(l * bt + r) * ldh + c];
  }
}

__global__ void __launch_bounds__(kThreads)
slstm_stack_sequence_k(const float* c0, const float* n0, const float* m0,
                       const float* h0, const float* xp, const float* u,
                       const float* wd, const float* b, const float* mask,
                       float* out, float* cT, float* nT, float* mT,
                       float* hT, int T, int B, int H, int L, int bt) {
  run_stack(c0, n0, m0, h0, xp, u, wd, b, mask, out, cT, nT, mT, hT, T, B,
            H, L, bt);
}

__global__ void __launch_bounds__(kThreads)
slstm_stack_decode_k(const float* c, const float* n, const float* m,
                     const float* h, const float* xp, const float* u,
                     const float* wd, const float* b, float* co, float* no,
                     float* mo, float* ho, int B, int H, int L, int bt) {
  run_stack(c, n, m, h, xp, u, wd, b, nullptr, nullptr, co, no, mo, ho, 1,
            B, H, L, bt);
}

// --- the warp routes --------------------------------------------------------

constexpr int kWarpMaxH = 32;          // one unit a lane
constexpr int kMaxLayers = 4;          // the deepest stack the routes take
constexpr int kGateCols = 4 * kWarpMaxH;   // a projection's 4 gates x 32 lanes
constexpr unsigned kFullWarp = 0xffffffffu;

// Lane c's columns of the four gates of a (H, 4H) matrix at m (the matrix
// plus c) in device memory: w[g][k] = m[k*4H + g*H], 0 for k >= H, loaded
// in one burst ahead of the pass that reads them, as row 3's load_cols
// (csrc/gru_sequence.cu) loads them: plain coherent ld.global closed by
// __syncwarp(), which ptxas may not move down to the fmas that read them
// (it sank __ldg loads there, and each k then waited on its load). With H
// a compile-time constant each load is one instruction at an immediate
// offset; with H at run time the row pointer steps by an opaque add, or
// ptxas holds all 128 addresses at once, and that instance spilled. A
// lane past H reads column 0 (its m is the matrix itself): its values
// stay finite, and every lane below H weighs them by an exact 0.
template <int HT>
__device__ __forceinline__ void load_gates(float (&w)[4][kWarpMaxH],
                                           const float* m, int H) {
  if constexpr (HT) {
#pragma unroll
    for (int k = 0; k < kWarpMaxH; ++k)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (k < HT)
          asm volatile("ld.global.f32 %0, [%1];"
                       : "=f"(w[g][k])
                       : "l"(m + k * 4 * HT + g * HT));
        else
          w[g][k] = 0.0f;
      }
  } else {
    const long long step = 16ll * H;      // bytes of a row of the matrix
#pragma unroll
    for (int k = 0; k < kWarpMaxH; ++k) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (k < H)
          asm volatile("ld.global.f32 %0, [%1];"
                       : "=f"(w[g][k])
                       : "l"(m + g * H));
        else
          w[g][k] = 0.0f;
      }
      asm volatile("add.s64 %0, %0, %1;" : "+l"(m) : "l"(step));
    }
  }
  __syncwarp();
}

// acc[g] = sum_k h_k w[g][k] over all 32 k in order by fma from 0, h_k
// read from the warp's slot of shared memory (32 floats, 16-byte aligned)
// as float4 broadcasts (row 3's SmemBcast: 1.4x faster than shuffles). No
// branch splits the pass: k >= H adds fma(h_k, +0), and a lane past H
// keeps 0 in the slot, so the sums equal run_stack's over k < H bit for
// bit.
__device__ __forceinline__ void warp_pass(const float (&w)[4][kWarpMaxH],
                                          const float* slot,
                                          float (&acc)[4]) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k4 = 0; k4 < kWarpMaxH / 4; ++k4) {
    const float4 q = reinterpret_cast<const float4*>(slot)[k4];
    const float hk[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) a[g] = fmaf(hk[i], w[g][4 * k4 + i], a[g]);
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) acc[g] = a[g];
}

// Per-layer leaf pointers of the warp route, by value: in[l] the c, n, m, h
// of layer l (each (B, H)), out[l] its new ones. The wrappers fill it from
// views of (L, B, H) stacks or, for the decode, straight from the served
// model's per-layer state, so no copy stacks the state around the launch.
// A gate warp indexes it by its own layer at run time: the kernel takes it
// as a __grid_constant__, read in place from the parameter space.
struct LeafTable {
  const float* in[kMaxLayers][4];
  float* out[kMaxLayers][4];
};

// A block's slots for the deepest stack: each layer's h by step parity,
// each projection's four gates by step parity (4 KB).
constexpr int kSeqSlotFloats =
    kMaxLayers * 64 + (kMaxLayers - 1) * 2 * kGateCols;

// The block's barrier between two ticks. Warps of different roles reach it
// from different places in the code, so it is the non-aligned form (a
// __syncthreads() is bar.sync.aligned, which all threads must reach at
// the same instruction).
__device__ __forceinline__ void tick_barrier() {
  asm volatile("barrier.sync 0;" ::: "memory");
}

// L layers over T steps for one batch row a block, on row 2's wavefront
// skewed by layer (gru_stack_sequence_warp_k). Layouts as run_stack's,
// but the leaves come through the table lv (layer l's (B, H) c, n, m, h,
// and where its new ones go). The block has 2L - 1
// warps: at even positions q = 2l the gate warp of layer l (lane c's 128
// columns of U_l in registers), between two layers the projection warp of
// layer l (q = 2l + 1, its W_l in registers). Warp q runs step j - q at
// tick j, and a barrier ends every tick, so the chain is T + 2(L - 1)
// ticks of one pass over k each, where the block route's is T x L
// layer-steps of a barrier each. At L = 1 the block is the one gate warp,
// and its tick ends at a __syncwarp().
//
// The gate warp of layer l keeps lane c's c, n and m in registers for the
// whole sequence. Its new h (gated: a dead step keeps all four leaves, the
// liveness read for the step the warp runs at that tick) goes to slot (t &
// 1) of the layer's two, where its own next step and the projection warp
// read it in the next tick; it writes that slot again two ticks on, after
// those reads and a barrier. The projection (four sums in k order by fma
// from 0, as run_stack's) goes to layer l+1 the same way. Nothing on the
// chain goes through device memory: every gate warp loads the next tick's
// liveness, and layer 0's its x_proj, one tick ahead into registers; the
// top layer stores out[t] and each gate warp its layer's finals. A gate
// warp asks for its leaves and its first tick's inputs before it waits on
// its h, so they come back in one trip to memory, not two (0.16 us of the
// decode at L=1 H=20, timed on an H100). out is always written: a null
// out tested every tick made the prefill 2 % slower at L=3 H=32.
//
// The decode is this kernel at T = 1 with no mask (its out a row the
// wrapper drops): one block a batch row of 2L - 1 warps, every matrix's
// columns loaded at entry, each in its own warp, and the layers handed on
// through the slots. A warp
// that chains the layers itself, loading each matrix when it gets there
// (row 3's design, gru_stack_decode_warp_k), was timed against it on an
// H100: slower by 1.0-1.5 us at L=3 H=32 (4.69-5.14 against 3.39-3.70),
// faster by 0.1 us at L=1 H=20 (PERF.md, rows 8-9), so the one kernel
// serves both.
//
// As row 2, written for ptxas: the launch bounds ask for one block an SM,
// and q comes from lane 0 by shuffle, so the slot addresses it gives stay
// in registers and are not rebuilt from threadIdx every tick.
template <int HT>
__global__ void __launch_bounds__(kThreads, 1)
slstm_stack_warp_k(const __grid_constant__ LeafTable lv,
                   const float* __restrict__ xp,
                   const float* __restrict__ u,
                   const float* __restrict__ wd,
                   const float* __restrict__ b,
                   const float* __restrict__ mask, float* __restrict__ out,
                   int T, int B, int H, int L) {
  if constexpr (HT) H = HT;
  __shared__ __align__(16) float smem[kSeqSlotFloats];
  const int H4 = 4 * H;
  const int n = H * H4;                   // floats of one matrix
  const int lane = threadIdx.x & 31;
  const int nw = 2 * L - 1;               // warps (positions) a row
  const int q = __shfl_sync(kFullWarp, threadIdx.x >> 5, 0);  // position
  const int row = blockIdx.x;
  const bool proj = q & 1;                // a projection warp
  const int l = q >> 1;                   // its layer (the one it projects)
  const bool col = lane < H;
  const int c = col ? lane : 0;
  const int ticks = T + nw - 1;

  float* hs = smem;                       // (L, 2, 32) h slots
  float* ps = hs + L * 64;                // (L-1, 2, 128) projections
  float* hslot = hs + l * 64;             // layer l's two h slots

  float w[4][kWarpMaxH];     // lane c's columns of U_l, or of W_l
  load_gates<HT>(w, (proj ? wd : u) + (size_t)l * n + c, H);

  if (proj) {                // layer l's new h -> layer l+1's input
    float* pslot = ps + l * 2 * kGateCols;
    for (int j = 0; j < ticks; ++j) {
      const int t = j - q;
      if (t >= 0 && t < T) {
        float p[4];
        warp_pass(w, hslot + (t & 1) * 32, p);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pslot[(t & 1) * kGateCols + g * 32 + lane] = p[g];
      }
      tick_barrier();
    }
    return;
  }

  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    bias[g] = col ? __ldg(b + (size_t)l * H4 + g * H + c) : 0.0f;
  const size_t e = (size_t)row * H + c;
  Leaves s{col ? __ldg(lv.in[l][0] + e) : 0.0f,
           col ? __ldg(lv.in[l][1] + e) : 0.0f,
           col ? __ldg(lv.in[l][2] + e) : 0.0f,
           col ? __ldg(lv.in[l][3] + e) : 0.0f};
  const float* pin = ps + (l > 0 ? l - 1 : 0) * 2 *
                              kGateCols;  // layer l-1's projections

  // tick j's liveness and, in layer 0, its x_proj columns, a tick ahead
  const auto fetch = [&](float (&x)[4], float& live, int j) {
    const int t = j - q;
    if (t < 0 || t >= T) return;
    const size_t r = (size_t)t * B + row;
    live = mask == nullptr ? 1.0f : __ldg(mask + r);
    if (l == 0) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        x[g] = col ? __ldg(xp + r * H4 + g * H + c) : 0.0f;
    }
  };
  float nx[4] = {}, nlive = 0.0f;
  fetch(nx, nlive, 0);
  hslot[32 + lane] = s.h;                 // h0, in the slot of step -1
  __syncwarp();

  for (int j = 0; j < ticks; ++j) {
    const int t = j - q;
    const bool act = t >= 0 && t < T;
    float x[4] = {}, live = 0.0f;
    if (act) {
      live = nlive;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[g] = nx[g];
    }
    fetch(nx, nlive, j + 1);
    if (act) {
      if (l > 0) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          x[g] = pin[(t & 1) * kGateCols + g * 32 + lane];
      }
      float a[4];
      warp_pass(w, hslot + ((t - 1) & 1) * 32, a);
      const Leaves nv = slstm_update(x, a, bias, s);
      if (live != 0.0f) s = nv;
      hslot[(t & 1) * 32 + lane] = col ? s.h : 0.0f;
      if (col && l == L - 1)
        out[((size_t)t * B + row) * H + c] = s.h;
    }
    if (nw > 1)
      tick_barrier();
    else
      __syncwarp();
  }
  if (col) {
    lv.out[l][0][e] = s.c;
    lv.out[l][1][e] = s.n;
    lv.out[l][2][e] = s.m;
    lv.out[l][3][e] = s.h;
  }
}

size_t smem_bytes(int L, int H, int bt) {
  const size_t H4 = 4 * (size_t)H;
  const size_t floats = (size_t)L * H * H4 + (size_t)(L - 1) * H * H4 +
                        L * H4 + 2 * (size_t)bt * H4 +
                        2 * (size_t)L * bt * (H | 1) +
                        3 * (size_t)L * bt * H + 2 * (size_t)bt;
  return floats * sizeof(float);
}

// one thread per (row, unit) of the tile, in whole warps, at most
// kThreads; at least kMinThreads, so the weight copy has enough in flight
constexpr int kMinThreads = 128;

int block_threads(int H, int bt) {
  const int want = (bt * H + 31) / 32 * 32;
  return want < kMinThreads ? kMinThreads : want < kThreads ? want : kThreads;
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

size_t seq_smem[kMaxDevices];
size_t decode_smem[kMaxDevices];

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int slstm_stack_sequence_launch(
    const float* c0, const float* n0, const float* m0, const float* h0,
    const float* xp, const float* u, const float* wd, const float* b,
    const float* mask, float* out, float* cT, float* nT, float* mT,
    float* hT, int T, int B, int H, int L, int bt, void* stream) {
  const size_t bytes = smem_bytes(L, H, bt);
  int err = allow_smem(slstm_stack_sequence_k, bytes, seq_smem);
  if (err) return err;
  slstm_stack_sequence_k<<<(B + bt - 1) / bt, block_threads(H, bt), bytes,
                           (cudaStream_t)stream>>>(
      c0, n0, m0, h0, xp, u, wd, b, mask, out, cT, nT, mT, hT, T, B, H, L,
      bt);
  return (int)cudaGetLastError();
}

extern "C" int slstm_stack_decode_launch(
    const float* c, const float* n, const float* m, const float* h,
    const float* xp, const float* u, const float* wd, const float* b,
    float* co, float* no, float* mo, float* ho, int B, int H, int L, int bt,
    void* stream) {
  const size_t bytes = smem_bytes(L, H, bt);
  int err = allow_smem(slstm_stack_decode_k, bytes, decode_smem);
  if (err) return err;
  slstm_stack_decode_k<<<(B + bt - 1) / bt, block_threads(H, bt), bytes,
                         (cudaStream_t)stream>>>(c, n, m, h, xp, u, wd, b, co,
                                                 no, mo, ho, B, H, L, bt);
  return (int)cudaGetLastError();
}

// The warp route of both kernels: a block of 2L - 1 warps per batch row
// over T steps (the decode: T = 1, mask null). `leaves` is a host
// array of 8L pointers: layer l's c, n, m, h at [4l .. 4l+3], its new ones
// at [4L + 4l ..]; it is copied into the kernel's by-value table. H at
// most 32 (20 and 32 compiled as constants), L at most kMaxLayers; its 4
// KB of shared memory is static.
extern "C" int slstm_stack_warp_launch(
    const float* const* leaves, const float* xp, const float* u,
    const float* wd, const float* b, const float* mask, float* out, int T,
    int B, int H, int L, void* stream) {
  if (H < 1 || H > kWarpMaxH || L < 1 || L > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  LeafTable lv{};
  for (int l = 0; l < L; ++l)
    for (int k = 0; k < 4; ++k) {
      lv.in[l][k] = leaves[4 * l + k];
      lv.out[l][k] = const_cast<float*>(leaves[4 * (L + l) + k]);
    }
  const auto go = [&](auto kernel) {
    kernel<<<B, 32 * (2 * L - 1), 0, (cudaStream_t)stream>>>(
        lv, xp, u, wd, b, mask, out, T, B, H, L);
    return (int)cudaGetLastError();
  };
  if (H == 32) return go(slstm_stack_warp_k<32>);
  if (H == 20) return go(slstm_stack_warp_k<20>);
  return go(slstm_stack_warp_k<0>);
}
