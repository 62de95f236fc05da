// Fused GRU recurrences for Hopper (sm_90a), fp32.
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/gru_sequence/kernel.py:
//   gru_sequence_warp_k (warp route),
//   gru_sequence_k (block route) <- gru_sequence_kernel   (depth-1 sequence)
//   gru_stack_sequence_warp_k (warp route),
//   gru_stack_sequence_k (block route) <- gru_stack_sequence_kernel (fused
//                                                                 depth-L seq)
//   gru_stack_decode_warp_k (warp route),
//   gru_stack_decode_k (block route) <- gru_stack_decode_kernel (one token,
//                                                                 L layers)
// They compute what the TPU kernels compute for variant v1 (paper/Cho gate
// math, two phases per step) and v3 (one stacked U matvec per step).
//
// Translation. The TPU walks a sequential time grid and carries h in VMEM
// scratch. Here the time loop (and the layer loop) runs INSIDE the kernel,
// and the grid runs over independent batch rows (the decode kernel's
// "parallel" axis on the TPU). Two routes for each kernel; the wrappers
// pick one by shape (seq_plan, stack_seq_plan and decode_plan in
// kernels/gru_sequence/kernel.py):
// - "warp" (H <= 32, every served width): one warp per batch row (R rows
//   for the sequence); lane c owns output column c of each gate
//   (warp_gru_step, shared by both kernels). The sequence keeps its 3H
//   weights of U (U[k*3H + c], k < H; coalesced across the lanes) in
//   registers from entry on; h_k reaches every lane by __shfl_sync from
//   the lane that owns it; v1 runs the z/r phase, forms r_c*h_c in lane
//   c, broadcasts it the same way and runs the candidate phase; v3 runs
//   one phase of three accumulators. Nothing on the step chain touches
//   shared memory, waits at a barrier or waits for device memory: each
//   lane's xp columns and the row's liveness are loaded D steps ahead into
//   a register ring (slot t % D), and out[t] is stored as the step ends
//   (coalesced; nothing reads it back). No branch splits a pass over k: it
//   runs all 32 lanes' k's, the lanes past H holding zeros, so the
//   shuffles go out ahead of the fma chain (a branch per k made each k
//   wait for its shuffle: 1.6 us a step at H=32 on an H100). The decode
//   (gru_stack_decode_warp_k, see its note) chains the L layers in the
//   same warp: layer l+1's input projection is the warp's own pass over
//   k; each layer's U and W come from device memory, in one burst of
//   loads a pass; h_k reaches the lanes through a slot of shared memory,
//   8 float4 reads a pass. The fused prefill (gru_stack_sequence_warp_k,
//   see its note) gives each batch row a block, each layer its own warp
//   (U in registers) and each pair of layers a projection warp (W in
//   registers), on a wavefront skewed by layer: layer l runs step t while
//   layer l-1 runs step t+1, and layer l's new h reaches layer l+1 through
//   shared memory within one barrier a hop, so the chain is T + 2(L - 1)
//   ticks, not T x L layer-steps.
// - "block" (run_stack, shared by all three kernels; each past its warp
//   route's bounds, H = 32 or the layer bound): a block per tile
//   of `bt` rows copies U, the deep layers' W and b into shared memory
//   once and keeps them for the whole loop (the paper's row reuse). Every
//   thread owns whole output columns of U (the paper's row-wise split) and
//   reads U[k*3H + j], so neighbouring threads read neighbouring shared-
//   memory words. The per-layer h lives in shared memory; layer l+1 reads
//   layer l's new h from there, never from device memory. A masked row
//   keeps its pre-step h in every layer, and the next layer consumes that
//   gated output.
//
// Bound on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): the work is a chain
// of tiny matvecs (2*3H*H flops per row, layer and step) over a few tens
// of KB of weights, so both the byte bound and the flop bound are tens of
// nanoseconds at the serving shapes; a launch costs microseconds. Both
// routes are bound by latency instead. The block route's step is four
// __syncthreads() with a block-wide matvec between each pair, and a trip
// to L2 for the step's xp and mask inside the chain; its U copy and
// barrier come before step 0. The warp route's step is H dependent fmas
// per accumulator (the broadcasts of h do not wait on them) and the gate
// math, twice for v1; the sequence's only trip to memory that the chain
// waits for is the load of U and of the first D steps at entry, the
// decode's the first layer's operands and each matrix's burst of loads,
// the fused prefill's one barrier a tick.
//
// Numerics: expf/tanhf, no fast math; sums accumulate in k order with fma
// from 0, and the epilogues add in the same order on both routes (z, r:
// x + (U.h + b); the v1 candidate (x + U.(r*h)) + b, v3's x + r*(U.h + b);
// the update fma(1 - z, h, z*ht), the contraction nvcc picks for
// run_stack's (1 - z)*h + z*ht, written out in the warp route; the
// deep projection h @ W in k order by fma from 0 as run_stack's matvec),
// so the two routes compute the same expressions.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// out[r*ldo + j] = sum_k in[r*H + k] * w[k*ldw + j], r < bt, j < n.
// Thread i owns output column j = i % n of row r = i / n.
__device__ __forceinline__ void matvec(const float* in, const float* w,
                                       int ldw, int n, int H, int bt,
                                       float* out, int ldo) {
  for (int i = threadIdx.x; i < bt * n; i += blockDim.x) {
    const int r = i / n;
    const int j = i - r * n;
    const float* x = in + r * H;
    const float* wc = w + j;
    float acc = 0.0f;
    for (int k = 0; k < H; ++k) acc = fmaf(x[k], wc[k * ldw], acc);
    out[r * ldo + j] = acc;
  }
}

// The shared routine of all three kernels. Layouts (row-major, fp32):
//   h0     (L, B, H)        initial per-layer states
//   xp     (T, B, 3H)       layer-0 input projection, time-major
//   u      (L, H, 3H)       recurrent matrices, gates [z | r | h]
//   wd     (L-1, H, 3H)     input projections of layers 1..L-1
//   b      (L, 3H)
//   mask   (T, B) or null   nonzero = live step
//   out_seq (T, B, H) or null   last layer's state after every step
//   finals  (L, B, H) or null   every layer's state after step T-1
__device__ void run_stack(const float* h0, const float* xp, const float* u,
                          const float* wd, const float* b, const float* mask,
                          float* out_seq, float* finals, int T, int B, int H,
                          int L, int v3, int bt) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* su = smem;                       // (L, H, 3H)
  float* swd = su + L * H * H3;           // (L-1, H, 3H)
  float* sb = swd + (L - 1) * H * H3;     // (L, 3H)
  float* sh = sb + L * H3;                // (L, bt, H) per-layer state
  float* sg = sh + L * bt * H;            // (bt, 3H) gate pre-activations
  float* sx = sg + bt * H3;               // (bt, 3H) deep-layer input proj
  float* srh = sx + bt * H3;              // (bt, H) r*h (v1)
  float* sm2 = srh + bt * H;              // (2, bt) liveness, by step parity

  const int row0 = blockIdx.x * bt;
  const int nrow = min(bt, B - row0);

  for (int i = tid; i < L * H * H3; i += nt) su[i] = u[i];
  for (int i = tid; i < (L - 1) * H * H3; i += nt) swd[i] = wd[i];
  for (int i = tid; i < L * H3; i += nt) sb[i] = b[i];
  for (int i = tid; i < L * bt * H; i += nt) {
    const int l = i / (bt * H);
    const int rc = i - l * bt * H;
    const int r = rc / H;
    const int c = rc - r * H;
    sh[i] = r < nrow ? h0[((size_t)l * B + row0 + r) * H + c] : 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    // double-buffered: step t+1 writes the other half while step t's last
    // epilogue may still read this one
    float* sm = sm2 + (t & 1) * bt;
    if (tid < bt) {
      sm[tid] = tid >= nrow ? 0.0f
                : mask == nullptr ? 1.0f
                : mask[(size_t)t * B + row0 + tid];
    }
    const float* xp_t = xp + ((size_t)t * B + row0) * H3;
    for (int l = 0; l < L; ++l) {
      float* hl = sh + l * bt * H;
      const float* ul = su + l * H * H3;
      const float* bl = sb + l * H3;
      const float* xin = l == 0 ? xp_t : sx;    // row stride 3H either way
      __syncthreads();  // weights, h, sm and sx are in place
      if (v3) {
        matvec(hl, ul, H3, H3, H, bt, sg, H3);
        __syncthreads();
        for (int i = tid; i < bt * H; i += nt) {
          const int r = i / H;
          const int c = i - r * H;
          if (r >= nrow) continue;
          const float* x = xin + r * H3;
          const float* g = sg + r * H3;
          const float z = sigmoid_f(x[c] + (g[c] + bl[c]));
          const float rr = sigmoid_f(x[H + c] + (g[H + c] + bl[H + c]));
          const float ht =
              tanhf(x[2 * H + c] + rr * (g[2 * H + c] + bl[2 * H + c]));
          const float hold = hl[i];
          const float hn = (1.0f - z) * hold + z * ht;
          hl[i] = sm[r] != 0.0f ? hn : hold;
        }
      } else {
        // phase 1: z and r from one (H, 2H) matvec
        matvec(hl, ul, H3, 2 * H, H, bt, sg, H3);
        __syncthreads();
        for (int i = tid; i < bt * H; i += nt) {
          const int r = i / H;
          const int c = i - r * H;
          float* g = sg + r * H3;
          float zv = 0.0f;
          float rh = 0.0f;
          if (r < nrow) {
            const float* x = xin + r * H3;
            zv = sigmoid_f(x[c] + (g[c] + bl[c]));
            rh = sigmoid_f(x[H + c] + (g[H + c] + bl[H + c])) * hl[i];
          }
          g[c] = zv;              // this thread alone reads g[c], g[H+c]
          srh[i] = rh;
        }
        __syncthreads();
        // phase 2: candidate matvec on r*h, into the h-gate columns of sg
        matvec(srh, ul + 2 * H, H3, H, H, bt, sg + 2 * H, H3);
        __syncthreads();
        for (int i = tid; i < bt * H; i += nt) {
          const int r = i / H;
          const int c = i - r * H;
          if (r >= nrow) continue;
          const float* x = xin + r * H3;
          const float* g = sg + r * H3;
          const float z = g[c];
          const float ht = tanhf((x[2 * H + c] + g[2 * H + c]) + bl[2 * H + c]);
          const float hold = hl[i];
          const float hn = (1.0f - z) * hold + z * ht;
          hl[i] = sm[r] != 0.0f ? hn : hold;
        }
      }
      if (l + 1 < L) {
        __syncthreads();
        // next layer's input projection, same step, from shared memory
        matvec(hl, swd + l * H * H3, H3, H3, H, bt, sx, H3);
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
gru_sequence_k(const float* h0, const float* xp, const float* u,
               const float* b, const float* mask, float* out, int T, int B,
               int H, int v3, int bt) {
  run_stack(h0, xp, u, nullptr, b, mask, out, nullptr, T, B, H, 1, v3, bt);
}

__global__ void __launch_bounds__(kThreads)
gru_stack_sequence_k(const float* h0, const float* xp, const float* u,
                     const float* wd, const float* b, const float* mask,
                     float* out, float* finals, int T, int B, int H, int L,
                     int v3, int bt) {
  run_stack(h0, xp, u, wd, b, mask, out, finals, T, B, H, L, v3, bt);
}

__global__ void __launch_bounds__(kThreads)
gru_stack_decode_k(const float* h, const float* xp, const float* u,
                   const float* wd, const float* b, float* out, int B, int H,
                   int L, int v3, int bt) {
  run_stack(h, xp, u, wd, b, nullptr, nullptr, out, 1, B, H, L, v3, bt);
}

// --- the warp routes ---------------------------------------------------------

constexpr int kWarpMaxH = 32;          // one output column a lane
constexpr unsigned kFullWarp = 0xffffffffu;

// How a warp's lanes see each other's values in a pass over k: at(r, k)
// is lane k's v[r] of the last put(v). By shuffle (row 1's route: each
// at() a __shfl_sync from lane k) or through a slot of shared memory per
// warp (the decode route: put() stores each lane's value once, and the
// pass reads the vector back as float4 broadcasts, 8 reads where the
// shuffles were 32; __syncwarp() on both sides of the store, so no lane
// overwrites a value another still reads). Both give the same values.
template <int R>
struct ShflBcast {
  float v[R];
  __device__ __forceinline__ void put(const float (&x)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = x[r];
  }
  __device__ __forceinline__ float at(int r, int k) const {
    return __shfl_sync(kFullWarp, v[r], k);
  }
};

template <int R>
struct SmemBcast {
  float* slot;                            // (R, 32) floats, 16-byte aligned
  int lane;
  __device__ __forceinline__ void put(const float (&x)[R]) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) slot[r * 32 + lane] = x[r];
    __syncwarp();
  }
  __device__ __forceinline__ float at(int r, int k) const {
    const float4 q = reinterpret_cast<const float4*>(slot + r * 32)[k >> 2];
    return (k & 3) == 0 ? q.x : (k & 3) == 1 ? q.y : (k & 3) == 2 ? q.z : q.w;
  }
};

// One GRU step of R batch rows by one warp (the warp routes' layer): lane
// c < H owns column c of every gate. x: the lane's three gate columns of
// the input projection, a row each; h: the lane's states; wt(k, g): lane
// c's weight of gate g in row k of U (U[k*3H + g*H + c]; 0 for k >= H);
// bc: how the pass sees h_k (and v1's r_k*h_k), see ShflBcast and
// SmemBcast; bz, br, bh: the lane's biases. Returns the new states in hn,
// unmasked.
//
// z and r (and v3's candidate) in one pass over k. All 32 k's, with no
// branch between them, so the broadcasts can all go out ahead of the fma
// chain; k >= H adds fma(h_k, +0): lane k >= H holds a finite h_k (+0 on
// row 1's route, whose lanes past H hold zeros throughout; a value no
// lane below H otherwise reads on the decode route), the product is +-0,
// and adding it leaves the sum (never -0) as it was, so the sums equal
// the block route's over k < H bit for bit.
template <int V3, int R, typename Wt, typename Bc>
__device__ __forceinline__ void warp_gru_step(const float (&x)[R][3],
                                              const float (&h)[R], Wt wt,
                                              Bc& bc, float bz, float br,
                                              float bh, float (&hn)[R]) {
  float az[R] = {}, ar[R] = {}, ah[R] = {}, z[R], ht[R];
  bc.put(h);
#pragma unroll
  for (int k = 0; k < kWarpMaxH; ++k) {
    const float uz = wt(k, 0), ur = wt(k, 1);
    const float uh = V3 ? wt(k, 2) : 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float hk = bc.at(r, k);
      az[r] = fmaf(hk, uz, az[r]);
      ar[r] = fmaf(hk, ur, ar[r]);
      if constexpr (V3) ah[r] = fmaf(hk, uh, ah[r]);
    }
  }
  if constexpr (V3) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      z[r] = sigmoid_f(x[r][0] + (az[r] + bz));
      const float rr = sigmoid_f(x[r][1] + (ar[r] + br));
      ht[r] = tanhf(x[r][2] + rr * (ah[r] + bh));
    }
  } else {      // v1: the candidate's pass over k, on lane c's r_c*h_c
    float rh[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      z[r] = sigmoid_f(x[r][0] + (az[r] + bz));
      rh[r] = sigmoid_f(x[r][1] + (ar[r] + br)) * h[r];
    }
    bc.put(rh);
#pragma unroll
    for (int k = 0; k < kWarpMaxH; ++k) {     // k >= H: weight 0
      const float uh = wt(k, 2);
#pragma unroll
      for (int r = 0; r < R; ++r) ah[r] = fmaf(bc.at(r, k), uh, ah[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) ht[r] = tanhf((x[r][2] + ah[r]) + bh);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    // (1 - z)*h + z*ht contracted as nvcc contracts it in run_stack (its
    // SASS: FMUL z*ht, then FFMA (1 - z), h), so that the routes round
    // alike; left to itself nvcc contracts the other product here
    hn[r] = __fmaf_rn(1.0f - z[r], h[r], __fmul_rn(z[r], ht[r]));
}

// One lane's operands of step t: its three gate columns of xp for each of
// its R rows and the rows' liveness (0 for a row past B).
template <int R>
__device__ __forceinline__ void load_step(float (&x)[R][3], float (&m)[R],
                                          const float* __restrict__ xp,
                                          const float* __restrict__ mask,
                                          int t, int B, int H, int row0,
                                          int nrow, bool col, int c) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = r < nrow;
    const size_t row = (size_t)t * B + row0 + r;
    const float* xr = xp + row * 3 * H + c;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      x[r][g] = in && col ? __ldg(xr + g * H) : 0.0f;
    m[r] = !in ? 0.0f : mask == nullptr ? 1.0f : __ldg(mask + row);
  }
}

// Depth-1 GRU over T steps, one warp per R batch rows (the source note's
// warp route): lane c < H owns column c of every gate. The warps of a
// block take neighbouring rows; a warp past B exits whole, so every lane
// of a live warp takes part in every shuffle. D: steps of xp and mask in
// flight ahead of the step that reads them.
template <int V3, int R, int D>
__global__ void __launch_bounds__(kThreads)
gru_sequence_warp_k(const float* __restrict__ h0,
                    const float* __restrict__ xp,
                    const float* __restrict__ u,
                    const float* __restrict__ b,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int T, int B, int H) {
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * R;
  if (row0 >= B) return;
  const int nrow = min(R, B - row0);
  const bool col = lane < H;
  const int c = col ? lane : 0;
  const int H3 = 3 * H;

  float uz[kWarpMaxH], ur[kWarpMaxH], uh[kWarpMaxH];
#pragma unroll
  for (int k = 0; k < kWarpMaxH; ++k) {
    const bool in = col && k < H;
    const float* uk = u + (size_t)k * H3 + c;
    uz[k] = in ? __ldg(uk) : 0.0f;
    ur[k] = in ? __ldg(uk + H) : 0.0f;
    uh[k] = in ? __ldg(uk + 2 * H) : 0.0f;
  }
  const auto wt = [&](int k, int g) {
    return g == 0 ? uz[k] : g == 1 ? ur[k] : uh[k];
  };
  const float bz = col ? __ldg(b + c) : 0.0f;
  const float br = col ? __ldg(b + H + c) : 0.0f;
  const float bh = col ? __ldg(b + 2 * H + c) : 0.0f;
  float h[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    h[r] = col && r < nrow ? __ldg(h0 + (size_t)(row0 + r) * H + c) : 0.0f;

  float ring_x[D][R][3], ring_m[D][R];     // slot t % D holds step t
#pragma unroll
  for (int i = 0; i < D; ++i)
    if (i < T)
      load_step<R>(ring_x[i], ring_m[i], xp, mask, i, B, H, row0, nrow, col,
                   c);

  for (int t0 = 0; t0 < T; t0 += D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int t = t0 + i;
      if (t >= T) break;
      float x[R][3], m[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] = ring_m[i][r];
#pragma unroll
        for (int g = 0; g < 3; ++g) x[r][g] = ring_x[i][r][g];
      }
      if (t + D < T)       // refill the slot just read, D steps ahead
        load_step<R>(ring_x[i], ring_m[i], xp, mask, t + D, B, H, row0, nrow,
                     col, c);
      float hn[R];
      ShflBcast<R> bc;
      warp_gru_step<V3, R>(x, h, wt, bc, bz, br, bh, hn);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        h[r] = m[r] != 0.0f ? hn[r] : h[r];
        if (col && r < nrow) out[((size_t)t * B + row0 + r) * H + c] = h[r];
      }
    }
  }
}

// --- the decode warp route --------------------------------------------------

constexpr int kDecodeMaxLayers = 4;    // the deepest stack the route takes

// Lane c's columns of a (H, 3H) matrix at m (the matrix plus c) in device
// memory: w[g][k] = m[k*3H + g*H], 0 for k >= H, loaded in one burst ahead
// of the pass that reads them. (Read inside the pass, one load before each
// fma, every k waited for its load: 2-5 us a layer.) The loads are plain
// coherent ld.global, and a __syncwarp() closes the burst: ptxas may not
// move such a load past the barrier. Through __ldg (ld.global.nc), which
// it may move, ptxas put each load just before the fma that reads it (43
// registers at H = 32, where the burst holds 96 values) and the pass
// waited on each in turn: 10.4 us a launch for v3 at L=3 H=32 on an H100
// against 4.2. With H a compile-time constant each load is one instruction
// at an immediate offset; with H at run time each also computes its
// address and predicate (a burst of 96 took about 770 cycles where its
// pass takes 190). A lane past H reads column 0 (its m is the matrix
// itself), unpredicated: a per-lane predicate tripled the burst at H = 20.
// Its sums are finite garbage that no lane below H reads: those lanes
// weigh every k >= H by an exact 0, and it stores nothing.
template <int HT>
__device__ __forceinline__ void load_cols(float (&w)[3][kWarpMaxH],
                                          const float* m, int H) {
  if constexpr (HT) H = HT;
#pragma unroll
  for (int k = 0; k < kWarpMaxH; ++k)
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      if (k < H)
        asm volatile("ld.global.f32 %0, [%1];"
                     : "=f"(w[g][k])
                     : "l"(m + k * 3 * H + g * H));
      else
        w[g][k] = 0.0f;
    }
  __syncwarp();
}

// The next layer's input projection of one row by one warp: p[g] = sum_k
// h_k W[k*3H + g*H + c] over k in order by fma from 0, as run_stack's
// matvec sums; h_k as bc gives it, and wt(k, g) is 0 for k >= H, as in
// warp_gru_step.
template <typename Wt, typename Bc>
__device__ __forceinline__ void warp_project(float h, Wt wt, Bc& bc,
                                             float (&p)[3]) {
  const float hv[1] = {h};
  bc.put(hv);
  p[0] = p[1] = p[2] = 0.0f;
#pragma unroll
  for (int k = 0; k < kWarpMaxH; ++k) {
    const float hk = bc.at(0, k);
#pragma unroll
    for (int g = 0; g < 3; ++g) p[g] = fmaf(hk, wt(k, g), p[g]);
  }
}

// One token through L <= kDecodeMaxLayers layers, one warp a batch row
// (the source note's decode warp route). Layouts as run_stack's (T = 1, no
// mask). Lane c < H owns column c of every gate in every layer; HT is H at
// compile time (the served 20 and 32) or 0 (any H <= 32, at run time).
//
// The weights: before each pass the warp loads lane c's 96 columns of the
// pass's matrix (U_l, then W_l) from device memory into registers in one
// burst (load_cols). (Staging every matrix in shared memory at entry by
// bulk copies, one mbarrier each, bought nothing over these reads.)
//
// The pass: h (and v1's r*h) reaches the lanes through the warp's slot of
// shared memory, as float4 broadcasts (SmemBcast; 32 shuffles a pass took
// 1.4x as long). Layer l+1's input projection h_l' @ W_l is the same warp's
// pass over k (three sums by fma in k order from 0, as run_stack's matvec
// sums), so it reaches the next layer in registers; each layer's h[c] and
// b are loaded one layer ahead. Nothing on the layer chain waits at a
// __syncthreads().
template <int V3, int HT>
__global__ void __launch_bounds__(kThreads)
gru_stack_decode_warp_k(const float* __restrict__ h,
                        const float* __restrict__ xp,
                        const float* __restrict__ u,
                        const float* __restrict__ wd,
                        const float* __restrict__ b, float* __restrict__ out,
                        int B, int H, int L) {
  if constexpr (HT) H = HT;
  __shared__ __align__(16) float sbc[kThreads];   // each warp's 32 slots
  const int H3 = 3 * H;
  const int n = H * H3;                   // floats of one matrix
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B) return;      // a warp past B
  const bool col = lane < H;
  const int c = col ? lane : 0;
  SmemBcast<1> bc{sbc + (threadIdx.x & ~31), lane};

  // layer 0's operands now, each later layer's h[c] and b one layer ahead
  // (issued before the layer's weight loads, so they land while it runs)
  float x[1][3], hl = 0.0f, bias[3] = {};
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    x[0][g] = col ? __ldg(xp + (size_t)row * H3 + g * H + c) : 0.0f;
    bias[g] = col ? __ldg(b + g * H + c) : 0.0f;
  }
  if (col) hl = __ldg(h + (size_t)row * H + c);

  float w[3][kWarpMaxH];     // lane c's columns of the matrix of the pass
  const auto wt = [&](int k, int g) { return w[g][k]; };
  for (int l = 0; l < L; ++l) {
    const bool ahead = col && l + 1 < L;
    const float h_next =
        ahead ? __ldg(h + ((size_t)(l + 1) * B + row) * H + c) : 0.0f;
    float b_next[3];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      b_next[g] = ahead ? __ldg(b + (size_t)(l + 1) * H3 + g * H + c) : 0.0f;
    load_cols<HT>(w, u + (size_t)l * n + c, H);
    const float hold[1] = {hl};
    float hn[1];
    warp_gru_step<V3, 1>(x, hold, wt, bc, bias[0], bias[1], bias[2], hn);
    if (col) out[((size_t)l * B + row) * H + c] = hn[0];
    if (l + 1 < L) {         // the next layer's input projection, in-warp
      load_cols<HT>(w, wd + (size_t)l * n + c, H);
      float p[3];
      warp_project(hn[0], wt, bc, p);
#pragma unroll
      for (int g = 0; g < 3; ++g) x[0][g] = p[g];
    }
    hl = h_next;
#pragma unroll
    for (int g = 0; g < 3; ++g) bias[g] = b_next[g];
  }
}

// --- the fused prefill's warp route: a layer-skewed wavefront ---------------

constexpr int kSeqMaxLayers = 4;       // the deepest stack the route takes
constexpr int kLaneCols = 3 * kWarpMaxH;   // a projection's 3 gates x 32 lanes
// A block's slots for the deepest stack: each layer's h by step parity,
// each projection's by step parity, each gate warp's r*h (3.75 KB).
constexpr int kSeqSlotFloats = kSeqMaxLayers * 64 +
                               (kSeqMaxLayers - 1) * 2 * kLaneCols +
                               kSeqMaxLayers * 32;

// The block's barrier between two ticks. Warps of different roles reach it
// from different places in the code, so it is the non-aligned form (a
// __syncthreads() is bar.sync.aligned, which all threads must reach at
// the same instruction).
__device__ __forceinline__ void tick_barrier() {
  asm volatile("barrier.sync 0;" ::: "memory");
}

// How a consumer's pass over k sees a row that another warp left in a
// slot of shared memory: SmemBcast's float4 broadcasts of the slot, with
// nothing to put (the producer stored it before the tick's barrier).
struct SlotRead : SmemBcast<1> {
  __device__ __forceinline__ void put(const float (&)[1]) {}
};

// How a gate warp's passes over k see h_k and v1's r_k*h_k: h straight
// from the layer's h slot, where the warp stored it the tick before (a
// barrier between), so the first put stores nothing; r*h through the
// warp's own slot, as SmemBcast puts it.
struct GateBcast : SmemBcast<1> {
  float* rh;
  bool first = true;
  __device__ __forceinline__ void put(const float (&x)[1]) {
    if (!first) {
      SmemBcast<1>{rh, lane}.put(x);
      slot = rh;
    }
    first = false;
  }
};

// L layers over T steps for one batch row a block, on a wavefront skewed
// by layer (the source note's prefill warp route). Layouts as run_stack's.
// The block has 2L - 1 warps: at even positions q = 2l the gate warp of
// layer l (its U in registers), between two layers the projection warp of
// layer l (q = 2l + 1, its W_l in registers). Warp q runs step j - q at
// tick j, and a barrier ends every tick, so the chain is T + 2(L - 1)
// ticks of one pass over k each (two for a v1 gate step), where the block
// route's is T x L layer-steps of several barriers each.
//
// Layer l's new h (its gated output: a masked row keeps its pre-step h,
// and the projection consumes that) goes to slot (t & 1) of the layer's
// two; the projection warp reads it in the next tick, and so does the gate
// warp's own next step; the gate warp writes the slot again two ticks on,
// after those reads and a barrier. The projection (three sums in k order
// by fma from 0, as run_stack's matvec) goes to layer l+1 the same way.
// Nothing on the chain goes through device memory: every gate warp loads
// the next tick's mask, and layer 0's its xp, one tick ahead into
// registers; the top layer stores out[t] and each gate warp its layer's
// finals.
//
// Written for ptxas, as timed on an H100 (PERF.md, Findings): the launch
// bounds ask for one block an SM, or ptxas may fit the v1 instance at
// H = 32 into 128 registers beside the weights' 96 and recompute its
// addresses every tick, which was slower; q comes from lane 0 by shuffle,
// so the slot addresses it gives stay in registers and are not rebuilt
// from threadIdx at every tick, which was slower too. Two or four rows a
// block, xp two or four ticks ahead, or W staged in shared memory for the
// next gate warp to project were no faster.
//
// A lane past H works on column 0's weights (load_cols): its values stay
// finite and every lane below H weighs them by an exact 0, so the sums
// equal run_stack's bit for bit, as warp_gru_step's note says.
template <int V3, int HT>
__global__ void __launch_bounds__(kThreads, 1)
gru_stack_sequence_warp_k(const float* __restrict__ h0,
                          const float* __restrict__ xp,
                          const float* __restrict__ u,
                          const float* __restrict__ wd,
                          const float* __restrict__ b,
                          const float* __restrict__ mask,
                          float* __restrict__ out,
                          float* __restrict__ finals, int T, int B, int H,
                          int L) {
  if constexpr (HT) H = HT;
  __shared__ __align__(16) float smem[kSeqSlotFloats];
  const int H3 = 3 * H;
  const int n = H * H3;                   // floats of one matrix
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
  float* ps = hs + L * 64;                // (L-1, 2, 96) projections
  float* bs = ps + (L - 1) * 2 * kLaneCols;   // (L, 32) r*h slots

  float w[3][kWarpMaxH];     // lane c's columns of U_l, or of W_l
  load_cols<HT>(w, (proj ? wd : u) + (size_t)l * n + c, H);
  const auto wt = [&](int k, int g) { return w[g][k]; };
  float* hslot = hs + l * 64;             // layer l's two h slots

  if (proj) {                // layer l's new h -> layer l+1's input
    float* pslot = ps + l * 2 * kLaneCols;
    for (int j = 0; j < ticks; ++j) {
      const int t = j - q;
      if (t >= 0 && t < T) {
        SlotRead sr{{hslot + (t & 1) * 32, lane}};
        float p[3];
        warp_project(0.0f, wt, sr, p);
#pragma unroll
        for (int g = 0; g < 3; ++g)
          pslot[(t & 1) * kLaneCols + g * 32 + lane] = p[g];
      }
      tick_barrier();
    }
    return;
  }

  const float bz = col ? __ldg(b + (size_t)l * H3 + c) : 0.0f;
  const float br = col ? __ldg(b + (size_t)l * H3 + H + c) : 0.0f;
  const float bh = col ? __ldg(b + (size_t)l * H3 + 2 * H + c) : 0.0f;
  float hc = col ? __ldg(h0 + ((size_t)l * B + row) * H + c) : 0.0f;
  float* rslot = bs + l * 32;
  hslot[32 + lane] = hc;                  // h0, in the slot of step -1
  __syncwarp();
  const float* pin = ps + (l > 0 ? l - 1 : 0) * 2 *
                              kLaneCols;  // layer l-1's projections

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
    float x[1][3] = {}, m = 0.0f;
    if (act) {
      m = nm;
#pragma unroll
      for (int g = 0; g < 3; ++g) x[0][g] = nx[g];
    }
    fetch(nx, nm, j + 1);
    if (act) {
      if (l > 0) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
          x[0][g] = pin[(t & 1) * kLaneCols + g * 32 + lane];
      }
      const float hold[1] = {hc};
      float hn[1];
      GateBcast bc{{hslot + ((t - 1) & 1) * 32, lane}, rslot};
      warp_gru_step<V3, 1>(x, hold, wt, bc, bz, br, bh, hn);
      hc = m != 0.0f ? hn[0] : hc;
      hslot[(t & 1) * 32 + lane] = hc;
      if (col && l == L - 1) out[((size_t)t * B + row) * H + c] = hc;
    }
    tick_barrier();
  }
  if (col) finals[((size_t)l * B + row) * H + c] = hc;
}

size_t smem_bytes(int L, int H, int bt) {
  const size_t H3 = 3 * (size_t)H;
  const size_t floats = (size_t)L * H * H3 + (size_t)(L - 1) * H * H3 +
                        L * H3 + (size_t)L * bt * H + 2 * bt * H3 +
                        (size_t)bt * H + 2 * (size_t)bt;
  return floats * sizeof(float);
}

// Above 48 KB a block's shared memory must be opted into per kernel and
// device; `configured` remembers the size already allowed on each device,
// so the attribute is set once, not on every launch.
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
size_t stack_smem[kMaxDevices];
size_t decode_smem[kMaxDevices];

// f(std::integral_constant<int, N>()) for n in {1, 2, 4, 8} up to Most
// (the warp route's rows a warp and prefetch depth); only those are
// instantiated.
template <int Most, typename F>
int by_pow2(int n, F&& f) {
  switch (n) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: if constexpr (Most >= 2) return f(std::integral_constant<int, 2>());
            break;
    case 4: if constexpr (Most >= 4) return f(std::integral_constant<int, 4>());
            break;
    case 8: if constexpr (Most >= 8) return f(std::integral_constant<int, 8>());
            break;
  }
  return (int)cudaErrorInvalidValue;
}

constexpr int kWarpMaxRows = 2;
constexpr int kWarpMaxDepth = 8;

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int gru_sequence_launch(const float* h0, const float* xp,
                                   const float* u, const float* b,
                                   const float* mask, float* out, int T, int B,
                                   int H, int v3, int bt, void* stream) {
  const size_t bytes = smem_bytes(1, H, bt);
  int err = allow_smem(gru_sequence_k, bytes, seq_smem);
  if (err) return err;
  gru_sequence_k<<<(B + bt - 1) / bt, kThreads, bytes,
                   (cudaStream_t)stream>>>(h0, xp, u, b, mask, out, T, B, H,
                                           v3, bt);
  return (int)cudaGetLastError();
}

extern "C" int gru_stack_sequence_launch(const float* h0, const float* xp,
                                         const float* u, const float* wd,
                                         const float* b, const float* mask,
                                         float* out, float* finals, int T,
                                         int B, int H, int L, int v3, int bt,
                                         void* stream) {
  const size_t bytes = smem_bytes(L, H, bt);
  int err = allow_smem(gru_stack_sequence_k, bytes, stack_smem);
  if (err) return err;
  gru_stack_sequence_k<<<(B + bt - 1) / bt, kThreads, bytes,
                         (cudaStream_t)stream>>>(h0, xp, u, wd, b, mask, out,
                                                 finals, T, B, H, L, v3, bt);
  return (int)cudaGetLastError();
}

extern "C" int gru_stack_decode_launch(const float* h, const float* xp,
                                       const float* u, const float* wd,
                                       const float* b, float* out, int B,
                                       int H, int L, int v3, int bt,
                                       void* stream) {
  const size_t bytes = smem_bytes(L, H, bt);
  int err = allow_smem(gru_stack_decode_k, bytes, decode_smem);
  if (err) return err;
  gru_stack_decode_k<<<(B + bt - 1) / bt, kThreads, bytes,
                       (cudaStream_t)stream>>>(h, xp, u, wd, b, out, B, H, L,
                                               v3, bt);
  return (int)cudaGetLastError();
}

// The warp route of the depth-1 sequence: `rows` batch rows a warp (1 or
// 2), `warps` warps a block (1 to 8), xp and mask `depth` steps ahead (1,
// 2, 4 or 8); H at most 32.
extern "C" int gru_sequence_warp_launch(const float* h0, const float* xp,
                                        const float* u, const float* b,
                                        const float* mask, float* out, int T,
                                        int B, int H, int v3, int rows,
                                        int warps, int depth, void* stream) {
  if (H < 1 || H > kWarpMaxH || warps < 1 || warps > kThreads / 32)
    return (int)cudaErrorInvalidValue;
  const int nwarps = (B + rows - 1) / rows;
  const dim3 grid((nwarps + warps - 1) / warps);
  cudaStream_t st = (cudaStream_t)stream;
  return by_pow2<kWarpMaxRows>(rows, [&](auto rc) {
    return by_pow2<kWarpMaxDepth>(depth, [&](auto dc) {
      constexpr int R = decltype(rc)::value, D = decltype(dc)::value;
      if (v3)
        gru_sequence_warp_k<1, R, D><<<grid, 32 * warps, 0, st>>>(
            h0, xp, u, b, mask, out, T, B, H);
      else
        gru_sequence_warp_k<0, R, D><<<grid, 32 * warps, 0, st>>>(
            h0, xp, u, b, mask, out, T, B, H);
      return (int)cudaGetLastError();
    });
  });
}

// The warp route of the fused decode: `warps` warps a block, one batch row
// each. H at most 32 (20 and 32 compiled as constants), L at most
// kDecodeMaxLayers.
extern "C" int gru_stack_decode_warp_launch(const float* h, const float* xp,
                                            const float* u, const float* wd,
                                            const float* b, float* out,
                                            int B, int H, int L, int v3,
                                            int warps, void* stream) {
  if (H < 1 || H > kWarpMaxH || L < 1 || L > kDecodeMaxLayers ||
      warps < 1 || warps > kThreads / 32)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + warps - 1) / warps);
  cudaStream_t st = (cudaStream_t)stream;
  const auto go = [&](auto kernel) {
    kernel<<<grid, 32 * warps, 0, st>>>(h, xp, u, wd, b, out, B, H, L);
    return (int)cudaGetLastError();
  };
  const auto width = [&](auto v3c) {
    constexpr int V = decltype(v3c)::value;
    if (H == 32) return go(gru_stack_decode_warp_k<V, 32>);
    if (H == 20) return go(gru_stack_decode_warp_k<V, 20>);
    return go(gru_stack_decode_warp_k<V, 0>);
  };
  return v3 ? width(std::integral_constant<int, 1>())
            : width(std::integral_constant<int, 0>());
}

// The warp route of the fused prefill: a block of 2L - 1 warps per batch
// row. H at most 32 (32 compiled as a constant), L at most kSeqMaxLayers;
// its 3.75 KB of shared memory is static.
extern "C" int gru_stack_sequence_warp_launch(
    const float* h0, const float* xp, const float* u, const float* wd,
    const float* b, const float* mask, float* out, float* finals, int T,
    int B, int H, int L, int v3, void* stream) {
  if (H < 1 || H > kWarpMaxH || L < 1 || L > kSeqMaxLayers)
    return (int)cudaErrorInvalidValue;
  const dim3 block(32 * (2 * L - 1));
  cudaStream_t st = (cudaStream_t)stream;
  const auto go = [&](auto kernel) {
    kernel<<<B, block, 0, st>>>(h0, xp, u, wd, b, mask, out, finals, T, B,
                                H, L);
    return (int)cudaGetLastError();
  };
  const auto width = [&](auto v3c) {
    constexpr int V = decltype(v3c)::value;
    if (H == 32) return go(gru_stack_sequence_warp_k<V, 32>);
    return go(gru_stack_sequence_warp_k<V, 0>);
  };
  return v3 ? width(std::integral_constant<int, 1>())
            : width(std::integral_constant<int, 0>());
}
