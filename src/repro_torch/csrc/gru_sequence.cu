// Fused GRU recurrences for Hopper (sm_90a), fp32.
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/gru_sequence/kernel.py:
//   gru_sequence_warp_k (warp route),
//   gru_sequence_k (block route) <- gru_sequence_kernel   (depth-1 sequence)
//   gru_stack_sequence_k  <- gru_stack_sequence_kernel  (fused depth-L seq)
//   gru_stack_decode_k    <- gru_stack_decode_kernel    (one token, L layers)
// They compute what the TPU kernels compute for variant v1 (paper/Cho gate
// math, two phases per step) and v3 (one stacked U matvec per step).
//
// Translation. The TPU walks a sequential time grid and carries h in VMEM
// scratch. Here the time loop (and the layer loop) runs INSIDE the kernel,
// and the grid runs over independent batch rows (the decode kernel's
// "parallel" axis on the TPU). Two routes; the wrapper picks one by shape
// (seq_plan in kernels/gru_sequence/kernel.py):
// - "warp" (the depth-1 sequence at H <= 32, every served width): one
//   warp per R batch rows; lane c owns output column c of each gate and
//   keeps its 3H weights of U (U[k*3H + c], k < H; coalesced across the
//   lanes) in registers from entry on. h_k reaches every lane by
//   __shfl_sync from the lane that owns it; v1 runs the z/r phase, forms
//   r_c*h_c in lane c, broadcasts it the same way and runs the candidate
//   phase; v3 runs one phase of three accumulators. Nothing on the step
//   chain touches shared memory, waits at a barrier or waits for device
//   memory: each lane's xp columns and the row's liveness are loaded D
//   steps ahead into a register ring (slot t % D), and out[t] is stored
//   as the step ends (coalesced; nothing reads it back). No branch splits
//   a pass over k: it runs all 32 lanes' k's, the lanes past H holding
//   zeros, so the shuffles go out ahead of the fma chain (a branch per k
//   made each k wait for its shuffle: 1.6 us a step at H=32 on an H100).
// - "block" (run_stack, shared by all three kernels; the depth-1 kernel
//   past H = 32): a block per tile of `bt` rows copies U, the deep layers'
//   W and b into shared memory once and keeps them for the whole loop (the
//   paper's row reuse). Every thread owns whole output columns of U (the
//   paper's row-wise split) and reads U[k*3H + j], so neighbouring threads
//   read neighbouring shared-memory words. The per-layer h lives in shared
//   memory; layer l+1 reads layer l's new h from there, never from device
//   memory. A masked row keeps its pre-step h in every layer, and the next
//   layer consumes that gated output.
//
// Bound on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): the work is a chain
// of tiny matvecs (2*3H*H flops per row, layer and step) over a few tens
// of KB of weights, so both the byte bound and the flop bound are tens of
// nanoseconds at the serving shapes; a launch costs microseconds. Both
// routes are bound by latency instead. The block route's step is four
// __syncthreads() with a block-wide matvec between each pair, and a trip
// to L2 for the step's xp and mask inside the chain; its U copy and
// barrier come before step 0. The warp route's step is H dependent fmas
// per accumulator (the shuffles of h do not wait on them) and the gate
// math, twice for v1; its only trip to memory that the chain waits for is
// the load of U and of the first D steps at entry.
//
// Numerics: expf/tanhf, no fast math; sums accumulate in k order with fma
// from 0, and the epilogues add in the same order on both routes (z, r:
// x + (U.h + b); the v1 candidate (x + U.(r*h)) + b, v3's x + r*(U.h + b);
// the update fma(1 - z, h, z*ht), the contraction nvcc picks for
// run_stack's (1 - z)*h + z*ht, written out in the warp route), so the
// two routes compute the same expressions.

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

// --- the warp route ----------------------------------------------------------

constexpr int kWarpMaxH = 32;          // one output column a lane
constexpr unsigned kFullWarp = 0xffffffffu;

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

      // z and r (and v3's candidate) in one pass over k. All 32 k's, with
      // no branch between them, so the shuffles can all go out ahead of
      // the fma chain; k >= H adds fma(+0, +0): lane k >= H holds h = +0
      // (its x, U and b are 0, so every step keeps it +0) and u[k] = 0,
      // and an fma of +0 leaves the sum (never -0) as it was, so the sums
      // equal the block route's over k < H bit for bit.
      float az[R] = {}, ar[R] = {}, ah[R] = {}, z[R], ht[R];
#pragma unroll
      for (int k = 0; k < kWarpMaxH; ++k) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hk = __shfl_sync(kFullWarp, h[r], k);
          az[r] = fmaf(hk, uz[k], az[r]);
          ar[r] = fmaf(hk, ur[k], ar[r]);
          if constexpr (V3) ah[r] = fmaf(hk, uh[k], ah[r]);
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
#pragma unroll
        for (int k = 0; k < kWarpMaxH; ++k)       // lane k >= H: rh = +0
#pragma unroll
          for (int r = 0; r < R; ++r)
            ah[r] = fmaf(__shfl_sync(kFullWarp, rh[r], k), uh[k], ah[r]);
#pragma unroll
        for (int r = 0; r < R; ++r) ht[r] = tanhf((x[r][2] + ah[r]) + bh);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float hold = h[r];
        // (1 - z)*h + z*ht contracted as nvcc contracts it in run_stack
        // (its SASS: FMUL z*ht, then FFMA (1 - z), h), so that the two
        // routes round alike; left to itself nvcc contracts the other
        // product here
        const float hn = __fmaf_rn(1.0f - z[r], hold, __fmul_rn(z[r], ht[r]));
        h[r] = m[r] != 0.0f ? hn : hold;
        if (col && r < nrow) out[((size_t)t * B + row0 + r) * H + c] = h[r];
      }
    }
  }
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
