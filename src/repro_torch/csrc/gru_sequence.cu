// Fused GRU recurrences for Hopper (sm_90a), fp32.
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/gru_sequence/kernel.py:
//   gru_sequence_k        <- gru_sequence_kernel        (depth-1 sequence)
//   gru_stack_sequence_k  <- gru_stack_sequence_kernel  (fused depth-L seq)
//   gru_stack_decode_k    <- gru_stack_decode_kernel    (one token, L layers)
// All three run one shared routine, run_stack(), and compute what the TPU
// kernels compute for variant v1 (paper/Cho gate math, two phases per
// step) and v3 (one stacked U matvec per step).
//
// Translation. The TPU walks a sequential time grid and carries h in VMEM
// scratch. Here the time loop and the layer loop run INSIDE one block, and
// the grid runs over independent batch tiles of `bt` rows (the decode
// kernel's "parallel" axis on the TPU). Each block copies U, the deep
// layers' W and b into shared memory once and keeps them for the whole
// loop (the paper's row reuse). Every thread owns whole output columns of
// U (the paper's row-wise split) and reads U[k*3H + j], so neighbouring
// threads read neighbouring shared-memory words. The per-layer h lives in
// shared memory; layer l+1 reads layer l's new h from there, never from
// device memory. A masked row keeps its pre-step h in every layer, and the
// next layer consumes that gated output.
//
// Bound on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): the work is a chain
// of tiny matvecs (2*3H*H flops per row, layer and step) over a few tens
// of KB of weights, so both the byte bound and the flop bound are tens of
// nanoseconds at the serving shapes; a launch costs microseconds. The
// kernel is therefore bound by latency: launch, the one-time weight copy
// into shared memory, and the __syncthreads() chain of each step. The
// design answers the bound the way the TPU kernel does: one launch for
// the whole recurrence, weights read from device memory once per block,
// no intermediate h in device memory. Making the chain shorter (warp-level
// phases, clusters, CUDA graphs) is later work.
//
// Numerics: expf/tanhf, no fast math; sums accumulate in k order with fma.

#include <cuda_runtime.h>

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
