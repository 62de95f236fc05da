// Fused sLSTM stack recurrences for Hopper (sm_90a), fp32.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/slstm_cell/kernel.py:
//   slstm_stack_sequence_k <- slstm_stack_sequence_kernel (masked prefill)
//   slstm_stack_decode_k   <- slstm_stack_decode_kernel   (one token)
// Both run one shared routine, run_stack(), and compute what the TPU
// kernels compute: per layer and step, gates [z, i, f, o] = x_proj + h.U
// + b, the exponential input and forget gates under the running
// log-scale stabilizer m, and the four state leaves c, n, m, h.
//
// Translation. The TPU walks a sequential time grid and carries the four
// leaves in VMEM scratch. Here the time loop and the layer loop run
// INSIDE one block, and the grid runs over independent batch tiles of `bt`
// rows. Each block copies U, the deep layers' W and b into shared memory
// once (cp.async, 16-byte pieces where aligned) and keeps them for the
// whole loop. c, n and m of every layer stay in shared memory, each
// element owned by one thread for the whole launch; h is double-buffered
// by step parity, so a layer-step is ONE phase ended by ONE barrier: the
// thread that owns (row, unit) computes all four gate sums of that unit
// (the U dot over the layer's old h, and for layers above 0 the W dot over
// the layer below's new h, read from shared memory, never from device
// memory), applies the update, and writes the new h into the other
// buffer. The layer-0 x_proj slab and the mask of step t+1 are copied
// into shared memory (cp.async) while step t runs. A masked row keeps all
// four leaves (select, never a perturbation), and the next layer consumes
// its frozen h.
//
// Shared-memory layout: U, W_deep and b dense (16-byte aligned, the
// copies' unit); each thread reads U[k][g*H + c] for its own c, so a warp
// reads consecutive words. h rows sit at an odd word stride (H | 1): the
// threads of one row read the same word (a broadcast), and two rows in one
// warp then always fall on different banks.
//
// Bound on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): per row, layer and
// step 8*H*H flops for U (and 8*H*H for W below the top) over a few to a
// hundred KB of weights, so both bounds are tens of nanoseconds at the
// serving shapes and a launch costs microseconds. The kernel is bound by
// latency: the launch, the weight copy into shared memory, and the chain
// of one dot product and one barrier per layer-step. The design answers
// that as the TPU kernel does: one launch for the whole recurrence,
// weights read from device memory once per block, no state in device
// memory between steps, and one barrier per layer-step.
//
// Numerics: expf/tanhf/log1pf, no fast math; dot products accumulate in k
// order with fma; log_sigmoid is the stable -softplus(-f); the forget term
// keeps JAX's order exp((logf + m) - m'), so a first step from
// m = M_INIT = -1e30 gives exactly 0.

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
        float x0, x1, x2, x3;
        if (l == 0) {
          const float* xr = xs + r * H4 + c;
          x0 = xr[0];
          x1 = xr[H];
          x2 = xr[2 * H];
          x3 = xr[3 * H];
        } else {  // the layer below's new h times its W, from shared memory
          const float* hb = hnew + ((l - 1) * bt + r) * ldh;
          const float* wl = swd + (size_t)(l - 1) * H * H4 + c;
          x0 = x1 = x2 = x3 = 0.0f;
          for (int k = 0; k < H; ++k) {
            const float hk = hb[k];
            const float* w = wl + k * H4;
            x0 = fmaf(hk, w[0], x0);
            x1 = fmaf(hk, w[H], x1);
            x2 = fmaf(hk, w[2 * H], x2);
            x3 = fmaf(hk, w[3 * H], x3);
          }
        }
        const int s = (l * bt + r) * H + c;
        float hv = hr[c];
        if (live[r] != 0.0f) {
          // JAX's order: g = (x_proj + h.U) + b
          const float z = (x0 + a0) + bl[c];
          const float ig = (x1 + a1) + bl[H + c];
          const float f = (x2 + a2) + bl[2 * H + c];
          const float o = (x3 + a3) + bl[3 * H + c];
          const float lm = log_sigmoid_f(f) + sm[s];
          const float m_new = fmaxf(lm, ig);
          const float i_ = expf(ig - m_new);
          const float f_ = expf(lm - m_new);
          const float c_new = f_ * sc[s] + i_ * tanhf(z);
          const float n_new = f_ * sn[s] + i_;
          hv = sigmoid_f(o) * c_new / fmaxf(n_new, 1e-6f);
          sc[s] = c_new;
          sn[s] = n_new;
          sm[s] = m_new;
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
