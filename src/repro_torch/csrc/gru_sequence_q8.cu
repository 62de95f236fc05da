// Fused int8 (q8) GRU recurrences for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the q8 datapath in
// src/repro/kernels/gru_sequence/kernel.py:
//   gru_stack_sequence_q8_k  <- gru_stack_sequence_q8_kernel  (masked prefill)
//   gru_stack_decode_q8_k    <- gru_stack_decode_q8_kernel    (one token)
// Both run one shared routine, run_stack_q8(), which computes
// _gate_math_q8 for every layer, v1 (two phases) or v3, with the deep
// layers' input projection in int8 too.
//
// The arithmetic. Weights are int8 ROWS, u_q (L, 3H, H): one contiguous
// row per output element, per-row dequant scale eff (activation scale
// folded in). Activations use the fixed scale 127: q = clip(rint(a * 127),
// -127, 127), rounding half to even as jnp.round/torch.round do (rintf,
// not roundf). Dot products accumulate in int32 with __dp4a, exact in any
// order. Dequant is acc * eff + b. The state h stays float32.
//
// Rounding. One float32 ulp in h can move rint(h * 127) across a half and
// change a gate pre-activation by max|row| / 127, so every float32
// expression that feeds a quantization or the state is written with
// __fmul_rn / __fadd_rn / __fsub_rn: nvcc never contracts those into an
// fma, and each op rounds on its own as in the JAX kernel and the plain
// PyTorch version (acc * eff + b; r * h before * 127; (1 - z) * h + z * ht;
// v3's x + r * ua). expf/tanhf without fast math.
//
// Translation, as in gru_sequence.cu: the time and layer loops run inside
// one block; the grid is over independent batch tiles of `bt` rows. Each
// block copies the int8 U and deep W, eff and b into shared memory once
// (gru-jet-deep: 9,216 + 6,144 B of int8, 3 KB of scales and bias). Rows
// are padded to a whole number of 4-byte words for __dp4a, and the row
// stride in words is made odd so the 32 threads of a warp, each on its own
// row, read 32 different banks. The per-layer h lives in shared memory;
// layer l+1 reads layer l's new (masked) h from there.
//
// Bound on an H100 (SXM): a few tens of KB of inputs (3.35 TB/s) and
// int8 MACs (1,979 TOP/s on the tensor cores) take tens of nanoseconds at
// the serving shapes; the kernel is bound by latency: the launch, the
// one-time weight copy and the __syncthreads() chain of each layer-step.
// Tensor-core IMMA (mma.sync s8) and a shorter chain are later work.

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

// int32 dot product of two int8 rows packed four to a word
__device__ __forceinline__ int dot_q8(const int* a, const int* w, int nw) {
  int acc = 0;
  for (int k = 0; k < nw; ++k) acc = __dp4a(a[k], w[k], acc);
  return acc;
}

__device__ __forceinline__ int words(int H) { return (H + 3) / 4; }

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

// The shared routine of both kernels. Layouts (row-major):
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
    if (tid < bt) {
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
      quantize_rows(hl, bt, H, sqh, nw);
      __syncthreads();
      if (v3) {
        for (int i = tid; i < bt * H; i += nt) {
          const int r = i / H;
          const int c = i - r * H;
          if (r >= nrow) continue;
          const int* a = sqh + r * nw;
          const float* x = xin + r * H3;
          const float gz = dequant(dot_q8(a, ul + c * ld, nw), el[c], bl[c]);
          const float gr = dequant(dot_q8(a, ul + (H + c) * ld, nw),
                                   el[H + c], bl[H + c]);
          const float gh = dequant(dot_q8(a, ul + (2 * H + c) * ld, nw),
                                   el[2 * H + c], bl[2 * H + c]);
          const float z = sigmoid_f(__fadd_rn(x[c], gz));
          const float rr = sigmoid_f(__fadd_rn(x[H + c], gr));
          const float ht = tanhf(__fadd_rn(x[2 * H + c], __fmul_rn(rr, gh)));
          const float hold = hl[i];
          const float hn = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), hold),
                                     __fmul_rn(z, ht));
          hl[i] = sm[r] != 0.0f ? hn : hold;
        }
      } else {
        // phase 1: z and r, and r*h quantized for the candidate
        for (int i = tid; i < bt * H; i += nt) {
          const int r = i / H;
          const int c = i - r * H;
          if (r >= nrow) continue;
          const int* a = sqh + r * nw;
          const float* x = xin + r * H3;
          const float gz = dequant(dot_q8(a, ul + c * ld, nw), el[c], bl[c]);
          const float gr = dequant(dot_q8(a, ul + (H + c) * ld, nw),
                                   el[H + c], bl[H + c]);
          sz[i] = sigmoid_f(__fadd_rn(x[c], gz));
          const float rr = sigmoid_f(__fadd_rn(x[H + c], gr));
          reinterpret_cast<int8_t*>(sqr + r * nw)[c] =
              q8_act(__fmul_rn(rr, hl[i]));
        }
        __syncthreads();
        // phase 2: candidate from q8(r*h), then the update
        for (int i = tid; i < bt * H; i += nt) {
          const int r = i / H;
          const int c = i - r * H;
          if (r >= nrow) continue;
          const float* x = xin + r * H3;
          const float cand =
              dequant(dot_q8(sqr + r * nw, ul + (2 * H + c) * ld, nw),
                      el[2 * H + c], bl[2 * H + c]);
          const float ht = tanhf(__fadd_rn(x[2 * H + c], cand));
          const float z = sz[i];
          const float hold = hl[i];
          const float hn = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), hold),
                                     __fmul_rn(z, ht));
          hl[i] = sm[r] != 0.0f ? hn : hold;
        }
      }
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

size_t stack_smem[kMaxDevices];
size_t decode_smem[kMaxDevices];

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
