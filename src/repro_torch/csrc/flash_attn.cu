// Blocked attention with an online softmax (flash attention, forward) for
// Hopper (sm_90a); fp32 or bf16 in, fp32 inside, the input's type out.
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attn/kernel.py (the prefill path of the dense
// LM), and computes what it computes: for each (b, q-head h, query row i)
//   o = softmax_k(q_i . k_j / sqrt(D) over the valid j) . v
// with q (B,Hq,Sq,D), k and v (B,Hkv,Sk,D), GQA mapping q-head h to
// kv-head h / (Hq/Hkv), a key valid when j < Sk, and (causal) i >= j,
// and (window > 0) i - j < window. A row with no valid key gives 0 (the
// TPU kernel's l == 0 -> 1 guard).
//
// Translation. The TPU grid (b, h, q block, kv block) walks the kv blocks
// in order and carries m, l and acc in VMEM scratch. Here one block owns
// (b, h, a tile of kBQ query rows), and the kv sweep is a loop inside it:
// the q tile (scaled) sits in shared memory for the whole sweep, each kv
// tile of kBK keys is copied into shared memory once, converted to fp32,
// and m, l and acc live in registers of the threads that own the row. A
// kv tile wholly above the diagonal or wholly outside the window is
// skipped by the same block-level test as the TPU kernel's pl.when, and
// each element is masked as there, so skipping changes no bit.
//
// Tiles are copied with 16-byte vector loads, K's and V's issued
// together (attn_tile.cuh), so the copy waits on device-memory latency
// about once per tile rather than once per element.
//
// Work split (256 threads, 8 warps): warp w owns query rows 4w..4w+3 for
// the whole sweep, so after the tile copy a warp works alone (warp
// barriers only). Scores: each lane computes the 4 rows x 2 keys (lane,
// lane + 32) as fma chains over d, reading q (a broadcast) and k as
// 16-byte shared loads. Softmax: eight lanes per row, three xor-shuffles
// for its max and sum. P.V: each lane owns 4 rows x 4 columns of acc, in
// registers, reading P as broadcasts and one 16-byte V row piece per key.
// The rows of q and k are padded to Dp + 4 words (Dp = D rounded up to 4,
// the pad zero), so 16-byte loads stay aligned and a warp's k loads fall
// on different banks; P rows to kBK + 8 words.
//
// Bound on an H100 (SXM, 3.35 TB/s; 989 TFLOP/s bf16 and 67 TFLOP/s fp32
// dense): 4*D flops per valid (query, key) pair and head, over 2 bytes
// (bf16) of q, k, v and out per element. At the served prefill shapes
// (S = 12..128, D = 128) both bounds are well under a microsecond and the
// kernel is bound by its launch and by latency; at S = 2048 causal the
// flops bound it (about 17 GFLOP per batch row). This first kernel does
// its products on the CUDA cores in fp32 (no tensor cores, no TMA); the
// tensor-core (wgmma) version is later work.
//
// Numerics: q is scaled first (q * scale, scale from the wrapper in fp32,
// as the TPU kernel's q * scale), scores and P.V accumulate in d and key
// order with fma, expf without fast math, and the output divides by l.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

using attn::TileSrc;

constexpr int kThreads = 256;
constexpr int kBQ = 32;             // query rows per block (4 per warp)
constexpr int kBK = 64;             // keys per kv tile
constexpr int kMaxD = 128;          // 32 lanes x 4 columns
constexpr int kLdP = kBK + 8;       // P row stride (words)
constexpr float kNegInf = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ __forceinline__ int padded(int D) { return (D + 3) & ~3; }

__host__ __device__ __forceinline__ size_t smem_floats(int D) {
  const int Dp = padded(D);
  return (size_t)(kBQ + kBK) * (Dp + 4) + (size_t)kBK * Dp +
         (size_t)kBQ * kLdP;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as astype
}

__device__ __forceinline__ bool valid_key(int qpos, int kpos, int Sk,
                                          int causal, int window) {
  bool ok = kpos < Sk;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_k(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv, int Sq,
    int Sk, int D, int causal, int window, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = padded(D), ldq = Dp + 4;
  float* Qs = smem;                    // [kBQ][Dp+4], scaled q
  float* Ks = Qs + kBQ * ldq;          // [kBK][Dp+4]
  float* Vs = Ks + kBK * ldq;          // [kBK][Dp]
  float* Ps = Vs + kBK * Dp;           // [kBQ][kLdP], scores then P

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + (size_t)(b * Hq + h) * Sq * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Sk * D;

  // the pad columns D..Dp-1 stay 0 (tile copies write columns < D only)
  for (int e = tid; e < (kBQ + 2 * kBK) * (Dp - D); e += kThreads) {
    const int r = e / (Dp - D), c = D + e % (Dp - D);
    if (r < kBQ + kBK) Qs[r * ldq + c] = 0.f;     // Qs and Ks rows
    else Vs[(r - kBQ - kBK) * Dp + c] = 0.f;
  }
  attn::load_tiles<T>(TileSrc<T>{qb, Qs, ldq, scale},
                      TileSrc<T>{nullptr, nullptr, 0, 1.f}, q0, kBQ, Sq, D,
                      vec, tid, kThreads);

  const int r0 = 4 * warp;             // this warp's rows r0..r0+3
  // softmax owner: row r0 + si, columns sl + 8*i
  const int si = lane >> 3, sl = lane & 7;
  const int qpos = q0 + r0 + si;
  float m = kNegInf, l = 0.f;
  float acc[4][4];                     // rows r0+i, columns 4*lane + j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const bool owns_cols = 4 * lane < Dp;

  const int nk = (Sk + kBK - 1) / kBK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    // the TPU kernel's block-level skip (same test, our tile sizes)
    bool run = true;
    if (causal) run = k0 <= q0 + kBQ - 1;
    if (window > 0) {
      const bool in_win = k0 + kBK - 1 >= q0 - window + 1;
      run = causal ? (run && in_win) : in_win;
    }
    if (!run) continue;                // uniform across the block
    __syncthreads();                   // q written / last tile's readers done
    attn::load_tiles<T>(TileSrc<T>{kb, Ks, ldq, 1.f},
                        TileSrc<T>{vb, Vs, Dp, 1.f}, k0, kBK, Sk, D, vec,
                        tid, kThreads);
    __syncthreads();

    // scores of rows r0..r0+3 against keys lane and lane + 32
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k_a = Ks + lane * ldq;
    const float* k_b = Ks + (lane + 32) * ldq;
    for (int d = 0; d < Dp; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k_a + d);
      const float4 kb4 = *reinterpret_cast<const float4*>(k_b + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (r0 + i) * ldq + d);
        s[i][0] = dot4(qv, ka, s[i][0]);
        s[i][1] = dot4(qv, kb4, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Ps[(r0 + i) * kLdP + lane] = s[i][0];
      Ps[(r0 + i) * kLdP + lane + 32] = s[i][1];
    }
    __syncwarp();

    // online softmax of row r0 + si over this tile (8 lanes)
    float sv[kBK / 8];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
      const int c = sl + 8 * i;
      sv[i] = valid_key(qpos, k0 + c, Sk, causal, window)
                  ? Ps[(r0 + si) * kLdP + c] : kNegInf;
      mx = fmaxf(mx, sv[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
      const int c = sl + 8 * i;
      const float p = valid_key(qpos, k0 + c, Sk, causal, window)
                          ? expf(sv[i] - m_new) : 0.f;
      Ps[(r0 + si) * kLdP + c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const float alpha = expf(m - m_new);
    l = alpha * l + sum;
    m = m_new;
    __syncwarp();

    // acc = acc * alpha + P.V for rows r0..r0+3, columns 4*lane..+3
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = __shfl_sync(0xffffffffu, alpha, 8 * i);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] *= a;
    }
    if (owns_cols) {
      for (int c = 0; c < kBK; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + c * Dp +
                                                           4 * lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(r0 + i) * kLdP + c];
          acc[i][0] = fmaf(p, vv.x, acc[i][0]);
          acc[i][1] = fmaf(p, vv.y, acc[i][1]);
          acc[i][2] = fmaf(p, vv.z, acc[i][2]);
          acc[i][3] = fmaf(p, vv.w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = __shfl_sync(0xffffffffu, l, 8 * i);
    const int row = q0 + r0 + i;
    if (row < Sq && owns_cols) {
      const float denom = li == 0.f ? 1.f : li;
      T* ob = out + ((size_t)(b * Hq + h) * Sq + row) * D;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = 4 * lane + jj;
        if (d < D) store(ob + d, acc[i][jj] / denom);
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// Above 48 KB a block's shared memory must be opted into per kernel and
// device; `configured` remembers the size already allowed on each device.
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

size_t f32_smem[kMaxDevices];
size_t bf16_smem[kMaxDevices];

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int D, int causal, int window,
           float scale, size_t* configured, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(D);
  int err = allow_smem(flash_attention_k<T>, bytes, configured);
  if (err) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  const int vec = attn::vector_ok<T>(D, q, k, v);
  flash_attention_k<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk, D,
      causal, window, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block (the wrapper's smem_bytes mirrors it).
extern "C" int flash_attention_smem_bytes(int D) {
  return (int)(sizeof(float) * smem_floats(D));
}

// C entry point, bound with ctypes: launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int D,
                                      int causal, int window, float scale,
                                      int bf16, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || D < 1 ||
      D > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                                 window, scale, bf16_smem, s);
  return launch<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, window,
                       scale, f32_smem, s);
}
