// Flash decode for Hopper (sm_90a): one query token per (b, kv-head)
// group against a ring-buffer KV cache; fp32 or bf16 in, fp32 out.
//
// Replaces the Pallas TPU kernel flash_decode of
// src/repro/kernels/decode_attn/kernel.py (the decode path of the dense
// LM), and computes what it computes: for each (b, kv-head h) and each of
// the G query heads of its group,
//   o_g = softmax_c(q_g . k_c / sqrt(D) over the valid slots c) . v
// with q (B,Hkv,G,D), caches (B,Hkv,C,D) and a (C,) byte mask of valid
// slots (the wrapper builds it from slot_pos, pos and the window). A
// fully masked cache gives 0 (the TPU kernel's l == 0 -> 1 guard). The
// output is fp32 (the TPU wrapper casts the kernel's output to fp32).
//
// Translation. The TPU grid (b, h, cache block) walks the cache blocks in
// order with m, l and acc in VMEM scratch. Here one block owns (b, h) and
// sweeps the cache in tiles of kBC slots inside a loop: the G scaled
// queries stay in shared memory, each K and V tile is copied into shared
// memory once (converted to fp32), the running m and l of each query sit
// in shared memory and acc in registers. C takes any value (the last tile
// is masked); the TPU wrapper's halving of its block to divide C is a
// TPU tiling detail, not needed here.
//
// K and V tiles are copied with 16-byte vector loads issued together
// (attn_tile.cuh), so the sweep waits on device-memory latency about once
// per tile rather than once per element.
//
// Work split (128 threads): the G x kBC scores one per thread (a d-order
// fma chain), the softmax of query g by one warp (two slots per lane,
// shuffle max and sum), and the P.V update by thread-owned (g, d)
// elements of acc, reading P as a broadcast and V rows as consecutive
// words.
//
// Bound on an H100 (SXM, 3.35 TB/s): the cache read once, C*D*2 elements
// per (b, h), 4*G*C*D flops over them: a few hundred KB and well under a
// microsecond at the served shapes, so the kernel is bound by its launch
// and the latency of its sweep; the (b, h) grid is B*Hkv blocks (32 for
// qwen3 at 4 requests). Splitting the cache over several blocks per
// (b, h) (split-k flash decoding) is later work.
//
// Numerics: q * scale first (scale from the wrapper in fp32), d-order fma
// for scores and c-order fma for P.V, expf without fast math, division by
// l at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

using attn::TileSrc;
using attn::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBC = 64;                          // cache slots per tile
constexpr int kMaxD = 128;
constexpr int kMaxG = 16;
constexpr int kAccPer = kMaxG * kMaxD / kThreads;  // acc elements per thread
constexpr float kNegInf = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;

size_t smem_floats(int G, int D) {
  return (size_t)G * D + (size_t)kBC * (D + 1) + (size_t)kBC * D +
         (size_t)G * kBC + 3 * (size_t)G;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_k(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int G, int C, int D, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = D + 1;
  float* Qs = smem;                  // [G][D], scaled
  float* Ks = Qs + G * D;            // [kBC][D+1]
  float* Vs = Ks + kBC * ldk;        // [kBC][D]
  float* Ps = Vs + kBC * D;          // [G][kBC], scores then P
  float* Ms = Ps + G * kBC;          // running max per query
  float* Ls = Ms + G;                // running sum per query
  float* As = Ls + G;                // this tile's rescale per query

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = blockIdx.x;      // b * Hkv + h
  const T* qb = q + bh * G * D;
  const T* kb = kc + bh * (size_t)C * D;
  const T* vb = vc + bh * (size_t)C * D;

  for (int e = tid; e < G * D; e += kThreads) Qs[e] = to_f(qb[e]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  float acc[kAccPer];
#pragma unroll
  for (int i = 0; i < kAccPer; ++i) acc[i] = 0.f;
  const int GD = G * D;

  for (int c0 = 0; c0 < C; c0 += kBC) {
    __syncthreads();                 // q written / last tile's readers done
    attn::load_tiles<T>(TileSrc<T>{kb, Ks, ldk, 1.f},
                        TileSrc<T>{vb, Vs, D, 1.f}, c0, kBC, C, D, vec, tid,
                        kThreads);
    __syncthreads();
    for (int e = tid; e < G * kBC; e += kThreads) {
      const int g = e / kBC, c = e - g * kBC;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(Qs[g * D + d], Ks[c * ldk + d], s);
      Ps[e] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float sv[kBC / 32];
      bool ok[kBC / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kBC / 32; ++i) {
        const int c = lane + 32 * i;
        ok[i] = c0 + c < C && mask[c0 + c] != 0;
        sv[i] = ok[i] ? Ps[g * kBC + c] : kNegInf;
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBC / 32; ++i) {
        const float p = ok[i] ? expf(sv[i] - m_new) : 0.f;
        Ps[g * kBC + lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        As[g] = alpha;
        Ls[g] = alpha * Ls[g] + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAccPer; ++i) {
      const int e = tid + kThreads * i;
      if (e < GD) {
        const int g = e / D, d = e - g * D;
        float a = acc[i] * As[g];
        for (int c = 0; c < kBC; ++c)
          a = fmaf(Ps[g * kBC + c], Vs[c * D + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();                   // Ls final
  float* ob = out + bh * G * D;
#pragma unroll
  for (int i = 0; i < kAccPer; ++i) {
    const int e = tid + kThreads * i;
    if (e < GD) {
      const float l = Ls[e / D];
      ob[e] = acc[i] / (l == 0.f ? 1.f : l);
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
int launch(const void* q, const void* k, const void* v, const uint8_t* mask,
           float* out, int B, int Hkv, int G, int C, int D, float scale,
           size_t* configured, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(G, D);
  int err = allow_smem(flash_decode_k<T>, bytes, configured);
  if (err) return err;
  const int vec = attn::vector_ok<T>(D, q, k, v);
  flash_decode_k<T><<<B * Hkv, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, out, G, C, D, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block (the wrapper's smem_bytes mirrors it).
extern "C" int flash_decode_smem_bytes(int G, int D) {
  return (int)(sizeof(float) * smem_floats(G, D));
}

// C entry point, bound with ctypes: launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const uint8_t* mask,
                                   float* out, int B, int Hkv, int G, int C,
                                   int D, float scale, int bf16,
                                   void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxG || C < 1 || D < 1 ||
      D > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, B, Hkv, G, C, D, scale,
                                 bf16_smem, s);
  return launch<float>(q, k, v, mask, out, B, Hkv, G, C, D, scale, f32_smem,
                       s);
}
