// Column-tile matvec for Hopper (sm_90a): the building block of the
// single-step GRU kernels (gru_cell.cu) and the row-wise / cascade matmuls
// (rowwise_matvec.cu).
//
// Problem: y[r][c] = sum_k x[r][k] * w[k][c] for a tile of BT batch rows
// (BT in {1, 2, 4, 8}) and `ct` output columns, with w in device memory
// (row stride ldw) read exactly once per tile, and x (the operand) staged
// in shared memory, transposed to (k, BT), so that one or two 16-byte
// loads give all BT rows of one k.
//
// Geometry of one block (kThreads = 256): a thread owns kVec = 4
// consecutive output columns (one 16-byte fp32 or 8-byte bf16 load per
// k); lpr = ct / 4 neighbouring threads cover one row segment of w (32
// bytes at ct = 8 fp32 or ct = 16 bf16: one DRAM sector), and the block's
// 256 / lpr "k-slices" walk the contraction with stride 256 / lpr. Partial
// sums meet in reduce_warps(): a butterfly over the lanes of a warp that
// share a column group, then one row per warp in shared memory, summed
// over the 8 warps in a fixed order by tile_sum(). Every sum is taken in
// the same order on every run (no atomics).
//
// Numerics: fp32 fma on the CUDA cores, no TF32 and no tensor cores; a
// bf16 weight or operand is widened to fp32 exactly, so a bf16 x bf16
// product is exact and only the sums round.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace coltile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                 // output columns per thread
constexpr int kLoadBatch = 16;          // operand loads in flight a thread
constexpr int kMaxDevices = 64;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_as(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_as(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to W's precision (round to nearest even), as a float: the
// cast of an operand to the weights' dtype before a product.
template <typename W>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<W, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Four consecutive elements at p, p aligned to four elements.
__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      float (&v)[kVec]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ p,
                                      float (&v)[kVec]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 c =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = c.x;
  v[3] = c.y;
}

// The first nv (<= 4 read) elements at p, any alignment; the rest 0.
template <typename W>
__device__ __forceinline__ void load4_tail(const W* __restrict__ p, int nv,
                                           float (&v)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = i < nv ? to_f(p[i]) : 0.0f;
}

// The BT operand rows of one k (16-byte aligned for BT >= 4).
template <int BT>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[BT]) {
  if constexpr (BT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BT / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = t.x;
      x[4 * q + 1] = t.y;
      x[4 * q + 2] = t.z;
      x[4 * q + 3] = t.w;
    }
  } else if constexpr (BT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

struct Tile {
  int ct;      // output columns of the tile (a multiple of kVec, <= 128)
  int lpr;     // threads per row segment of w: ct / kVec (divides 32)
  int slices;  // k-slices of the block: kThreads / lpr
  int slice;   // this thread's k-slice
  int cg;      // this thread's column group: columns kVec*cg .. +3
};

__device__ __forceinline__ Tile make_tile(int ct) {
  Tile t;
  t.ct = ct;
  t.lpr = ct / kVec;
  t.slices = kThreads / t.lpr;
  t.slice = threadIdx.x / t.lpr;
  t.cg = threadIdx.x % t.lpr;
  return t;
}

// x rows [row0, row0 + nrow) of src (row stride lds), columns [k0, k1),
// rounded to W, into dst laid out (k1 - k0, BT); rows nrow..BT-1 are 0.
// Thread t writes dst[t], dst[t + kThreads], ... (a warp's stores hit
// distinct banks) and starts kLoadBatch loads before it stores any, so the
// copy waits on memory latency once per batch, not once per element.
template <int BT, typename W, typename S>
__device__ __forceinline__ void load_operand(float* dst, const S* src,
                                             size_t lds, int row0, int nrow,
                                             int k0, int k1) {
  const int total = BT * (k1 - k0);
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kLoadBatch) {
    float v[kLoadBatch];
#pragma unroll
    for (int q = 0; q < kLoadBatch; ++q) {
      const int i = i0 + q * kThreads;
      const int k = i / BT;
      const int r = i - k * BT;
      v[q] = i < total && r < nrow
                 ? to_f(src[(size_t)(row0 + r) * lds + k0 + k])
                 : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kLoadBatch; ++q) {
      const int i = i0 + q * kThreads;
      if (i < total) dst[i] = round_to<W>(v[q]);
    }
  }
}

template <bool VEC, int G, int BT, typename W>
__device__ __forceinline__ void accumulate_impl(
    float (&acc)[G][BT][kVec], const float* x, const W* __restrict__ w,
    size_t ldw, const int (&col)[G], int nv, int k0, int k1, const Tile& t) {
#pragma unroll 4
  for (int k = k0 + t.slice; k < k1; k += t.slices) {
    const W* wr = w + (size_t)k * ldw;
    float wv[G][kVec];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if constexpr (VEC) {
        load4(wr + col[g], wv[g]);
      } else {
        load4_tail(wr + col[g], nv, wv[g]);
      }
    }
    float xr[BT];
    load_rows<BT>(x + (size_t)(k - k0) * BT, xr);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[g][r][i] = fmaf(xr[r], wv[g][i], acc[g][r][i]);
  }
}

// acc[g][r][i] += x[k][r] * w[k][col[g] + i] over this thread's k-slice of
// [k0, k1). x holds the operand for [k0, k1) at (k - k0) * BT; nv is the
// number of the thread's columns inside the matrix (<= 0: none). vec: the
// four columns may be read with one aligned vector load.
template <int G, int BT, typename W>
__device__ __forceinline__ void accumulate(float (&acc)[G][BT][kVec],
                                           const float* x,
                                           const W* __restrict__ w,
                                           size_t ldw, const int (&col)[G],
                                           int nv, int vec, int k0, int k1,
                                           const Tile& t) {
  if (nv <= 0) return;
  if (vec && nv >= kVec) {
    accumulate_impl<true>(acc, x, w, ldw, col, nv, k0, k1, t);
  } else {
    accumulate_impl<false>(acc, x, w, ldw, col, nv, k0, k1, t);
  }
}

// Sum acc over the k-slices of each warp (butterfly over the lanes that
// share a column group), and write each warp's sums to red, laid out
// (kWarps, G, BT, ct). The rounds run outside and the thread's G*BT*4
// sums inside, so one round's shuffles go out back to back instead of each
// waiting on the one before. Every thread of the block must call it; the
// caller syncs before tile_sum() reads red.
template <int G, int BT>
__device__ __forceinline__ void reduce_warps(float (&acc)[G][BT][kVec],
                                             float* red, const Tile& t) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = t.lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[g][r][i] += __shfl_xor_sync(0xffffffffu, acc[g][r][i], off);
  }
  if (lane < t.lpr) {                   // slice 0 of the warp: cg == lane
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          red[((warp * G + g) * BT + r) * t.ct + kVec * lane + i] =
              acc[g][r][i];
  }
}

// The finished sum of gate g, row r, tile column c: the warps' sums added
// in warp order.
template <int G, int BT>
__device__ __forceinline__ float tile_sum(const float* red, int ct, int g,
                                          int r, int c) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[((w * G + g) * BT + r) * ct + c];
  return s;
}

// Floats of the warps' partial sums for G gates.
__host__ __device__ inline size_t red_floats(int G, int bt, int ct) {
  return (size_t)kWarps * G * bt * ct;
}

// f(std::integral_constant<int, BT>) for the batch tile bt.
template <typename F>
int by_tile(int bt, F&& f) {
  switch (bt) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// A tile the kernels take: ct a multiple of kVec whose row segment spans
// a divisor of the warp (ct / kVec in {1, 2, 4, 8, 16, 32}).
inline bool valid_ct(int ct) {
  return ct >= kVec && ct % kVec == 0 && 32 % (ct / kVec) == 0;
}

// Raise the kernel's dynamic shared-memory limit to `bytes` once per device.
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

}  // namespace coltile
