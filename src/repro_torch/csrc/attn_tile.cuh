// What the two attention kernels (flash_attn.cu, decode_attn.cu) share:
// fp32/bf16 conversion and the copy of row tiles from device memory into
// shared memory as fp32.
//
// A tile copy is bound by the latency of its device-memory loads, so it
// issues them as 16-byte vectors (8 bf16 or 4 fp32 values), kUnroll per
// source and thread, and both sources' (K's and V's) loads before any of
// their stores, so up to 2*kUnroll loads per thread are in flight at
// once. The vector path needs D to be a multiple of the vector and every
// base pointer 16-byte aligned (the launcher checks; `vec` is uniform per
// launch); otherwise each element is loaded on its own.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);   // values per 16-byte vector
};

__device__ __forceinline__ void unpack(const uint4& u, const float*,
                                       float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, const __nv_bfloat16*,
                                       float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    memcpy(&h, &w[i], sizeof(h));
    const float2 p = __bfloat1622float2(h);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// One source of a tile copy: rows [row0, row0 + rows) of a row-major
// (n, D) array, rows >= `valid` read as 0, written as fp32 times `scale`
// at row stride `ld` (words).
template <typename T>
struct TileSrc {
  const T* src;
  float* dst;
  int ld;
  float scale;
};

// Copy one or two tiles (b.src == nullptr: one) of `rows` rows of D
// values with `threads` threads.
template <typename T>
__device__ __forceinline__ void load_tiles(TileSrc<T> a, TileSrc<T> b,
                                           int row0, int rows, int valid,
                                           int D, bool vec, int tid,
                                           int threads) {
  const int nsrc = b.src ? 2 : 1;
  if (!vec) {
    for (int e = tid; e < rows * D; e += threads) {
      const int r = e / D, d = e - r * D;
      const bool ok = row0 + r < valid;
      const size_t at = (size_t)(row0 + r) * D + d;
      a.dst[r * a.ld + d] = ok ? to_f(a.src[at]) * a.scale : 0.f;
      if (nsrc == 2) b.dst[r * b.ld + d] = ok ? to_f(b.src[at]) * b.scale : 0.f;
    }
    return;
  }
  constexpr int V = Vec<T>::kN;
  const int vpr = D / V;                      // vectors per row
  const int nvec = rows * vpr;
  for (int base = tid; base < nvec; base += threads * kUnroll) {
    uint4 ua[kUnroll], ub[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * threads;
      const int r = e / vpr;
      ua[u] = ub[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < nvec && row0 + r < valid) {
        const size_t at = (size_t)(row0 + r) * D + (size_t)(e - r * vpr) * V;
        ua[u] = *reinterpret_cast<const uint4*>(a.src + at);
        if (nsrc == 2) ub[u] = *reinterpret_cast<const uint4*>(b.src + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * threads;
      if (e < nvec) {
        const int r = e / vpr, c = (e - r * vpr) * V;
        float f[V];
        unpack(ua[u], (const T*)nullptr, f);
#pragma unroll
        for (int j = 0; j < V; ++j) a.dst[r * a.ld + c + j] = f[j] * a.scale;
        if (nsrc == 2) {
          unpack(ub[u], (const T*)nullptr, f);
#pragma unroll
          for (int j = 0; j < V; ++j) b.dst[r * b.ld + c + j] = f[j] * b.scale;
        }
      }
    }
  }
}

// Whether a launch may take the vector path: D a multiple of the vector
// and every base pointer 16-byte aligned.
template <typename T>
inline bool vector_ok(int D, const void* p0, const void* p1, const void* p2) {
  const uintptr_t m = (uintptr_t)p0 | (uintptr_t)p1 | (uintptr_t)p2;
  return D % Vec<T>::kN == 0 && (m & 15u) == 0;
}

}  // namespace attn
