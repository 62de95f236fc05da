// Flash decode for Hopper (sm_90a), split over the cache: one query token
// per (b, kv-head) group against a ring-buffer KV cache; fp32 or bf16 in,
// fp32 out.
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
// order with m, l and acc in VMEM scratch. Here the cache of each (b, h)
// is cut into `splits` runs of whole tiles of kBC slots (split s takes
// tiles [s*n/splits, (s+1)*n/splits) of n, so every split has at least
// one), and the grid is (B*Hkv, splits): at B = 1 qwen3-0.6b's 8 kv-heads
// would fill 8 of the 132 SMs, its C = 2112 cache in 16 splits fills 128
// blocks. The wrapper picks `splits` (num_splits, from the card's SM
// count). Each block runs the TPU kernel's online softmax over its run
// and, with more than one split, writes a partial (m, l, acc[G][D]) in
// fp32 to scratch; the last block of each (b, h) to finish (a ticket
// counter the wrapper zeroes) merges its partials in split order, in the
// same launch:
//   M = max_s m_s,  o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s.
// A split without a valid slot has m = -1e30 and l = acc = 0 and merges
// as nothing; a fully masked cache gives M = -1e30, l = 0 and 0. With one
// split the block writes o itself. The ticket picks which block merges,
// never the order of the sums: the same inputs give the same bits every
// run.
//
// Tiles. K and V tiles stay in the input type in shared memory, rows
// padded by 16 bytes, in a ring of three stages filled by 16-byte
// cp.async copies, all three issued before the sweep: a split of at most
// three tiles waits for memory once, and a longer one keeps two tiles in
// flight behind the one computed; one barrier per tile. Slots past C are
// copied as zeros. Where D is not a multiple of the vector or a base is
// not 16-byte aligned, each element is loaded on its own (the `vec` flag,
// uniform per launch).
//
// Products: each of the 16 warps (8 for G > 2, whose 16-query register
// bucket needs it) owns 4 (8) slots of every tile and runs its own
// online softmax over them, four slots at a time: a lane holds four
// columns of q (scaled, in registers), of each k and v row, and of acc; a
// slot's score is the lanes' partial dots summed by five xor shuffles, so
// no score leaves the warp and the warps meet only at the tile barrier. A
// warp's chain per tile is short but dependent (shuffles, exp, the
// rescale), so the block carries many warps to hide it. After the sweep
// the warps' (m, l, acc) merge in warp order. All fp32 fma on the CUDA
// cores. Bound on an H100
// (SXM, 3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores): the cache read
// once, 4*G*D flops per slot over 4*D bytes (bf16): G flops per byte, far
// under the 20 flops per byte the CUDA cores sustain at the memory's
// rate, so the kernel is bound by bytes and tensor cores would buy
// nothing here; what it needs is enough blocks and bytes in flight, and a
// short chain per tile.
//
// Numerics: q * scale first (scale from the wrapper in fp32), a slot's
// score as four-term fma chains added across lanes, expf without fast
// math, per warp an online softmax over chunks of four slots, division by
// l at the end; the merges (warps, then splits) multiply in order with
// fma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tile.cuh"

namespace {

using attn::kNegInf;
using attn::to_f;

constexpr int kBC = 64;                          // cache slots per tile
constexpr int kChunk = 4;                        // slots scored together
constexpr int kMaxD = 128;                       // 4 columns per lane
constexpr int kMaxG = 16;

template <typename T>
struct Layout {
  static constexpr int kV = attn::Vec<T>::kN;            // values / 16 B
  static constexpr int kStages = 3;
};

__host__ __device__ __forceinline__ int padded(int D, int v) {
  return (D + v - 1) / v * v;
}

// One block's shared memory: kStages x (K tile, V tile) of kBC rows of
// Dp + V values (Dp = D rounded up to the vector V). After the sweep the
// same bytes hold the warps' partial (m, l, acc) for the block's merge.
template <typename T>
__host__ __device__ size_t smem_size(int D) {
  const int Dp = padded(D, Layout<T>::kV), ld = Dp + Layout<T>::kV;
  return (size_t)Layout<T>::kStages * 2 * kBC * ld * sizeof(T);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Four consecutive values of a shared-memory row as fp32 (8- or 16-byte
// aligned: the column is a multiple of 4).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  memcpy(&a, &u.x, 4);
  memcpy(&b, &u.y, 4);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

// Threads of a block for the query bucket GB: 16 warps while the
// registers allow (GB = 2), else 8; more warps hide more of each warp's
// dependent chain.
template <int GB>
struct Block {
  static constexpr int kThreads = GB <= 2 ? 512 : 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPerWarp = kBC / kWarps;  // a warp's slots per tile
};

// Start the copy of cache slots [c0, c0 + kBC) of K and V into one stage
// (rows of `ld` values); slots >= C and columns >= D become zeros.
template <typename T, int kThreads>
__device__ __forceinline__ void load_tile(const T* __restrict__ kb,
                                          const T* __restrict__ vb, T* Ks,
                                          T* Vs, int c0, int C, int D,
                                          int Dp, int ld, bool vec, int tid) {
  constexpr int V = Layout<T>::kV;
  if (vec) {
    const int cpr = Dp / V;                  // 16-byte pieces per row
    for (int e = tid; e < kBC * cpr; e += kThreads) {
      const int r = e / cpr, cc = e - r * cpr;
      const bool ok = c0 + r < C;
      const size_t at = ok ? (size_t)(c0 + r) * D + (size_t)cc * V : 0;
      attn::cp_async16(Ks + r * ld + cc * V, kb + at, ok ? 16 : 0);
      attn::cp_async16(Vs + r * ld + cc * V, vb + at, ok ? 16 : 0);
    }
    return;
  }
  for (int e = tid; e < kBC * Dp; e += kThreads) {
    const int r = e / Dp, d = e - r * Dp;
    const bool ok = c0 + r < C && d < D;
    const size_t at = (size_t)(c0 + r) * D + d;
    Ks[r * ld + d] = ok ? kb[at] : zero<T>();
    Vs[r * ld + d] = ok ? vb[at] : zero<T>();
  }
}

// Merge the partials of (b, h) = bh in split order, with the block's
// threads: the splits' (m, l) into shared memory `sw` (3*splits*G floats),
// each query's max, sum and split weights e^(m_s - M), then each output
// element as a sum over splits of independent loads (cache-global: other
// blocks wrote them).
template <int kThreads>
__device__ __forceinline__ void merge_splits(const float* part, float* out,
                                             size_t bh, int NB, int splits,
                                             int G, int D, int tid,
                                             float* sw) {
  const size_t i0 = bh * splits * G;         // partial (bh, s=0, g=0)
  const float* ml = part + (size_t)NB * splits * G * D;
  const int SG = splits * G;
  float* Mv = sw;                            // [splits][G]: m, then weight
  float* Lv = sw + SG;                       // [splits][G]
  float* Lg = sw + 2 * SG;                   // [G]: the merged sum
  for (int e = tid; e < SG; e += kThreads) {
    Mv[e] = __ldcg(ml + 2 * (i0 + e));
    Lv[e] = __ldcg(ml + 2 * (i0 + e) + 1);
  }
  __syncthreads();
  if (tid < G) {
    float M = kNegInf;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, Mv[s * G + tid]);
    float L = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(Mv[s * G + tid] - M);
      Mv[s * G + tid] = w;
      L = fmaf(w, Lv[s * G + tid], L);
    }
    Lg[tid] = L;
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e - g * D;
    const float* pa = part + (i0 + g) * D + d;   // split s: + s*G*D
    float A = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s)
      A = fmaf(Mv[s * G + g], __ldcg(pa + (size_t)s * G * D), A);
    const float L = Lg[g];
    out[(bh * G + g) * D + d] = A / (L == 0.f ? 1.f : L);
  }
}

// Grid (B*Hkv, splits); GB >= G queries (a register bucket). part ==
// nullptr (one split): write o. Otherwise write this split's acc at
// part[((bh*splits + s)*G + g)*D + d] and its (m, l) after all of them,
// and the last split of each (b, h) to finish, by ticket[bh] (zeroed by
// the caller), merges them into o.
template <typename T, int GB>
__global__ void __launch_bounds__(Block<GB>::kThreads) flash_decode_k(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const uint8_t* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ part,
    int* __restrict__ ticket, int G, int C, int D, float scale, int vec) {
  constexpr int V = Layout<T>::kV, S = Layout<T>::kStages;
  constexpr int kThreads = Block<GB>::kThreads, kWarps = Block<GB>::kWarps;
  constexpr int kPerWarp = Block<GB>::kPerWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dp = padded(D, V), ld = Dp + V;
  T* tiles = reinterpret_cast<T*>(smem_raw);   // S x {K, V} [kBC][ld]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = blockIdx.x;        // b * Hkv + h
  const int split = blockIdx.y, splits = gridDim.y;
  const int ntile = (C + kBC - 1) / kBC;
  const int t0 = (int)((long long)split * ntile / splits);
  const int n = (int)((long long)(split + 1) * ntile / splits) - t0;
  const T* qb = q + bh * G * D;
  const T* kb = kc + bh * (size_t)C * D;
  const T* vb = vc + bh * (size_t)C * D;
  auto k_stage = [&](int st) { return tiles + (size_t)(2 * st) * kBC * ld; };
  auto v_stage = [&](int st) {
    return tiles + (size_t)(2 * st + 1) * kBC * ld;
  };

  // the first S tiles in flight, one cp.async group each (group t holds
  // tile t): a split of at most S tiles waits for memory once
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < n)
      load_tile<T, kThreads>(kb, vb, k_stage(i), v_stage(i), (t0 + i) * kBC,
                             C, D, Dp, ld, vec, tid);
    attn::cp_async_commit();
  }
  // this lane's columns c4..c4+3: the scaled queries, and per query the
  // warp's running max and sum and this lane's part of acc
  const int c4 = 4 * lane;
  const bool cols = c4 < Dp;
  float qr[GB][4], acc[GB][4], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[g][e] = g < G && c4 + e < D ? to_f(qb[g * D + c4 + e]) * scale
                                     : 0.f;
      acc[g][e] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  // this warp's slots' mask bytes, one tile ahead (lane j < kPerWarp:
  // slot j of the warp's slots)
  const int my = warp * kPerWarp;
  auto mask_byte = [&](int t) -> uint8_t {
    const int c = (t0 + t) * kBC + my + lane;
    return t < n && lane < kPerWarp && c < C ? mask[c] : 0;
  };
  uint8_t mnext = mask_byte(0);
  for (int i = 0; i < n; ++i) {
    const uint32_t valid = __ballot_sync(0xffffffffu, mnext != 0);
    mnext = mask_byte(i + 1);
    attn::cp_async_wait<S - 2>();      // tile i has landed (this thread's)
    __syncthreads();                   // ... and every thread's, and every
    if (i > 0) {                       // warp is done with tile i-1:
      const int nx = i - 1 + S;        // group nx, tile nx, in its stage
      if (nx < n)
        load_tile<T, kThreads>(kb, vb, k_stage(nx % S), v_stage(nx % S),
                               (t0 + nx) * kBC, C, D, Dp, ld, vec, tid);
      attn::cp_async_commit();
    }
    if (valid == 0u) continue;         // warp-uniform
    const T* Ks = k_stage(i % S) + (size_t)my * ld + c4;
    const T* Vs = v_stage(i % S) + (size_t)my * ld + c4;
#pragma unroll
    for (int ch = 0; ch < kPerWarp; ch += kChunk) {
      // scores of kChunk slots: each lane's four columns, summed over
      // the warp by five xor shuffles
      float sc[GB][kChunk];
      float4 vv[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4 k4 = cols ? load4(Ks + (ch + jj) * ld)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        vv[jj] = cols ? load4(Vs + (ch + jj) * ld)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float s = qr[g][0] * k4.x;
          s = fmaf(qr[g][1], k4.y, s);
          s = fmaf(qr[g][2], k4.z, s);
          sc[g][jj] = fmaf(qr[g][3], k4.w, s);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj)
            sc[g][jj] += __shfl_xor_sync(0xffffffffu, sc[g][jj], o);
      // the online softmax over the chunk's valid slots, per query
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
        float mx = m[g];
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj)
          if ((valid >> (ch + jj)) & 1u) mx = fmaxf(mx, sc[g][jj]);
        const float alpha = expf(m[g] - mx);
        float p[kChunk], sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          p[jj] = (valid >> (ch + jj)) & 1u ? expf(sc[g][jj] - mx) : 0.f;
          sum += p[jj];
        }
        l[g] = l[g] * alpha + sum;
        m[g] = mx;
        float a0 = acc[g][0] * alpha, a1 = acc[g][1] * alpha;
        float a2 = acc[g][2] * alpha, a3 = acc[g][3] * alpha;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          a0 = fmaf(p[jj], vv[jj].x, a0);
          a1 = fmaf(p[jj], vv[jj].y, a1);
          a2 = fmaf(p[jj], vv[jj].z, a2);
          a3 = fmaf(p[jj], vv[jj].w, a3);
        }
        acc[g][0] = a0;
        acc[g][1] = a1;
        acc[g][2] = a2;
        acc[g][3] = a3;
      }
    }
  }

  // merge the warps' partials per query, in warp order (the tiles'
  // memory is free after the barrier)
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(tiles);    // [kWarps][G]
  float* Lw = Mw + kWarps * G;                     // [kWarps][G]
  float* Aw = Lw + kWarps * G;                     // [kWarps][Dp]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < G) {
        Mw[warp * G + g] = m[g];
        Lw[warp * G + g] = l[g];
      }
  }
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g >= G) break;
    if (cols) {
#pragma unroll
      for (int e = 0; e < 4; ++e) Aw[warp * Dp + c4 + e] = acc[g][e];
    }
    __syncthreads();
    if (tid < Dp) {
      float M = kNegInf;
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Mw[w * G + g]);
      float L = 0.f, A = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(Mw[w * G + g] - M);
        L = fmaf(f, Lw[w * G + g], L);
        A = fmaf(f, Aw[w * Dp + tid], A);
      }
      if (part == nullptr) {
        if (tid < D) out[(bh * G + g) * D + tid] = A / (L == 0.f ? 1.f : L);
      } else {
        const size_t at = (bh * splits + split) * G + g;
        if (tid < D) part[at * D + tid] = A;
        if (tid == 0) {
          float* ml = part + (size_t)gridDim.x * splits * G * D;
          ml[2 * at] = M;
          ml[2 * at + 1] = L;
        }
      }
    }
    __syncthreads();                   // Aw free for the next query
  }
  if (part == nullptr) return;
  __shared__ int last;
  __threadfence();                     // this split's partial, published
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket + bh, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge_splits<kThreads>(part, out, bh, gridDim.x, splits, G, D, tid,
                         reinterpret_cast<float*>(tiles));
}

size_t f32_smem[2][attn::kMaxDevices];
size_t bf16_smem[2][attn::kMaxDevices];

template <typename T, int GB>
int launch(const void* q, const void* k, const void* v, const uint8_t* mask,
           float* out, float* part, int* ticket, int B, int Hkv, int G,
           int C, int D, int splits, float scale, size_t* configured,
           cudaStream_t stream) {
  const size_t bytes = smem_size<T>(D);
  int err = attn::allow_smem(flash_decode_k<T, GB>, bytes, configured);
  if (err) return err;
  const int vec = attn::vector_ok<T>(D, q, k, v);
  const dim3 grid(B * Hkv, splits);
  flash_decode_k<T, GB><<<grid, Block<GB>::kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, out,
      splits > 1 ? part : nullptr, ticket, G, C, D, scale, vec);
  return (int)cudaGetLastError();
}

// The query count's register bucket: 2 (qwen3's groups, the served
// case) or 16 (any other group, at 8 warps).
template <typename T>
int launch_g(const void* q, const void* k, const void* v, const uint8_t* mask,
             float* out, float* part, int* ticket, int B, int Hkv, int G,
             int C, int D, int splits, float scale,
             size_t (*configured)[attn::kMaxDevices], cudaStream_t stream) {
  auto go = [&](auto gb, size_t* conf) {
    return launch<T, decltype(gb)::value>(q, k, v, mask, out, part, ticket,
                                          B, Hkv, G, C, D, splits, scale,
                                          conf, stream);
  };
  if (G <= 2) return go(std::integral_constant<int, 2>{}, configured[0]);
  return go(std::integral_constant<int, 16>{}, configured[1]);
}

size_t smem_bytes_of(int bf16, int D) {
  return bf16 ? smem_size<__nv_bfloat16>(D) : smem_size<float>(D);
}

}  // namespace

// Dynamic shared memory of one block (the wrapper's smem_bytes mirrors it).
extern "C" int flash_decode_smem_bytes(int D, int bf16) {
  return (int)smem_bytes_of(bf16, D);
}

// C entry point, bound with ctypes: launches one kernel on `stream` and
// returns cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a
// shape the kernel does not take. With splits > 1, `part` holds
// B*Hkv*splits*G*(D+2) floats and `ticket` B*Hkv zeroed ints.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const uint8_t* mask,
                                   float* out, float* part, int* ticket,
                                   int B, int Hkv, int G, int C, int D,
                                   int splits, float scale, int bf16,
                                   void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxG || C < 1 || D < 1 ||
      D > kMaxD || splits < 1 || splits > (C + kBC - 1) / kBC ||
      (size_t)3 * splits * G * sizeof(float) > smem_bytes_of(bf16, D) ||
      (splits > 1 && (part == nullptr || !ticket)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_g<__nv_bfloat16>(q, k, v, mask, out, part, ticket, B, Hkv,
                                   G, C, D, splits, scale, bf16_smem, s);
  return launch_g<float>(q, k, v, mask, out, part, ticket, B, Hkv, G, C, D,
                         splits, scale, f32_smem, s);
}
