// Row-wise (output-stationary) and cascade matmuls for Hopper (sm_90a):
// y = x @ w, x (B, K) and w (K, N), both float32 or both bfloat16.
//
// Replaces two Pallas TPU kernels of
// src/repro/kernels/rowwise_matvec/kernel.py:
//   rowwise_matmul (_rowwise_kernel): the paper's E4 tiling. A block owns
//     CT whole output columns (the AIE's whole matrix rows of W^T) and
//     all of the contraction; no accumulator is shared between blocks.
//     fp32 sums, output in x's dtype, rounded once.
//   cascade_matmul (_cascade_kernel): the baseline the paper argues
//     against. The contraction is walked in blocks of bk; each block's
//     partial product is finished in fp32 and added to a zeroed fp32
//     accumulator in k order (0 + p0 + p1 + ..., the AIE cascade stream).
//     Output float32.
//
// Bound on an H100 (SXM, 3.35 TB/s; 67 TFLOP/s fp32, 989 bf16 on the
// tensor cores): at B <= 8 a matmul reads each weight once for 2*B flops,
// so it is bound by bytes; qwen3-0.6b's up-projection (B = 4, K = 1024,
// N = 3072) moves 6.3 MB in bf16, 1.9 us. On the card the time does not
// follow the bytes (fp32 and bf16 take about as long) but the chunks each
// warp works through in turn (PERF.md's findings); the wrapper's tiles, warps
// and stages were read off tools/rowwise_tiles.py.
//
// Design: one mainloop for both kernels.
//  * The contraction is cut into chunks of kc rows, none straddling a
//    k-block. Consumer warp c takes chunks c, c + W, ... and loads them
//    itself into its own `stages / W` shared-memory stages: the (kc, ct)
//    box of w and the (rows, kc) box of x, by TMA from one lane (the
//    wrapper's route where w, x and their row strides are 16-byte aligned;
//    the 32/64/128-byte swizzle keeps the ldmatrix reads free of bank
//    conflicts) or by plain loads (any alignment); out-of-range rows and
//    columns read as zero. Every warp
//    issues all of its chunks at once where the stages hold them (they
//    do at qwen3's widths), so the loads of all W warps are in flight
//    from the start; a warp refills a stage as soon as it has read it,
//    and nothing waits for a reduction to issue a load. (One producer
//    warp issuing for all serialises the issue: the time then grows with
//    the chunks, not the bytes.)
//  * Products. bf16: mma.sync m16n8k16 with the operands swapped, w's
//    tile on M (output columns, loaded transposed by ldmatrix.trans) and
//    x's rows on N (the batch padded with zeros to 8), fp32 accumulators;
//    a bf16 x bf16 product is exact in fp32, so this is the CUDA-core
//    function. Each group of four 16-row steps loads all its fragments
//    before its mma. The bytes bound the kernel, so mma.sync is enough;
//    wgmma's 64-row M would need 64 output columns per warpgroup and
//    starve the grid. fp32: FMAs on the CUDA cores (no TF32), lanes split
//    (k slice, 4 columns), the slices summed by a fixed butterfly.
//  * The sums. A consumer's accumulator is reset per k-block. Moving past
//    a block, it writes its partial to the block's slot (one part per
//    consumer taking part, in chunk order) in a ring of slots (a multiple
//    of W, so a slot always has the same writers). Warp W, the adder,
//    waits for the slots in k order, sums each block's parts in chunk
//    order, adds the block to its running total (0 + p0 + p1 + ...),
//    releases the slot and at the end stores. The loads never wait for
//    it; the slot ring bounds how far the consumers run ahead (an
//    explicit bk = 16 at K = 3072 gives 192 blocks). Rowwise is the one
//    block of K rows: its final sum over the warps, in warp order.
//  * A problem of one chunk needs no ring: in bf16 its consumer stores;
//    in fp32 (the paper's B = 8, K = 32, N = 96) a block of one warp per
//    batch row and column tile loads w and x straight into registers
//    (route "direct"), so the time is the launch, one memory trip and a
//    short chain of products and shuffles.
// Every sum is taken in the same order on every run; there are no atomics.
// block_b and block_n are TPU tiling and do not reach the kernels; bk is
// the cascade's summation structure and does.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int kMaxWarps = 16;           // consumer warps
constexpr int kSlots = 4;               // partial-sum slots, at least
constexpr int kAlign = 1024;            // stage alignment: the swizzle period
constexpr int kMaxDevices = 64;
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ inline size_t round_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

// The shared memory of one block and the bookkeeping of its chunks; the
// kernel and the host compute it alike (rowwise_smem_bytes).
struct Config {
  int rows;          // batch rows of a tile (x's box): 8 bf16, pow2 fp32
  int nblk;          // k-blocks: K / bk
  int cpb;           // chunks per k-block: ceil(bk / kc)
  int chunks;        // nblk * cpb
  int nc;            // consumers taking part in a block: min(cpb, warps)
  int slots;         // partial-sum slots: a multiple of warps >= kSlots,
                     // at most nblk
  size_t w_stage;    // bytes of one stage's w box, aligned
  size_t x_stage;    // bytes of one stage's x box, aligned
  size_t slot_off;   // the slots, after the ring
  size_t bar_off;    // the mbarriers, after the slots
  size_t total;      // bytes to request, alignment slack included
};

__host__ __device__ inline int tile_rows(int bf16, int B) {
  if (bf16 || B >= 8) return 8;
  int r = 1;
  while (r < B) r <<= 1;
  return r;
}

__host__ __device__ inline Config make_config(int bf16, int B, int K, int bk,
                                              int ct, int kc, int stages,
                                              int warps) {
  Config c;
  const int item = bf16 ? 2 : 4;
  c.rows = tile_rows(bf16, B);
  c.nblk = K / bk;
  c.cpb = (bk + kc - 1) / kc;
  c.chunks = c.nblk * c.cpb;
  c.nc = c.cpb < warps ? c.cpb : warps;
  const int want = (kSlots + warps - 1) / warps * warps;
  c.slots = c.nblk < want ? c.nblk : want;
  c.w_stage = round_up((size_t)kc * ct * item, kAlign);
  c.x_stage = round_up((size_t)kc * c.rows * item, kAlign);
  c.slot_off = (size_t)stages * (c.w_stage + c.x_stage);
  c.bar_off = c.slot_off + (size_t)c.slots * c.nc * c.rows * ct * 4;
  c.total = kAlign + c.bar_off + 8 * ((size_t)stages + 2 * c.slots);
  return c;
}

// 16-byte chunk swizzle of TMA's 32/64/128-byte modes (bits = 1, 2, 3) on
// a byte offset inside a stage aligned to kAlign; bits = 0: none.
__host__ __device__ constexpr int swizzle_bits(int row_bytes) {
  return row_bytes == 32 ? 1 : row_bytes == 64 ? 2 : row_bytes == 128 ? 3
                                                                      : 0;
}

__device__ __forceinline__ uint32_t swz(uint32_t off, int bits) {
  return off ^ (((off >> 7) & ((1u << bits) - 1)) << 4);
}

// --- mbarriers, TMA, ldmatrix, mma -----------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(b))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          saddr(b)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. After
// kWatchdog failed tries it traps, so a schedule fault fails the launch
// instead of hanging the card.
constexpr uint32_t kWatchdog = 1u << 26;

__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = saddr(b);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == kWatchdog) __trap();
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(saddr(b))
      : "memory");
}

__device__ __forceinline__ void ldm_x4_t(uint32_t a, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldm_x2_t(uint32_t a, uint32_t& r0,
                                         uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r0), "=r"(r1)
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_as(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_as(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// The halves of a pair of bf16 at contraction rows kk, kk + 1 that lie
// below `rem` (the rest of a chunk that ends inside a 16-row step).
__device__ __forceinline__ uint32_t keep_pair(int kk, int rem) {
  return (kk < rem ? 0x0000ffffu : 0u) | (kk + 1 < rem ? 0xffff0000u : 0u);
}

// --- the copy paths of a chunk ---------------------------------------------

// The routes (the `route` argument): two ways of a chunk into its stage,
// and the fp32 one-chunk path without one.
constexpr int kPlain = 0;     // plain loads by the warp: any alignment
constexpr int kTma = 1;       // two TMA boxes issued by one lane
constexpr int kDirect = 2;    // fp32, one chunk: registers straight from
                              // device memory, no stage (launch latency)

// One stage by plain loads: w rows [k0, k0 + len) x columns [col0, col0 +
// CT) into (kc, CT) at row pitch CT * item with w's swizzle, and x rows
// [row0, row0 + rows) x k's [k0, k0 + len) into (rows, kc) with x's; zero
// elsewhere. Eight loads in flight a lane before it stores.
template <typename T, int CT>
__device__ __forceinline__ void copy_stage(
    uint8_t* ws, uint8_t* xs, const T* __restrict__ w,
    const T* __restrict__ x, int B, int K, int N, int row0, int col0,
    int k0, int len, int kc, int rows, int lane) {
  constexpr int kBatch = 8;
  constexpr int kWBits = sizeof(T) == 2 ? swizzle_bits(CT * 2) : 0;
  const int xbits = sizeof(T) == 2 ? swizzle_bits(kc * 2) : 0;
  const int wn = kc * CT;
  for (int e0 = lane; e0 < wn; e0 += 32 * kBatch) {
    T v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + 32 * q;
      const int kk = e / CT, c = e - kk * CT;
      const int k = k0 + kk, col = col0 + c;
      v[q] = (e < wn && kk < len && col < N) ? w[(size_t)k * N + col]
                                             : T(0.0f);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + 32 * q;
      if (e < wn)
        *reinterpret_cast<T*>(
            ws + swz((uint32_t)e * sizeof(T), kWBits)) = v[q];
    }
  }
  const int xn = rows * kc;
  for (int e0 = lane; e0 < xn; e0 += 32 * kBatch) {
    T v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + 32 * q;
      const int r = e / kc, kk = e - r * kc;
      const int row = row0 + r, k = k0 + kk;
      v[q] = (e < xn && kk < len && row < B && k < K)
                 ? x[(size_t)row * K + k]
                 : T(0.0f);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + 32 * q;
      if (e < xn)
        *reinterpret_cast<T*>(
            xs + swz((uint32_t)e * sizeof(T), xbits)) = v[q];
    }
  }
}

// --- the consumers' arithmetic ---------------------------------------------

// bf16: acc[mt] is the (16 columns, 8 rows) tile mt of the block's output;
// a chunk of `len` (<= kc) rows in 16-row steps, the last one masked.
template <int CT>
struct TensorCoreMath {
  static constexpr int kTiles = CT >= 16 ? CT / 16 : 1;
  static constexpr bool kHalf = CT == 8;  // M rows 8..15 are padding
  static constexpr int kWBits = swizzle_bits(CT * 2);
  float acc[kTiles][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0.0f;
  }

  // S 16-row steps from row k0 (rem: rows left, masked when < 16): all the
  // steps' shared-memory loads first, then their mma, so the loads of a
  // group are in flight together instead of one dependent step at a time.
  template <int S>
  __device__ __forceinline__ void steps(const uint8_t* ws, const uint8_t* xs,
                                        int k0, int rem, int kc, int lane) {
    const int g = lane >> 2, q = lane & 3;
    const int xbits = swizzle_bits(kc * 2);
    const uint32_t wsa = saddr(ws);
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
    uint32_t b[S][2], a[S][kTiles][4];
#pragma unroll
    for (int st = 0; st < S; ++st) {
      const int k = k0 + 16 * st;
      b[st][0] = *reinterpret_cast<const uint32_t*>(
          xs + swz((uint32_t)(g * kc + k + 2 * q) * 2, xbits));
      b[st][1] = *reinterpret_cast<const uint32_t*>(
          xs + swz((uint32_t)(g * kc + k + 8 + 2 * q) * 2, xbits));
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        if constexpr (kHalf) {
          // lanes 0-7: rows k..k+7, lanes 8-15: rows k+8..k+15; 8 columns
          const int row = k + mr + ((mi & 1) << 3);
          ldm_x2_t(wsa + swz((uint32_t)row * CT * 2, kWBits), a[st][t][0],
                   a[st][t][2]);
          a[st][t][1] = a[st][t][3] = 0u;
        } else {
          // matrix mi: rows k + 8 * (mi >> 1), columns 16t + 8 * (mi & 1)
          const int row = k + mr + ((mi >> 1) << 3);
          const int col = 16 * t + ((mi & 1) << 3);
          ldm_x4_t(wsa + swz((uint32_t)(row * CT + col) * 2, kWBits),
                   a[st][t]);
        }
      }
    }
    if (S == 1 && rem < 16) {
      const uint32_t lo = keep_pair(2 * q, rem), hi = keep_pair(2 * q + 8, rem);
      b[0][0] &= lo;
      b[0][1] &= hi;
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        a[0][t][0] &= lo;
        a[0][t][1] &= lo;
        a[0][t][2] &= hi;
        a[0][t][3] &= hi;
      }
    }
#pragma unroll
    for (int st = 0; st < S; ++st)
#pragma unroll
      for (int t = 0; t < kTiles; ++t) mma_bf16(acc[t], a[st][t], b[st][0],
                                                b[st][1]);
  }

  __device__ __forceinline__ void chunk(const uint8_t* ws, const uint8_t* xs,
                                        int len, int kc, int lane) {
    int k = 0;
    for (; k + 64 <= len; k += 64) steps<4>(ws, xs, k, 64, kc, lane);
    for (; k < len; k += 16) steps<1>(ws, xs, k, len - k, kc, lane);
  }

  // f(row, column, value) for each of the lane's outputs.
  template <typename F>
  __device__ __forceinline__ void each(int lane, F&& f) const {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      f(2 * q, 16 * t + g, acc[t][0]);
      f(2 * q + 1, 16 * t + g, acc[t][1]);
      if constexpr (!kHalf) {
        f(2 * q, 16 * t + g + 8, acc[t][2]);
        f(2 * q + 1, 16 * t + g + 8, acc[t][3]);
      }
    }
  }
};

// fp32: lane = slice * G + group; the lane owns columns 4*group..+3 and
// rows k = slice, slice + S, ... of each chunk, for BT batch rows.
template <int CT, int BT>
struct CudaCoreMath {
  static constexpr int kG = CT / 4;
  static constexpr int kS = 32 / kG;
  float acc[BT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = 0.0f;
  }

  __device__ __forceinline__ void chunk(const uint8_t* ws, const uint8_t* xs,
                                        int len, int kc, int lane) {
    const int g = lane % kG, s = lane / kG;
    const float* w = reinterpret_cast<const float*>(ws);
    const float* x = reinterpret_cast<const float*>(xs);
#pragma unroll 4
    for (int k = s; k < len; k += kS) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k * CT + 4 * g);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float xv = x[r * kc + k];
        acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
        acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
        acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
        acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
      }
    }
  }

  // Sum the slices (a fixed butterfly), then f(row, column, value) on the
  // lanes of slice 0.
  template <typename F>
  __device__ __forceinline__ void each(int lane, F&& f) {
    for (int off = kG; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);
    if (lane < kG)
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) f(r, 4 * lane + i, acc[r][i]);
  }
};

// The whole problem as one fp32 chunk (K <= kc, one k-block), for one
// warp: lane (slice, group) loads its four columns of its rows of w and
// the matching x straight into registers, all loads issued before the
// first product, then the slices are summed by the fixed butterfly and
// slice 0 stores 0 + sum. No stage, barrier or second warp: at the
// paper's B = 8, K = 32, N = 96 the time is launch and one memory trip.
template <int CT, int BT>
__device__ __forceinline__ void direct_fp32(const float* __restrict__ x,
                                            const float* __restrict__ w,
                                            float* __restrict__ y, int B,
                                            int K, int N, int row0, int col0,
                                            int lane) {
  CudaCoreMath<CT, BT> math;
  math.zero();
  const int g = lane % math.kG, sl = lane / math.kG;
  const int col = col0 + 4 * g;
#pragma unroll 4
  for (int k = sl; k < K; k += math.kS) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wv[i] = col + i < N ? __ldg(w + (size_t)k * N + col + i) : 0.0f;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float xv = row0 + r < B ? __ldg(x + (size_t)(row0 + r) * K + k)
                                    : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        math.acc[r][i] = fmaf(xv, wv[i], math.acc[r][i]);
    }
  }
  math.each(lane, [&](int r, int c, float v) {
    if (row0 + r < B && col0 + c < N)
      y[(size_t)(row0 + r) * N + col0 + c] = 0.0f + v;
  });
}

// --- the kernel ------------------------------------------------------------

template <typename T, typename OUT, int CT, int BT>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1))
matmul_k(const __grid_constant__ CUtensorMap wmap,
         const __grid_constant__ CUtensorMap xmap, const T* __restrict__ x,
         const T* __restrict__ w, OUT* __restrict__ y, int B, int K, int N,
         int bk, int kc, int stages, int warps, int route) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  using Math = typename std::conditional<kBf16, TensorCoreMath<CT>,
                                         CudaCoreMath<CT, BT>>::type;
  extern __shared__ uint8_t smem_matmul[];
  uint8_t* base = smem_matmul + ((kAlign - (saddr(smem_matmul) & (kAlign - 1)))
                                 & (kAlign - 1));
  const Config cf = make_config(kBf16, B, K, bk, CT, kc, stages, warps);
  const int rows = cf.rows;
  float* slot_mem = reinterpret_cast<float*>(base + cf.slot_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + cf.bar_off);
  uint64_t* sfull = full + stages;
  uint64_t* sempty = sfull + cf.slots;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * CT, row0 = blockIdx.y * rows;
  const bool direct = cf.nblk == 1 && cf.nc == 1;
  const size_t part = (size_t)rows * CT;  // floats of one consumer's part
  const size_t stage_bytes = cf.w_stage + cf.x_stage;
  if constexpr (!kBf16) {
    if (route == kDirect) {   // one warp per block, one batch row per block
      direct_fp32<CT, 1>(x, w, reinterpret_cast<float*>(y), B, K, N,
                         blockIdx.y, col0, lane);
      return;
    }
  }

  if (route == kTma && threadIdx.x == 0) {   // fetch the descriptors early
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&wmap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&xmap))
                 : "memory");
  }
  // one barrier a thread: full[stages], sfull[slots], sempty[slots]
  for (int b = threadIdx.x; b < stages + 2 * cf.slots; b += blockDim.x) {
    const int count = b < stages ? 1 : b < stages + cf.slots ? cf.nc : 1;
    bar_init(full + b, count);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  if (warp < warps) {                               // a consumer
    // Consumer c takes chunks i = c + t * warps, t = 0, 1, ...; chunk i is
    // chunk m of k-block j. It loads them itself into its own `per` stages
    // (stage c * per + t % per, its use t / per), all of them at once where
    // they fit, and refills a stage as soon as it has read it: the warps'
    // loads run side by side, nothing waits on a reduction to issue one.
    const int c = warp;
    const int per = stages / warps;
    const int mine = cf.chunks > c ? (cf.chunks - 1 - c) / warps + 1 : 0;
    // the next chunk to load: its block lj, chunk lm and slot ls, stepped
    int lt = 0, lj = c / cf.cpb, lm = c % cf.cpb, ls = 0;
    auto load_next = [&]() {
      const int k0 = lj * bk + lm * kc, len = min(kc, bk - lm * kc);
      const int s = c * per + ls;
      uint8_t* ws = base + s * stage_bytes;
      if (route == kTma) {
        if (lane == 0) {
          if (lt >= per)   // the stage was last read by this warp's loads
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          bar_expect(&full[s], (uint32_t)(kc * (CT + rows) * sizeof(T)));
          tma_load(ws, &wmap, col0, k0, &full[s]);
          tma_load(ws + cf.w_stage, &xmap, k0, row0, &full[s]);
        }
      } else {
        copy_stage<T, CT>(ws, ws + cf.w_stage, w, x, B, K, N, row0, col0, k0,
                          len, kc, rows, lane);
        __syncwarp();
        if (lane == 0) bar_arrive(&full[s]);
      }
      ++lt;
      if (++ls == per) ls = 0;
      for (lm += warps; lm >= cf.cpb; lm -= cf.cpb) ++lj;
    };
    while (lt < per && lt < mine) load_next();

    Math math;
    math.zero();
    int cur = -1;
    auto flush = [&](int j) {
      if (direct) {
        math.each(lane, [&](int r, int col, float v) {
          if (row0 + r < B && col0 + col < N)
            store_as(0.0f + v, y + (size_t)(row0 + r) * N + col0 + col);
        });
        return;
      }
      const int r = j % cf.slots;
      if (j >= cf.slots) bar_wait(&sempty[r], ((j / cf.slots) - 1) & 1);
      // this consumer's part: its first chunk of the block, in chunk order
      const int m0 = ((c - j * cf.cpb) % warps + warps) % warps;
      float* dst = slot_mem + ((size_t)r * cf.nc + m0) * part;
      math.each(lane, [&](int rr, int col, float v) { dst[rr * CT + col] = v; });
      __syncwarp();
      if (lane == 0) bar_arrive(&sfull[r]);
    };
    // chunk t's block j, chunk m, slot cs and the slot's use cu, stepped
    int j = c / cf.cpb, m = c % cf.cpb, cs = 0, cu = 0;
    for (int t = 0; t < mine; ++t) {
      if (j != cur) {
        if (cur >= 0) {
          flush(cur);
          math.zero();
        }
        cur = j;
      }
      bar_wait(&full[c * per + cs], cu & 1);
      const uint8_t* ws = base + (c * per + cs) * stage_bytes;
      math.chunk(ws, ws + cf.w_stage, min(kc, bk - m * kc), kc, lane);
      __syncwarp();
      if (lt < mine) load_next();
      for (m += warps; m >= cf.cpb; m -= cf.cpb) ++j;
      if (++cs == per) {
        cs = 0;
        ++cu;
      }
    }
    if (cur >= 0) flush(cur);
    return;
  }

  if (warp == warps && !direct) {                   // the adder
    constexpr int kPer = (8 * CT + 31) / 32;
    const int n = rows * CT;
    float total[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) total[t] = 0.0f;
    for (int j = 0; j < cf.nblk; ++j) {
      const int r = j % cf.slots;
      bar_wait(&sfull[r], (j / cf.slots) & 1);
      const float* src = slot_mem + (size_t)r * cf.nc * part;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int o = lane + 32 * t;
        if (o < n) {
          float p = src[o];
          for (int m = 1; m < cf.nc; ++m) p += src[m * part + o];
          total[t] += p;
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&sempty[r]);
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int o = lane + 32 * t;
      const int r = o / CT, col = o - r * CT;
      if (o < n && row0 + r < B && col0 + col < N)
        store_as(total[t], y + (size_t)(row0 + r) * N + col0 + col);
    }
  }
}

// --- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime loaded (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

CUtensorMapSwizzle swizzle_mode(int bits) {
  return bits == 1 ? CU_TENSOR_MAP_SWIZZLE_32B
                   : bits == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : bits == 3 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// A 2-D row-major (rows, cols) tensor at p with row stride `stride` bytes,
// read in (box_rows, box_cols) boxes. Encoded maps are kept, keyed by all
// of these, in a small ring (kMaps): a call that repeats one, as every
// decode step does, costs a lookup, not libcuda's encode. The map goes
// to the kernel by value, so a CUDA graph holds its own copy.
constexpr int kMaps = 64;

struct MapKey {
  const void* p;
  uint64_t rows, cols, stride;
  int bf16, box_rows, box_cols, bits;
  bool operator==(const MapKey& o) const {
    return p == o.p && rows == o.rows && cols == o.cols &&
           stride == o.stride && bf16 == o.bf16 && box_rows == o.box_rows &&
           box_cols == o.box_cols && bits == o.bits;
  }
};

bool encode(CUtensorMap* map, const void* p, int bf16, uint64_t rows,
            uint64_t cols, uint64_t stride, int box_rows, int box_cols,
            int bits) {
  static std::mutex mu;
  static MapKey keys[kMaps];
  static CUtensorMap maps[kMaps];
  static int used = 0, next = 0;
  const MapKey key{p, rows, cols, stride, bf16, box_rows, box_cols, bits};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (keys[i] == key) {
      *map = maps[i];
      return true;
    }
  }
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  if (fn(map,
         bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         2, const_cast<void*>(p), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode(bits),
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMaps;
  if (used < kMaps) ++used;
  return true;
}

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

struct Args {
  const void* x;
  const void* w;
  void* y;
  int B, K, N, bk, kc, stages, warps, route;
  cudaStream_t stream;
};

template <typename T, typename OUT, int CT, int BT>
int launch(const Args& a) {
  static size_t configured[kMaxDevices];
  constexpr int kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const Config cf = make_config(kBf16, a.B, a.K, a.bk, CT, a.kc, a.stages,
                                a.warps);
  int err = allow_smem(matmul_k<T, OUT, CT, BT>, cf.total, configured);
  if (err) return err;
  CUtensorMap wmap, xmap;
  memset(&wmap, 0, sizeof(wmap));
  memset(&xmap, 0, sizeof(xmap));
  if (a.route == kTma) {
    const uint64_t item = sizeof(T);
    const uint64_t xstride =
        a.B == 1 ? round_up(a.K * item, 16) : a.K * item;
    if (!encode(&wmap, a.w, kBf16, a.K, a.N, a.N * item, a.kc, CT,
                kBf16 ? swizzle_bits(CT * 2) : 0) ||
        !encode(&xmap, a.x, kBf16, a.B, a.K, xstride, cf.rows, a.kc,
                kBf16 ? swizzle_bits(a.kc * 2) : 0))
      return (int)cudaErrorInvalidValue;
  }
  // the one-chunk fp32 route: a block of one warp for each batch row (the
  // time there is a dependent chain, so the shorter the better)
  const bool direct = a.route == kDirect;
  const dim3 grid((a.N + CT - 1) / CT,
                  direct ? a.B : (a.B + cf.rows - 1) / cf.rows);
  matmul_k<T, OUT, CT, BT><<<grid, direct ? 32 : 32 * (a.warps + 1),
                             direct ? 0 : cf.total, a.stream>>>(
      wmap, xmap, static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<OUT*>(a.y), a.B, a.K, a.N, a.bk, a.kc, a.stages, a.warps,
      a.route);
  return (int)cudaGetLastError();
}

template <typename T, typename OUT, int CT>
int by_rows(const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch<T, OUT, CT, 8>(a);
  } else {
    switch (tile_rows(0, a.B)) {
      case 1: return launch<T, OUT, CT, 1>(a);
      case 2: return launch<T, OUT, CT, 2>(a);
      case 4: return launch<T, OUT, CT, 4>(a);
      default: return launch<T, OUT, CT, 8>(a);
    }
  }
}

template <typename T, typename OUT>
int by_tile(int ct, const Args& a) {
  switch (ct) {
    case 8: return by_rows<T, OUT, 8>(a);
    case 16: return by_rows<T, OUT, 16>(a);
    case 32: return by_rows<T, OUT, 32>(a);
    case 64: return by_rows<T, OUT, 64>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What the kernels take: ct in {8, 16, 32, 64}; kc a power of two, bf16
// 16 to 64 (x's box row is one swizzle span), fp32 4 to 256;
// bk divides K; 1 <= warps <= kMaxWarps; the block's shared memory within
// a Hopper block's.
bool valid(int bf16, const Args& a, int ct) {
  if (a.B < 1 || a.K < 1 || a.N < 1 || a.bk < 1 || a.K % a.bk) return false;
  if (ct != 8 && ct != 16 && ct != 32 && ct != 64) return false;
  if (a.kc < (bf16 ? 16 : 4) || a.kc > (bf16 ? 64 : 256) ||
      (a.kc & (a.kc - 1)))
    return false;
  if (a.stages < 1 || a.warps < 1 || a.warps > kMaxWarps) return false;
  if (a.route < kPlain || a.route > kDirect) return false;
  const size_t item = bf16 ? 2 : 4;
  const Config d =
      make_config(bf16, a.B, a.K, a.bk, ct, a.kc, a.stages, a.warps);
  if (a.route == kDirect && (bf16 || d.chunks != 1)) return false;
  if (a.route == kTma &&
      ((uintptr_t)a.w % 16 || (uintptr_t)a.x % 16 || a.N * item % 16 ||
       (a.B > 1 && a.K * item % 16)))
    return false;
  const Config c =
      make_config(bf16, a.B, a.K, a.bk, ct, a.kc, a.stages, a.warps);
  return a.stages % a.warps == 0 && c.total <= 232448;
}

int run(int bf16, int cascade, int ct, const Args& a) {
  if (!valid(bf16, a, ct)) return (int)cudaErrorInvalidValue;
  if (!bf16) return by_tile<float, float>(ct, a);
  return cascade ? by_tile<__nv_bfloat16, float>(ct, a)
                 : by_tile<__nv_bfloat16, __nv_bfloat16>(ct, a);
}

}  // namespace

// C entry points, bound with ctypes. bf16: x and w are bfloat16 (else
// float32); ct output columns per block; kc contraction rows per stage;
// `stages` stages in the ring; `warps` consumer warps; route: 0 plain
// loads (any alignment), 1 TMA (needs w and x 16-byte aligned, w's row
// stride and, for B > 1, x's a multiple of 16 bytes), 2 direct (fp32, one
// chunk).
// Each launches on `stream` and returns cudaGetLastError() (0 = launched);
// a configuration the kernel does not take, or a tensor map libcuda
// refuses, returns cudaErrorInvalidValue.

extern "C" size_t rowwise_smem_bytes(int bf16, int B, int K, int bk, int ct,
                                     int kc, int stages, int warps) {
  return make_config(bf16, B, K, bk, ct, kc, stages, warps).total;
}

extern "C" int rowwise_matmul_launch(const void* x, const void* w, void* y,
                                     int B, int K, int N, int bf16, int ct,
                                     int kc, int stages, int warps, int route,
                                     void* stream) {
  const Args a{x, w, y, B, K, N, K, kc, stages, warps, route,
               (cudaStream_t)stream};
  return run(bf16, 0, ct, a);
}

extern "C" int cascade_matmul_launch(const void* x, const void* w, float* y,
                                     int B, int K, int N, int bk, int bf16,
                                     int ct, int kc, int stages, int warps,
                                     int route, void* stream) {
  const Args a{x, w, y, B, K, N, bk, kc, stages, warps, route,
               (cudaStream_t)stream};
  return run(bf16, 1, ct, a);
}
