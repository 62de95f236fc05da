// Blocked attention with an online softmax (flash attention, forward) for
// Hopper (sm_90a): bf16 on the tensor cores (wgmma), fp32 on the CUDA
// cores; the input's type out.
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
// (b, h, a tile of query rows), and the kv sweep is a loop inside it,
// over the kv tiles that the TPU kernel's block-level test (pl.when) does
// not skip: wholly above the diagonal or wholly outside the window, at
// this kernel's tile sizes; each element is masked as there, so skipping
// changes no bit.
//
// bf16: flash_attention_tc, one warpgroup (128 threads) per 64 query rows
// of one q-head. The grid is (head, query tile, b) with the query tiles
// issued last first: under a causal mask the blocks with the most kv
// tiles start first and the short ones fill the SMs at the end (issued
// the other way, the long blocks that start last set the kernel's time).
// - Tiles stay bf16 in shared memory, in the 128-byte swizzled layout
//   wgmma reads (rows of 64 values, 16-byte piece p of row r at p ^ r%8,
//   1024-byte atoms; D <= 64 in one column block, D <= 128 in two, the
//   columns past D zero). The q tile stays for the whole sweep; K and V
//   tiles of 64 keys go through a ring of two stages (83 KB at D = 128,
//   two blocks to an SM), the next tile's 16-byte cp.async copies in
//   flight while one is computed (keys past Sk copied as zeros).
//   cp.async, not TMA: at the served prefill shapes a block sweeps one or
//   two kv tiles, and three tensor maps encoded on the host per call
//   would cost more than the copies they replace.
// - A software pipeline (FA3's intra-warpgroup overlap): the softmax of
//   kv tile j runs on the CUDA cores while the tensor cores run tile j-1's
//   P.V; each step retires its wgmma groups before the next.
// - Scores: S = Q.K^T by wgmma m64n64k16, both operands from shared
//   memory, K-major (K's rows are D-contiguous), fp32 accumulators; the
//   scale multiplies S in fp32 after the product (the TPU kernel scales q
//   first; bf16 products are exact in fp32, so the two differ by about an
//   fp32 ulp).
// - Softmax on the accumulator registers: a thread holds 2 rows x 16 keys;
//   a row's max of the raw scores across the 4 threads that share it (two
//   xor shuffles), then p = 2^(s * scale * log2 e - m), one fma and one
//   ex2 each; the sum stays per thread until the end. A tile whose every
//   (row, key) pair is valid runs without the per-element mask.
// - P.V by wgmma m64n64k16 per column block of V, with P from registers
//   (the score accumulators are laid out as the A operand's fragments)
//   and V from shared memory, MN-major (the transpose bit). P is split
//   into two bf16 operands, hi = bf16(p) and lo = bf16(p - hi), both
//   accumulated into the same fp32 acc: the TPU kernel multiplies V by p
//   in fp32, one bf16 P keeps 8 bits of it, hi + lo about 16. That costs
//   1.5x the tensor-core flops of one bf16 P.
// fp32: flash_attention_k, the CUDA-core kernel (no serving path runs
// flash attention in fp32: the fp32 LM serves on `chunked`). 256 threads
// per 32 query rows, warp w owns rows 4w..4w+3; K and V tiles of 64 keys
// copied to shared memory with 16-byte loads; scores and P.V as fma
// chains in d and key order.
//
// Bound on an H100 (SXM, 3.35 TB/s; 989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s fp32 on the CUDA cores): 4*D flops per valid (query,
// key) pair and head, over 2 bytes (bf16) of q, k, v and out per element.
// At the served prefill shapes (S = 12..128, D = 128) both bounds are
// well under a microsecond and the kernel is bound by its launch and by
// latency; at S = 2048 causal the flops bound it (about 17 GFLOP per
// batch row).
//
// Numerics: fp32 sums; expf without fast math (fp32 kernel) or ex2.approx
// (bf16 kernel, about 2 ulp); the output divides by l and rounds to
// nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

using attn::kNegInf;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ bool valid_key(int qpos, int kpos, int Sk,
                                          int causal, int window) {
  bool ok = kpos < Sk;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// The kv tiles [lo, hi] of tile size bk that a query tile [q0, q0 + bq)
// needs: the TPU kernel's block-level test, which keeps a contiguous run.
__device__ __forceinline__ void kv_range(int q0, int bq, int bk, int Sk,
                                         int causal, int window, int* lo,
                                         int* hi) {
  *hi = (Sk - 1) / bk;
  if (causal) *hi = min(*hi, (q0 + bq - 1) / bk);
  *lo = 0;
  if (window > 0) {                    // j*bk + bk - 1 >= q0 - window + 1
    const int t = q0 - window + 1 - (bk - 1);
    if (t > 0) *lo = (t + bk - 1) / bk;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWG = 128;               // threads of one warpgroup
constexpr int kBM = 64;                // query rows per warpgroup
constexpr int kBN = 64;                // keys per kv tile
constexpr int kSwBlock = 64 * 128;     // [64 rows][64 bf16] swizzled, bytes

__host__ __device__ __forceinline__ int col_blocks(int D) {
  return D <= 64 ? 1 : 2;
}

constexpr int kStages = 2;             // K/V ring, filled before the sweep

// the q tile and the K/V ring, plus 1024 bytes to align the atoms: 83 KB
// at D = 128, two blocks to an SM
__host__ __device__ __forceinline__ size_t smem_size(int D) {
  return 1024 + (size_t)(1 + 2 * kStages) * col_blocks(D) * kSwBlock;
}

// Byte offset of (row r, column c) in a tile of 64 rows: column block
// c / 64, 16-byte piece (c / 8) % 8 swizzled by r % 8.
__device__ __forceinline__ int sw_offset(int r, int c) {
  return (c >> 6) * kSwBlock + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// Start the copy of rows [row0, row0 + 64) of a row-major (n, D) bf16
// array into a swizzled tile; rows >= valid and columns >= D become zeros.
// Vector path: thread t copies the 16-byte piece (t % P) of rows t / P,
// t / P + 128 / P, ... (P pieces a row): one column and one swizzle for
// all its rows, so the addresses are computed once.
template <int KB>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          unsigned char* dst, int row0,
                                          int valid, int D, bool vec,
                                          int tid) {
  constexpr int kCols = KB * 64;
  if (vec) {
    constexpr int kPieces = kCols / 8;       // 16-byte pieces per row
    constexpr int kStep = kWG / kPieces;     // rows apart (a multiple of 8)
    const int r0 = tid / kPieces, c = (tid % kPieces) * 8;
    unsigned char* d0 = dst + sw_offset(r0, c);
    const bf16* s0 = src + (size_t)(row0 + r0) * D + c;
#pragma unroll
    for (int u = 0; u < 64 / kStep; ++u) {
      const bool ok = c < D && row0 + r0 + u * kStep < valid;
      attn::cp_async16(d0 + u * kStep * 128,
                       ok ? s0 + (size_t)u * kStep * D : src, ok ? 16 : 0);
    }
    return;
  }
  for (int e = tid; e < 64 * kCols; e += kWG) {
    const int r = e / kCols, c = e - r * kCols;
    const bool ok = row0 + r < valid && c < D;
    *reinterpret_cast<bf16*>(dst + sw_offset(r, c)) =
        ok ? src[(size_t)(row0 + r) * D + c] : __float2bfloat16(0.f);
  }
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle; offsets in
// bytes. K-major: `sbo` between 8-row groups, `lbo` unused. MN-major:
// `sbo` between 8-row (k) groups, `lbo` between 64-value column blocks,
// which a 64-wide operand does not have.
__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((attn::smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are in
// flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (it sees only the asm statement).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// Writes of the generic proxy (cp.async, plain stores) visible to the
// async proxy wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x (ex2.approx: about 2 ulp; results under 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d = A . B (accumulate = 0) or d += A . B: A (64 x 16) and B (16 x 64)
// from shared memory, both K-major.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B: A (64 x 16) from registers (bf16 pairs), B (16 x 64) from
// shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Issue s = Q . K^T over D in steps of 16 (not committed, not waited).
template <int KB>
__device__ __forceinline__ void scores(float (&s)[32],
                                       const unsigned char* Qs,
                                       const unsigned char* Ks) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * KB; ++kk) {
    const int off = (kk >> 2) * kSwBlock + (kk & 3) * 32;
    mma_ss_n64(s, desc(Qs + off, 16, 1024), desc(Ks + off, 16, 1024),
               kk > 0);
  }
}

// (hi, lo) bf16 pairs of (x, y): hi rounds to nearest, lo the rest.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  memcpy(hi, &h, 4);
  memcpy(lo, &l, 4);
}

__device__ __forceinline__ void store_pair(bf16* row, int d, int D, float x,
                                           float y) {
  if (d + 1 < D && (D & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(x, y);
    return;
  }
  if (d < D) row[d] = __float2bfloat16(x);
  if (d + 1 < D) row[d + 1] = __float2bfloat16(y);
}

// The online softmax of a thread's two rows (ra and ra + 8 of the tile,
// at positions qa and qb8) over one kv tile of scores in accumulator
// layout: register 4i+e (e = 0, 1) holds row ra, key 8i + c2 + e; 4i+2+e
// row ra + 8, the same key.
struct Softmax {
  int qa, qb8, c2, q0, Sk, causal, window;
  float scale_log2;
  float m_a = kNegInf, m_b = kNegInf;  // running max (log2 units)
  float l_a = 0.f, l_b = 0.f;          // this thread's part of the sums
  float al_a = 1.f, al_b = 1.f;        // this tile's rescale of acc

  // scores of keys k0.. -> p in place; a tile whose every (row, key) pair
  // is valid runs without the per-element mask
  __device__ __forceinline__ void tile(float (&s)[32], int k0) {
    const bool whole = k0 + kBN <= Sk && (!causal || k0 + kBN - 1 <= q0) &&
                       (window <= 0 || q0 + kBM - 1 - k0 < window);
    if (whole) {
      update<false>(s, 0u);
      return;
    }
    uint32_t ok = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * i + c2 + e;
        ok |= (uint32_t)valid_key(qa, key, Sk, causal, window) << (4 * i + e);
        ok |= (uint32_t)valid_key(qb8, key, Sk, causal, window)
              << (4 * i + 2 + e);
      }
    update<true>(s, ok);
  }

  // the row max of the raw scores (the scale is positive), then
  // p = 2^(s * scale_log2 - m) with m in log2 units, one fma each; with
  // kMasked, register r counts only where bit r of `ok` is set
  template <bool kMasked>
  __device__ __forceinline__ void update(float (&s)[32], uint32_t ok) {
    auto valid = [&](int r) { return !kMasked || ((ok >> r) & 1u); };
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ia = 4 * i + e, ib = ia + 2;
        mx_a = fmaxf(mx_a, valid(ia) ? s[ia] : kNegInf);
        mx_b = fmaxf(mx_b, valid(ib) ? s[ib] : kNegInf);
      }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, w));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, w));
    }
    // a row without a valid key so far keeps m = -1e30
    const float mn_a =
        fmaxf(m_a, mx_a == kNegInf ? kNegInf : mx_a * scale_log2);
    const float mn_b =
        fmaxf(m_b, mx_b == kNegInf ? kNegInf : mx_b * scale_log2);
    al_a = ex2(m_a - mn_a);
    al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ia = 4 * i + e, ib = ia + 2;
        s[ia] = valid(ia) ? ex2(fmaf(s[ia], scale_log2, -mn_a)) : 0.f;
        s[ib] = valid(ib) ? ex2(fmaf(s[ib], scale_log2, -mn_b)) : 0.f;
        sum_a += s[ia];
        sum_b += s[ib];
      }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
  }
};

// Keep P.V's accumulators and A operands in place across its wait.
template <int KB>
__device__ __forceinline__ void fence_pv(float (&o)[KB][32],
                                         uint32_t (&ph)[4][4],
                                         uint32_t (&pl)[4][4]) {
  fence_regs(ph);
  fence_regs(pl);
#pragma unroll
  for (int cb = 0; cb < KB; ++cb) fence_regs(o[cb]);
}

// Issue o += P.V for one tile (not committed): P as the A operand in hi
// and lo bf16 parts, V from the stage at Vs.
template <int KB>
__device__ __forceinline__ void pv(float (&o)[KB][32], uint32_t (&ph)[4][4],
                                   uint32_t (&pl)[4][4],
                                   const unsigned char* Vs) {
  fence_pv<KB>(o, ph, pl);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int cb = 0; cb < KB; ++cb) {
      // keys 16t..16t+15 of column block cb: two 8-key groups 1024 bytes
      // apart (the one stride a 64-wide MN-major operand uses)
      const uint64_t dv = desc(Vs + cb * kSwBlock + t * 16 * 128, 1024, 1024);
      mma_rs_n64(o[cb], ph[t], dv);
      mma_rs_n64(o[cb], pl[t], dv);
    }
}

// KB column blocks: D <= 64 * KB.
template <int KB>
__global__ void __launch_bounds__(kWG) flash_attention_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int Hq, int Hkv,
    int Sq, int Sk, int D, int causal, int window, float scale_log2,
    int vec) {
  constexpr int kTile = KB * kSwBlock;
  constexpr int S = kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (attn::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;
  auto k_stage = [&](int st) { return base + kTile * (1 + 2 * st); };
  auto v_stage = [&](int st) { return base + kTile * (2 + 2 * st); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bf16* qb = q + (size_t)(b * Hq + h) * Sq * D;
  const bf16* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const bf16* vb = v + (size_t)(b * Hkv + hk) * Sk * D;
  int j_lo, j_hi;
  kv_range(q0, kBM, kBN, Sk, causal, window, &j_lo, &j_hi);
  const int n = j_hi - j_lo + 1;             // kv tiles to sweep

  // accumulator layout (wgmma m64n64): register 4i+e (e = 0, 1) holds row
  // ra, column 8i + c2 + e; 4i+2+e row ra + 8, the same column. o[cb]
  // holds columns 64cb..64cb+63.
  const int ra = warp * 16 + (lane >> 2);
  const int qa = q0 + ra, qb8 = qa + 8;
  const int c2 = 2 * (lane & 3);
  float o[KB][32];
#pragma unroll
  for (int cb = 0; cb < KB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;

  // the q tile and the first S kv tiles in flight, one cp.async group
  // per kv tile (the q tile in tile 0's): group t holds tile t
  if (n > 0) load_tile<KB>(qb, Qs, q0, Sq, D, vec, tid);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < n) {
      load_tile<KB>(kb, k_stage(i), (j_lo + i) * kBN, Sk, D, vec, tid);
      load_tile<KB>(vb, v_stage(i), (j_lo + i) * kBN, Sk, D, vec, tid);
    }
    attn::cp_async_commit();
  }

  // Software pipeline over the kv tiles (FA3's intra-warpgroup overlap):
  // the softmax of tile it runs on the CUDA cores while the tensor cores
  // run tile it-1's P.V. Each step retires all its wgmma groups:
  //   it: issue S(it) | issue P.V(it-1) | wait S(it) | softmax(it) |
  //       wait P.V(it-1), rescale acc | sync, copy tile it-1+S into tile
  //       it-1's stage | P(it) into the A operands
  float s[32];
  uint32_t ph[4][4], pl[4][4];
  Softmax sm{qa, qb8, c2, q0, Sk, causal, window, scale_log2};
  for (int it = 0; it < n; ++it) {
    attn::cp_async_wait<S - 2>();      // tile it (at it = 0, tile 1 too)
    fence_proxy_async();
    __syncthreads();
    scores<KB>(s, Qs, k_stage(it % S));
    wgmma_commit();
    if (it > 0) {
      pv<KB>(o, ph, pl, v_stage((it - 1) % S));
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    sm.tile(s, (j_lo + it) * kBN);
    wgmma_wait<0>();
    fence_pv<KB>(o, ph, pl);
#pragma unroll
    for (int cb = 0; cb < KB; ++cb)    // acc of tiles < it, rescaled
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[cb][4 * i] *= sm.al_a;
        o[cb][4 * i + 1] *= sm.al_a;
        o[cb][4 * i + 2] *= sm.al_b;
        o[cb][4 * i + 3] *= sm.al_b;
      }
    __syncthreads();                   // tile it-1's stage free
    if (it > 0) {                      // group it-1+S: tile it-1+S
      const int nx = it - 1 + S;
      if (nx < n) {
        load_tile<KB>(kb, k_stage(nx % S), (j_lo + nx) * kBN, Sk, D, vec,
                      tid);
        load_tile<KB>(vb, v_stage(nx % S), (j_lo + nx) * kBN, Sk, D, vec,
                      tid);
      }
      attn::cp_async_commit();
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)        // keys 16t..16t+15: registers 8t..
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair(s[8 * t + 2 * r], s[8 * t + 2 * r + 1], &ph[t][r],
                   &pl[t][r]);
  }
  if (n > 0) {                         // the last tile's P.V
    pv<KB>(o, ph, pl, v_stage((n - 1) % S));
    wgmma_commit();
    wgmma_wait<0>();
    fence_pv<KB>(o, ph, pl);
  }
  float l_a = sm.l_a, l_b = sm.l_b;

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
  }
  const float den_a = l_a == 0.f ? 1.f : l_a;
  const float den_b = l_b == 0.f ? 1.f : l_b;
  bf16* oa = out + ((size_t)(b * Hq + h) * Sq + qa) * D;
  bf16* ob = oa + (size_t)8 * D;
#pragma unroll
  for (int cb = 0; cb < KB; ++cb)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = 64 * cb + 8 * i + c2;
      const float* r = o[cb] + 4 * i;
      if (qa < Sq) store_pair(oa, d, D, r[0] / den_a, r[1] / den_a);
      if (qb8 < Sq) store_pair(ob, d, D, r[2] / den_b, r[3] / den_b);
    }
}

size_t smem_configured[2][attn::kMaxDevices];

template <int KB>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_size(D);
  int err = attn::allow_smem(flash_attention_tc<KB>, bytes,
                             smem_configured[KB - 1]);
  if (err) return err;
  const dim3 grid(Hq, (Sq + kBM - 1) / kBM, B);
  const int vec = attn::vector_ok<bf16>(D, q, k, v);
  flash_attention_tc<KB><<<grid, kWG, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, Hq, Hkv,
      Sq, Sk, D, causal, window, scale * 1.4426950408889634f, vec);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace cc {

constexpr int kThreads = 256;
constexpr int kBQ = 32;             // query rows per block (4 per warp)
constexpr int kBK = 64;             // keys per kv tile
constexpr int kLdP = kBK + 8;       // P row stride (words)
constexpr int kUnroll = 4;

__host__ __device__ __forceinline__ int padded(int D) { return (D + 3) & ~3; }

__host__ __device__ __forceinline__ size_t smem_floats(int D) {
  const int Dp = padded(D);
  return (size_t)(kBQ + kBK) * (Dp + 4) + (size_t)kBK * Dp +
         (size_t)kBQ * kLdP;
}

// One source of a tile copy: rows [row0, row0 + rows) of a row-major
// (n, D) array, rows >= `valid` read as 0, written times `scale` at row
// stride `ld` (words).
struct TileSrc {
  const float* src;
  float* dst;
  int ld;
  float scale;
};

// Copy one or two tiles (b.src == nullptr: one) of `rows` rows of D
// values: 16-byte loads, kUnroll per source and thread, both sources'
// loads before any of their stores (2*kUnroll in flight per thread).
__device__ __forceinline__ void load_tiles(TileSrc a, TileSrc b, int row0,
                                           int rows, int valid, int D,
                                           bool vec, int tid) {
  const int nsrc = b.src ? 2 : 1;
  if (!vec) {
    for (int e = tid; e < rows * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool ok = row0 + r < valid;
      const size_t at = (size_t)(row0 + r) * D + d;
      a.dst[r * a.ld + d] = ok ? a.src[at] * a.scale : 0.f;
      if (nsrc == 2) b.dst[r * b.ld + d] = ok ? b.src[at] * b.scale : 0.f;
    }
    return;
  }
  const int vpr = D / 4;                      // vectors per row
  const int nvec = rows * vpr;
  for (int base = tid; base < nvec; base += kThreads * kUnroll) {
    float4 ua[kUnroll], ub[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * kThreads;
      const int r = e / vpr;
      ua[u] = ub[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < nvec && row0 + r < valid) {
        const size_t at = (size_t)(row0 + r) * D + (size_t)(e - r * vpr) * 4;
        ua[u] = *reinterpret_cast<const float4*>(a.src + at);
        if (nsrc == 2) ub[u] = *reinterpret_cast<const float4*>(b.src + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * kThreads;
      if (e < nvec) {
        const int r = e / vpr, c = (e - r * vpr) * 4;
        float* da = a.dst + r * a.ld + c;
        da[0] = ua[u].x * a.scale;
        da[1] = ua[u].y * a.scale;
        da[2] = ua[u].z * a.scale;
        da[3] = ua[u].w * a.scale;
        if (nsrc == 2) {
          float* db = b.dst + r * b.ld + c;
          db[0] = ub[u].x * b.scale;
          db[1] = ub[u].y * b.scale;
          db[2] = ub[u].z * b.scale;
          db[3] = ub[u].w * b.scale;
        }
      }
    }
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__global__ void __launch_bounds__(kThreads) flash_attention_k(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Hq, int Hkv,
    int Sq, int Sk, int D, int causal, int window, float scale, int vec) {
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
  const float* qb = q + (size_t)(b * Hq + h) * Sq * D;
  const float* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const float* vb = v + (size_t)(b * Hkv + hk) * Sk * D;

  // the pad columns D..Dp-1 stay 0 (tile copies write columns < D only)
  for (int e = tid; e < (kBQ + 2 * kBK) * (Dp - D); e += kThreads) {
    const int r = e / (Dp - D), c = D + e % (Dp - D);
    if (r < kBQ + kBK) Qs[r * ldq + c] = 0.f;     // Qs and Ks rows
    else Vs[(r - kBQ - kBK) * Dp + c] = 0.f;
  }
  load_tiles(TileSrc{qb, Qs, ldq, scale}, TileSrc{nullptr, nullptr, 0, 1.f},
             q0, kBQ, Sq, D, vec, tid);

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

  int j_lo, j_hi;
  kv_range(q0, kBQ, kBK, Sk, causal, window, &j_lo, &j_hi);
  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * kBK;
    __syncthreads();                   // q written / last tile's readers done
    load_tiles(TileSrc{kb, Ks, ldq, 1.f}, TileSrc{vb, Vs, Dp, 1.f}, k0, kBK,
               Sk, D, vec, tid);
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
      float* ob = out + ((size_t)(b * Hq + h) * Sq + row) * D;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = 4 * lane + jj;
        if (d < D) ob[d] = acc[i][jj] / denom;
      }
    }
  }
}

size_t smem_configured[attn::kMaxDevices];

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(D);
  int err = attn::allow_smem(flash_attention_k, bytes, smem_configured);
  if (err) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  const int vec = attn::vector_ok<float>(D, q, k, v);
  flash_attention_k<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Hq, Hkv,
      Sq, Sk, D, causal, window, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace cc

constexpr int kMaxD = 128;

}  // namespace

// Dynamic shared memory of one block (the wrapper's smem_bytes mirrors it).
extern "C" int flash_attention_smem_bytes(int D, int bf16) {
  return (int)(bf16 ? tc::smem_size(D) : sizeof(float) * cc::smem_floats(D));
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
  if (!bf16)
    return cc::launch(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, window,
                      scale, s);
  if (tc::col_blocks(D) == 1)
    return tc::launch<1>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, window,
                         scale, s);
  return tc::launch<2>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, window,
                       scale, s);
}
