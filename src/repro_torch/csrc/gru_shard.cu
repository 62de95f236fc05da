// The per-shard GRU step kernels for Hopper (sm_90a), fp32: the compute of
// one rank of the row-wise / cascade split, between two collectives.
//
// Replaces the seven shard kernels of src/repro/kernels/gru_sequence/
// kernel.py (each a whole-block pallas_call, _shard_call :622):
//   rowwise_shard_direct_k<MODE> (direct route) and
//   rowwise_shard_k<MODE> (tile), MODE =
//     kStep <- gru_rowwise_shard_step      :702 (body :632), v3
//     kZr   <- gru_rowwise_shard_zr        :714 (body :646), v1 phase 1
//     kCand <- gru_rowwise_shard_candidate :723 (body :658), v1 phase 2
//   shard_matvec_direct_k (direct route),
//   shard_matvec_k (tile)  <- gru_shard_matvec            :733 (body :667)
//   cascade_gates_k        <- gru_cascade_shard_gates     :741 (body :673)
//   cascade_zr_direct_k (direct route),
//   cascade_zr_k (tile)    <- gru_cascade_shard_zr        :749 (body :685)
//   cascade_update_k       <- gru_cascade_shard_update    :759 (body :697)
// Layouts are JAX's: B batch rows, H the full width, Hl = H / n this
// rank's rows; a row-wise shard's u is (H, G*Hl), gate-major ([z | r | h]
// of its own rows; the v1 pair gets the [z | r] and [h] column slices), a
// cascade shard's u rows are (Hl, 3H). 2-D operands may be row-strided
// views (the callers pass gate slices, the candidate's 2Hl floats into
// the shard's columns: not 16-byte aligned at Hl = 5 or 10); each takes
// its row stride (ld*), columns are unit-stride.
//
// Translation. On the TPU each kernel is one grid step whose operands sit
// whole in VMEM. Here two routes, picked by shape and kernel in Python
// (shard_plan in kernels/gru_sequence/kernel.py):
// - "direct" (the three row-wise modes, the cascade's partial product and
//   its v1 middle phase at the paper's widths, where the contraction is
//   short): each output (row, column) belongs to one thread, or to S
//   lanes of one warp that split K and meet in one fixed butterfly over
//   the G x R values they own. Every global load goes out at entry, the epilogue's operands
//   (xp's G gates, b's, h_local and the candidate's z) included: no shared
//   memory, no barrier, no atomics. Lanes of a slice read neighbouring
//   columns of u with scalar loads (coalesced whatever the alignment), x
//   is a broadcast; blocks of a few warps spread the outputs over the SMs.
//   The candidate's x is the gather of every rank's r*h, so its
//   contraction cannot start before the gather; only its epilogue's
//   operands are fetched beside the first chunk. The cascade's middle
//   phase forms its operand r*h = sigmoid(xp + zr) * h in the lane that
//   reads it, from loads of its own k's, and stores z from the lanes of
//   its first Hl columns.
// - "tile" (long contractions): col_tile.cuh's column tile. A block owns `ct` output columns (of every gate it needs)
//   and a batch tile of at most 8 rows, stages its operand rows in shared
//   memory, streams the shard's u from device memory once, and applies the
//   gate epilogue to its finished columns after a second barrier. The
//   cascade's middle phase computes z and r*h of its batch tile in the
//   block (elementwise, from the psum'd pre-activations) into shared memory
//   as the operand of its product, so the partial product needs no round
//   trip through device memory.
// The two epilogue-only kernels are elementwise, one thread an output,
// reading their operands in place: the v3 cascade gates g, xp and b
// through gate-strided views of the psum'd and projected (B, 3H) arrays
// (no slice copies, no bias add around it); the v1 cascade update the
// candidate's three addends through column slices of the psum, of xp and
// of b (no add kernels around it).
//
// Bound on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s fp32): a shard's operands
// are a few KB at these widths, so every kernel's bound is a few
// nanoseconds (bytes); the kernels are bound by latency instead: the
// launch, the trips to memory and the dependent chain after them, 1-5 us.
// The direct route makes that chain one trip to memory (the contraction's
// and the epilogue's loads together, the cascade's r*h operands too), the
// butterfly and the gate math; the tile's is three trips and two barriers. The collectives around
// them cost more.
//
// Numerics: expf/tanhf, no fast math; fma on the CUDA cores, no TF32. The
// epilogues add in the plain versions' order (x + U.h, then + b). A direct
// route's sum: each lane's k = s, s + S, s + 2S, ... in order by fma from
// 0, then the butterfly adds the slices pairwise (slice s with s ^ 1, then
// s ^ 2, ...). Every sum is taken in the same order on every run.

#include "col_tile.cuh"

namespace {

using namespace coltile;

enum { kStep = 0, kZr = 1, kCand = 2 };

// Gate columns a row-wise mode contracts: z, r, h; z, r; h.
__host__ __device__ constexpr int gates(int mode) {
  return mode == kStep ? 3 : mode == kZr ? 2 : 1;
}

// The (K, BT) operand and the warps' sums of G gates.
size_t shard_smem(int K, int bt, int G, int ct) {
  return 4 * ((size_t)K * bt + red_floats(G, bt, ct));
}

// Row-wise shard: x (B, H) replicated (h_full, or the gathered r*h for
// kCand) against u's gate columns of this rank's rows. kStep (v3): h' of
// the local rows; kZr (v1 phase 1): z into out0, r*h_local into out1;
// kCand (v1 phase 2): h' from the candidate and zin.
template <int MODE, int BT>
__global__ void __launch_bounds__(kThreads)
rowwise_shard_k(const float* __restrict__ x, const float* __restrict__ hl,
                int ldhl, const float* __restrict__ zin,
                const float* __restrict__ xp, int ldxp,
                const float* __restrict__ u, int ldu,
                const float* __restrict__ b, float* __restrict__ out0,
                float* __restrict__ out1, int B, int H, int Hl, int ct,
                int vec) {
  constexpr int G = gates(MODE);
  extern __shared__ float4 smem_rowwise[];
  float* sx = reinterpret_cast<float*>(smem_rowwise);  // (H, BT) x
  float* red = sx + (size_t)H * BT;
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const int tile = blockIdx.x;

  load_operand<BT, float>(sx, x, H, row0, nrow, 0, H);
  __syncthreads();
  const int j = tile * ct + kVec * t.cg;
  int col[G];
#pragma unroll
  for (int g = 0; g < G; ++g) col[g] = g * Hl + j;
  float acc[G][BT][kVec] = {};
  accumulate<G, BT>(acc, sx, u, ldu, col, Hl - j, vec, 0, H, t);
  reduce_warps<G, BT>(acc, red, t);
  __syncthreads();
  for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
    const int r = o / ct;
    const int c = o - r * ct;
    const int jj = tile * ct + c;
    if (r >= nrow || jj >= Hl) continue;
    const size_t row = row0 + r;
    const float* xr = xp + row * ldxp;
    const float hv = hl[row * ldhl + jj];
    const size_t o_at = row * Hl + jj;
    if constexpr (MODE == kStep) {
      const float z =
          sigmoid_f((xr[jj] + tile_sum<G, BT>(red, ct, 0, r, c)) + b[jj]);
      const float rg = sigmoid_f(
          (xr[Hl + jj] + tile_sum<G, BT>(red, ct, 1, r, c)) + b[Hl + jj]);
      const float ht = tanhf(
          xr[2 * Hl + jj]
          + rg * (tile_sum<G, BT>(red, ct, 2, r, c) + b[2 * Hl + jj]));
      out0[o_at] = (1.0f - z) * hv + z * ht;
    } else if constexpr (MODE == kZr) {
      const float z =
          sigmoid_f((xr[jj] + tile_sum<G, BT>(red, ct, 0, r, c)) + b[jj]);
      const float rg = sigmoid_f(
          (xr[Hl + jj] + tile_sum<G, BT>(red, ct, 1, r, c)) + b[Hl + jj]);
      out0[o_at] = z;
      out1[o_at] = rg * hv;
    } else {
      const float ht =
          tanhf((xr[jj] + tile_sum<G, BT>(red, ct, 0, r, c)) + b[jj]);
      const float z = zin[o_at];
      out0[o_at] = (1.0f - z) * hv + z * ht;
    }
  }
}

// The cascade's partial product: out (B, N) = x (B, K) @ w (K, N), K = Hl.
template <int BT>
__global__ void __launch_bounds__(kThreads)
shard_matvec_k(const float* __restrict__ x, int ldx,
               const float* __restrict__ w, int ldw, float* __restrict__ out,
               int B, int K, int N, int ct, int vec) {
  extern __shared__ float4 smem_matvec[];
  float* sx = reinterpret_cast<float*>(smem_matvec);   // (K, BT) x
  float* red = sx + (size_t)K * BT;
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const int tile = blockIdx.x;

  load_operand<BT, float>(sx, x, ldx, row0, nrow, 0, K);
  __syncthreads();
  const int j = tile * ct + kVec * t.cg;
  const int col[1] = {j};
  float acc[1][BT][kVec] = {};
  accumulate<1, BT>(acc, sx, w, ldw, col, N - j, vec, 0, K, t);
  reduce_warps<1, BT>(acc, red, t);
  __syncthreads();
  for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
    const int r = o / ct;
    const int c = o - r * ct;
    const int jj = tile * ct + c;
    if (r >= nrow || jj >= N) continue;
    out[(size_t)(row0 + r) * N + jj] = tile_sum<1, BT>(red, ct, 0, r, c);
  }
}

// v1 cascade middle phase: z and r from the local slices of the psum'd
// z,r pre-activations zr (B, 2Hl) and xp (B, 2Hl); r*h of the block's batch
// tile staged in shared memory as the operand of p (B, N) = (r*h) @ u
// (Hl, N). Blocks of column tile 0 write z.
template <int BT>
__global__ void __launch_bounds__(kThreads)
cascade_zr_k(const float* __restrict__ zr, const float* __restrict__ xp,
             const float* __restrict__ h, const float* __restrict__ u,
             int ldu, float* __restrict__ zout, float* __restrict__ p, int B,
             int Hl, int N, int ct, int vec) {
  extern __shared__ float4 smem_czr[];
  float* sx = reinterpret_cast<float*>(smem_czr);      // (Hl, BT) r*h
  float* red = sx + (size_t)Hl * BT;
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const int tile = blockIdx.x;
  const size_t w2 = 2 * (size_t)Hl;

  for (int i = threadIdx.x; i < Hl * BT; i += kThreads) {
    const int k = i / BT;
    const int r = i - k * BT;
    float v = 0.0f;
    if (r < nrow) {
      const size_t row = row0 + r;
      const float rg = sigmoid_f(xp[row * w2 + Hl + k] + zr[row * w2 + Hl + k]);
      v = rg * h[row * Hl + k];
      if (tile == 0)
        zout[row * Hl + k] = sigmoid_f(xp[row * w2 + k] + zr[row * w2 + k]);
    }
    sx[i] = v;
  }
  __syncthreads();
  const int j = tile * ct + kVec * t.cg;
  const int col[1] = {j};
  float acc[1][BT][kVec] = {};
  accumulate<1, BT>(acc, sx, u, ldu, col, N - j, vec, 0, Hl, t);
  reduce_warps<1, BT>(acc, red, t);
  __syncthreads();
  for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
    const int r = o / ct;
    const int c = o - r * ct;
    const int jj = tile * ct + c;
    if (r >= nrow || jj >= N) continue;
    p[(size_t)(row0 + r) * N + jj] = tile_sum<1, BT>(red, ct, 0, r, c);
  }
}

// v3 cascade epilogue, one thread an element (row, c) of the new h shard
// (B, Hl). g and xp are read where they lie: gate k of row `row` at
// row * ld + k * gs + c (the local (B, 3Hl) slices: gs = Hl; gate views
// of the full (B, 3H) arrays: gs = H, the rank's offset in the pointer).
// BIAS: b's gate k at k * gsb + c is added to g first, rounded on its own
// (JAX's psum(...) + b, then xp + g). Every load goes out at entry; z's
// and r's sigmoids do not wait on each other. The candidate and the
// update are written as nvcc contracted them in the kernel this one
// replaces (the add kernel, the slices' copies and a loop over contiguous
// slices), so the results are those bit for bit.
constexpr int kGatesThreads = 128;   // a block of the v3 cascade epilogue

template <bool BIAS>
__global__ void __launch_bounds__(kGatesThreads)
cascade_gates_k(const float* __restrict__ g, int ldg, int gsg,
                const float* __restrict__ xp, int ldx, int gsx,
                const float* __restrict__ b, int gsb,
                const float* __restrict__ h, float* __restrict__ out, int B,
                int Hl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Hl) return;
  const int row = i / Hl;
  const int c = i - row * Hl;
  const float* gr = g + row * ldg + c;
  const float* xr = xp + row * ldx + c;
  float gz = __ldg(gr), gg = __ldg(gr + gsg), gh = __ldg(gr + 2 * gsg);
  const float xz = __ldg(xr), xg = __ldg(xr + gsx), xh = __ldg(xr + 2 * gsx);
  const float hv = __ldg(h + i);
  if constexpr (BIAS) {
    gz = __fadd_rn(gz, __ldg(b + c));
    gg = __fadd_rn(gg, __ldg(b + gsb + c));
    gh = __fadd_rn(gh, __ldg(b + 2 * gsb + c));
  }
  const float z = sigmoid_f(__fadd_rn(xz, gz));
  const float r = sigmoid_f(__fadd_rn(xg, gg));
  const float ht = tanhf(__fmaf_rn(r, gh, xh));
  out[i] = __fmaf_rn(1.0f - z, hv, __fmul_rn(z, ht));
}

// v1 cascade epilogue, one thread an element (row, c) of the new h shard
// (B, Hl): (1 - z) h + z tanh(ht_in), z and h contiguous. The candidate's
// pre-activation is read where its addends lie: row `row` of the psum'd
// partial at ht + row * ldt + c (a column slice of the (B, H) psum: ldt =
// H, the rank's offset in the pointer; a finished local (B, Hl) ht_in:
// ldt = Hl), and, where given, this rank's columns of xp's candidate gate
// (xp + row * ldx + c, a column slice of the (B, 3H) projection) and of b
// (b + c). They are added in JAX's order, (xp + psum) + b, each rounded on
// its own, as the two add kernels this replaces rounded them. A block
// row of the grid is a batch row, so every load's address is at hand at
// entry (no division by Hl before the loads: it delayed them by 0.1 us on
// an H100), and every load goes out at once. The update is written as
// nvcc contracted the grid-stride kernel this one replaces (its SASS: FMUL
// z*tanh, then FFMA (1 - z), h), so the results are that sequence's bit
// for bit.
__global__ void __launch_bounds__(kGatesThreads)
cascade_update_k(const float* __restrict__ z, const float* __restrict__ ht,
                 int ldt, const float* __restrict__ xp, int ldx,
                 const float* __restrict__ b, const float* __restrict__ h,
                 float* __restrict__ out, int Hl) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (c >= Hl) return;
  const int i = row * Hl + c;
  const float zv = __ldg(z + i), hv = __ldg(h + i);
  float a = __ldg(ht + row * ldt + c);
  const float xv = xp != nullptr ? __ldg(xp + row * ldx + c) : 0.0f;
  const float bv = b != nullptr ? __ldg(b + c) : 0.0f;
  if (xp != nullptr) a = __fadd_rn(xv, a);
  if (b != nullptr) a = __fadd_rn(a, bv);
  out[i] = __fmaf_rn(1.0f - zv, hv, __fmul_rn(zv, tanhf(a)));
}

// --- the direct route ------------------------------------------------------

constexpr int kLaneK = 8;   // k's each lane loads per chunk of the contraction

// acc[g][r] += x[row0 + r][k] * w[k][col[g]] over this lane's k's of [0, K):
// k = s, s + S, ... in chunks of kLaneK, each chunk's loads all issued
// before its first product (one chunk where K <= S * kLaneK). `live`: the
// lane's column is inside the matrix; rows nrow..R-1 read nothing.
template <int G, int S, int R>
__device__ __forceinline__ void direct_dot(float (&acc)[G][R],
                                           const float* __restrict__ x,
                                           size_t ldx, int row0, int nrow,
                                           const float* __restrict__ w,
                                           size_t ldw, const int (&col)[G],
                                           bool live, int K, int s) {
  for (int k0 = s; k0 < K; k0 += S * kLaneK) {
    float wv[kLaneK][G];
    float xv[kLaneK][R];
#pragma unroll
    for (int i = 0; i < kLaneK; ++i) {
      const int k = k0 + i * S;
#pragma unroll
      for (int g = 0; g < G; ++g)
        wv[i][g] = live && k < K ? __ldg(w + (size_t)k * ldw + col[g]) : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r)
        xv[i][r] = k < K && r < nrow
                       ? __ldg(x + (size_t)(row0 + r) * ldx + k) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kLaneK; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (k0 + i * S < K) acc[g][r] = fmaf(xv[i][r], wv[i][g], acc[g][r]);
  }
}

// direct_dot for an operand each lane forms from loads (the cascade's r*h:
// a sigmoid a k): x.load(r, k, in) loads what row r's operand at k is made
// of (a zero operand where `in` is false: k past K or r past nrow),
// x.value(raw) makes it, for k < K only, after all of the chunk's loads
// have gone out, so that no arithmetic (and no branch of the division)
// sits between them. A loop of its own: folding direct_dot's plain
// loads into this form made the row-wise zr kernel 15 % slower on an
// H100 (ptxas scheduled it otherwise).
template <int G, int S, int R, typename X>
__device__ __forceinline__ void direct_dot_formed(float (&acc)[G][R],
                                                  const X& x, int nrow,
                                                  const float* __restrict__ w,
                                                  size_t ldw,
                                                  const int (&col)[G],
                                                  bool live, int K, int s) {
  for (int k0 = s; k0 < K; k0 += S * kLaneK) {
    float wv[kLaneK][G];
    typename X::Raw xv[kLaneK][R];
#pragma unroll
    for (int i = 0; i < kLaneK; ++i) {
      const int k = k0 + i * S;
#pragma unroll
      for (int g = 0; g < G; ++g)
        wv[i][g] = live && k < K ? __ldg(w + (size_t)k * ldw + col[g]) : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) xv[i][r] = x.load(r, k, k < K && r < nrow);
    }
#pragma unroll
    for (int i = 0; i < kLaneK; ++i) {
      if (k0 + i * S >= K) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = x.value(xv[i][r]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][r] = fmaf(v, wv[i][g], acc[g][r]);
      }
    }
  }
}

// Sum the S slices of each column: a butterfly over the lanes that share
// it (lane = s * (32 / S) + c), so every slice ends with the same sums.
template <int G, int S, int R>
__device__ __forceinline__ void slice_sum(float (&acc)[G][R]) {
#pragma unroll
  for (int off = 32 / S; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], off);
}

// A direct-route thread's place: a warp covers 32 / S neighbouring columns
// of R batch rows with S slices of K each; a block's warps take
// neighbouring column groups, the grid's y the batch rows.
struct Lane {
  int s;      // slice of K
  int j;      // column
  int row0;   // first batch row
  int nrow;   // batch rows inside the matrix (<= R)
};

template <int S, int R>
__device__ __forceinline__ Lane direct_lane(int B) {
  constexpr int CW = 32 / S;
  const int lane = threadIdx.x & 31;
  Lane l;
  l.s = lane / CW;
  l.j = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * CW
        + lane % CW;
  l.row0 = blockIdx.y * R;
  l.nrow = min(R, B - l.row0);
  return l;
}

// The cascade's partial product on the direct route: out (B, N) = x (B, K)
// @ w (K, N).
template <int S, int R>
__global__ void __launch_bounds__(kThreads)
shard_matvec_direct_k(const float* __restrict__ x, int ldx,
                      const float* __restrict__ w, int ldw,
                      float* __restrict__ out, int B, int K, int N) {
  const Lane l = direct_lane<S, R>(B);
  const int col[1] = {l.j};
  float acc[1][R] = {};
  direct_dot<1, S, R>(acc, x, ldx, l.row0, l.nrow, w, ldw, col, l.j < N, K,
                      l.s);
  slice_sum<1, S, R>(acc);
  if (l.s != 0 || l.j >= N) return;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < l.nrow) out[(size_t)(l.row0 + r) * N + l.j] = acc[0][r];
}

// The row-wise modes on the direct route: x (B, H) replicated (h_full, or
// the gathered r*h for kCand) against u's G gate columns of the lane's
// column j. Every operand of the epilogue (xp's G gates, b's, h_local and,
// for kCand, z) is loaded at entry, beside the first chunk of the
// contraction; kCand's x cannot be fetched any earlier, since it is the
// gather's result. Slice 0's lanes store, in the plain versions' order:
// kStep h'; kZr z into out0 and r*h_local into out1; kCand h' from the
// candidate and zin.
template <int MODE, int S, int R>
__global__ void __launch_bounds__(kThreads)
rowwise_shard_direct_k(const float* __restrict__ x,
                       const float* __restrict__ hl, int ldhl,
                       const float* __restrict__ zin,
                       const float* __restrict__ xp, int ldxp,
                       const float* __restrict__ u, int ldu,
                       const float* __restrict__ b, float* __restrict__ out0,
                       float* __restrict__ out1, int B, int H, int Hl) {
  constexpr int G = gates(MODE);
  const Lane l = direct_lane<S, R>(B);
  const bool live = l.j < Hl;
  float xg[G][R], hv[R], zv[MODE == kCand ? R : 1], bg[G];
#pragma unroll
  for (int g = 0; g < G; ++g) bg[g] = live ? __ldg(b + g * Hl + l.j) : 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = live && r < l.nrow;
    const size_t row = l.row0 + r;
#pragma unroll
    for (int g = 0; g < G; ++g)
      xg[g][r] = in ? __ldg(xp + row * ldxp + g * Hl + l.j) : 0.0f;
    hv[r] = in ? __ldg(hl + row * ldhl + l.j) : 0.0f;
    if constexpr (MODE == kCand)
      zv[r] = in ? __ldg(zin + row * Hl + l.j) : 0.0f;
  }
  int col[G];
#pragma unroll
  for (int g = 0; g < G; ++g) col[g] = g * Hl + l.j;
  float acc[G][R] = {};
  direct_dot<G, S, R>(acc, x, H, l.row0, l.nrow, u, ldu, col, live, H, l.s);
  slice_sum<G, S, R>(acc);
  if (l.s != 0 || !live) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= l.nrow) continue;
    const size_t o_at = (size_t)(l.row0 + r) * Hl + l.j;
    if constexpr (MODE == kStep) {
      const float z = sigmoid_f((xg[0][r] + acc[0][r]) + bg[0]);
      const float rg = sigmoid_f((xg[1][r] + acc[1][r]) + bg[1]);
      const float ht = tanhf(xg[2][r] + rg * (acc[2][r] + bg[2]));
      out0[o_at] = (1.0f - z) * hv[r] + z * ht;
    } else if constexpr (MODE == kZr) {
      out0[o_at] = sigmoid_f((xg[0][r] + acc[0][r]) + bg[0]);
      out1[o_at] = sigmoid_f((xg[1][r] + acc[1][r]) + bg[1]) * hv[r];
    } else {
      const float ht = tanhf((xg[0][r] + acc[0][r]) + bg[0]);
      out0[o_at] = (1.0f - zv[r]) * hv[r] + zv[r] * ht;
    }
  }
}

// A read-only load that the compiler issues where it stands (asm
// volatile: not moved after other code or into a branch).
__device__ __forceinline__ float load_in_place(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// The loads of one (row, k) of the cascade's operand: the r gate's xp and
// psum'd pre-activation zr, and h.
struct CascadeRaw {
  float xp, zr, h;
};

// The cascade's operand r*h = sigmoid(xp + zr) * h at (row0 + r, k), in the
// plain version's order; zr and xp of row stride 2Hl, the r gate Hl in.
// Its loads are issued whether or not they are needed, at a clamped (row,
// k), and kept in program order (load_in_place), so that no branch and no
// sigmoid sits between them: the same loads under `in ? ... : 0` made
// ptxas spill in 5 of the 18 instances (a stack frame beside the
// division's slow-path call).
struct CascadeRh {
  using Raw = CascadeRaw;
  const float* zr;
  const float* xp;
  const float* h;
  int Hl;
  int row0;
  int nrow;
  __device__ __forceinline__ CascadeRaw load(int r, int k, bool in) const {
    const size_t row = row0 + min(r, nrow - 1);
    const int kk = min(k, Hl - 1);
    const size_t at = row * 2 * Hl + Hl + kk;
    const CascadeRaw v = {load_in_place(xp + at), load_in_place(zr + at),
                          load_in_place(h + row * Hl + kk)};
    return in ? v : CascadeRaw{};
  }
  __device__ __forceinline__ float value(const CascadeRaw& v) const {
    return sigmoid_f(v.xp + v.zr) * v.h;
  }
};

// The v1 cascade's middle phase on the direct route: p (B, N) = (r*h) (B,
// Hl) @ u (Hl, N), K = Hl. Each lane forms the r*h of its own k's from
// their loads (zr, xp of the r gate, h), in the plain version's order
// sigmoid(xp + zr) * h, as the operand of its chunk (all loads first, z's
// too): no staging, no barrier. Slice 0 of the lanes of columns j < Hl
// stores z (the grid covers max(N, Hl) columns), those of columns j < N
// the product.
template <int S, int R>
__global__ void __launch_bounds__(kThreads)
cascade_zr_direct_k(const float* __restrict__ zr,
                    const float* __restrict__ xp,
                    const float* __restrict__ h, const float* __restrict__ u,
                    int ldu, float* __restrict__ zout, float* __restrict__ p,
                    int B, int Hl, int N) {
  const Lane l = direct_lane<S, R>(B);
  const size_t w2 = 2 * (size_t)Hl;
  const bool zcol = l.s == 0 && l.j < Hl;
  float zx[R], zz[R];          // z's loads at entry, its sigmoid at the end
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t at = (l.row0 + r) * w2 + l.j;
    const bool in = zcol && r < l.nrow;
    zx[r] = in ? __ldg(xp + at) : 0.0f;
    zz[r] = in ? __ldg(zr + at) : 0.0f;
  }
  const int col[1] = {l.j};
  float acc[1][R] = {};
  direct_dot_formed<1, S, R>(acc, CascadeRh{zr, xp, h, Hl, l.row0, l.nrow},
                             l.nrow, u, ldu, col, l.j < N, Hl, l.s);
  slice_sum<1, S, R>(acc);
  if (l.s != 0) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= l.nrow) continue;
    const size_t row = l.row0 + r;
    if (l.j < Hl) zout[row * Hl + l.j] = sigmoid_f(zx[r] + zz[r]);
    if (l.j < N) p[row * N + l.j] = acc[0][r];
  }
}

// f(std::integral_constant<int, S>) for the slices of K, s in {1, 2, 4,
// 8, 16, 32}.
template <typename F>
int by_slices(int s, F&& f) {
  switch (s) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// f(std::integral_constant<int, R>) for a direct-route thread's batch rows,
// r in {1, 2, 4} (8 never won a sweep of tools/shard_tiles.py: PERF.md).
template <typename F>
int by_rows(int r, F&& f) {
  switch (r) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// Grid of the direct route: blocks of `warps` warps over ncols columns
// (32 / S a warp) and B rows (R a thread).
dim3 direct_grid(int ncols, int B, int slices, int rows, int warps) {
  const int cols = warps * (32 / slices);
  return dim3((ncols + cols - 1) / cols, (B + rows - 1) / rows);
}

bool valid_direct(int warps) { return warps >= 1 && warps <= kWarps; }

// --- the tile route's launches ----------------------------------------------

dim3 tiles(int ncols, int B, int bt, int ct) {
  return dim3((ncols + ct - 1) / ct, (B + bt - 1) / bt);
}

template <int MODE, int BT>
int launch_rowwise(const float* x, const float* hl, int ldhl,
                   const float* zin, const float* xp, int ldxp,
                   const float* u, int ldu, const float* b, float* out0,
                   float* out1, int B, int H, int Hl, int ct, int vec,
                   cudaStream_t stream) {
  static size_t configured[kMaxDevices];
  constexpr int G = gates(MODE);
  const size_t bytes = shard_smem(H, BT, G, ct);
  int err = allow_smem(rowwise_shard_k<MODE, BT>, bytes, configured);
  if (err) return err;
  rowwise_shard_k<MODE, BT><<<tiles(Hl, B, BT, ct), kThreads, bytes,
                              stream>>>(x, hl, ldhl, zin, xp, ldxp, u, ldu,
                                        b, out0, out1, B, H, Hl, ct, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. bt in {1, 2, 4, 8} rows per block; ct
// columns per tile (valid_ct); vec: the gate offsets and row strides are
// multiples of 4 and u (w) is 16-byte aligned. Each launches on `stream`
// and returns cudaGetLastError() (0 = launched).

// Dynamic shared memory of one matvec block: a (K, bt) operand and the
// warps' sums of G gates at ct columns.
extern "C" size_t gru_shard_smem_bytes(int K, int bt, int G, int ct) {
  return shard_smem(K, bt, G, ct);
}

// mode 0: gru_rowwise_shard_step, 1: gru_rowwise_shard_zr (out1 = r*h),
// 2: gru_rowwise_shard_candidate (x = the gathered r*h, zin = z).
extern "C" int gru_rowwise_shard_launch(int mode, const float* x,
                                        const float* hl, int ldhl,
                                        const float* zin, const float* xp,
                                        int ldxp, const float* u, int ldu,
                                        const float* b, float* out0,
                                        float* out1, int B, int H, int Hl,
                                        int bt, int ct, int vec,
                                        void* stream) {
  if (!valid_ct(ct) || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    switch (mode) {
      case kStep:
        return launch_rowwise<kStep, BT>(x, hl, ldhl, zin, xp, ldxp, u, ldu,
                                         b, out0, out1, B, H, Hl, ct, vec, s);
      case kZr:
        return launch_rowwise<kZr, BT>(x, hl, ldhl, zin, xp, ldxp, u, ldu, b,
                                       out0, out1, B, H, Hl, ct, vec, s);
      default:
        return launch_rowwise<kCand, BT>(x, hl, ldhl, zin, xp, ldxp, u, ldu,
                                         b, out0, out1, B, H, Hl, ct, vec, s);
    }
  });
}

extern "C" int gru_shard_matvec_launch(const float* x, int ldx,
                                       const float* w, int ldw, float* out,
                                       int B, int K, int N, int bt, int ct,
                                       int vec, void* stream) {
  if (!valid_ct(ct)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    static size_t configured[kMaxDevices];
    const size_t bytes = shard_smem(K, BT, 1, ct);
    int err = allow_smem(shard_matvec_k<BT>, bytes, configured);
    if (err) return err;
    shard_matvec_k<BT><<<tiles(N, B, BT, ct), kThreads, bytes, s>>>(
        x, ldx, w, ldw, out, B, K, N, ct, vec);
    return (int)cudaGetLastError();
  });
}

// The direct route (rows of R in {1, 2, 4}, slices S in {1, 2, 4, 8,
// 16, 32}, `warps` warps of 32 a block, at most 8): the cascade's partial
// product out (B, N) = x (B, K) @ w (K, N) ...
extern "C" int gru_shard_matvec_direct_launch(const float* x, int ldx,
                                              const float* w, int ldw,
                                              float* out, int B, int K, int N,
                                              int slices, int rows, int warps,
                                              void* stream) {
  if (!valid_direct(warps)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return by_slices(slices, [&](auto sc) {
    return by_rows(rows, [&](auto rc) {
      constexpr int S = decltype(sc)::value, R = decltype(rc)::value;
      shard_matvec_direct_k<S, R><<<direct_grid(N, B, S, R, warps),
                                    32 * warps, 0, st>>>(x, ldx, w, ldw, out,
                                                         B, K, N);
      return (int)cudaGetLastError();
    });
  });
}

// ... and the three row-wise modes (gru_rowwise_shard_launch's operands and
// modes).
extern "C" int gru_rowwise_shard_direct_launch(
    int mode, const float* x, const float* hl, int ldhl, const float* zin,
    const float* xp, int ldxp, const float* u, int ldu, const float* b,
    float* out0, float* out1, int B, int H, int Hl, int slices, int rows,
    int warps, void* stream) {
  if (!valid_direct(warps) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return by_slices(slices, [&](auto sc) {
    return by_rows(rows, [&](auto rc) {
      constexpr int S = decltype(sc)::value, R = decltype(rc)::value;
      const dim3 grid = direct_grid(Hl, B, S, R, warps);
      switch (mode) {
        case kStep:
          rowwise_shard_direct_k<kStep, S, R><<<grid, 32 * warps, 0, st>>>(
              x, hl, ldhl, zin, xp, ldxp, u, ldu, b, out0, out1, B, H, Hl);
          break;
        case kZr:
          rowwise_shard_direct_k<kZr, S, R><<<grid, 32 * warps, 0, st>>>(
              x, hl, ldhl, zin, xp, ldxp, u, ldu, b, out0, out1, B, H, Hl);
          break;
        default:
          rowwise_shard_direct_k<kCand, S, R><<<grid, 32 * warps, 0, st>>>(
              x, hl, ldhl, zin, xp, ldxp, u, ldu, b, out0, out1, B, H, Hl);
      }
      return (int)cudaGetLastError();
    });
  });
}

extern "C" int gru_cascade_shard_zr_launch(const float* zr, const float* xp,
                                           const float* h, const float* u,
                                           int ldu, float* z, float* p, int B,
                                           int Hl, int N, int bt, int ct,
                                           int vec, void* stream) {
  if (!valid_ct(ct)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    static size_t configured[kMaxDevices];
    const size_t bytes = shard_smem(Hl, BT, 1, ct);
    int err = allow_smem(cascade_zr_k<BT>, bytes, configured);
    if (err) return err;
    cascade_zr_k<BT><<<tiles(N, B, BT, ct), kThreads, bytes, s>>>(
        zr, xp, h, u, ldu, z, p, B, Hl, N, ct, vec);
    return (int)cudaGetLastError();
  });
}

// ... and the v1 cascade's middle phase (gru_cascade_shard_zr_launch's
// operands).
extern "C" int gru_cascade_shard_zr_direct_launch(
    const float* zr, const float* xp, const float* h, const float* u, int ldu,
    float* z, float* p, int B, int Hl, int N, int slices, int rows, int warps,
    void* stream) {
  if (!valid_direct(warps)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return by_slices(slices, [&](auto sc) {
    return by_rows(rows, [&](auto rc) {
      constexpr int S = decltype(sc)::value, R = decltype(rc)::value;
      cascade_zr_direct_k<S, R><<<direct_grid(N > Hl ? N : Hl, B, S, R,
                                              warps),
                                  32 * warps, 0, st>>>(zr, xp, h, u, ldu, z,
                                                       p, B, Hl, N);
      return (int)cudaGetLastError();
    });
  });
}

// g and xp: row and gate strides (ld*, gs*) in floats; b null (no bias)
// or gate stride gsb. One thread an element, kGatesThreads a block.
extern "C" int gru_cascade_shard_gates_launch(const float* g, int ldg,
                                              int gsg, const float* xp,
                                              int ldx, int gsx, const float* b,
                                              int gsb, const float* h,
                                              float* out, int B, int Hl,
                                              void* stream) {
  const int n = B * Hl;
  const int grid = (n + kGatesThreads - 1) / kGatesThreads;
  cudaStream_t st = (cudaStream_t)stream;
  if (b != nullptr)
    cascade_gates_k<true><<<grid, kGatesThreads, 0, st>>>(
        g, ldg, gsg, xp, ldx, gsx, b, gsb, h, out, B, Hl);
  else
    cascade_gates_k<false><<<grid, kGatesThreads, 0, st>>>(
        g, ldg, gsg, xp, ldx, gsx, b, gsb, h, out, B, Hl);
  return (int)cudaGetLastError();
}

// ht: row stride ldt in floats; xp (row stride ldx) and b null where the
// caller passes a finished pre-activation. One thread an element: a grid
// row per batch row (B at most 65535), the row's Hl columns over blocks
// of at most kGatesThreads threads, whole warps.
extern "C" int gru_cascade_shard_update_launch(const float* z,
                                               const float* ht, int ldt,
                                               const float* xp, int ldx,
                                               const float* b,
                                               const float* h, float* out,
                                               int B, int Hl, void* stream) {
  if (B < 1 || B > 65535 || Hl < 1) return (int)cudaErrorInvalidValue;
  const int warps32 = (Hl + 31) / 32 * 32;
  const int threads = warps32 < kGatesThreads ? warps32 : kGatesThreads;
  const dim3 grid((Hl + threads - 1) / threads, B);
  cascade_update_k<<<grid, threads, 0, (cudaStream_t)stream>>>(
      z, ht, ldt, xp, ldx, b, h, out, Hl);
  return (int)cudaGetLastError();
}
