// One GRU step for Hopper (sm_90a), fp32 state with fp32 or bf16 weights.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/gru_cell/kernel.py:
//   gru_step_fused_k                  <- gru_step_fused   (_fused_kernel)
//   gru_blocked_gates_k + _cand_k     <- gru_step_blocked (_blocked_kernel)
// Layouts are JAX's: h (B, H), x_proj (B, 3H), u (H, 3H) with gate
// columns [z | r | h] contracted as h @ u, b (3H). h and r*h are rounded
// to u's dtype before each product, as the TPU kernels cast them; sums are
// fp32 and the gate math follows each TPU kernel's order of additions.
//
// Translation. Both TPU kernels keep h resident and stream whole columns
// of U (the paper's row-wise split: each program finishes its own outputs;
// U's rows are the AIE's rows). Here a block owns a tile of output columns
// and all of the contraction (col_tile.cuh); h of its batch tile (at most
// 8 rows) is staged in shared memory. U is never staged: it is read once
// per step, so it streams from device memory with coalesced loads and the
// fused kernel takes any width.
//
// * gru_step_fused_k, v3: no gate depends on another column, so the grid
//   spreads column tiles over blocks; each block fuses the bias and the
//   gate epilogue into its matvec (the paper's hybrid aggregation).
// * gru_step_fused_k, v1: the candidate needs r*h of EVERY column, a
//   dependency across the whole state. The block walks all column tiles
//   itself, z and r first (z and r*h kept in shared memory), then one
//   block barrier, then the candidate tiles: "whole state in one program",
//   as on the TPU. One block per batch tile: right for the paper's widths,
//   slow at large H (one SM streams all of U).
// * gru_step_blocked: the TPU runs its (3 phases x H/bn) grid in order on
//   one core and stages z and r*h in VMEM scratch; phase 2 reads all of
//   r*h. CUDA blocks run concurrently in no order, so a literal port races.
//   Chosen here: TWO LAUNCHES on the caller's stream. gru_blocked_gates_k
//   computes z and r*h for all columns (phases 0 and 1 need only h, so
//   they run together) into global scratch the wrapper allocates; the
//   stream orders it before gru_blocked_cand_k, which computes the
//   candidate and the update. Each launch spreads H / ct column tiles over
//   the SMs (128-256 blocks at H = 1024-2048), not H / bn = 4-8. A
//   cooperative grid sync, or a thread-block-cluster split with DSMEM, is
//   later work.
//
// Bound on an H100 (SXM, 3.35 TB/s): a step reads U once (3H^2 weights)
// and does 6*B*H^2 flops, so at B <= 8 it is bound by bytes: 12.8 MB, 3.8
// us, at H = 1024 fp32. At the paper's widths (H = 20, 32) the bound is
// nanoseconds and the kernel is bound by latency: the launch, the operand
// copy and the barriers of its tiles.
//
// Numerics: expf/tanhf, no fast math; fma on the CUDA cores, no TF32.

#include "col_tile.cuh"

namespace {

using namespace coltile;

// fused: (H, BT) h operand, the warps' sums, and for v1 the (H, BT) r*h
// operand and (BT, H) z.
size_t fused_smem(int H, int bt, int ct, int v3) {
  const size_t hb = (size_t)H * bt;
  return 4 * (hb + red_floats(v3 ? 3 : 2, bt, ct) + (v3 ? 0 : 2 * hb));
}

// blocked: each of its two kernels holds one (H, BT) operand and the warps'
// sums (two gates in the first, one in the second).
size_t gates_smem(int H, int bt, int ct) {
  return 4 * ((size_t)H * bt + red_floats(2, bt, ct));
}

size_t cand_smem(int H, int bt, int ct) {
  return 4 * ((size_t)H * bt + red_floats(1, bt, ct));
}

template <int BT, typename W>
__global__ void __launch_bounds__(kThreads)
gru_step_fused_k(const float* __restrict__ h, const float* __restrict__ xp,
                 const W* __restrict__ u, const float* __restrict__ b,
                 float* __restrict__ out, int B, int H, int v3, int ct,
                 int vec) {
  extern __shared__ float4 smem_fused[];
  float* sx = reinterpret_cast<float*>(smem_fused);  // (H, BT) h as W
  float* red = sx + (size_t)H * BT;
  float* srh = red + red_floats(v3 ? 3 : 2, BT, ct);  // v1: (H, BT) r*h as W
  float* sz = srh + (size_t)H * BT;                   // v1: (BT, H) z
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const size_t H3 = 3 * (size_t)H;
  const int ntiles = (H + ct - 1) / ct;

  load_operand<BT, W>(sx, h, H, row0, nrow, 0, H);
  __syncthreads();

  if (v3) {                          // ua = h @ u + b, one stacked matvec
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int j = tile * ct + kVec * t.cg;
      const int col[3] = {j, H + j, 2 * H + j};
      float acc[3][BT][kVec] = {};
      accumulate<3, BT>(acc, sx, u, H3, col, H - j, vec, 0, H, t);
      reduce_warps<3, BT>(acc, red, t);
      __syncthreads();
      for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
        const int r = o / ct;
        const int c = o - r * ct;
        const int jj = tile * ct + c;
        if (r >= nrow || jj >= H) continue;
        const size_t row = row0 + r;
        const float* x = xp + row * H3;
        const float uz = tile_sum<3, BT>(red, ct, 0, r, c) + b[jj];
        const float ur = tile_sum<3, BT>(red, ct, 1, r, c) + b[H + jj];
        const float uh = tile_sum<3, BT>(red, ct, 2, r, c) + b[2 * H + jj];
        const float z = sigmoid_f(x[jj] + uz);
        const float rg = sigmoid_f(x[H + jj] + ur);
        const float ht = tanhf(x[2 * H + jj] + rg * uh);
        const float hv = h[row * H + jj];
        out[row * H + jj] = (1.0f - z) * hv + z * ht;
      }
      __syncthreads();               // red is rewritten by the next tile
    }
    return;
  }

  // v1, phase 1: zr = h @ u[:, :2H] + b[:2H]; z, r; r*h staged
  for (int tile = 0; tile < ntiles; ++tile) {
    const int j = tile * ct + kVec * t.cg;
    const int col[2] = {j, H + j};
    float acc[2][BT][kVec] = {};
    accumulate<2, BT>(acc, sx, u, H3, col, H - j, vec, 0, H, t);
    reduce_warps<2, BT>(acc, red, t);
    __syncthreads();
    for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
      const int r = o / ct;
      const int c = o - r * ct;
      const int jj = tile * ct + c;
      if (jj >= H) continue;
      if (r >= nrow) {
        srh[jj * BT + r] = 0.0f;
        continue;
      }
      const size_t row = row0 + r;
      const float* x = xp + row * H3;
      const float zr_z = tile_sum<2, BT>(red, ct, 0, r, c) + b[jj];
      const float zr_r = tile_sum<2, BT>(red, ct, 1, r, c) + b[H + jj];
      const float z = sigmoid_f(x[jj] + zr_z);
      const float rg = sigmoid_f(x[H + jj] + zr_r);
      sz[r * H + jj] = z;
      srh[jj * BT + r] = round_to<W>(rg * h[row * H + jj]);
    }
    __syncthreads();
  }

  // v1, phase 2: ht = tanh(xh + (r*h) @ u[:, 2H:] + b[2H:]); the update
  for (int tile = 0; tile < ntiles; ++tile) {
    const int j = tile * ct + kVec * t.cg;
    const int col[1] = {2 * H + j};
    float acc[1][BT][kVec] = {};
    accumulate<1, BT>(acc, srh, u, H3, col, H - j, vec, 0, H, t);
    reduce_warps<1, BT>(acc, red, t);
    __syncthreads();
    for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
      const int r = o / ct;
      const int c = o - r * ct;
      const int jj = tile * ct + c;
      if (r >= nrow || jj >= H) continue;
      const size_t row = row0 + r;
      const float ht =
          tanhf((xp[row * H3 + 2 * H + jj] + tile_sum<1, BT>(red, ct, 0, r, c))
                + b[2 * H + jj]);
      const float z = sz[r * H + jj];
      const float hv = h[row * H + jj];
      out[row * H + jj] = (1.0f - z) * hv + z * ht;
    }
    __syncthreads();
  }
}

// Blocked step, launch 1 (the TPU kernel's phases 0 and 1): for the block's
// column tile, z = sigmoid(xz + h @ u_z + b_z) and r*h with
// r = sigmoid(xr + h @ u_r + b_r), into the (B, H) scratch zs and rhs.
template <int BT, typename W>
__global__ void __launch_bounds__(kThreads)
gru_blocked_gates_k(const float* __restrict__ h, const float* __restrict__ xp,
                    const W* __restrict__ u, const float* __restrict__ b,
                    float* __restrict__ zs, float* __restrict__ rhs, int B,
                    int H, int ct, int vec) {
  extern __shared__ float4 smem_gates[];
  float* sx = reinterpret_cast<float*>(smem_gates);  // (H, BT) h as W
  float* red = sx + (size_t)H * BT;
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const size_t H3 = 3 * (size_t)H;
  const int tile = blockIdx.x;

  load_operand<BT, W>(sx, h, H, row0, nrow, 0, H);
  __syncthreads();
  const int j = tile * ct + kVec * t.cg;
  const int col[2] = {j, H + j};
  float acc[2][BT][kVec] = {};
  accumulate<2, BT>(acc, sx, u, H3, col, H - j, vec, 0, H, t);
  reduce_warps<2, BT>(acc, red, t);
  __syncthreads();
  for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
    const int r = o / ct;
    const int c = o - r * ct;
    const int jj = tile * ct + c;
    if (r >= nrow || jj >= H) continue;
    const size_t row = row0 + r;
    const float* x = xp + row * H3;
    zs[row * H + jj] =
        sigmoid_f((x[jj] + tile_sum<2, BT>(red, ct, 0, r, c)) + b[jj]);
    const float rg = sigmoid_f((x[H + jj] + tile_sum<2, BT>(red, ct, 1, r, c))
                               + b[H + jj]);
    rhs[row * H + jj] = rg * h[row * H + jj];
  }
}

// Blocked step, launch 2 (phase 2): ht = tanh(xh + (r*h) @ u_h + b_h) over
// ALL of r*h (written by launch 1 for every column tile), then
// h' = (1 - z) * h + z * ht for the block's column tile.
template <int BT, typename W>
__global__ void __launch_bounds__(kThreads)
gru_blocked_cand_k(const float* __restrict__ h, const float* __restrict__ xp,
                   const W* __restrict__ u, const float* __restrict__ b,
                   const float* __restrict__ zs, const float* __restrict__ rhs,
                   float* __restrict__ out, int B, int H, int ct, int vec) {
  extern __shared__ float4 smem_cand[];
  float* sx = reinterpret_cast<float*>(smem_cand);   // (H, BT) r*h as W
  float* red = sx + (size_t)H * BT;
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const size_t H3 = 3 * (size_t)H;
  const int tile = blockIdx.x;

  load_operand<BT, W>(sx, rhs, H, row0, nrow, 0, H);
  __syncthreads();
  const int j = tile * ct + kVec * t.cg;
  const int col[1] = {2 * H + j};
  float acc[1][BT][kVec] = {};
  accumulate<1, BT>(acc, sx, u, H3, col, H - j, vec, 0, H, t);
  reduce_warps<1, BT>(acc, red, t);
  __syncthreads();
  for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
    const int r = o / ct;
    const int c = o - r * ct;
    const int jj = tile * ct + c;
    if (r >= nrow || jj >= H) continue;
    const size_t row = row0 + r;
    const float ht =
        tanhf((xp[row * H3 + 2 * H + jj] + tile_sum<1, BT>(red, ct, 0, r, c))
              + b[2 * H + jj]);
    const float z = zs[row * H + jj];
    const float hv = h[row * H + jj];
    out[row * H + jj] = (1.0f - z) * hv + z * ht;
  }
}

template <int BT, typename W>
int launch_fused(const float* h, const float* xp, const void* u,
                 const float* b, float* out, int B, int H, int v3, int ct,
                 int vec, cudaStream_t stream) {
  static size_t configured[kMaxDevices];
  const size_t bytes = fused_smem(H, BT, ct, v3);
  int err = allow_smem(gru_step_fused_k<BT, W>, bytes, configured);
  if (err) return err;
  const dim3 grid(v3 ? (H + ct - 1) / ct : 1, (B + BT - 1) / BT);
  gru_step_fused_k<BT, W><<<grid, kThreads, bytes, stream>>>(
      h, xp, static_cast<const W*>(u), b, out, B, H, v3, ct, vec);
  return (int)cudaGetLastError();
}

template <int BT, typename W>
int launch_blocked(const float* h, const float* xp, const void* u,
                   const float* b, float* zs, float* rhs, float* out, int B,
                   int H, int ct, int vec, cudaStream_t stream) {
  static size_t gates_configured[kMaxDevices];
  static size_t cand_configured[kMaxDevices];
  const size_t gbytes = gates_smem(H, BT, ct);
  const size_t cbytes = cand_smem(H, BT, ct);
  int err = allow_smem(gru_blocked_gates_k<BT, W>, gbytes, gates_configured);
  if (err) return err;
  err = allow_smem(gru_blocked_cand_k<BT, W>, cbytes, cand_configured);
  if (err) return err;
  const dim3 grid((H + ct - 1) / ct, (B + BT - 1) / BT);
  const W* uw = static_cast<const W*>(u);
  gru_blocked_gates_k<BT, W><<<grid, kThreads, gbytes, stream>>>(
      h, xp, uw, b, zs, rhs, B, H, ct, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  gru_blocked_cand_k<BT, W><<<grid, kThreads, cbytes, stream>>>(
      h, xp, uw, b, zs, rhs, out, B, H, ct, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. u is float32 (bf16 = 0) or bfloat16;
// bt in {1, 2, 4, 8} rows per block; ct columns per tile (valid_ct); vec:
// H % 4 == 0 and u aligned to four elements. Each launches on `stream` and
// returns cudaGetLastError() (0 = launched).

// Dynamic shared memory of one block: kind 0 fused v1, 1 fused v3, 2 the
// larger of the blocked step's two kernels.
extern "C" size_t gru_cell_smem_bytes(int kind, int H, int bt, int ct) {
  if (kind == 2) {
    const size_t g = gates_smem(H, bt, ct);
    const size_t c = cand_smem(H, bt, ct);
    return g > c ? g : c;
  }
  return fused_smem(H, bt, ct, kind == 1);
}

extern "C" int gru_step_fused_launch(const float* h, const float* xp,
                                     const void* u, const float* b,
                                     float* out, int B, int H, int v3,
                                     int bf16, int bt, int ct, int vec,
                                     void* stream) {
  if (!valid_ct(ct)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    return bf16 ? launch_fused<BT, __nv_bfloat16>(h, xp, u, b, out, B, H, v3,
                                                  ct, vec, s)
                : launch_fused<BT, float>(h, xp, u, b, out, B, H, v3, ct,
                                          vec, s);
  });
}

// Two kernels on `stream`: gates into zs and rhs ((B, H) float32 scratch),
// then the candidate and the update into out.
extern "C" int gru_step_blocked_launch(const float* h, const float* xp,
                                       const void* u, const float* b,
                                       float* zs, float* rhs, float* out,
                                       int B, int H, int bf16, int bt, int ct,
                                       int vec, void* stream) {
  if (!valid_ct(ct)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    return bf16 ? launch_blocked<BT, __nv_bfloat16>(h, xp, u, b, zs, rhs, out,
                                                    B, H, ct, vec, s)
                : launch_blocked<BT, float>(h, xp, u, b, zs, rhs, out, B, H,
                                            ct, vec, s);
  });
}
