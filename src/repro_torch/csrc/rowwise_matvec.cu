// Row-wise (output-stationary) and cascade matmuls for Hopper (sm_90a):
// y = x @ w, x (B, K) and w (K, N), both float32 or both bfloat16.
//
// Replaces two Pallas TPU kernels of
// src/repro/kernels/rowwise_matvec/kernel.py:
//   rowwise_k  <- rowwise_matmul (_rowwise_kernel): the paper's E4 tiling.
//              Each program owns whole output columns (the AIE's whole
//              matrix rows of W^T) and all of the contraction; x is
//              broadcast once and reused ("row reuse"); no accumulator is
//              shared between programs. Output in x's dtype.
//   cascade_k  <- cascade_matmul (_cascade_kernel): the baseline the
//              paper argues against. The contraction is walked in blocks
//              of bk; each block's partial product is finished and then
//              added to an fp32 accumulator, in k order (the AIE cascade
//              stream). Output float32.
//
// Translation. The TPU grids are (B/bb, N/bn) and (B/bb, N/bn, K/bk) with
// BlockSpecs sized for VMEM and the MXU. Here a block owns a batch tile of
// at most 8 rows and a tile of ct output columns (8 fp32, 16 bf16: one
// 32-byte sector of each row of w; col_tile.cuh), and walks K itself: x's
// rows stream through shared memory in chunks of kc (<= 2048) k's, w is
// read once, straight from device memory with coalesced loads. The
// cascade's k-block loop runs inside the block, in order, with a block
// reduction and the add to the accumulator after each block: the
// sequential accumulation of the TPU's k grid axis, without split-K
// atomics (their sums would change from run to run). block_b and block_n
// are TPU tiling and do not reach the kernels; block_k is the cascade's
// summation structure and does.
//
// Bound on an H100 (SXM, 3.35 TB/s; 67 TFLOP/s fp32, 989 bf16 on the
// tensor cores): at B <= 8 a matvec reads each weight once for 2*B flops,
// so it is bound by bytes: qwen3-0.6b's up-projection (B = 4, K = 1024,
// N = 3072) moves 6.3 MB in bf16, 1.9 us. Parallelism is N / ct column
// tiles times the batch tiles (the wrapper shrinks the batch tile until
// the grid covers the SMs: 64 bf16 column tiles for the N = 1024
// down-projection become 256 blocks of one row); each thread keeps four
// 16-byte (8-byte in bf16) loads of w in flight.
//
// Numerics: fma on the CUDA cores in fp32, no TF32; bf16 inputs widen to
// fp32 exactly; rowwise rounds its bf16 output once, to nearest even.

#include "col_tile.cuh"

namespace {

using namespace coltile;

// One block: the (kc, BT) chunk of x and the warps' sums.
size_t matmul_smem(int kc, int bt, int ct) {
  return 4 * ((size_t)kc * bt + red_floats(1, bt, ct));
}

template <int BT, typename T>
__global__ void __launch_bounds__(kThreads)
rowwise_k(const T* __restrict__ x, const T* __restrict__ w,
          T* __restrict__ y, int B, int K, int N, int ct, int kc, int vec) {
  extern __shared__ float4 smem_rowwise[];
  float* sx = reinterpret_cast<float*>(smem_rowwise);   // (kc, BT)
  float* red = sx + (size_t)kc * BT;
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const int j = blockIdx.x * ct + kVec * t.cg;
  const int col[1] = {j};
  float acc[1][BT][kVec] = {};
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int k1 = min(K, k0 + kc);
    load_operand<BT, T>(sx, x, K, row0, nrow, k0, k1);
    __syncthreads();
    accumulate<1, BT>(acc, sx, w, N, col, N - j, vec, k0, k1, t);
    __syncthreads();
  }
  reduce_warps<1, BT>(acc, red, t);
  __syncthreads();
  for (int o = threadIdx.x; o < BT * ct; o += kThreads) {
    const int r = o / ct;
    const int c = o - r * ct;
    const int jj = blockIdx.x * ct + c;
    if (r < nrow && jj < N)
      store_as(tile_sum<1, BT>(red, ct, 0, r, c),
               y + (size_t)(row0 + r) * N + jj);
  }
}

// BT * ct <= kThreads (the launcher checks): thread o keeps output o's
// accumulator in a register across the k blocks.
template <int BT, typename T>
__global__ void __launch_bounds__(kThreads)
cascade_k(const T* __restrict__ x, const T* __restrict__ w,
          float* __restrict__ y, int B, int K, int N, int bk, int ct, int kc,
          int vec) {
  extern __shared__ float4 smem_cascade[];
  float* sx = reinterpret_cast<float*>(smem_cascade);   // (kc, BT)
  float* red = sx + (size_t)kc * BT;
  const Tile t = make_tile(ct);
  const int row0 = blockIdx.y * BT;
  const int nrow = min(BT, B - row0);
  const int j = blockIdx.x * ct + kVec * t.cg;
  const int col[1] = {j};
  const int o = threadIdx.x;
  const int r = o / ct;
  const int c = o - r * ct;
  float total = 0.0f;                   // the output block, zeroed at k = 0
  for (int kb = 0; kb < K; kb += bk) {
    const int kb1 = min(K, kb + bk);
    float acc[1][BT][kVec] = {};
    for (int k0 = kb; k0 < kb1; k0 += kc) {
      const int k1 = min(kb1, k0 + kc);
      load_operand<BT, T>(sx, x, K, row0, nrow, k0, k1);
      __syncthreads();
      accumulate<1, BT>(acc, sx, w, N, col, N - j, vec, k0, k1, t);
      __syncthreads();
    }
    reduce_warps<1, BT>(acc, red, t);
    __syncthreads();
    if (o < BT * ct) total += tile_sum<1, BT>(red, ct, 0, r, c);
    __syncthreads();                    // red is rewritten by the next block
  }
  const int jj = blockIdx.x * ct + c;
  if (o < BT * ct && r < nrow && jj < N)
    y[(size_t)(row0 + r) * N + jj] = total;
}

template <int BT, typename T>
int launch_rowwise(const void* x, const void* w, void* y, int B, int K,
                   int N, int ct, int kc, int vec, cudaStream_t stream) {
  static size_t configured[kMaxDevices];
  const size_t bytes = matmul_smem(kc, BT, ct);
  int err = allow_smem(rowwise_k<BT, T>, bytes, configured);
  if (err) return err;
  const dim3 grid((N + ct - 1) / ct, (B + BT - 1) / BT);
  rowwise_k<BT, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      B, K, N, ct, kc, vec);
  return (int)cudaGetLastError();
}

template <int BT, typename T>
int launch_cascade(const void* x, const void* w, float* y, int B, int K,
                   int N, int bk, int ct, int kc, int vec,
                   cudaStream_t stream) {
  static size_t configured[kMaxDevices];
  if (BT * ct > kThreads) return (int)cudaErrorInvalidValue;
  const size_t bytes = matmul_smem(kc, BT, ct);
  int err = allow_smem(cascade_k<BT, T>, bytes, configured);
  if (err) return err;
  const dim3 grid((N + ct - 1) / ct, (B + BT - 1) / BT);
  cascade_k<BT, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), y, B, K, N, bk, ct,
      kc, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. bf16: x and w are bfloat16 (else
// float32); bt in {1, 2, 4, 8} rows per block; ct columns per tile
// (valid_ct); kc k's of x per shared-memory chunk; vec: N % 4 == 0 and w
// aligned to four elements. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).

extern "C" size_t rowwise_smem_bytes(int kc, int bt, int ct) {
  return matmul_smem(kc, bt, ct);
}

extern "C" int rowwise_matmul_launch(const void* x, const void* w, void* y,
                                     int B, int K, int N, int bf16, int bt,
                                     int ct, int kc, int vec, void* stream) {
  if (!valid_ct(ct) || kc < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    return bf16 ? launch_rowwise<BT, __nv_bfloat16>(x, w, y, B, K, N, ct, kc,
                                                    vec, s)
                : launch_rowwise<BT, float>(x, w, y, B, K, N, ct, kc, vec, s);
  });
}

extern "C" int cascade_matmul_launch(const void* x, const void* w, float* y,
                                     int B, int K, int N, int bk, int bf16,
                                     int bt, int ct, int kc, int vec,
                                     void* stream) {
  if (!valid_ct(ct) || kc < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return by_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    return bf16 ? launch_cascade<BT, __nv_bfloat16>(x, w, y, B, K, N, bk, ct,
                                                    kc, vec, s)
                : launch_cascade<BT, float>(x, w, y, B, K, N, bk, ct, kc, vec,
                                            s);
  });
}
