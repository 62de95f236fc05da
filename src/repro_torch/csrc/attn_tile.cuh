// What the two attention kernels (flash_attn.cu, decode_attn.cu) share:
// 16-byte cp.async copies from device memory into shared memory (rows past
// the end read as zeros), the element conversion to fp32, the test for the
// vector path, and the opt-in to more than 48 KB of shared memory.
//
// Tiles stay in their input type in shared memory (bf16 or fp32); each
// kernel converts an element to fp32 where its products read it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);   // values per 16-byte vector
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from `src` to shared `dst` in the background; with
// `bytes` = 0 nothing is read and `dst` gets 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether a launch may take the vector path: D a multiple of the vector
// and every base pointer 16-byte aligned.
template <typename T>
inline bool vector_ok(int D, const void* p0, const void* p1, const void* p2) {
  const uintptr_t m = (uintptr_t)p0 | (uintptr_t)p1 | (uintptr_t)p2;
  return D % Vec<T>::kN == 0 && (m & 15u) == 0;
}

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

}  // namespace attn
