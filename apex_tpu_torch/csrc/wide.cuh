// Helpers of the "wide" attention family (csrc/flash_wide.cu and
// csrc/paged_wide.cu): the kernels that take what the wgmma and mma
// instances do not -- fp32, bf16 and fp16 operands at any head dim up to
// 256 -- and compute on the CUDA cores in fp32.
//
// The element type T is float, __nv_bfloat16 or __half; the head dim is
// a template bucket D (64, 128 or 256) and the real d (<= D, any value)
// a run-time argument: shared-memory rows are D elements long and their
// columns d..D stay zero.

#pragma once

#include <cuda_fp16.h>

#include <atomic>

#include "hopper.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back: a 16-bit type's feed of a product (p for
// P.V, ds for dq and dk), as the plain versions round them; fp32 as is
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Rows [0, rows) of a shared-memory tile [rows][D] of T from `rows`
// global rows of d elements each, row j at src(j) (nullptr: a dead row,
// zero-filled), by the block's NT threads, rows `stride` elements apart:
// 16-byte cp.async where `vec` (d * sizeof(T) a multiple of 16 and every
// row 16-byte aligned; `base`, any global address, is the source a dead
// row's zero-fill names), else element by element with plain loads.
// Columns d.. are never written.  The caller commits the cp.async group.
template <typename T, int NT, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int rows, int d, bool vec,
                                           int stride, const T* base,
                                           Src src) {
  if (vec) {
    constexpr int kE = 16 / sizeof(T);       // elements a 16-byte unit
    const int units = d / kE;
    for (int i = threadIdx.x; i < rows * units; i += NT) {
      const int j = i / units, c = (i - j * units) * kE;
      const T* s = src(j);
      cp_async16z(smem_addr(dst + j * stride + c), s ? s + c : base,
                  s != nullptr);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += NT) {
      const int j = i / d, c = i - j * d;
      const T* s = src(j);
      dst[j * stride + c] = s ? s[c] : from_f<T>(0.f);
    }
  }
}

// Zero `n` elements of T in shared memory, by the block's NT threads.
template <typename T, int NT>
__device__ __forceinline__ void zero_smem(T* p, int n) {
  for (int i = threadIdx.x; i < n; i += NT) p[i] = from_f<T>(0.f);
}

// The sum of x over the `width` lanes of a group (width a power of two,
// the group's lanes adjacent): every lane of the group gets the same bits
// (each step adds a pair in either order, and fp32 addition commutes).
template <int WIDTH>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < WIDTH; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Allow `bytes` of dynamic shared memory for `kernel` on the current
// device, once per device (a bit of `allowed` each).
template <typename Kernel>
int allow_wide_smem(Kernel kernel, size_t bytes,
                    std::atomic<unsigned>& allowed) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(bit);
  }
  return 0;
}

// The element types by the code the wrappers pass: 0 float, 1 bf16,
// 2 fp16.
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

}  // namespace
