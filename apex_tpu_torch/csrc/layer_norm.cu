// Row LayerNorm / RMSNorm forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/layer_norm.py :: _ln_fwd_kernel (launched by
// _fwd_2d through pl.pallas_call).  Same function: per row, fp32
// statistics (mean and centred variance for LayerNorm, mean square for
// RMSNorm), rsqrt(stat + eps), then the fp32 affine, stored in the
// input dtype.
//
// What bounds it on the H100: bytes.  A [rows, hidden] bf16 call reads
// the input once and writes the output once (2 * 2 * rows * hidden
// bytes) and does ~5 flops per element, far below the ~295 flops/byte
// where the tensor cores would be the limit.  So the design moves each
// byte once from device memory: one block per row, 16-byte loads and
// stores where the row allows, the row's passes after the first hit
// L1/L2 (a 4096-wide bf16 row is 8 KB), and the reductions stay on chip
// (warp shuffles, then one shared-memory hop across the block's warps).
// The TPU kernel's VMEM rule (hidden % 128 == 0) does not apply: any
// hidden size is taken.
//
// Plain C interface (loaded with ctypes): apex_layer_norm_fwd launches
// on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the total.  `sh` holds 33 floats.
__device__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) sh[32] = t;
  }
  __syncthreads();
  const float total = sh[32];
  __syncthreads();  // sh may be reused by the next reduction
  return total;
}

// Eight consecutive elements as fp32, in 16-byte loads (the caller
// guarantees 16-byte alignment).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    o[2 * j] = f.x;
    o[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h2[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// One block per row.  VEC: hidden % 8 == 0 and 16-byte aligned rows —
// every pass moves 8 elements per thread per load; otherwise one
// element at a time (any hidden size).  Passes after the first re-read
// the row from L1/L2, not from device memory.
template <typename TX, typename TW, bool VEC>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
              const TW* __restrict__ b, TX* __restrict__ y, int hidden,
              float eps, int rms) {
  __shared__ float sh[33];
  const size_t row = blockIdx.x;
  const TX* xr = x + row * hidden;
  TX* yr = y + row * hidden;
  const float inv_n = 1.f / (float)hidden;
  constexpr int kStep = VEC ? 8 : 1;
  const int start = threadIdx.x * kStep, stride = blockDim.x * kStep;

  float mean = 0.f;
  if (!rms) {
    float acc = 0.f;
    for (int i = start; i < hidden; i += stride) {
      if (VEC) {
        float v[8];
        load8(xr + i, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += v[j];
      } else {
        acc += to_f(xr[i]);
      }
    }
    mean = block_sum(acc, sh) * inv_n;
  }
  // mean square of (x - mean): the centred variance, or RMSNorm's
  // mean square when mean stays 0
  float ss = 0.f;
  for (int i = start; i < hidden; i += stride) {
    if (VEC) {
      float v[8];
      load8(xr + i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float c = v[j] - mean;
        ss += c * c;
      }
    } else {
      const float c = to_f(xr[i]) - mean;
      ss += c * c;
    }
  }
  const float rstd = rsqrtf(block_sum(ss, sh) * inv_n + eps);
  for (int i = start; i < hidden; i += stride) {
    if (VEC) {
      float v[8], wv[8], bv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      load8(xr + i, v);
      load8(w + i, wv);
      if (b != nullptr) load8(b + i, bv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = (v[j] - mean) * rstd * wv[j] + bv[j];
      store8(yr + i, v);
    } else {
      float v = (to_f(xr[i]) - mean) * rstd * to_f(w[i]);
      if (b != nullptr) v += to_f(b[i]);
      yr[i] = from_f<TX>(v);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, const void* b, void* y, int rows,
            int hidden, float eps, int rms, cudaStream_t stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(y);
  if (hidden % 8 == 0 && bits % 16 == 0)
    ln_fwd_kernel<TX, TW, true><<<rows, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<const TW*>(b), static_cast<TX*>(y), hidden, eps, rms);
  else
    ln_fwd_kernel<TX, TW, false><<<rows, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<const TW*>(b), static_cast<TX*>(y), hidden, eps, rms);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `b` may be null (no bias;
// always null for RMSNorm).
extern "C" int apex_layer_norm_fwd(const void* x, const void* w,
                                   const void* b, void* y, int rows,
                                   int hidden, float eps, int rms,
                                   int x_dtype, int w_dtype, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  if (rows <= 0 || hidden <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, rows, hidden, eps, rms, s);
  else if (x_dtype == 1 && w_dtype == 0)
    launch<__nv_bfloat16, float>(x, w, b, y, rows, hidden, eps, rms, s);
  else if (x_dtype == 0 && w_dtype == 1)
    launch<float, __nv_bfloat16>(x, w, b, y, rows, hidden, eps, rms, s);
  else if (x_dtype == 0 && w_dtype == 0)
    launch<float, float>(x, w, b, y, rows, hidden, eps, rms, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Shared by every entry of the library: the text of a CUDA error code.
extern "C" const char* apex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
