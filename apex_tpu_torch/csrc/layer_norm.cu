// Row LayerNorm / RMSNorm forward and backward for Hopper (sm_90a).  The
// backward (ln_bwd_kernel + ln_bwd_reduce_kernel) has its own note below.
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

// ---------------------------------------------------------------------------
// Backward.  Replaces: apex_tpu/ops/layer_norm.py :: _ln_bwd_kernel
// (launched by _bwd_2d).  Same function: the row statistics are
// recomputed from the saved x (nothing was saved by the forward), then
//   xhat = (x - mean) * rstd,  wdy = dy * w,
//   c1 = mean(wdy) (LayerNorm only),  c2 = mean(wdy * xhat),
//   dx = (wdy - c1 - xhat * c2) * rstd          (in x's dtype),
//   dw = sum over rows of dy * xhat,  db = sum over rows of dy   (fp32).
//
// Translation: the TPU kernel carries dw/db across its sequential grid
// in one accumulator.  Blocks here run in parallel, so each block walks
// a strided set of rows and keeps its own fp32 column sums in shared
// memory (every thread owns fixed columns, so the sums need no atomics),
// writes them as one row of a [nblocks, hidden] partial, and a second
// small kernel sums the partials down the rows.  No atomics into bf16.
//
// What bounds it on the H100: bytes (x and dy read, dx written: 3 * 2 *
// rows * hidden bytes in bf16, ~10 flops per element).  The passes of a
// row after the first hit L1/L2, as in the forward.
// ---------------------------------------------------------------------------

template <typename TX, typename TW, bool VEC>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
              const TX* __restrict__ dy, TX* __restrict__ dx,
              float* __restrict__ dw_part, float* __restrict__ db_part,
              int rows, int hidden, float eps, int rms) {
  extern __shared__ float acc[];  // dw sums [hidden], then db sums [hidden]
  __shared__ float sh[33];
  float* dw_acc = acc;
  float* db_acc = acc + hidden;
  const float inv_n = 1.f / (float)hidden;
  constexpr int kStep = VEC ? 8 : 1;
  const int start = threadIdx.x * kStep, stride = blockDim.x * kStep;
  for (int i = start; i < hidden; i += stride)
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      dw_acc[i + j] = 0.f;
      if (!rms) db_acc[i + j] = 0.f;
    }

  for (size_t row = blockIdx.x; row < (size_t)rows; row += gridDim.x) {
    const TX* xr = x + row * hidden;
    const TX* dyr = dy + row * hidden;
    TX* dxr = dx + row * hidden;
    float mean = 0.f;
    if (!rms) {
      float a = 0.f;
      for (int i = start; i < hidden; i += stride) {
        float v[8];
        if (VEC) load8(xr + i, v); else v[0] = to_f(xr[i]);
#pragma unroll
        for (int j = 0; j < kStep; ++j) a += v[j];
      }
      mean = block_sum(a, sh) * inv_n;
    }
    float ss = 0.f;
    for (int i = start; i < hidden; i += stride) {
      float v[8];
      if (VEC) load8(xr + i, v); else v[0] = to_f(xr[i]);
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        const float c = v[j] - mean;
        ss += c * c;
      }
    }
    const float rstd = rsqrtf(block_sum(ss, sh) * inv_n + eps);
    // c1 = mean(wdy), c2 = mean(wdy * xhat)
    float s1 = 0.f, s2 = 0.f;
    for (int i = start; i < hidden; i += stride) {
      float v[8], g[8], wv[8];
      if (VEC) {
        load8(xr + i, v); load8(dyr + i, g); load8(w + i, wv);
      } else {
        v[0] = to_f(xr[i]); g[0] = to_f(dyr[i]); wv[0] = to_f(w[i]);
      }
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        const float wdy = g[j] * wv[j];
        s1 += wdy;
        s2 += wdy * ((v[j] - mean) * rstd);
      }
    }
    const float c1 = rms ? 0.f : block_sum(s1, sh) * inv_n;
    const float c2 = block_sum(s2, sh) * inv_n;
    for (int i = start; i < hidden; i += stride) {
      float v[8], g[8], wv[8], o[8];
      if (VEC) {
        load8(xr + i, v); load8(dyr + i, g); load8(w + i, wv);
      } else {
        v[0] = to_f(xr[i]); g[0] = to_f(dyr[i]); wv[0] = to_f(w[i]);
      }
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        const float xhat = (v[j] - mean) * rstd;
        o[j] = (g[j] * wv[j] - c1 - xhat * c2) * rstd;
        dw_acc[i + j] += g[j] * xhat;
        if (!rms) db_acc[i + j] += g[j];
      }
      if (VEC) store8(dxr + i, o); else dxr[i] = from_f<TX>(o[0]);
    }
  }
  for (int i = start; i < hidden; i += stride)
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      dw_part[(size_t)blockIdx.x * hidden + i + j] = dw_acc[i + j];
      if (!rms) db_part[(size_t)blockIdx.x * hidden + i + j] = db_acc[i + j];
    }
}

// Column sums of the [nparts, hidden] partials: 32 columns per block,
// 8 row groups per column, then one shared-memory hop.  blockIdx.y
// picks dw (0) or db (1).
__global__ void __launch_bounds__(256)
ln_bwd_reduce_kernel(const float* __restrict__ dw_part,
                     const float* __restrict__ db_part,
                     float* __restrict__ dw, float* __restrict__ db,
                     int nparts, int hidden) {
  __shared__ float sh[8][33];
  const float* part = blockIdx.y ? db_part : dw_part;
  float* out = blockIdx.y ? db : dw;
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < hidden)
    for (int r = threadIdx.y; r < nparts; r += 8)
      s += part[(size_t)r * hidden + col];
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < hidden) {
#pragma unroll
    for (int r = 1; r < 8; ++r) s += sh[r][threadIdx.x];
    out[col] = s;
  }
}

template <typename TX, typename TW>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               float* dw_part, float* db_part, int rows, int hidden,
               int nblocks, float eps, int rms, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)hidden * (rms ? 1 : 2);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx);
  const bool vec = hidden % 8 == 0 && bits % 16 == 0;
  auto kern = vec ? ln_bwd_kernel<TX, TW, true> : ln_bwd_kernel<TX, TW, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<nblocks, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TX*>(dy), static_cast<TX*>(dx), dw_part, db_part,
      rows, hidden, eps, rms);
  return (int)cudaGetLastError();
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

// x, dy, dx [rows, hidden] in x's dtype; w [hidden]; dw_part (and, for
// LayerNorm, db_part) [nblocks, hidden] fp32 scratch; dw (and db)
// [hidden] fp32 outputs.  For RMSNorm (rms = 1) db_part and db are null.
extern "C" int apex_layer_norm_bwd(const void* x, const void* w,
                                   const void* dy, void* dx, void* dw_part,
                                   void* db_part, void* dw, void* db,
                                   int rows, int hidden, int nblocks,
                                   float eps, int rms, int x_dtype,
                                   int w_dtype, void* stream) {
  cudaGetLastError();
  if (rows <= 0 || hidden <= 0 || nblocks <= 0) return 0;
  if (!rms && (db_part == nullptr || db == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dwp = static_cast<float*>(dw_part);
  float* dbp = static_cast<float*>(db_part);
  int err;
  if (x_dtype == 1 && w_dtype == 1)
    err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, w, dy, dx, dwp, dbp, rows, hidden, nblocks, eps, rms, s);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch_bwd<__nv_bfloat16, float>(
        x, w, dy, dx, dwp, dbp, rows, hidden, nblocks, eps, rms, s);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch_bwd<float, __nv_bfloat16>(
        x, w, dy, dx, dwp, dbp, rows, hidden, nblocks, eps, rms, s);
  else if (x_dtype == 0 && w_dtype == 0)
    err = launch_bwd<float, float>(
        x, w, dy, dx, dwp, dbp, rows, hidden, nblocks, eps, rms, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  dim3 grid((hidden + 31) / 32, rms ? 1 : 2);
  ln_bwd_reduce_kernel<<<grid, dim3(32, 8), 0, s>>>(
      dwp, dbp, static_cast<float*>(dw), static_cast<float*>(db), nblocks,
      hidden);
  return (int)cudaGetLastError();
}

// Shared by every entry of the library: the text of a CUDA error code.
extern "C" const char* apex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
