// Flat-buffer optimizer kernels for Hopper (sm_90a): the amp unscale with
// a non-finite flag, and Adam/AdamW.
//
// Replaces: apex_tpu/ops/fused_update.py :: _scale_kernel (launched by
// fused_scale) and _adam_kernel (launched by fused_adam_flat), both
// through pl.pallas_call.  Same functions:
//   scale: out = x * scale (fp32 math, stored in out's dtype) and a
//          device fp32 flag, 1.0 when any output is inf or nan;
//   adam:  fp32 math over flat p, g, m, v with the nine hyperparameters
//          [lr, beta1, beta2, eps, weight_decay, 1/bc1, 1/sqrt(bc2),
//          noop, grad_scale] read from a small DEVICE vector, so the
//          bias corrections (from the device step count) and the noop
//          flag (the unscale's overflow flag) never visit the host;
//          noop > 0 leaves p, m and v bit-identical (the kernel returns
//          before any store).  AdamW (decoupled decay) and L2 modes.
//
// Translation: the TPU kernels walk the flat buffer in a parallel grid
// of 64K-element blocks and write per-block flags that XLA reduces with
// a max.  Here a grid-stride loop covers the buffer; the flag is zeroed
// on the stream first, each block ORs its threads' flags with
// __syncthreads_or and one thread stores 1.0 if any was set -- a
// reduction on the device, with no read back.  Every index is 64-bit:
// the slice's flat buffer holds 1.92e9 elements, and its fp32 bytes
// pass 2^32.  The unscale may write in place (out == x), the port's
// counterpart of the JAX buffer donation; Adam always updates p, m and
// v in place.
//
// What bounds both on the H100: bytes.  The unscale reads and writes
// each element once (8 bytes per fp32 element, one flop); Adam reads
// p, g, m, v and writes p, m, v (28 bytes per element, ~15 flops).  So
// the design only streams: 16-byte loads and stores where the buffers
// are aligned, a scalar tail, no shared memory.
//
// Plain C interface (loaded with ctypes): apex_fused_scale and
// apex_fused_adam launch on the caller's stream and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

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

// Four consecutive elements as fp32 (16-byte fp32 / 8-byte bf16 loads).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ bool bad(float v) { return !isfinite(v); }

// out may alias x (element i is read before it is written, by the same
// thread), so neither pointer is __restrict__.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const TI* x, TO* out, const float* __restrict__ scale_ptr,
             float* __restrict__ flag, int64_t n, int vec) {
  const float s = *scale_ptr;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  bool any = false;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      float4 v = load4(x + 4 * i);
      v.x *= s; v.y *= s; v.z *= s; v.w *= s;
      any |= bad(v.x) | bad(v.y) | bad(v.z) | bad(v.w);
      store4(out + 4 * i, v);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const float y = to_f(x[i]) * s;
    any |= bad(y);
    out[i] = from_f<TO>(y);
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) *flag = 1.f;
}

struct AdamHp {
  float lr, b1, b2, eps, wd, inv_bc1, inv_sqrt_bc2, gscale;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, const AdamHp& h,
                                         bool adam_w) {
  g = g * h.gscale;
  if (!adam_w) g = g + h.wd * p;
  m = h.b1 * m + (1.f - h.b1) * g;
  v = h.b2 * v + (1.f - h.b2) * g * g;
  const float denom = sqrtf(v) * h.inv_sqrt_bc2 + h.eps;
  float update = (m * h.inv_bc1) / denom;
  if (adam_w) update = update + h.wd * p;
  p = p - h.lr * update;
}

template <typename TG>
__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, const TG* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v,
            const float* __restrict__ hp, int64_t n, int adam_w, int vec) {
  if (hp[7] > 0.f) return;  // noop: p, m, v stay bit-identical
  const AdamHp h{hp[0], hp[1], hp[2], hp[3], hp[4], hp[5], hp[6], hp[8]};
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      float4 pp = load4(p + 4 * i), mm = load4(m + 4 * i),
             vv = load4(v + 4 * i);
      const float4 gg = load4(g + 4 * i);
      adam_one(pp.x, gg.x, mm.x, vv.x, h, adam_w);
      adam_one(pp.y, gg.y, mm.y, vv.y, h, adam_w);
      adam_one(pp.z, gg.z, mm.z, vv.z, h, adam_w);
      adam_one(pp.w, gg.w, mm.w, vv.w, h, adam_w);
      store4(p + 4 * i, pp);
      store4(m + 4 * i, mm);
      store4(v + 4 * i, vv);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(pp, to_f(g[i]), mm, vv, h, adam_w);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

int blocks_for(int64_t n) {
  const int64_t want = (n / 4 + kThreads - 1) / kThreads;
  return (int)(want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want));
}

bool aligned16(const void* a, const void* b, const void* c) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return bits % 16 == 0;
}

template <typename TI, typename TO>
void launch_scale(const void* x, void* out, const float* scale, float* flag,
                  int64_t n, cudaStream_t s) {
  // four elements per access: 16 bytes of fp32, 8 bytes of bf16
  const int vec = reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TI)) == 0 &&
                  reinterpret_cast<uintptr_t>(out) % (4 * sizeof(TO)) == 0;
  scale_kernel<TI, TO><<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const TI*>(x), static_cast<TO*>(out), scale, flag, n, vec);
}

}  // namespace

// out = x * (*scale); flag (one fp32 on the device) = 1.0 if any output
// is not finite, else 0.0.  dtype codes: 0 = float32, 1 = bfloat16.  out
// may equal x.  scale and flag are device pointers.
extern "C" int apex_fused_scale(const void* x, void* out, const void* scale,
                                void* flag, long long n, int x_dtype,
                                int out_dtype, void* stream) {
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(flag);
  cudaError_t err = cudaMemsetAsync(f, 0, sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const float* sc = static_cast<const float*>(scale);
  if (x_dtype == 0 && out_dtype == 0)
    launch_scale<float, float>(x, out, sc, f, n, s);
  else if (x_dtype == 1 && out_dtype == 0)
    launch_scale<__nv_bfloat16, float>(x, out, sc, f, n, s);
  else if (x_dtype == 0 && out_dtype == 1)
    launch_scale<float, __nv_bfloat16>(x, out, sc, f, n, s);
  else if (x_dtype == 1 && out_dtype == 1)
    launch_scale<__nv_bfloat16, __nv_bfloat16>(x, out, sc, f, n, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// One Adam(W) step over flat fp32 p, m, v (updated in place) with grads
// g (fp32 or bf16, dtype code g_dtype); hp is the device vector
// [lr, beta1, beta2, eps, weight_decay, 1/bc1, 1/sqrt(bc2), noop,
// grad_scale].
extern "C" int apex_fused_adam(void* p, const void* g, void* m, void* v,
                               const void* hp, long long n, int g_dtype,
                               int adam_w, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hp);
  const int vec = aligned16(p, m, v) &&
                  reinterpret_cast<uintptr_t>(g) % (g_dtype ? 8 : 16) == 0;
  if (g_dtype == 0)
    adam_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<float*>(m), static_cast<float*>(v), h, n, adam_w, vec);
  else if (g_dtype == 1)
    adam_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<const __nv_bfloat16*>(g),
        static_cast<float*>(m), static_cast<float*>(v), h, n, adam_w, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
