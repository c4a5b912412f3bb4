// Flat-buffer optimizer kernels for Hopper (sm_90a): the amp unscale with
// a non-finite flag, Adam/AdamW, the L2 norm, LAMB's first phase, SGD
// and Adagrad.
//
// Replaces: apex_tpu/ops/fused_update.py :: _scale_kernel (launched by
// fused_scale), _adam_kernel (fused_adam_flat), _l2norm_kernel
// (fused_l2norm), _lamb1_kernel (fused_lamb_phase1_flat), _sgd_kernel
// (fused_sgd_flat) and _adagrad_kernel (fused_adagrad_flat), all
// through pl.pallas_call.  Same functions:
//   scale:   out = x * scale (fp32 math, stored in out's dtype) and a
//            device fp32 flag, 1.0 when any output is inf or nan;
//   adam:    fp32 math over flat p, g, m, v with the nine hyperparameters
//            [lr, beta1, beta2, eps, weight_decay, 1/bc1, 1/sqrt(bc2),
//            noop, grad_scale] read from a small DEVICE vector, so the
//            bias corrections (from the device step count) and the noop
//            flag (the unscale's overflow flag) never visit the host;
//            noop > 0 leaves p, m and v bit-identical (the kernel returns
//            before any store).  AdamW (decoupled decay) and L2 modes.
//   l2norm:  sqrt of the fp32 sum of squares, written to a device scalar;
//   lamb1:   new m, v and the raw direction u = m^/(sqrt(v^) + eps) + wd p
//            (the trust ratios are applied per leaf by the caller); its
//            vector carries a noop flag the TPU kernel has not: noop > 0
//            leaves m and v bit-identical and writes u = 0, which makes
//            the caller's per-leaf update exactly zero;
//   sgd:     torch-SGD momentum, dampening, nesterov, weight decay before
//            or after the momentum, and the first-step seeding of the
//            buffer with the direction (a device flag); noop as Adam's;
//   adagrad: h += g^2, p -= lr g / (sqrt(h) + eps), L2 or decoupled
//            decay; noop as Adam's.
//
// Translation: the TPU kernels walk the flat buffer in a parallel grid
// of 64K-element blocks and write per-block flags and partial sums that
// XLA reduces.  Here a grid-stride loop covers the buffer; the flag is
// zeroed on the stream first, each block ORs its threads' flags with
// __syncthreads_or and one thread stores 1.0 if any was set -- a
// reduction on the device, with no read back.  The L2 norm writes one
// partial sum per block into a scratch vector and a second, one-block
// kernel adds the partials in a fixed order: no atomics, so a norm (and
// the LAMB trust ratios built from norms) repeats bit for bit from run
// to run.  Every index is 64-bit: the slice's flat buffer holds 1.92e9
// elements, and its fp32 bytes pass 2^32.  The unscale may write in
// place (out == x), the port's counterpart of the JAX buffer donation;
// the update kernels always update p and their slots in place.
//
// What bounds them all on the H100: bytes.  The unscale reads and writes
// each element once (8 bytes per fp32 element, one flop); Adam reads
// p, g, m, v and writes p, m, v (28 bytes per element, ~15 flops); the
// norm reads 4 bytes per element; LAMB's phase 1 28 (p, g, m, v in; m,
// v, u out); SGD and Adagrad 20.  So the design only streams: 16-byte
// loads and stores where every buffer is aligned, a scalar loop where
// one is not (LAMB's per-leaf norms run over slices at any element
// offset) and for the tail, no shared memory beyond the norm's
// 32-float block reduction.
//
// Plain C interface (loaded with ctypes): every apex_fused_* entry
// launches on the caller's stream and returns cudaGetLastError().

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

// -- L2 norm ---------------------------------------------------------------

// Sum of v over the block, valid in thread 0: a butterfly within each
// warp, then the 8 warp sums in one warp.  The order is fixed, so the
// same inputs give the same bits.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    if (lane < kThreads / 32) v = warp_sums[lane];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// One fp32 partial sum of squares per block: partials[blockIdx.x].  Each
// thread keeps four accumulators (one per lane of its 4-element loads),
// which shortens the chains of fp32 additions fourfold.
template <typename T>
__global__ void __launch_bounds__(kThreads)
l2norm_partial_kernel(const T* __restrict__ x, float* __restrict__ partials,
                      int64_t n, int vec) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = load4(x + 4 * i);
      a0 += v.x * v.x;
      a1 += v.y * v.y;
      a2 += v.z * v.z;
      a3 += v.w * v.w;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const float v = to_f(x[i]);
    a0 += v * v;
  }
  const float sum = block_sum((a0 + a1) + (a2 + a3));
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

// One block: the partials added in a fixed order, the root stored.
__global__ void __launch_bounds__(kThreads)
l2norm_final_kernel(const float* __restrict__ partials, int nparts,
                    float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kThreads) acc += partials[i];
  const float sum = block_sum(acc);
  if (threadIdx.x == 0) *out = sqrtf(sum);
}

// -- LAMB phase 1 ----------------------------------------------------------

struct LambHp {
  float b1, b2, eps, wd, inv_bc1, inv_sqrt_bc2, gscale, beta3;
};

__device__ __forceinline__ float lamb_one(float p, float g, float& m,
                                          float& v, const LambHp& h) {
  g = g * h.gscale;
  m = h.b1 * m + h.beta3 * g;
  v = h.b2 * v + (1.f - h.b2) * g * g;
  return (m * h.inv_bc1) / (sqrtf(v) * h.inv_sqrt_bc2 + h.eps) + h.wd * p;
}

template <typename TG>
__global__ void __launch_bounds__(kThreads)
lamb1_kernel(const float* __restrict__ p, const TG* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v,
             float* __restrict__ u, const float* __restrict__ hp, int64_t n,
             int vec) {
  const bool noop = hp[8] > 0.f;  // m, v untouched; u = 0
  const LambHp h{hp[0], hp[1], hp[2], hp[3], hp[4], hp[5], hp[6], hp[7]};
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      if (noop) {
        store4(u + 4 * i, make_float4(0.f, 0.f, 0.f, 0.f));
        continue;
      }
      const float4 pp = load4(p + 4 * i), gg = load4(g + 4 * i);
      float4 mm = load4(m + 4 * i), vv = load4(v + 4 * i), uu;
      uu.x = lamb_one(pp.x, gg.x, mm.x, vv.x, h);
      uu.y = lamb_one(pp.y, gg.y, mm.y, vv.y, h);
      uu.z = lamb_one(pp.z, gg.z, mm.z, vv.z, h);
      uu.w = lamb_one(pp.w, gg.w, mm.w, vv.w, h);
      store4(m + 4 * i, mm);
      store4(v + 4 * i, vv);
      store4(u + 4 * i, uu);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    if (noop) {
      u[i] = 0.f;
      continue;
    }
    float mm = m[i], vv = v[i];
    u[i] = lamb_one(p[i], to_f(g[i]), mm, vv, h);
    m[i] = mm;
    v[i] = vv;
  }
}

// -- SGD -------------------------------------------------------------------

struct SgdHp {
  float lr, mom, damp, wd, first, gscale;
};

__device__ __forceinline__ void sgd_one(float& p, float g, float& b,
                                        const SgdHp& h, bool nesterov,
                                        bool wd_after) {
  g = g * h.gscale;
  const float d = wd_after ? g : g + h.wd * p;
  b = h.first > 0.f ? d : h.mom * b + (1.f - h.damp) * d;
  float dir = nesterov ? d + h.mom * b : b;
  if (h.mom == 0.f) dir = d;
  if (wd_after) dir = dir + h.wd * p;
  p = p - h.lr * dir;
}

template <typename TG>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(float* __restrict__ p, const TG* __restrict__ g,
           float* __restrict__ b, const float* __restrict__ hp, int64_t n,
           int nesterov, int wd_after, int vec) {
  if (hp[5] > 0.f) return;  // noop: p, buf stay bit-identical
  const SgdHp h{hp[0], hp[1], hp[2], hp[3], hp[4], hp[6]};
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      float4 pp = load4(p + 4 * i), bb = load4(b + 4 * i);
      const float4 gg = load4(g + 4 * i);
      sgd_one(pp.x, gg.x, bb.x, h, nesterov, wd_after);
      sgd_one(pp.y, gg.y, bb.y, h, nesterov, wd_after);
      sgd_one(pp.z, gg.z, bb.z, h, nesterov, wd_after);
      sgd_one(pp.w, gg.w, bb.w, h, nesterov, wd_after);
      store4(p + 4 * i, pp);
      store4(b + 4 * i, bb);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float pp = p[i], bb = b[i];
    sgd_one(pp, to_f(g[i]), bb, h, nesterov, wd_after);
    p[i] = pp;
    b[i] = bb;
  }
}

// -- Adagrad ---------------------------------------------------------------

struct AdagradHp {
  float lr, eps, wd, gscale;
};

__device__ __forceinline__ void adagrad_one(float& p, float g, float& s,
                                            const AdagradHp& h, bool w_mode) {
  g = g * h.gscale;
  if (!w_mode) g = g + h.wd * p;
  s = s + g * g;
  float update = g / (sqrtf(s) + h.eps);
  if (w_mode) update = update + h.wd * p;
  p = p - h.lr * update;
}

template <typename TG>
__global__ void __launch_bounds__(kThreads)
adagrad_kernel(float* __restrict__ p, const TG* __restrict__ g,
               float* __restrict__ s, const float* __restrict__ hp,
               int64_t n, int w_mode, int vec) {
  if (hp[3] > 0.f) return;  // noop: p, h stay bit-identical
  const AdagradHp h{hp[0], hp[1], hp[2], hp[4]};
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      float4 pp = load4(p + 4 * i), ss = load4(s + 4 * i);
      const float4 gg = load4(g + 4 * i);
      adagrad_one(pp.x, gg.x, ss.x, h, w_mode);
      adagrad_one(pp.y, gg.y, ss.y, h, w_mode);
      adagrad_one(pp.z, gg.z, ss.z, h, w_mode);
      adagrad_one(pp.w, gg.w, ss.w, h, w_mode);
      store4(p + 4 * i, pp);
      store4(s + 4 * i, ss);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float pp = p[i], ss = s[i];
    adagrad_one(pp, to_f(g[i]), ss, h, w_mode);
    p[i] = pp;
    s[i] = ss;
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

bool aligned(const void* a, int bytes) {
  return reinterpret_cast<uintptr_t>(a) % bytes == 0;
}

// g's 4-element accesses: 16 bytes of fp32, 8 bytes of bf16
bool g_aligned(const void* g, int g_dtype) {
  return aligned(g, g_dtype ? 8 : 16);
}

// Launch f(TG{}) for the grads' element type; cudaErrorInvalidValue for
// any other dtype code.
template <typename F>
int with_grad_type(int g_dtype, F f) {
  if (g_dtype == 0)
    f(float{});
  else if (g_dtype == 1)
    f(__nv_bfloat16{});
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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

// out (one fp32 on the device) = sqrt(sum of x^2) over x's n elements
// (dtype code x_dtype), 0 for n = 0.  partials is device scratch of
// parts_cap floats: one partial per block, so the grid has at most
// parts_cap blocks.
extern "C" int apex_fused_l2norm(const void* x, void* partials, void* out,
                                 long long n, int parts_cap, int x_dtype,
                                 void* stream) {
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (n <= 0) return (int)cudaMemsetAsync(o, 0, sizeof(float), s);
  if (parts_cap < 1) return (int)cudaErrorInvalidValue;
  const int blocks = blocks_for(n) < parts_cap ? blocks_for(n) : parts_cap;
  float* part = static_cast<float*>(partials);
  const int err = with_grad_type(x_dtype, [&](auto tag) {
    using T = decltype(tag);
    l2norm_partial_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), part, n, g_aligned(x, x_dtype));
  });
  if (err) return err;
  l2norm_final_kernel<<<1, kThreads, 0, s>>>(part, blocks, o);
  return (int)cudaGetLastError();
}

// LAMB phase 1 over flat fp32 p (read), m, v (updated in place) and u
// (written), grads g of dtype code g_dtype; hp is the device vector
// [beta1, beta2, eps, weight_decay, 1/bc1, 1/sqrt(bc2), grad_scale,
// beta3, noop].
extern "C" int apex_fused_lamb1(const void* p, const void* g, void* m,
                                void* v, void* u, const void* hp, long long n,
                                int g_dtype, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(p, m, v) && aligned(u, 16) &&
                  g_aligned(g, g_dtype);
  return with_grad_type(g_dtype, [&](auto tag) {
    using TG = decltype(tag);
    lamb1_kernel<TG><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const TG*>(g),
        static_cast<float*>(m), static_cast<float*>(v),
        static_cast<float*>(u), static_cast<const float*>(hp), n, vec);
  });
}

// One SGD step over flat fp32 p and momentum buffer (in place); hp is
// the device vector [lr, momentum, dampening, weight_decay, first_run,
// noop, grad_scale].
extern "C" int apex_fused_sgd(void* p, const void* g, void* buf,
                              const void* hp, long long n, int g_dtype,
                              int nesterov, int wd_after, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec =
      aligned(p, 16) && aligned(buf, 16) && g_aligned(g, g_dtype);
  return with_grad_type(g_dtype, [&](auto tag) {
    using TG = decltype(tag);
    sgd_kernel<TG><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<const TG*>(g),
        static_cast<float*>(buf), static_cast<const float*>(hp), n,
        nesterov, wd_after, vec);
  });
}

// One Adagrad step over flat fp32 p and sum of squares h (in place); hp
// is the device vector [lr, eps, weight_decay, noop, grad_scale].
extern "C" int apex_fused_adagrad(void* p, const void* g, void* h,
                                  const void* hp, long long n, int g_dtype,
                                  int w_mode, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec =
      aligned(p, 16) && aligned(h, 16) && g_aligned(g, g_dtype);
  return with_grad_type(g_dtype, [&](auto tag) {
    using TG = decltype(tag);
    adagrad_kernel<TG><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<const TG*>(g),
        static_cast<float*>(h), static_cast<const float*>(hp), n, w_mode,
        vec);
  });
}
