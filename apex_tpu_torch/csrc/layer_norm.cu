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
// in one accumulator.  Blocks here run in parallel, so a persistent grid
// of one or two blocks an SM walks the rows, each thread owning the
// same columns in every row it sees and summing dw and db for them in
// registers; each block writes one row of a [nblocks, hidden] partial,
// and ln_bwd_reduce_kernel adds the partials down the columns in a fixed
// order (dw and db repeat bit for bit).  No atomics.
//
// What bounds it on the H100: bytes (x and dy read, dx written: 3 * 2 *
// rows * hidden bytes in bf16, ~10 flops per element).  So each row is
// read once: a group of 256 threads holds its row of x and dy in
// registers (bf16 rows up to 4096 wide, 16 elements a thread in 16-byte
// chunks, two groups a block each walking its own rows; unaligned rows
// up to 2048 wide, 8 elements a thread one at a time), and loads its
// next row while this one's reductions run.  The sums of a row reduce
// together: for RMSNorm sum(x^2) and sum(w dy x) in one reduction
// (c2 = rstd * mean(w dy x)); for LayerNorm the mean first, then the
// centred sum of squares, sum(w dy) and sum(w dy (x - mean)) in one.
// The weight is read per chunk where it is used (it stays in L1).
// Any other row (fp32, or too wide for the registers) takes the MULTI
// instance of the same kernel: the row in passes of 2048 columns (the
// later passes hit L2) and dw/db in shared memory, each thread again
// owning its columns.  launch_bwd picks the instance.
// ---------------------------------------------------------------------------

// C consecutive elements of a row as loaded (16 bytes for bf16 C = 8).
template <typename T, int C>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void to(float* o) const {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      o[2 * j] = f.x;
      o[2 * j + 1] = f.y;
    }
  }
};
template <>
struct Chunk<float, 8> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void to(float* o) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};
template <typename T>
struct Chunk<T, 1> {
  T v;
  __device__ __forceinline__ void load(const T* p) { v = *p; }
  __device__ __forceinline__ void zero() { v = from_f<T>(0.f); }
  __device__ __forceinline__ void to(float* o) const { o[0] = to_f(v); }
};

template <typename T, int C>
__device__ __forceinline__ void store_c(T* p, const float* v) {
  if constexpr (C == 8) store8(p, v); else *p = from_f<T>(v[0]);
}

// The block's instance: TG threads a row and R rows in flight a block
// (each group of TG threads walks its own rows), E elements a thread per
// pass in chunks of C; MULTI: any number of passes, dw/db in shared
// memory.
template <typename TX, typename TW, int TG, int E, int C, bool MULTI, int R>
__global__ void __launch_bounds__(TG * R, TG * R <= 256 ? 2 : 1)
ln_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
              const TX* __restrict__ dy, TX* __restrict__ dx,
              float* __restrict__ dw_part, float* __restrict__ db_part,
              int rows, int hidden, float eps, int rms) {
  constexpr int kBlock = TG * R;
  constexpr int NC = E / C;                 // chunks a thread per pass
  constexpr int kWarpsG = TG / 32;
  static_assert(!MULTI || R == 1, "the multi-pass instance takes a row a block");
  __shared__ float red[2][R][kWarpsG][4];   // by reduction parity
  extern __shared__ float sacc[];
  const int group = threadIdx.x / TG, gt = threadIdx.x % TG;
  const int lane = threadIdx.x & 31, wg = gt >> 5;
  const float inv_n = 1.f / (float)hidden;
  int par = 0;
  // sums over the row's group: warp shuffles, then (TG > 32) one
  // shared-memory hop behind the group's own barrier, added in warp
  // order
  auto group_sum = [&](float* v, int k) {
    for (int i = 0; i < k; ++i) v[i] = warp_sum(v[i]);
    if constexpr (TG > 32) {
      if (lane == 0)
        for (int i = 0; i < k; ++i) red[par][group][wg][i] = v[i];
      if constexpr (R == 1)
        __syncthreads();
      else
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(TG)
                     : "memory");
      for (int i = 0; i < k; ++i) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < kWarpsG; ++j) t += red[par][group][j][i];
        v[i] = t;
      }
      par ^= 1;
    }
  };
  // first column of chunk j of pass s (its C columns are all in or all
  // out of the row: hidden % C == 0)
  auto col = [&](int s, int j) { return s * TG * E + (j * TG + gt) * C; };
  auto load_pass = [&](Chunk<TX, C> (&cx)[NC], Chunk<TX, C> (&cg)[NC],
                       size_t row, int s) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = col(s, j);
      if (c < hidden) {
        cx[j].load(x + row * hidden + c);
        cg[j].load(dy + row * hidden + c);
      } else {
        cx[j].zero();
        cg[j].zero();
      }
    }
  };
  // the weight of the chunk at column c, from L1 (zero past the row)
  auto w_chunk = [&](float* wc, int c) {
    if (c < hidden) {
      Chunk<TW, C> cw;
      cw.load(w + c);
      cw.to(wc);
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) wc[k] = 0.f;
    }
  };
  auto load_w = [&](float (&wv)[E], int s) {
#pragma unroll
    for (int j = 0; j < NC; ++j) w_chunk(wv + j * C, col(s, j));
  };
  auto unpack = [&](const Chunk<TX, C> (&cx)[NC],
                    const Chunk<TX, C> (&cg)[NC], float (&xv)[E],
                    float (&gv)[E]) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      cx[j].to(xv + j * C);
      cg[j].to(gv + j * C);
    }
  };
  const size_t stride = (size_t)gridDim.x * R;
  Chunk<TX, C> cx[NC], cg[NC];
  float wv[E], xv[E], gv[E];

  if constexpr (!MULTI) {
    // the row in registers, as loaded (unpacked to fp32 where used: the
    // next row's loads are in flight meanwhile); dw and db in registers
    float dwa[E], dba[E];
#pragma unroll
    for (int i = 0; i < E; ++i) dwa[i] = dba[i] = 0.f;
    Chunk<TX, C> nx[NC], ng[NC];
    size_t row = (size_t)blockIdx.x * R + group;
    if (row < (size_t)rows) load_pass(nx, ng, row, 0);
    for (; row < (size_t)rows; row += stride) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        cx[j] = nx[j];
        cg[j] = ng[j];
      }
      if (row + stride < (size_t)rows) load_pass(nx, ng, row + stride, 0);
      float mean = 0.f, c1 = 0.f, rstd, c2;
      if (rms) {
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          float xc[C], gc[C], wc[C];
          cx[j].to(xc);
          cg[j].to(gc);
          w_chunk(wc, col(0, j));
#pragma unroll
          for (int k = 0; k < C; ++k) {
            s[0] += xc[k] * xc[k];
            s[1] += wc[k] * gc[k] * xc[k];
          }
        }
        group_sum(s, 2);
        rstd = rsqrtf(s[0] * inv_n + eps);
        c2 = rstd * (s[1] * inv_n);
      } else {
        float s[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          float xc[C];
          cx[j].to(xc);
#pragma unroll
          for (int k = 0; k < C; ++k) s[0] += xc[k];
        }
        group_sum(s, 1);
        mean = s[0] * inv_n;
        s[0] = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          float xc[C], gc[C], wc[C];
          cx[j].to(xc);
          cg[j].to(gc);
          w_chunk(wc, col(0, j));
          // a chunk past the row adds nothing (its x reads 0, not mean)
          const float in = col(0, j) < hidden ? 1.f : 0.f;
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const float c = (xc[k] - mean) * in, wdy = wc[k] * gc[k];
            s[0] += c * c;
            s[1] += wdy;
            s[2] += wdy * c;
          }
        }
        group_sum(s, 3);
        rstd = rsqrtf(s[0] * inv_n + eps);
        c1 = s[1] * inv_n;
        c2 = rstd * (s[2] * inv_n);
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float xc[C], gc[C], wc[C], o[C];
        cx[j].to(xc);
        cg[j].to(gc);
        w_chunk(wc, col(0, j));
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const float xhat = (xc[k] - mean) * rstd;
          o[k] = (gc[k] * wc[k] - c1 - xhat * c2) * rstd;
          dwa[j * C + k] += gc[k] * xhat;
          dba[j * C + k] += gc[k];
        }
        const int c = col(0, j);
        if (c < hidden) store_c<TX, C>(dx + row * hidden + c, o);
      }
    }
    if constexpr (R == 1) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = col(0, j);
        if (c < hidden)
#pragma unroll
          for (int k = 0; k < C; ++k) {
            dw_part[(size_t)blockIdx.x * hidden + c + k] = dwa[j * C + k];
            if (!rms) db_part[(size_t)blockIdx.x * hidden + c + k] =
                dba[j * C + k];
          }
      }
    } else {
      // the block's R rows of sums through shared memory, in row order
      constexpr int W = TG * E;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const int lc = (j * TG + gt) * C + k;
          sacc[group * W + lc] = dwa[j * C + k];
          sacc[(R + group) * W + lc] = dba[j * C + k];
        }
      __syncthreads();
      for (int i = threadIdx.x; i < hidden; i += kBlock) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a += sacc[r * W + i];
          b += sacc[(R + r) * W + i];
        }
        dw_part[(size_t)blockIdx.x * hidden + i] = a;
        if (!rms) db_part[(size_t)blockIdx.x * hidden + i] = b;
      }
    }
  } else {
    // passes of TG * E columns; dw and db in shared memory, each thread
    // reading and writing only its own columns
    float* dwa = sacc;
    float* dba = sacc + hidden;
    const int npass = (hidden + TG * E - 1) / (TG * E);
    for (int s = 0; s < npass; ++s)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = col(s, j);
        if (c < hidden)
#pragma unroll
          for (int k = 0; k < C; ++k) {
            dwa[c + k] = 0.f;
            if (!rms) dba[c + k] = 0.f;
          }
      }
    for (size_t row = blockIdx.x; row < (size_t)rows; row += stride) {
      float mean = 0.f;
      if (!rms) {
        float s1[1] = {0.f};
        for (int s = 0; s < npass; ++s) {
          load_pass(cx, cg, row, s);
          unpack(cx, cg, xv, gv);
#pragma unroll
          for (int i = 0; i < E; ++i) s1[0] += xv[i];
        }
        group_sum(s1, 1);
        mean = s1[0] * inv_n;
      }
      float sm[3] = {0.f, 0.f, 0.f};
      for (int s = 0; s < npass; ++s) {
        load_pass(cx, cg, row, s);
        load_w(wv, s);
        unpack(cx, cg, xv, gv);
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const float in = col(s, i / C) < hidden ? 1.f : 0.f;
          const float c = (xv[i] - mean) * in, wdy = wv[i] * gv[i];
          sm[0] += c * c;
          sm[1] += wdy;
          sm[2] += wdy * c;   // c = x for RMSNorm (mean 0)
        }
      }
      group_sum(sm, 3);
      const float rstd = rsqrtf(sm[0] * inv_n + eps);
      const float c1 = rms ? 0.f : sm[1] * inv_n;
      const float c2 = rstd * (sm[2] * inv_n);
      for (int s = 0; s < npass; ++s) {
        load_pass(cx, cg, row, s);
        load_w(wv, s);
        unpack(cx, cg, xv, gv);
        float o[E];
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const float xhat = (xv[i] - mean) * rstd;
          o[i] = (gv[i] * wv[i] - c1 - xhat * c2) * rstd;
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = col(s, j);
          if (c < hidden) {
            store_c<TX, C>(dx + row * hidden + c, o + j * C);
#pragma unroll
            for (int k = 0; k < C; ++k) {
              const float g = gv[j * C + k];
              dwa[c + k] += g * ((xv[j * C + k] - mean) * rstd);
              if (!rms) dba[c + k] += g;
            }
          }
        }
      }
    }
    for (int s = 0; s < npass; ++s)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = col(s, j);
        if (c < hidden)
#pragma unroll
          for (int k = 0; k < C; ++k) {
            dw_part[(size_t)blockIdx.x * hidden + c + k] = dwa[c + k];
            if (!rms) db_part[(size_t)blockIdx.x * hidden + c + k] =
                dba[c + k];
          }
      }
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

// One instance: TG * R threads a block, a persistent grid of at most
// nblocks * 256 / (TG * R) blocks (no more than the rows need), then the
// column sums of the grid's partials.
template <typename TX, typename TW, int TG, int E, int C, bool MULTI, int R>
int launch_bwd_inst(const void* x, const void* w, const void* dy, void* dx,
                    float* dw_part, float* db_part, float* dw, float* db,
                    int rows, int hidden, int nblocks, float eps, int rms,
                    cudaStream_t stream) {
  constexpr int kBlock = TG * R;
  const int most = nblocks * 256 / kBlock;
  const int want = (rows + R - 1) / R;
  const int grid = want < most ? want : (most > 0 ? most : 1);
  const size_t smem =
      MULTI ? sizeof(float) * (size_t)hidden * (rms ? 1 : 2)
            : (R > 1 ? sizeof(float) * 2 * R * TG * E : 0);
  auto kern = ln_bwd_kernel<TX, TW, TG, E, C, MULTI, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, kBlock, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const TX*>(dy), static_cast<TX*>(dx), dw_part, db_part,
      rows, hidden, eps, rms);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_bwd_reduce_kernel<<<dim3((hidden + 31) / 32, rms ? 1 : 2), dim3(32, 8),
                         0, stream>>>(dw_part, db_part, dw, db, grid,
                                      hidden);
  return (int)cudaGetLastError();
}

// The instance for hidden and alignment (the plan lives here alone):
// 16-byte chunks need hidden % 8 == 0 and 16-byte aligned operands.
// bf16 rows up to 4096 wide (Llama-3-8B's hidden) stay in registers, 16
// elements a thread, two rows in flight a 512-thread block; unaligned
// rows up to 2048 wide likewise, one element at a time, a row a block;
// every other row (fp32, wider) takes the multi-pass instance.
template <typename TX, typename TW>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               float* dw_part, float* db_part, float* dw, float* db, int rows,
               int hidden, int nblocks, float eps, int rms,
               cudaStream_t stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx);
  const bool vec = hidden % 8 == 0 && bits % 16 == 0;
  if (vec) {
    if constexpr (sizeof(TX) == 2)
      if (hidden <= 256 * 16)
        return launch_bwd_inst<TX, TW, 256, 16, 8, false, 2>(
            x, w, dy, dx, dw_part, db_part, dw, db, rows, hidden, nblocks,
            eps, rms, stream);
    return launch_bwd_inst<TX, TW, 256, 8, 8, true, 1>(
        x, w, dy, dx, dw_part, db_part, dw, db, rows, hidden, nblocks, eps,
        rms, stream);
  }
  if (hidden <= 256 * 8)
    return launch_bwd_inst<TX, TW, 256, 8, 1, false, 1>(
        x, w, dy, dx, dw_part, db_part, dw, db, rows, hidden, nblocks, eps,
        rms, stream);
  return launch_bwd_inst<TX, TW, 256, 8, 1, true, 1>(
      x, w, dy, dx, dw_part, db_part, dw, db, rows, hidden, nblocks, eps, rms,
      stream);
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
// LayerNorm, db_part) [nblocks, hidden] fp32 scratch, of which the
// launch uses at most nblocks rows (one a block of 256 threads, one a
// block of 512 for the row-in-registers instance); dw (and db) [hidden]
// fp32 outputs.  For RMSNorm (rms = 1) db_part and db are null.
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
  float* dwo = static_cast<float*>(dw);
  float* dbo = static_cast<float*>(db);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, w, dy, dx, dwp, dbp, dwo, dbo, rows, hidden, nblocks, eps, rms, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(
        x, w, dy, dx, dwp, dbp, dwo, dbo, rows, hidden, nblocks, eps, rms, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(
        x, w, dy, dx, dwp, dbp, dwo, dbo, rows, hidden, nblocks, eps, rms, s);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_bwd<float, float>(
        x, w, dy, dx, dwp, dbp, dwo, dbo, rows, hidden, nblocks, eps, rms, s);
  return (int)cudaErrorInvalidValue;
}

// Shared by every entry of the library: the text of a CUDA error code.
extern "C" const char* apex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
