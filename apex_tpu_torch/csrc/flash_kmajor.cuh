// The key-major flash-attention backward for Hopper (sm_90a):
// flash_bwd_kernel<D, DQ>, the one-pass kernel (DQ) and the split
// backward's dk/dv kernel without a mask and dropout (#4 and #6,
// flash_attention_bwd.cu), with the launch helpers the backward sources
// share.  The instances with a mask or dropout (#4m, #4md, #4d, #6md)
// are a warp-specialized kernel of their own on the same blocks and
// products (flash_kmajor_ws.cuh).  flash_attention_bwd.cu describes the
// design.
#pragma once

#include "flash_qmajor.cuh"

namespace {

// ---------------------------------------------------------------------
// The one-pass kernel and the split dk/dv kernel: wgmma

constexpr int kBQ = 64;             // queries per step

// Two warpgroups a block, 64 keys each (one warpgroup a block, two blocks
// an SM, measured slower).
constexpr int kBK = 128;            // keys per block
constexpr int kThreads = 256;

// Shared memory, byte offsets from a 1024-aligned base (the swizzle's
// period).  Tiles of bf16 [rows][DP] are held as DP / 64 chunks of
// [rows][64] in the 128-byte-swizzle layout: sK, sV [kBK], sQ, sO [2
// stages][kBQ], then fp32 lse and delta [2 stages][kBQ] each, and with
// the dq half dS^T [kBK keys][kBQ queries] (one chunk) and the fp32 dq
// partial [kBQ][D] as D / 32 chunks of [kBQ][32] in the tensor map's
// 128-byte swizzle.
template <int D>
struct Tiles {
  static constexpr int DP = kDP<D>;
  static constexpr int kKV = kBK * DP * 2;
  static constexpr int kQ = kBQ * DP * 2;
  static constexpr int kDS = kBK * kBQ * 2;
  static constexpr int oK = 0, oV = kKV, oQ = 2 * kKV, oO = oQ + 2 * kQ,
                       oStats = oO + 2 * kQ, oDS = oStats + 4 * kBQ * 4,
                       oDQ = oDS + kDS;
  __host__ __device__ static constexpr int end(bool dq) {
    return dq ? oDQ + kBQ * D * 4 : oDS;
  }
  static constexpr size_t bytes(bool dq) { return 1024 + end(dq); }
};

// The dq map's box at (column c, row r, head bh) += the swizzled fp32
// tile at src: one bulk tensor reduction (rows past sq are not written).
__device__ __forceinline__ void tensor_add_f32(const CUtensorMap* map, int c,
                                               int r, int bh, uint32_t src) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(r), "r"(bh), "r"(src)
      : "memory");
}

// The fp32 dk (times scale) and dv of a product thread's key rows kr0
// and kr0 + 8 (accumulator columns 8 j + 2 tig + e), rows < sk, into the
// [bh, sk, D] buffers that dk and dv point at.
template <int D, int N>
__device__ __forceinline__ void store_dkv_f32(bf16* dk, bf16* dv, size_t bh,
                                              int sk, int kr0, int tig,
                                              const float (&dka)[N],
                                              const float (&dva)[N],
                                              float scale) {
  float* dkb = reinterpret_cast<float*>(dk) + bh * (size_t)sk * D;
  float* dvb = reinterpret_cast<float*>(dv) + bh * (size_t)sk * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kr = kr0 + hf * 8;
    if (kr < sk) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const size_t o = (size_t)kr * D + j * 8 + tig * 2;
        *reinterpret_cast<float2*>(dkb + o) = make_float2(
            scale * dka[j * 4 + hf * 2], scale * dka[j * 4 + hf * 2 + 1]);
        *reinterpret_cast<float2*>(dvb + o) =
            make_float2(dva[j * 4 + hf * 2], dva[j * 4 + hf * 2 + 1]);
      }
    }
  }
}

// DQ: the one-pass kernel (dq added into dq_acc through dq_map); without
// it the split dk/dv kernel (dq_map unused).  Warpgroup wg owns keys
// k0 + 64 wg .. + 63; within it warp w owns 16 of them, and a thread the
// rows grp and grp + 8 of those, as wgmma's accumulator layout places
// them.  F32: dk and dv point at fp32 [bh, sk, D], stored from the
// accumulators without a round to bf16 (ring attention's partials).
template <int D, bool DQ, bool F32 = false>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const __grid_constant__ CUtensorMap dq_map,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                 int causal, int off, int valid_q, int valid_k,
                 float scale_log2, float scale) {
  using T = Tiles<D>;
  constexpr int DP = T::DP;
  constexpr int kKS = D / 16;        // k16 steps of S^T and dP^T over d
  constexpr int kQS = kBQ / 16;      // k16 steps of dV and dK over queries
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base + T::oK, sV = base + T::oV, sQ = base + T::oQ,
                 sO = base + T::oO, sStats = base + T::oStats,
                 sDS = base + T::oDS, sDQ = base + T::oDQ;
  const float* stats = reinterpret_cast<const float*>(smem + T::oStats);

  const int k0 = blockIdx.x * kBK;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * (size_t)sq * D;
  const bf16* ob = dout + bh * (size_t)sq * D;
  const float* lb = lse + bh * (size_t)sq;
  const float* db = delta + bh * (size_t)sq;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int krow = wg * 64 + warp * 16 + grp;   // and krow + 8

  const int kv_end = min(sk, valid_k);
  const int q_end = min(sq, valid_q);
  // query rows that can see any of this block's keys: [q_begin, q_end)
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - off);
  q_begin = (q_begin / kBQ) * kBQ;
  const int nq = (k0 < kv_end && q_begin < q_end)
                     ? (q_end - q_begin + kBQ - 1) / kBQ : 0;

  // one step's q, dO, lse and delta into stage st
  auto load_step = [&](int q0, int st) {
    load_sw<D, kBQ, kThreads>(sQ + st * T::kQ, qb, q0, sq);
    load_sw<D, kBQ, kThreads>(sO + st * T::kQ, ob, q0, sq);
    if (tid < 2 * kBQ) {
      const int i = tid % kBQ, which = tid / kBQ;
      const float* src = which ? db : lb;
      const bool live = q0 + i < sq;
      cp_async4z(sStats + ((which * 2 + st) * kBQ + i) * 4,
                 live ? src + q0 + i : src, live);
    }
  };
  load_sw<D, kBK, kThreads>(sK, k + bh * (size_t)sk * D, k0, sk);
  load_sw<D, kBK, kThreads>(sV, v + bh * (size_t)sk * D, k0, sk);
  if (nq > 0) load_step(q_begin, 0);
  cp_async_commit();

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  unsigned pa[kQS][4], da[kQS][4];

  for (int it = 0; it < nq; ++it) {
    const int q0 = q_begin + it * kBQ;
    const int st = it & 1;
    cp_async_wait<0>();
    fence_async_smem();     // the copies, visible to wgmma's async reads
    __syncthreads();
    if (it + 1 < nq) load_step(q0 + kBQ, st ^ 1);
    cp_async_commit();
    const uint32_t cQ = sQ + st * T::kQ, cO = sO + st * T::kQ;

    // S^T = K Q^T and dP^T = V dO^T over this warpgroup's 64 keys, one
    // commit group each (the first k-step overwrites the accumulators)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    keep(s);
    keep(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const uint32_t ko = (ks >> 2) * (kBK * 128) + wg * (64 * 128) +
                          (ks & 3) * 32;
      const uint32_t qo = (ks >> 2) * (kBQ * 128) + (ks & 3) * 32;
      wgmma_ss<0, 0>(s, gmma_desc(sK + ko, 16, 1024),
                     gmma_desc(cQ + qo, 16, 1024), ks > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const uint32_t ko = (ks >> 2) * (kBK * 128) + wg * (64 * 128) +
                          (ks & 3) * 32;
      const uint32_t qo = (ks >> 2) * (kBQ * 128) + (ks & 3) * 32;
      wgmma_ss<0, 0>(dp, gmma_desc(sV + ko, 16, 1024),
                     gmma_desc(cO + qo, 16, 1024), ks > 0);
    }
    wgmma_commit();
    // without the dq half, P^T and dV overlap the dP^T product; with it
    // the step measured faster with both products done first (and dV
    // issued beside dK)
    constexpr bool kEarlyDV = !DQ;
    wgmma_wait<kEarlyDV ? 1 : 0>();
    keep(s);

    // P^T = exp2(S^T * scale_log2 - lse[q]) with the masks; a tile inside
    // both masks skips the per-element test
    const float* cl = stats + st * kBQ;
    const float* cd = stats + (2 + st) * kBQ;
    const int wk0 = k0 + wg * 64;
    const bool full = wk0 + 64 <= kv_end && q0 + kBQ <= q_end &&
                      (!causal || wk0 + 63 <= q0 + off);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(cl + j * 8 + tig * 2);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = q0 + j * 8 + tig * 2 + e;
        const float l = e ? l2.y : l2.x;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kr = k0 + krow + hf * 8;
          const bool live = full || (kr < kv_end && qc < q_end &&
                                     (!causal || kr <= qc + off));
          const int x = j * 4 + hf * 2 + e;
          s[x] = (live && l > kMaskedRowThresh)
                     ? exp2_ftz(s[x] * scale_log2 - l)
                     : 0.f;
        }
      }
    }
    // the accumulator fragments of query columns 16t .. 16t + 15 are the
    // A fragment of k-step t, rounded to bf16
#pragma unroll
    for (int t = 0; t < kQS; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[t][i] = pack_bf16(s[8 * t + 2 * i], s[8 * t + 2 * i + 1]);

    // dV += P^T dO: A from registers, dO read N-major from the step's
    // tile (LBO: the 64-column chunk stride)
    auto issue_dv = [&] {
#pragma unroll
      for (int t = 0; t < kQS; ++t)
        wgmma_rs(dva, pa[t], gmma_desc(cO + t * 16 * 128, kBQ * 128, 1024),
                 1);
    };
    if constexpr (kEarlyDV) {
      keep(dva);
      keep(pa);
      wgmma_fence();
      issue_dv();
      wgmma_commit();
      wgmma_wait<1>();        // dP^T is done; dV may still run
    }
    keep(dp);

    // dS^T = P^T (dP^T - delta[q])
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(cd + j * 8 + tig * 2);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int x = j * 4 + hf * 2 + e;
          dp[x] = s[x] * (dp[x] - (e ? d2.y : d2.x));
        }
    }
#pragma unroll
    for (int t = 0; t < kQS; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        da[t][i] = pack_bf16(dp[8 * t + 2 * i], dp[8 * t + 2 * i + 1]);
    float dqa[32];     // dQ's partial (the dq half)
    if constexpr (DQ) {
      // stage dS^T [keys][queries] for dQ = dS K: query column pair
      // (8j + 2 tig, +1) of key rows krow, krow + 8
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = krow + hf * 8;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                           sDS + sw128<kBK>(r, j) + tig * 4),
                       "r"(da[j >> 1][(j & 1) * 2 + hf]));
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
      keep(dqa);
    }

    // dK += dS^T Q: as dV, Q read N-major
    keep(dva);
    keep(dka);
    keep(pa);
    keep(da);
    wgmma_fence();
    if constexpr (!kEarlyDV) issue_dv();
#pragma unroll
    for (int t = 0; t < kQS; ++t)
      wgmma_rs(dka, da[t], gmma_desc(cQ + t * 16 * 128, kBQ * 128, 1024), 1);
    wgmma_commit();

    if constexpr (DQ) {
      fence_async_smem();                 // dS^T, visible to wgmma
      if (tid == 0) bulk_wait_read();     // the dq tile is free again
      __syncthreads();
      // dQ[:, 64 wg ..] = dS K: dS^T read M-major, K N-major (with
      // DP = 64 the second warpgroup has no columns)
      if (wg * 64 < DP) {
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < kBK / 16; ++kt)
          wgmma_ss<1, 1>(
              dqa, gmma_desc(sDS + kt * 16 * 128, kBK * 128, 1024),
              gmma_desc(sK + wg * (kBK * 128) + kt * 16 * 128, kBK * 128,
                        1024),
              kt > 0);
        wgmma_commit();
      }
      wgmma_wait_all();
      keep(dqa);
      keep(dva);
      keep(dka);
      keep(pa);
      keep(da);
      if (wg * 64 < DP) {
        // the scaled partial into the tensor map's swizzled [32-column
        // chunk][kBQ][32] tile
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wg * 64 + j * 8 + tig * 2;
          if (col < D) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = warp * 16 + grp + hf * 8, c = col & 31;
              const uint32_t a = sDQ + (col >> 5) * (kBQ * 128) + r * 128 +
                                 ((((c >> 2) ^ (r & 7))) << 4) + (c & 3) * 4;
              asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
                           "f"(scale * dqa[j * 4 + hf * 2]),
                           "f"(scale * dqa[j * 4 + hf * 2 + 1]));
            }
          }
        }
      }
      fence_async_smem();                 // the dq tile, visible to the
      if (tid < 32) {                     // bulk reductions
        bar_sync(1, kThreads);
        if (tid == 0) {
#pragma unroll
          for (int c = 0; c < D / 32; ++c)
            tensor_add_f32(&dq_map, c * 32, q0, (int)bh,
                           sDQ + c * (kBQ * 128));
          bulk_commit();
        }
      } else {
        bar_arrive(1, kThreads);
      }
    } else {
      wgmma_wait_all();
      keep(dva);
      keep(dka);
      keep(pa);
      keep(da);
    }
  }
  if (DQ && tid == 0) bulk_wait();
  cp_async_wait<0>();  // nq == 0: the k/v copies may still be in flight

  // this block owns its keys' dk and dv: plain stores, no atomics
  if constexpr (F32) {
    store_dkv_f32<D>(dk, dv, bh, sk, k0 + krow, tig, dka, dva, scale);
    return;
  }
  bf16* dkb = dk + bh * (size_t)sk * D;
  bf16* dvb = dv + bh * (size_t)sk * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kr = k0 + krow + hf * 8;
    if (kr < sk) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const size_t o = (size_t)kr * D + j * 8 + tig * 2;
        *reinterpret_cast<__nv_bfloat162*>(dkb + o) = __floats2bfloat162_rn(
            scale * dka[j * 4 + hf * 2], scale * dka[j * 4 + hf * 2 + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + o) = __floats2bfloat162_rn(
            dva[j * 4 + hf * 2], dva[j * 4 + hf * 2 + 1]);
      }
    }
  }
}

// dq (bf16) = scale * the fp32 accumulator, 8 elements per thread (n % 8
// == 0): scale 1 after the one-pass kernel, which scales its partials;
// the softmax scale after the mask/dropout kernel, which does not.
__global__ void dq_cast_kernel(const float* __restrict__ src,
                               bf16* __restrict__ dst, size_t n8,
                               float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 a = reinterpret_cast<const float4*>(src)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(src)[2 * i + 1];
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(scale * a.x, scale * a.y);
    h[1] = __floats2bfloat162_rn(scale * a.z, scale * a.w);
    h[2] = __floats2bfloat162_rn(scale * b.x, scale * b.y);
    h[3] = __floats2bfloat162_rn(scale * b.z, scale * b.w);
    reinterpret_cast<uint4*>(dst)[i] = raw;
  }
}

// The tensor map of the fp32 dq accumulator [bh, sq, d] for the kernel's
// bulk reductions: boxes of 64 rows x 32 columns, 128-byte swizzle.
int dq_tensor_map(CUtensorMap* map, void* dq_acc, int bh, int sq, int d) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)sq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                 (cuuint64_t)sq * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)kBQ, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dq_acc,
                            dims, strides, box, one,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// flash_bwd_kernel<D, DQ, F32> over (key block, b*h).
template <int D, bool DQ, bool F32 = false>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const CUtensorMap& map,
               void* dk, void* dv, int bh, int sq, int sk, int causal,
               int off, int valid_q, int valid_k, float scale_log2,
               float scale, cudaStream_t stream) {
  const size_t bytes = Tiles<D>::bytes(DQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D, DQ, F32>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + kBK - 1) / kBK, bh);
  flash_bwd_kernel<D, DQ, F32><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), map,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, causal, off,
      valid_q, valid_k, scale_log2, scale);
  return (int)cudaGetLastError();
}

// dq [n] (bf16) = scale * dq_acc [n] (fp32), n % 8 == 0.
inline int launch_dq_cast(const void* dq_acc, void* dq, size_t n,
                          float scale, cudaStream_t stream) {
  const size_t n8 = n / 8;
  const int blocks = (int)((n8 + 255) / 256 < 4096 ? (n8 + 255) / 256 : 4096);
  dq_cast_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), n8, scale);
  return (int)cudaGetLastError();
}

// The one-pass backward without a mask and dropout: dq_acc zeroed, the
// kernel adding into it, dq cast from it.  F32: dq, dk and dv are fp32;
// dq is the accumulator itself (dq_acc unused, no cast).
template <int D, bool F32 = false>
int launch_one_pass(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq_acc, void* dq, void* dk, void* dv, int bh,
                    int sq, int sk, int causal, int off, int valid_q,
                    int valid_k, float scale_log2, float scale,
                    cudaStream_t stream) {
  const size_t n = (size_t)bh * sq * D;
  void* acc = F32 ? dq : dq_acc;
  cudaError_t err = cudaMemsetAsync(acc, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (sk > 0) {
    CUtensorMap map;
    const int e = dq_tensor_map(&map, acc, bh, sq, D);
    if (e) return e;
    const int r = launch_bwd<D, true, F32>(
        q, k, v, dout, lse, delta, map, dk, dv, bh, sq, sk, causal, off,
        valid_q, valid_k, scale_log2, scale, stream);
    if (r) return r;
  }
  if (F32) return 0;
  return launch_dq_cast(dq_acc, dq, n, 1.f, stream);
}

}  // namespace
