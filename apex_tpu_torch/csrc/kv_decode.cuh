// Single-token decode attention against a KV cache for Hopper (sm_90a),
// bf16 in, fp32 math: the kernel template shared by paged decode
// (csrc/paged_attention.cu, the pool through the page table) and the
// dense slot cache's decode (csrc/flash_attention.cu, DENSE = true: the
// slot's own rows, PS at a time, from one layer's strided view of the
// [slots, layers, kv_heads, S, d] cache).  The design notes are
// paged_attention.cu's; the dense instance differs only in where the
// producer's boxes come from (no page table: box (c, r, kv head, slot)
// of a 4-d tensor map over [slots, kv heads, S, d]) and in its window
// (the cache's S; a last tile past S reads zeros, masked by the length).

#pragma once

#include <atomic>
#include <mutex>

#include "hopper.cuh"

namespace {


constexpr int kWarps = 8;                     // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;   // + one producer warp
constexpr int kStageBudget = 128 * 1024;      // k/v stage bytes aimed at

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// the transpose of the 8 x 8 bf16 matrix whose row lane / 4, columns
// 2 (lane % 4) and + 1, this thread holds, in the same layout
__device__ __forceinline__ unsigned movmatrix_t(unsigned a) {
  unsigned d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}
// c += A B, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The box at (column c, row r, kv head h, page p) of a 4-d tensor map,
// completing `bar`'s transactions.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c, int r, int h,
                                          int p) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(h), "r"(p),
      "r"(bar)
      : "memory");
}

// Shared memory of one block for head dim D and page size PS: a ring of
// stages, each one page of k then one of v as D / 64 swizzled
// [PS][64] chunks; the stages' mbarriers; the merge flag.  The warps'
// states are merged through the stages once the ring is drained.
// The consumer warps work in groups of kPageWarps on one page at a time,
// each warp kWT 16-token tiles of it, the kGroups groups taking pages in
// turn.  The stage count is a multiple of the groups, so the stage a
// warp waits on last held a page of the same warp: a warp never waits
// on a phase two ahead of its barrier (a parity wait cannot tell them
// apart).
template <int D, int PS>
struct PagedSmem {
  static constexpr int kTiles = PS / 16;
  static constexpr int kPageWarps = kTiles < kWarps ? kTiles : kWarps;
  static constexpr int kWT = kTiles / kPageWarps;
  static constexpr int kGroups = kWarps / kPageWarps;
  static_assert(kTiles % kPageWarps == 0 && kWarps % kPageWarps == 0,
                "a page's tiles split evenly over the warps");
  static constexpr int kOperand = PS * D * 2;   // one page of k (or v)
  static constexpr int kStage = 2 * kOperand;
  static constexpr int kFit = kStageBudget / kStage / kGroups * kGroups;
  static constexpr int kStages = kFit < kGroups ? kGroups
                                 : kFit > 8 ? (kGroups > 8 ? kGroups : 8)
                                            : kFit;
  static_assert(kStages % kGroups == 0, "each group keeps its own stages");
  static constexpr int oBar = kStages * kStage;  // full[kStages], empty[...]
  static constexpr int oFlag = oBar + 16 * kStages;
  static constexpr size_t bytes = 1024 + oFlag + 16;
  // the merge: acc [kWarps][8][D], then m and l [kWarps][8]; the last
  // block's split weights, 2 * 8 * splits + 8 floats, fit for any split
  // count up to kMaxSplits
  static_assert(sizeof(float) * kWarps * 8 * (D + 2) <= (size_t)oBar,
                "the warps' states fit in the stages");
  static constexpr int kMaxSplits = (oBar / 4 - 8) / 16;
};

template <int G, int D, int PS, bool DENSE = false>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const bf16* __restrict__ q,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, bf16* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ counters, int kvh, int mpps, int pps,
                    int window, float scale_log2) {
  using S = PagedSmem<D, PS>;
  constexpr int kWT = S::kWT;       // 16-token tiles of a page a warp takes
  constexpr int kK = D / 16;        // k16 steps of S^T, m16 tiles of O^T
  constexpr int kChunk = PS * 128;  // bytes of one 64-column chunk
  const int split = blockIdx.x, kh = blockIdx.y, slot = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = ((size_t)slot * kvh + kh) * G;   // first query row
  const int len = min(lengths[slot], window);
  const int live_pages = (len + PS - 1) / PS;
  const int first = split * pps;
  if (first >= live_pages) {
    // no live token here; split 0 of an empty slot writes its zeros
    if (split == 0)
      for (int i = tid; i < G * D; i += kThreads)
        out[row0 * D + i] = __float2bfloat16(0.f);
    return;
  }
  const int n = min(pps, live_pages - first);
  const int n_live_splits = (live_pages + pps - 1) / pps;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);   // generic view
  const uint32_t bFull = base + S::oBar, bEmpty = bFull + 8 * S::kStages;
  int* flag = reinterpret_cast<int*>(gbase + S::oFlag);
  if (tid == 0) {
    for (int st = 0; st < S::kStages; ++st) {
      mbar_init(bFull + 8 * st, 1);
      mbar_init(bEmpty + 8 * st, S::kPageWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int gq = lane >> 2, tig = lane & 3;
  float acc[kK][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int mt = 0; mt < kK; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  if (warp == kWarps) {
    // the producer: one thread, one page-table read (DENSE: the slot's
    // rows PS at a time) and one box per 64 columns of k and of v per page
    if (lane == 0) {
      const int* row = DENSE ? nullptr : page_table + (size_t)slot * mpps + first;
      for (int i = 0; i < n; ++i) {
        const int st = i % S::kStages;
        if (i >= S::kStages)
          mbar_wait(bEmpty + 8 * st, ((i / S::kStages) - 1) & 1);
        const int r = DENSE ? (first + i) * PS : 0;
        const int outer = DENSE ? slot : row[i];
        const uint32_t sk = base + st * S::kStage, sv = sk + S::kOperand;
        mbar_expect_tx(bFull + 8 * st, S::kStage);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load4(sk + c * kChunk, &kmap, bFull + 8 * st, c * 64, r, kh,
                    outer);
          tma_load4(sv + c * kChunk, &vmap, bFull + 8 * st, c * 64, r, kh,
                    outer);
        }
      }
    }
    __syncwarp();
  } else {
    // q as the B operand of S^T = K Q^T: query row lane / 4 (zero past
    // the group), dims 2 (lane % 4) + {0, 1} and + 8 of each k16 step
    unsigned qf[kK][2];
    const bf16* qr = q + (row0 + gq) * D + tig * 2;
#pragma unroll
    for (int ks = 0; ks < kK; ++ks) {
      qf[ks][0] = gq < G ? *reinterpret_cast<const unsigned*>(qr + ks * 16)
                         : 0u;
      qf[ks][1] = gq < G
                      ? *reinterpret_cast<const unsigned*>(qr + ks * 16 + 8)
                      : 0u;
    }
    // this warp's tiles of each page it takes: rows r0 .. r0 + 16 kWT
    const int grp = warp / S::kPageWarps;
    const int r0 = (warp % S::kPageWarps) * kWT * 16;
    for (int i = grp; i < n; i += S::kGroups) {
      const int st = i % S::kStages;
      mbar_wait(bFull + 8 * st, (i / S::kStages) & 1);
      const uint32_t sk = base + st * S::kStage, sv = sk + S::kOperand;
      const int live = len - (first + i) * PS - r0;  // live rows of ours
      if (live < kWT * 16) {
        // the slot's last page: rows past the length must still multiply
        // p = 0 by finite values, so this warp's such v rows are zeroed
        unsigned char* gv = gbase + st * S::kStage + S::kOperand;
        const int from = live < 0 ? 0 : live;
        for (int u = lane; u < (kWT * 16 - from) * (D / 8); u += 32) {
          const int r = r0 + from + u / (D / 8), c = (u % (D / 8)) / 8,
                    k = u % 8;
          *reinterpret_cast<uint4*>(gv + c * kChunk + r * 128 + k * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        fence_async_smem();   // before the stage goes back to the copies
        __syncwarp();
      }
      // S^T: token rows r0 + t * 16 + (lane / 4, + 8), query rows
      // 2 (lane % 4) and + 1; even and odd k steps into two sums, so the
      // dependent products run two chains
      float sc[kWT][4];
#pragma unroll
      for (int t = 0; t < kWT; ++t) {
        float sb[4] = {0.f, 0.f, 0.f, 0.f};
        sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
        const int tok = r0 + t * 16 + (lane & 15);
#pragma unroll
        for (int ks = 0; ks < kK; ++ks) {
          unsigned a[4];
          ldsm_x4(a, sk + sw128<PS>(tok, ks * 2 + (lane >> 4)));
          mma16816(ks & 1 ? sb : sc[t], a, qf[ks][0], qf[ks][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[t][e] += sb[e];
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int t = 0; t < kWT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool on = t * 16 + gq + (e >> 1) * 8 < live;
          sc[t][e] = on ? sc[t][e] * scale_log2 : kNegInf;
        }
#pragma unroll
      for (int t = 0; t < kWT; ++t) {
        mx0 = fmaxf(mx0, fmaxf(sc[t][0], sc[t][2]));
        mx1 = fmaxf(mx1, fmaxf(sc[t][1], sc[t][3]));
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2_ftz(m0 - mn0), al1 = exp2_ftz(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // p (fp32 into l, bf16 into P^T: one movmatrix per 8 x 8 block
      // turns the accumulator's layout into the B operand's)
      unsigned pb[kWT][2];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int t = 0; t < kWT; ++t) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = sc[t][e] == kNegInf ? 0.f
                                     : exp2_ftz(sc[t][e] - (e & 1 ? m1 : m0));
        ps0 += p[0] + p[2];
        ps1 += p[1] + p[3];
        pb[t][0] = movmatrix_t(pack_bf16(p[0], p[1]));
        pb[t][1] = movmatrix_t(pack_bf16(p[2], p[3]));
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      // O^T += V^T P^T: dims 16 mt + lane / 4 (+ 8), query rows as above
#pragma unroll
      for (int mt = 0; mt < kK; ++mt) {
        acc[mt][0] *= al0;
        acc[mt][1] *= al1;
        acc[mt][2] *= al0;
        acc[mt][3] *= al1;
      }
#pragma unroll
      for (int t = 0; t < kWT; ++t) {
        const int tok = r0 + t * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
        for (int mt = 0; mt < kK; ++mt) {
          unsigned a[4];
          ldsm_x4_t(a, sv + sw128<PS>(tok, mt * 2 + ((lane >> 3) & 1)));
          mma16816(acc[mt], a, pb[t][0], pb[t][1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bEmpty + 8 * st);
    }
    // this warp's l over its lanes (m is the same on them already)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
  }
  __syncthreads();   // every page consumed: the stages are free

  // the warps' states, merged in warp order
  float* rAcc = reinterpret_cast<float*>(gbase);       // [kWarps][8][D]
  float* rM = rAcc + kWarps * 8 * D;                   // [kWarps][8]
  float* rL = rM + kWarps * 8;
  if (warp < kWarps) {
#pragma unroll
    for (int mt = 0; mt < kK; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rAcc[(warp * 8 + 2 * tig + (e & 1)) * D + mt * 16 + gq +
             (e >> 1) * 8] = acc[mt][e];
    if (gq == 0) {
      rM[warp * 8 + 2 * tig] = m0;
      rM[warp * 8 + 2 * tig + 1] = m1;
      rL[warp * 8 + 2 * tig] = l0;
      rL[warp * 8 + 2 * tig + 1] = l1;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, e = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, rM[w * 8 + g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2_ftz(rM[w * 8 + g] - mx);
      l += f * rL[w * 8 + g];
      a += f * rAcc[(w * 8 + g) * D + e];
    }
    const size_t qrow = row0 + g;
    if (n_live_splits == 1) {
      out[qrow * D + e] = __float2bfloat16(a / l);
    } else {
      part_acc[(qrow * nsplit + split) * D + e] = a;
      if (e == 0) {
        part_ml[(qrow * nsplit + split) * 2] = mx;
        part_ml[(qrow * nsplit + split) * 2 + 1] = l;
      }
    }
  }
  if (n_live_splits == 1) return;

  // the last live split of this (slot, kv head) to finish merges them
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + (size_t)slot * kvh + kh;
    const int last = atomicAdd(ctr, 1) == n_live_splits - 1;
    if (last) *ctr = 0;   // ready for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // every live split's (m, l) of these rows at once (one round of loads
  // from L2, not one a split), then each split's weight 2^(m - M) and
  // the normalizer, summed in split order
  const int ns = n_live_splits;
  float* wM = rAcc;                   // [G][ns] m, then the weights
  float* wL = wM + G * ns;            // [G][ns] l
  float* wSum = wL + G * ns;          // [G]
  for (int i = tid; i < G * ns; i += kThreads) {
    const float* ml = part_ml + ((row0 + i / ns) * nsplit + i % ns) * 2;
    wM[i] = __ldcg(ml);
    wL[i] = __ldcg(ml + 1);
  }
  __syncthreads();
  if (tid < G) {
    float mx = kNegInf;
    for (int sp = 0; sp < ns; ++sp) mx = fmaxf(mx, wM[tid * ns + sp]);
    float l = 0.f;
    for (int sp = 0; sp < ns; ++sp) {
      const float f = exp2_ftz(wM[tid * ns + sp] - mx);
      wM[tid * ns + sp] = f;
      l += f * wL[tid * ns + sp];
    }
    wSum[tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, e = i % D;
    const size_t qrow = row0 + g;
    const float* pa = part_acc + qrow * nsplit * D + e;
    float a = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < ns; ++sp)
      a += wM[g * ns + sp] * __ldcg(pa + (size_t)sp * D);
    out[qrow * D + e] = __float2bfloat16(a / wSum[g]);
  }
}

// The tensor map of a [n, kvh, rows, d] bf16 view (rows contiguous,
// `head_stride` elements from head to head, `outer_stride` from one
// outer index to the next) for boxes of [box_rows][64] columns in the
// 128-byte swizzle: paged decode's one layer of the pool ([pages, kvh,
// ps, d], head stride ps * d, boxes of a page) and the dense decode's
// one layer of the slot cache ([slots, kvh, S, d], boxes of PS rows).
int kv_map(CUtensorMap* map, const void* p, int d, long long rows, int kvh,
           long long n, long long head_stride, long long outer_stride,
           int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)kvh, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)head_stride * 2,
                                 (cuuint64_t)outer_stride * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(p), dims, strides, box, one,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The two tensor maps of each layer's view, encoded once: a decode step
// asks for the same maps of every layer on every step, and the step is
// bound by host time.  A map is kept under everything it encodes
// (address, sizes, strides, box), so a reused address with the same view
// gets the same, still valid, map.
struct MapKey {
  const void* p;
  long long rows, n, head_stride, outer_stride;
  int d, kvh, box_rows;
  bool operator==(const MapKey& o) const {
    return p == o.p && rows == o.rows && n == o.n &&
           head_stride == o.head_stride && outer_stride == o.outer_stride &&
           d == o.d && kvh == o.kvh && box_rows == o.box_rows;
  }
};
constexpr int kMapCache = 256;
std::mutex g_map_mu;
MapKey g_map_key[kMapCache];
CUtensorMap g_map[kMapCache];
int g_map_used = 0, g_map_next = 0;

int cached_kv_map(CUtensorMap* map, const void* p, int d, long long rows,
                  int kvh, long long n, long long head_stride,
                  long long outer_stride, int box_rows) {
  const MapKey key{p, rows, n, head_stride, outer_stride, d, kvh, box_rows};
  std::lock_guard<std::mutex> lock(g_map_mu);
  for (int i = 0; i < g_map_used; ++i)
    if (g_map_key[i] == key) {
      *map = g_map[i];
      return 0;
    }
  const int e = kv_map(map, p, d, rows, kvh, n, head_stride, outer_stride,
                       box_rows);
  if (e) return e;
  g_map_key[g_map_next] = key;
  g_map[g_map_next] = *map;
  g_map_next = (g_map_next + 1) % kMapCache;
  if (g_map_used < kMapCache) ++g_map_used;
  return 0;
}

// The kernel's shared memory allowed once per device (bit `dev`) for
// each instance
template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes, std::atomic<unsigned>& allowed) {
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

}  // namespace
