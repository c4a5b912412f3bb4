// Ragged paged decode attention for Hopper (sm_90a), bf16 in, fp32 math.
//
// Replaces: apex_tpu/ops/paged_attention.py :: _paged_kernel (launched
// by _paged_kernel_call through pl.pallas_call).  Same function: one
// query token per slot attends to the slot's live tokens, which live in
// fixed-size pages of a shared pool reached through the slot's row of
// the page table; grouped-query scoring per kv head (the `group = h /
// kvh` query rows of a kv head score its k rows once, no broadcast); an
// fp32 online softmax in base 2 with an fp32 accumulator, p rounded to
// bf16 for the P.V product as the TPU kernel feeds its MXU, the
// normalizer summed from the fp32 p; a slot of length 0 emits zeros; a
// length past the window scores the whole window.
//
// Translation: the TPU kernel gets the page table and lengths as scalar
// prefetch and walks a sequential (slots, pages) grid carrying the
// softmax state in VMEM.  Blocks here run in parallel, so the work is
// split flash-decoding style: one block per (split, kv head, slot), a
// split being a fixed run of whole pages of the slot's window (sized on
// the host from the window, the slot and head counts and the SM count;
// never from the lengths, which live on the device).  A block reads the
// slot's length itself; a split with no live token returns at once.
// With one live split the block writes the output; otherwise every live
// block writes its partial (m, l, acc) and the last of them to finish
// (a device counter per (slot, kv head), which that block resets)
// merges the partials in split order, so the output repeats bit for
// bit.  The k/v operands are one layer's STRIDED view of the [pages,
// layers, kv_heads, page_size, head_dim] pool, read in place through
// 4-d tensor maps (columns, rows, kv heads, pages) with the page stride.
//
// What bounds it on the H100: bytes.  Each live token's k and v rows
// are read once (2 * head_dim * 2 bytes per kv head per layer) and
// scored with ~4 * group * head_dim flops.  So the design keeps whole
// pages in flight and spends as few instructions per byte as it can:
// - one thread of a producer warp issues one TMA box per 64 columns of
//   a page of k and of v (one page-table read per page) into a ring of
//   stages guarded by full/empty mbarriers; the boxes land in the
//   128-byte swizzle, so the fragment loads below hit every bank once;
// - eight consumer warps share each page (a 16-token tile each, or a
//   page each where a page is one tile), groups of them taking pages in
//   turn; each warp keeps its own online-softmax state: no block
//   barrier until the end;
// - the products run on the tensor cores with the tokens on the M side
//   and the kv head's <= 8 query rows as an n = 8 operand (zero rows
//   past the group): S^T = K Q^T (k from ldmatrix, q in registers for
//   the whole block), then O^T = V^T P^T (v from ldmatrix.trans, p from
//   the scores' accumulator by one movmatrix.trans per 8 x 8 block);
// - the warps' states merge once, through shared memory.
//
// Plain C interface (loaded with ctypes): apex_paged_decode_attention
// launches on the caller's stream and returns cudaGetLastError().

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

template <int G, int D, int PS>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const bf16* __restrict__ q,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, bf16* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ counters, int kvh, int mpps, int pps,
                    float scale_log2) {
  using S = PagedSmem<D, PS>;
  constexpr int kWT = S::kWT;       // 16-token tiles of a page a warp takes
  constexpr int kK = D / 16;        // k16 steps of S^T, m16 tiles of O^T
  constexpr int kChunk = PS * 128;  // bytes of one 64-column chunk
  const int split = blockIdx.x, kh = blockIdx.y, slot = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = ((size_t)slot * kvh + kh) * G;   // first query row
  const int len = min(lengths[slot], mpps * PS);
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
    // the producer: one thread, one page-table read and one box per 64
    // columns of k and of v per page
    if (lane == 0) {
      const int* row = page_table + (size_t)slot * mpps + first;
      for (int i = 0; i < n; ++i) {
        const int st = i % S::kStages;
        if (i >= S::kStages)
          mbar_wait(bEmpty + 8 * st, ((i / S::kStages) - 1) & 1);
        const int page = row[i];
        const uint32_t sk = base + st * S::kStage, sv = sk + S::kOperand;
        mbar_expect_tx(bFull + 8 * st, S::kStage);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load4(sk + c * kChunk, &kmap, bFull + 8 * st, c * 64, 0, kh,
                    page);
          tma_load4(sv + c * kChunk, &vmap, bFull + 8 * st, c * 64, 0, kh,
                    page);
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

// The tensor map of one layer's [pages, kvh, ps, d] view of the pool
// (rows and heads contiguous inside a page, `page_stride` elements from
// page to page) for boxes of [ps][64] columns in the 128-byte swizzle.
int page_map(CUtensorMap* map, const void* p, int d, int ps, int kvh,
             long long pages, long long page_stride) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)ps, (cuuint64_t)kvh,
                              (cuuint64_t)pages};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)ps * d * 2,
                                 (cuuint64_t)page_stride * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)ps, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(p), dims, strides, box, one,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The two tensor maps of each layer's pool view, encoded once: a decode
// step asks for the same maps of every layer on every step, and the
// step is bound by host time.  A map is kept under everything it
// encodes (address, sizes, page stride), so a reused address with the
// same view gets the same, still valid, map.
struct MapKey {
  const void* p;
  long long pages, page_stride;
  int d, ps, kvh;
  bool operator==(const MapKey& o) const {
    return p == o.p && pages == o.pages && page_stride == o.page_stride &&
           d == o.d && ps == o.ps && kvh == o.kvh;
  }
};
constexpr int kMapCache = 256;
std::mutex g_map_mu;
MapKey g_map_key[kMapCache];
CUtensorMap g_map[kMapCache];
int g_map_used = 0, g_map_next = 0;

int cached_page_map(CUtensorMap* map, const void* p, int d, int ps, int kvh,
                    long long pages, long long page_stride) {
  const MapKey key{p, pages, page_stride, d, ps, kvh};
  std::lock_guard<std::mutex> lock(g_map_mu);
  for (int i = 0; i < g_map_used; ++i)
    if (g_map_key[i] == key) {
      *map = g_map[i];
      return 0;
    }
  const int e = page_map(map, p, d, ps, kvh, pages, page_stride);
  if (e) return e;
  g_map_key[g_map_next] = key;
  g_map[g_map_next] = *map;
  g_map_next = (g_map_next + 1) % kMapCache;
  if (g_map_used < kMapCache) ++g_map_used;
  return 0;
}

struct Args {
  const void *q, *k, *v, *pt, *lengths;
  void *out, *part_acc, *part_ml, *counters;
  int slots, kvh, mpps, nsplit, pps;
  long long pages, page_stride;
  float scale_log2;
  cudaStream_t stream;
};

template <int G, int D, int PS>
int launch(const Args& a) {
  using S = PagedSmem<D, PS>;
  if (a.nsplit > S::kMaxSplits) return (int)cudaErrorInvalidValue;
  CUtensorMap km, vm;
  int e = cached_page_map(&km, a.k, D, PS, a.kvh, a.pages, a.page_stride);
  if (!e) e = cached_page_map(&vm, a.v, D, PS, a.kvh, a.pages, a.page_stride);
  if (e) return e;
  // the instance's shared memory allowed once per device (bit `dev`)
  static std::atomic<unsigned> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(paged_decode_kernel<G, D, PS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)S::bytes);
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(bit);
  }
  const dim3 grid(a.nsplit, a.kvh, a.slots);
  paged_decode_kernel<G, D, PS><<<grid, kThreads, S::bytes, a.stream>>>(
      km, vm, static_cast<const bf16*>(a.q), static_cast<const int*>(a.pt),
      static_cast<const int*>(a.lengths), static_cast<bf16*>(a.out),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
      static_cast<int*>(a.counters), a.kvh, a.mpps, a.pps, a.scale_log2);
  return (int)cudaGetLastError();
}

template <int D, int PS>
int launch_g(int group, const Args& a) {
  switch (group) {
    case 1: return launch<1, D, PS>(a);
    case 2: return launch<2, D, PS>(a);
    case 4: return launch<4, D, PS>(a);
    case 8: return launch<8, D, PS>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_ps(int group, int ps, const Args& a) {
  switch (ps) {
    case 16: return launch_g<D, 16>(group, a);
    case 32: return launch_g<D, 32>(group, a);
    case 64: return launch_g<D, 64>(group, a);
    case 128: return launch_g<D, 128>(group, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [slots, h, d] contiguous bf16; k/v pages [pages, kvh, ps, d] bf16
// with rows and heads contiguous (head stride ps * d) and page stride
// `page_stride` elements (a multiple of 8, 16-byte aligned bases);
// page_table [slots, mpps] and lengths [slots] int32; out [slots, h, d]
// bf16.  The window runs as nsplit splits of `pages_per_split` pages
// (nsplit = ceil(mpps / pages_per_split)); with nsplit > 1, part_acc
// [slots * h, nsplit, d] and part_ml [slots * h, nsplit, 2] are fp32
// scratch and counters [slots * kvh] int32, zero before the launch, is
// left zero by it; nsplit is at most 256.  group = h / kvh must be 1,
// 2, 4 or 8, d 64 or 128, ps 16, 32, 64 or 128.
extern "C" int apex_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_acc,
    void* part_ml, void* counters, int slots, int h, int kvh, int ps, int d,
    int mpps, long long pages, long long page_stride, int nsplit,
    int pages_per_split, float scale_log2, void* stream) {
  cudaGetLastError();
  if (slots <= 0) return 0;
  if (kvh <= 0 || h % kvh || slots > 65535 || kvh > 65535 || mpps <= 0 ||
      pages <= 0 || pages_per_split <= 0 || nsplit < 1 ||
      (long long)nsplit * pages_per_split < mpps ||
      (long long)(nsplit - 1) * pages_per_split >= mpps ||
      (nsplit > 1 && (!part_acc || !part_ml || !counters)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, page_table, lengths, out, part_acc,
               part_ml, counters, slots, kvh, mpps, nsplit, pages_per_split,
               pages, page_stride, scale_log2,
               static_cast<cudaStream_t>(stream)};
  const int group = h / kvh;
  switch (d) {
    case 64: return launch_ps<64>(group, ps, a);
    case 128: return launch_ps<128>(group, ps, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
