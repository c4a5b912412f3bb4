// The key-major flash-attention backward's mask and dropout instances for
// Hopper (sm_90a), warp-specialized: flash_bwd_ws_kernel<D, DQ, MASK,
// DROP>, launched by flash_attention_bwd_md.cu for the one-pass kernel
// (DQ: #4m, #4md and #4d) and the split backward's dk/dv kernel (#6md).
//
// Replaces: apex_tpu/ops/attention.py :: _bwd_fused_kernel and
// _dkv_kernel (launched by _bwd_impl through pl.pallas_call) with their
// mask3 and dropout operands.  Same function, blocks and products as the
// key-major template's kernels (flash_kmajor.cuh): a block owns 128 keys,
// keeps their k and v in shared memory and their dk and dv in registers,
// and walks the 64-query steps that can see them; S^T = K Q^T and dP^T =
// V dO^T, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
// register A fragments, and (DQ) dQ = dS K added into an fp32 buffer by
// bulk tensor reductions.  Arranged for this card:
//
// - A copying warpgroup.  Its first warp issues every load: k and v
//   once, then each live step's q and dO as TMA boxes of tensor maps (the
//   128-byte swizzle wgmma reads), its lse and delta rows as cp.async
//   copies that arrive on the stage's mbarrier
//   (cp.async.mbarrier.arrive.noinc: an lse row has no 16-byte alignment
//   for a TMA box), and, for a partial MASK step, the step's 1 KB of the
//   pre-pass's mask bits as one bulk copy.  It writes the step's first
//   query beside them, so the product threads never read the tile
//   classes in the loop.  The ring has kStages stages, each with a "full" mbarrier
//   (the copies) and an "empty" one (every product thread's arrival once
//   the step's products are retired).  Its second warp issues the dq
//   reductions.  setmaxnreg leaves the copying warpgroup 24 registers and
//   gives the two product warpgroups 240.  No block-wide barrier runs in
//   the loop, and no product thread issues a copy.
// - dq off the critical path.  Each product warpgroup writes its 64 x 64
//   fp32 partial into one of two shared buffers and arrives on the
//   buffer's "full" mbarrier; the second copying warp issues the
//   cp.reduce.async.bulk.tensor adds, waits until they have read the
//   buffer and releases it ("empty"), so a product thread waits on a
//   reduction only if it is two steps ahead of it.  The partials are
//   unscaled: the cast that follows multiplies by the softmax scale.  At
//   d = 128 the two warpgroups split dQ's columns (64 each, over all 128
//   keys: both warpgroups' dS^T rows, behind a barrier of the 256
//   product threads; a second one keeps a warpgroup from overwriting dS^T
//   before the other's dQ product has read it).  At d = 64 each
//   warpgroup multiplies its own 64 keys' dS^T rows behind a barrier of
//   its own 128 threads and adds its own partial: both warpgroups work
//   through dQ, at twice the reduction bytes.
// - The step's dead bits (the causal and validity masks; a partial MASK
//   step's staged mask words, 16 loads a thread) and, with DROP, its 32
//   keep bits (the murmur3 hash with the query as its row and the key as
//   its column, as _keep_mask has it; the row's and the column's parts
//   pre-folded through the finalizer's first xor-shift) are computed in
//   the source after S^T and dP^T are issued.  A thread all of whose
//   elements are live takes exp2 without a test.
// - The dk/dv kernel (DQ false) is the same block without the dq half:
//   no dS^T staging, no dq buffers, no reduction warp; the shared memory
//   they held deepens the ring.  Its grid is one block a (key block,
//   batch-head) in an order of its own, the longest key blocks first (for
//   causal attention the first keys see every query, the last ones few)
//   within groups of heads whose q and dO fit half the L2; it writes each
//   block's dk and dv once, so a second run gives the same bits.
//
// Shared memory (d = 128): k, v 64 KB; dS^T 16 KB; two dq buffers 64 KB;
// each ring stage q and dO 32 KB, lse/delta 0.5 KB and mask words 1 KB.
// Two stages fit the 227 KB (212 KB in all); a third does not, so the
// double-buffered dq tile was taken over a third stage (a reduction is
// issued at the end of a step and its buffer is needed again two steps
// later; the next step's q/dO are copied a whole step ahead).  At
// d = 64 the same budget holds four stages, and so does the dk/dv
// kernel's at both head dims.
//
// What bounds it on the H100: operations (five m64 products a step, 2.5x
// the forward's flops), and beside them per-thread work that the
// products do not hide: the softmax with the keep hash (ptxas places the
// hash after the S^T wait wherever the source puts it), dS^T's staging
// and the dq partial's.  tools/flash_bwd_probe.py reads the phases'
// clocks and each one's share; PERF.md records them.  Measured no
// faster and not kept: the hash one step ahead (in the shadow of the dV,
// dK and dQ products), on two copying warps (24 registers: they became
// the bottleneck) or anchored before the S^T wait; dV issued before
// dS^T; the dq partial's staging moved into the next step (beside its
// S^T product); the two warpgroups taking turns on the tensor cores,
// with or without dQ a step late; a persistent grid with double-buffered
// k/v at d = 64 (static tile shares and spills).
#pragma once

#include "flash_kmajor.cuh"

namespace {

constexpr int kWsThreads = 384;     // two product warpgroups, one copying
constexpr int kWsConsumers = 256;
constexpr int kWsRegs = 240;        // registers of a product thread
constexpr int kWsCopyRegs = 24;     // and of a copying thread
constexpr int kWsMaxStages = 4;

// The mask and dropout operands: the mask pre-pass's tile classes cls
// [nmask, nqb, nkt] (flash_qmajor.cuh; its bits are a kernel argument of
// their own), batch-head bh reading mask bh / mask_hper; the seed operand
// seed3 [seed, row_off, col_off] int32, the keep threshold and inv_keep =
// 1 / (1 - rate).
struct MdParams {
  const unsigned char* cls;
  const int* seed3;
  int mask_hper;
  unsigned threshold;
  float inv_keep;
};

// A step's mask words: rows q0 % 128 .. + 63 of the pre-pass's 128 x 128
// tile, 4 words a row (bit 2 j + e of word (r, t): key 8 j + 2 t + e).
constexpr int kWsBitsBytes = kBQ * 4 * 4;

// Shared memory, byte offsets from a 1024-aligned base: sK, sV [kBK][DP];
// (DQ) dS^T [kBK keys][kBQ queries] (one 64-column chunk) and the dq
// buffers [2][2 warpgroups][2 chunks of 32 columns][kBQ][32] fp32 in the
// dq map's 128-byte swizzle; sQ [kStages][kBQ][DP] and sO likewise; lse
// and delta [kStages][2][kBQ] fp32; the mask words [kStages][kBQ * 4];
// the mbarriers: k/v, each stage's full and empty, each (buffer,
// warpgroup)'s dq full, each buffer's dq empty.
template <int D, bool DQ>
struct WsTiles {
  static constexpr int DP = kDP<D>;
  static constexpr bool kSplitCols = DP == 128;
  static constexpr int kKV = kBK * DP * 2;
  static constexpr int kQ = kBQ * DP * 2;
  static constexpr int kDS = kBK * kBQ * 2;
  static constexpr int kDQHalf = kBQ * 64 * 4;     // a warpgroup's partial
  static constexpr int kDQ = 2 * kDQHalf;          // a buffer
  static constexpr int kStats = 2 * kBQ * 4;
  static constexpr int kBars = 1 + 2 * kWsMaxStages + 4 + 2;
  static constexpr int oK = 0, oV = kKV, oDS = 2 * kKV,
                       oDQ = oDS + (DQ ? kDS : 0),
                       oQ = oDQ + (DQ ? 2 * kDQ : 0);
  static constexpr int kStage = 2 * kQ + kStats + kWsBitsBytes;
  static constexpr int kFit =
      (kSmemMax - 1024 - oQ - kBars * 8 - kWsMaxStages * 4) / kStage;
  static constexpr int kStages = kFit < kWsMaxStages ? kFit : kWsMaxStages;
  static constexpr int oO = oQ + kStages * kQ, oStats = oO + kStages * kQ,
                       oBits = oStats + kStages * kStats,
                       oBar = oBits + kStages * kWsBitsBytes,
                       oInfo = oBar + kBars * 8;
  static constexpr size_t bytes = 1024 + oInfo + kWsMaxStages * 4;
  static_assert(kStages >= 2, "a ring of two stages fits");
  static_assert(bytes <= kSmemMax, "the tiles fit in shared memory");
};

// `bytes` of global memory at src into shared memory at dst, completing
// `bar`'s transactions (both 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// An arrival on `bar` once every cp.async this thread issued has landed
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// Operands as flash_bwd_kernel's, with q, dO, k and v as tensor maps
// (bf16_tile_map: kBQ-row boxes for q and dO, kBK-row boxes for k and
// v), dq_map unused without DQ, and, for MASK, the pre-pass's bits
// [nmask, nqb, nkt, kMaskWords].  DQ: the grid is (key block, batch-head);
// without it one dimension of nbh x nkt blocks, the longest key blocks
// first within groups of `group` heads.
template <int D, bool DQ, bool MASK, bool DROP>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_ws_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap dq_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int sq, int sk, int causal,
                    int off, int valid_q, int valid_k, float scale_log2,
                    float scale, const unsigned* __restrict__ bits,
                    const MdParams md, int nbh, int group) {
  static_assert(D == 64 || D == 128, "the mask/dropout head dims");
  using T = WsTiles<D, DQ>;
  constexpr int DP = T::DP, S = T::kStages;
  constexpr int kKS = D / 16;        // k16 steps of S^T and dP^T over d
  constexpr int kQS = kBQ / 16;      // k16 steps of dV and dK over queries
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base + T::oK, sV = base + T::oV, sQ = base + T::oQ,
                 sO = base + T::oO, sDS = base + T::oDS, sDQ = base + T::oDQ,
                 sStats = base + T::oStats, sBits = base + T::oBits;
  const uint32_t bKV = base + T::oBar, bFull = bKV + 8,
                 bEmpty = bFull + 8 * kWsMaxStages,
                 bDqFull = bEmpty + 8 * kWsMaxStages, bDqEmpty = bDqFull + 32;

  // this block's key block kb of batch-head bh, of nkt key blocks (the
  // pre-pass's key tiles)
  const int nkt = (sk + kBK - 1) / kBK;
  int kb = blockIdx.x, bh = blockIdx.y;
  if constexpr (!DQ) {
    const int g = blockIdx.x / (group * nkt), r = blockIdx.x % (group * nkt);
    const int gsize = min(group, nbh - g * group);
    bh = g * group + r % gsize;
    kb = r / gsize;
  }
  const int k0 = kb * kBK;
  const int tid = threadIdx.x;
  const int kv_end = min(sk, valid_k);
  const int q_end = min(sq, valid_q);
  // query rows that can see any of this block's keys: [q_begin, q_end)
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - off);
  q_begin = (q_begin / kBQ) * kBQ;
  const int nq = (k0 < kv_end && q_begin < q_end)
                     ? (q_end - q_begin + kBQ - 1) / kBQ : 0;
  // MASK: the class of the step at query q0 (its 128-query block's, this
  // block's key tile's); the steps every role walks are the live ones
  const int nqb = (sq + kQmBQ - 1) / kQmBQ;
  const size_t mtiles = MASK ? (size_t)(bh / md.mask_hper) * nqb * nkt : 0;
  auto step_cls = [&](int q0) -> unsigned char {
    if constexpr (MASK) return md.cls[mtiles + (q0 / kQmBQ) * nkt + kb];
    return kTileFull;
  };
  int nlive = nq;
  if constexpr (MASK) {
    nlive = 0;
    for (int it = 0; it < nq; ++it)
      nlive += step_cls(q_begin + it * kBQ) != kTileDead;
  }

  if (tid == 0) {
    mbar_init(bKV, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(bFull + 8 * st, 1 + 32);   // the TMA arrival, 32 cp.async
      mbar_init(bEmpty + 8 * st, kWsConsumers);
    }
    if constexpr (DQ) {
      for (int i = 0; i < 4; ++i) mbar_init(bDqFull + 8 * i, 128);
      for (int i = 0; i < 2; ++i) mbar_init(bDqEmpty + 8 * i, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kWsConsumers) {
    reg_dealloc<kWsCopyRegs>();
    const int w = (tid - kWsConsumers) >> 5, lane = tid & 31;
    if (nlive == 0 || w > (DQ ? 1 : 0)) return;
    // every role walks the live steps in order: step i in stage i % S
    if (w == 0) {
      // the loads: k and v, then each live step's q, dO, lse, delta (and
      // a partial step's mask words) into stage i % S
      if (lane == 0) {
        mbar_expect_tx(bKV, 2 * T::kKV);
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(sK + c * (kBK * 128), &tk, bKV, c * 64, k0, bh);
          tma_load(sV + c * (kBK * 128), &tv, bKV, c * 64, k0, bh);
        }
      }
      const float* lb = lse + (size_t)bh * sq;
      const float* db = delta + (size_t)bh * sq;
      for (int it = 0, i = 0; it < nq; ++it) {
        const int q0 = q_begin + it * kBQ;
        const unsigned char c = step_cls(q0);
        if (MASK && c == kTileDead) continue;
        const int st = i % S, use = i / S;
        ++i;
        const uint32_t full = bFull + 8 * st;
        if (use > 0) mbar_wait(bEmpty + 8 * st, (use - 1) & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h;
          const bool live = q0 + r < sq;
          cp_async4z(sStats + (st * 2 * kBQ + r) * 4, live ? lb + q0 + r : lb,
                     live);
          cp_async4z(sStats + (st * 2 * kBQ + kBQ + r) * 4,
                     live ? db + q0 + r : db, live);
        }
        cp_async_arrive(full);
        if (lane == 0) {
          const bool part = MASK && c == kTilePartial;
          reinterpret_cast<volatile int*>(smem + T::oInfo)[st] = q0 * 2 + part;
          mbar_expect_tx(full, 2 * T::kQ + (part ? kWsBitsBytes : 0));
          for (int cc = 0; cc < DP / 64; ++cc) {
            tma_load(sQ + st * T::kQ + cc * (kBQ * 128), &tq, full, cc * 64,
                     q0, bh);
            tma_load(sO + st * T::kQ + cc * (kBQ * 128), &tdo, full, cc * 64,
                     q0, bh);
          }
          if (part)
            bulk_load(sBits + st * kWsBitsBytes,
                      bits + ((mtiles + (q0 / kQmBQ) * nkt + kb) *
                                  kMaskWords +
                              (q0 % kQmBQ) * 4),
                      kWsBitsBytes, full);
        }
      }
    } else if (w == 1) {
      if (lane > 0) return;
      // the dq reductions: each live step's two partials (one a product
      // warpgroup) from buffer i % 2, then the buffer released
      for (int it = 0, i = 0; it < nq; ++it) {
        const int q0 = q_begin + it * kBQ;
        if (MASK && step_cls(q0) == kTileDead) continue;
        const int b = i & 1, use = i >> 1;
        ++i;
        for (int g = 0; g < 2; ++g) {
          mbar_wait(bDqFull + 8 * (b * 2 + g), use & 1);
#pragma unroll
          for (int c = 0; c < 2; ++c)
            tensor_add_f32(&dq_map, (T::kSplitCols ? g * 64 : 0) + c * 32,
                           q0, bh,
                           sDQ + b * T::kDQ + g * T::kDQHalf +
                               c * (kBQ * 128));
        }
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(bDqEmpty + 8 * b);
      }
      bulk_wait();
    }
    return;
  }
  reg_alloc<kWsRegs>();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int krow = wg * 64 + warp * 16 + grp;   // and krow + 8
  const int wk0 = k0 + wg * 64;
  const float* stats = reinterpret_cast<const float*>(smem + T::oStats);
  const unsigned* swords = reinterpret_cast<const unsigned*>(smem + T::oBits);

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  unsigned pa[kQS][4], da[kQS][4];
  // DROP: the seed's and batch-head's part of the keep hash, the query
  // offset, and the hash of this thread's two keys
  uint32_t hseed = 0u, hroff = 0u, hkey[2] = {0u, 0u};
  if constexpr (DROP) {
    hseed = drop_row((uint32_t)__ldg(md.seed3), (uint32_t)bh, 0u);
    hroff = (uint32_t)__ldg(md.seed3 + 1);
    const uint32_t coff = (uint32_t)__ldg(md.seed3 + 2);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      hkey[hf] = fold16(drop_col(coff + (uint32_t)(k0 + krow + hf * 8)));
  }
  if (nlive > 0) mbar_wait(bKV, 0);

  for (int n = 0; n < nlive; ++n) {
    const int st = n % S, b = n & 1;
    const uint32_t cQ = sQ + st * T::kQ, cO = sO + st * T::kQ;
    mbar_wait(bFull + 8 * st, (n / S) & 1);
    // the step's first query and (MASK) whether it reads its mask words
    const int info = reinterpret_cast<const int*>(smem + T::oInfo)[st];
    const int q0 = info >> 1;
    const bool partial = MASK && (info & 1);

    // S^T = K Q^T and dP^T = V dO^T over this warpgroup's 64 keys, one
    // commit group each (the first k-step overwrites the accumulators,
    // which are only declared here, at no instruction)
    float s[32], dp[32];
    undef(s);
    undef(dp);
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

    // while they run: bit x of `dead` masks element x (query q0 + j * 8 +
    // tig * 2 + e, key krow + hf * 8, x = j * 4 + hf * 2 + e), bit x of
    // kbits keeps it (DROP: the query as the hash's row, the key as its
    // column)
    const bool full = wk0 + 64 <= kv_end && q0 + kBQ <= q_end &&
                      (!causal || wk0 + 63 <= q0 + off);
    unsigned dead = 0u;
    if (!full) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = q0 + j * 8 + tig * 2 + e;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int kr = k0 + krow + hf * 8;
            const bool live = kr < kv_end && qc < q_end &&
                              (!causal || kr <= qc + off);
            dead |= (unsigned)!live << (j * 4 + hf * 2 + e);
          }
        }
    }
    if constexpr (MASK) {
      if (partial) {
        // word (row, grp / 2) holds key krow at bit sh, krow + 8 at sh + 2
        const unsigned* wrow = swords + st * (kBQ * 4) + (grp >> 1);
        const int sh = 2 * (krow >> 3) + (grp & 1);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const unsigned wd = wrow[(j * 8 + tig * 2 + e) * 4] >> sh;
            dead |= ((wd & 1u) << (j * 4 + e)) |
                    (((wd >> 2) & 1u) << (j * 4 + 2 + e));
          }
      }
    }
    unsigned kbits = 0u;
    if constexpr (DROP) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t hq = fold16(
              hseed ^ ((hroff + (uint32_t)(q0 + j * 8 + tig * 2 + e)) * kH2));
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            kbits |= (unsigned)drop_keep_folded(hq, hkey[hf], md.threshold)
                     << (j * 4 + hf * 2 + e);
        }
    }
    wgmma_wait<1>();
    keep(s);

    // P^T = exp2(S^T * scale_log2 - lse[q]) where live (every element of
    // this thread live: its rows' lse are finite, no test)
    const float* cl = stats + st * 2 * kBQ;
    const float* cd = cl + kBQ;
    if (dead == 0u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(cl + j * 8 + tig * 2);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          s[j * 4 + hf * 2] = exp2_ftz(s[j * 4 + hf * 2] * scale_log2 - l2.x);
          s[j * 4 + hf * 2 + 1] =
              exp2_ftz(s[j * 4 + hf * 2 + 1] * scale_log2 - l2.y);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(cl + j * 8 + tig * 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = e ? l2.y : l2.x;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int x = j * 4 + hf * 2 + e;
            s[x] = (!((dead >> x) & 1u) && l > kMaskedRowThresh)
                       ? exp2_ftz(s[x] * scale_log2 - l)
                       : 0.f;
          }
        }
      }
    }
    // the accumulator fragments of query columns 16t .. 16t + 15 are the
    // A fragment of k-step t, rounded to bf16 (DROP: dropped and
    // rescaled, for dV alone)
#pragma unroll
    for (int t = 0; t < kQS; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int x = 8 * t + 2 * u;
        if constexpr (DROP)
          pa[t][u] = pack_bf16((kbits >> x) & 1u ? s[x] * md.inv_keep : 0.f,
                               (kbits >> (x + 1)) & 1u
                                   ? s[x + 1] * md.inv_keep : 0.f);
        else
          pa[t][u] = pack_bf16(s[x], s[x + 1]);
      }
    wgmma_wait<0>();
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
          float g = dp[x];
          if constexpr (DROP)
            g = (kbits >> x) & 1u ? g * md.inv_keep : 0.f;
          dp[x] = s[x] * (g - (e ? d2.y : d2.x));
        }
    }
#pragma unroll
    for (int t = 0; t < kQS; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        da[t][u] = pack_bf16(dp[8 * t + 2 * u], dp[8 * t + 2 * u + 1]);
    if constexpr (!DQ) {
      // the dk/dv kernel: dV += P^T dO and dK += dS^T Q, then the stage
      // is released
      keep(dva);
      keep(dka);
      keep(pa);
      keep(da);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kQS; ++t)
        wgmma_rs(dva, pa[t], gmma_desc(cO + t * 16 * 128, kBQ * 128, 1024),
                 1);
#pragma unroll
      for (int t = 0; t < kQS; ++t)
        wgmma_rs(dka, da[t], gmma_desc(cQ + t * 16 * 128, kBQ * 128, 1024),
                 1);
      wgmma_commit();
      wgmma_wait_all();
      keep(dva);
      keep(dka);
      keep(pa);
      keep(da);
      mbar_arrive(bEmpty + 8 * st);          // q, dO, lse, delta read
      continue;
    }

    // stage dS^T [keys][queries] for dQ = dS K (d = 128: once the other
    // warpgroup's dQ product of the last step has read the tile)
    if constexpr (T::kSplitCols)
      if (n > 0) bar_sync(2, kWsConsumers);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = krow + hf * 8;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                         sDS + sw128<kBK>(r, j) + tig * 4),
                     "r"(da[j >> 1][(j & 1) * 2 + hf]));
      }
    fence_async_smem();     // dS^T, visible to wgmma
    float dqa[32];
    undef(dqa);

    // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q read
    // N-major from the step's tiles (LBO: the 64-column chunk stride)
    keep(dqa);
    keep(dva);
    keep(dka);
    keep(pa);
    keep(da);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kQS; ++t)
      wgmma_rs(dva, pa[t], gmma_desc(cO + t * 16 * 128, kBQ * 128, 1024), 1);
#pragma unroll
    for (int t = 0; t < kQS; ++t)
      wgmma_rs(dka, da[t], gmma_desc(cQ + t * 16 * 128, kBQ * 128, 1024), 1);
    wgmma_commit();

    // dQ = dS K: dS^T read M-major, K N-major
    if constexpr (T::kSplitCols) {
      bar_sync(1, kWsConsumers);   // both warpgroups' dS^T rows
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < kBK / 16; ++kt)
        wgmma_ss<1, 1>(
            dqa, gmma_desc(sDS + kt * 16 * 128, kBK * 128, 1024),
            gmma_desc(sK + wg * (kBK * 128) + kt * 16 * 128, kBK * 128,
                      1024),
            kt > 0);
    } else {
      bar_sync(3 + wg, 128);       // this warpgroup's dS^T rows
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt)
        wgmma_ss<1, 1>(
            dqa, gmma_desc(sDS + (wg * 64 + kt * 16) * 128, kBK * 128, 1024),
            gmma_desc(sK + (wg * 64 + kt * 16) * 128, kBK * 128, 1024),
            kt > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep(dqa);
    keep(dva);
    keep(dka);
    keep(pa);
    keep(da);
    mbar_arrive(bEmpty + 8 * st);            // q, dO, lse, delta read

    // the partial (unscaled: the cast scales dq) into buffer b's
    // swizzled [2][kBQ][32] tile of this warpgroup, once the reductions
    // two steps back have read it
    if (n >= 2) mbar_wait(bDqEmpty + 8 * b, ((n >> 1) - 1) & 1);
    const uint32_t dst = sDQ + b * T::kDQ + wg * T::kDQHalf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + tig * 2, c = col & 31;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = warp * 16 + grp + hf * 8;
        const uint32_t a = dst + (col >> 5) * (kBQ * 128) + r * 128 +
                           ((((c >> 2) ^ (r & 7))) << 4) + (c & 3) * 4;
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
                     "f"(dqa[j * 4 + hf * 2]), "f"(dqa[j * 4 + hf * 2 + 1]));
      }
    }
    fence_async_smem();     // the partial, visible to the reductions
    mbar_arrive(bDqFull + 8 * (b * 2 + wg));
  }

  // this block owns its keys' dk and dv: plain stores, no atomics
  bf16* dkb = dk + (size_t)bh * sk * D;
  bf16* dvb = dv + (size_t)bh * sk * D;
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

// The operands the MASK and DROP instances need.
template <bool MASK, bool DROP>
bool ws_operands_ok(const MdParams& md, const void* bits, int bh) {
  if (MASK && (md.cls == nullptr || bits == nullptr || md.mask_hper < 1 ||
               bh % md.mask_hper))
    return false;
  return !DROP || md.seed3 != nullptr;
}

// The one-pass backward with a mask and/or dropout: dq_acc zeroed, the
// kernel over (key block, b*h) adding into it, dq cast from it.
template <int D, bool MASK, bool DROP>
int launch_one_pass_ws(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq_acc, void* dq, void* dk, void* dv, int bh,
                       int sq, int sk, int causal, int off, int valid_q,
                       int valid_k, float scale_log2, float scale,
                       cudaStream_t stream, const MdParams& md,
                       const void* bits) {
  if (!ws_operands_ok<MASK, DROP>(md, bits, bh))
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)bh * sq * D;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (sk > 0) {
    CUtensorMap tq, tk, tv, tdo, tdq;
    int e = dq_tensor_map(&tdq, dq_acc, bh, sq, D);
    if (!e) e = bf16_tile_map(&tq, q, bh, sq, D, kBQ);
    if (!e) e = bf16_tile_map(&tdo, dout, bh, sq, D, kBQ);
    if (!e) e = bf16_tile_map(&tk, k, bh, sk, D, kBK);
    if (!e) e = bf16_tile_map(&tv, v, bh, sk, D, kBK);
    if (e) return e;
    const size_t bytes = WsTiles<D, true>::bytes;
    err = cudaFuncSetAttribute(flash_bwd_ws_kernel<D, true, MASK, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((sk + kBK - 1) / kBK, bh);
    flash_bwd_ws_kernel<D, true, MASK, DROP>
        <<<grid, kWsThreads, bytes, stream>>>(
        tq, tk, tv, tdo, tdq, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), sq, sk, causal, off, valid_q, valid_k,
        scale_log2, scale, static_cast<const unsigned*>(bits), md, bh, 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_dq_cast(dq_acc, dq, n, scale, stream);   // unscaled partials
}

// The split backward's dk/dv kernel with a mask and/or dropout (the
// pre-pass has run for MASK): one block a (key block, batch-head), the
// longest key blocks first within groups of heads whose q and dO fit half
// the L2.
template <int D, bool MASK, bool DROP>
int launch_dkv_ws(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int sq, int sk, int causal,
                  int off, int valid_q, int valid_k, float scale_log2,
                  float scale, cudaStream_t stream, const MdParams& md,
                  const void* bits) {
  if (!ws_operands_ok<MASK, DROP>(md, bits, bh))
    return (int)cudaErrorInvalidValue;
  if (sk <= 0) return 0;
  CUtensorMap tq, tk, tv, tdo;
  // no queries: no block loads q or dO, whose maps then describe k
  int e = sq > 0 ? bf16_tile_map(&tq, q, bh, sq, D, kBQ)
                 : bf16_tile_map(&tq, k, bh, sk, D, kBQ);
  if (!e) e = sq > 0 ? bf16_tile_map(&tdo, dout, bh, sq, D, kBQ)
                     : bf16_tile_map(&tdo, k, bh, sk, D, kBQ);
  if (!e) e = bf16_tile_map(&tk, k, bh, sk, D, kBK);
  if (!e) e = bf16_tile_map(&tv, v, bh, sk, D, kBK);
  if (e) return e;
  const size_t bytes = WsTiles<D, false>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_ws_kernel<D, false, MASK, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // heads in groups of near-equal size whose q and dO fit half the L2
  const long long qdo_bytes = 4LL * (sq > 0 ? sq : 1) * D * bh;
  const long long ngroups = (qdo_bytes + kL2Half - 1) / kL2Half;
  const int group = (int)((bh + ngroups - 1) / ngroups);
  const long long blocks = (long long)bh * ((sk + kBK - 1) / kBK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_ws_kernel<D, false, MASK, DROP>
      <<<(unsigned)blocks, kWsThreads, bytes, stream>>>(
      tq, tk, tv, tdo, tq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, sk, causal, off, valid_q, valid_k,
      scale_log2, scale, static_cast<const unsigned*>(bits), md, bh, group);
  return (int)cudaGetLastError();
}

}  // namespace
