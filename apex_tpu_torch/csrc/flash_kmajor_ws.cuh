// The key-major flash-attention backward's mask and dropout instances for
// Hopper (sm_90a), warp-specialized: flash_bwd_ws_kernel<D, DQ, MASK,
// DROP>, launched by flash_attention_bwd_md.cu for the one-pass kernel
// (DQ: #4m, #4md and #4d) and the split backward's dk/dv kernel (#6md).
// The wide family's dk/dv (#6w: flash_wide.cu through flash_wide_ws.cuh)
// is its other operand modes (OP, below): fp16 operands, bf16 at head
// dim 256, fp32 as three bf16 planes.
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
// The wide modes (OP != kOpBf16, the dk/dv kernel alone; launched by
// launch_wide_dkv_ws in flash_wide_ws.cuh).  Replaces _dkv_kernel for
// the operands the bf16 instances do not take; flash_qmajor_ws.cuh's
// operand modes (kOpWideF16, kOpWideBf16, kOpWideF32 and the
// row-copying kOpWideBf16Rows, kOpWideF16Rows).  A block owns 64 keys
// (WsWideTiles): at d 256 one warpgroup's dK and dV accumulators would
// take 256 registers a thread, and three planes of K and V for 128 keys
// do not fit beside a ring.  So the first product warpgroup computes
// S^T = K Q^T, P^T and dV += P^T dO, the second dP^T = V dO^T, dS^T and
// dK += dS^T Q, over the same 64 keys and each step's BQ queries (64; 32
// for fp32 at d 128, whose six planes of q and dO make a stage 48 KB):
// D / 2 accumulator registers a thread, P^T and dS^T register A
// fragments as in the bf16 instances.  The first hands P^T to the second
// through the stage's slot of fp32 values in its own fragment order (a
// thread writes and the same thread of the other warpgroup reads each
// value, bank-conflict free), a dropped element with its sign bit set,
// and arrives on the stage's "P full" mbarrier; the ring's empty
// barrier keeps the slot until both are done with it.  Each warpgroup
// issues the next step's S^T (dP^T) before it waits on its last dV (dK)
// product.  The mask: mask3 read in place (a byte an element, by the
// first warpgroup alone; no pre-pass, whose scratch the wide entries do
// not take and whose 128 x 128 tiles a 64-key block would read half
// of), and a block whose keys it masks for every query skipped whole
// after one pass of all threads over its bytes; the keep hash, the query
// as its row, in the first warpgroup.
// The operands come at their real head dim d (columns past d read as
// zero; fp32 planes padded to dp, a multiple of 8), fp16 runs the .f16
// products, p and ds are rounded to the operand type (fp32: split into
// three planes in registers, each product six bf16 products smallest
// first), dk and dv leave from the accumulators (columns < d, rows < sk)
// in the operands' type.  16-bit rows TMA cannot read are copied by
// warps 1-3 of the copying warpgroup (copy_tile; the "full" mbarriers
// count their 96 arrivals).  The kernel's arguments stay those of the
// bf16 instances: the head dim rides in the unused dq map, mask3 in the
// pre-pass bits' pointer, dk and dv in the bf16 pointers.  Shared memory
// (WsWideTiles): 16-bit d 256 two stages (226 KB), d 128 three, d 64
// four; fp32 two.
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
#include "flash_qmajor_ws.cuh"

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

// The wide modes (OP != kOpBf16, the dk/dv kernel alone): a block of
// kWideBK keys whose K and V stay resident, a ring of BQ-query stages
// (Q, dO, P^T handed from the dV warpgroup to the dK one, lse and
// delta), an operand NPL bf16 planes for fp32 (three) and one otherwise.
// Offsets from a 1024-aligned base: sK, sV [NPL][kWideBK][DP]; sQ, sO
// [kStages][NPL][BQ][DP]; P^T [kStages][BQ / 2 elements][128 threads]
// fp32; lse and delta [kStages][2][BQ] fp32; the mbarriers (K/V, each
// stage's full, empty and P^T full); each stage's first query.  BQ: 64,
// but 32 for fp32 past head dim 64 (two stages of six planes of 64
// queries do not fit beside three planes of K and V).
constexpr int kWideBK = 64;
template <int D, int OP>
struct WsWideTiles {
  static constexpr int NPL = kOpPlanes<OP>;
  static constexpr int DP = kDP<D>;
  static constexpr int BQ = NPL == 3 && D > 64 ? 32 : 64;
  static constexpr int kKVP = kWideBK * DP * 2;   // a plane of K or V
  static constexpr int kKV = NPL * kKVP;
  static constexpr int kQP = BQ * DP * 2;         // a plane of Q or dO
  static constexpr int kQ = NPL * kQP;
  static constexpr int kP = kWideBK * BQ * 4;
  static constexpr int kStats = 2 * BQ * 4;
  static constexpr int kBars = 1 + 3 * kWsMaxStages;
  static constexpr int oK = 0, oV = kKV, oQ = 2 * kKV;
  static constexpr int kStage = 2 * kQ + kP + kStats;
  static constexpr int kFit =
      (kSmemMax - 1024 - oQ - kBars * 8 - kWsMaxStages * 4) / kStage;
  static constexpr int kStages = kFit < kWsMaxStages ? kFit : kWsMaxStages;
  static constexpr int oO = oQ + kStages * kQ, oP = oO + kStages * kQ,
                       oStats = oP + kStages * kP,
                       oBar = oStats + kStages * kStats,
                       oInfo = oBar + kBars * 8;
  static constexpr size_t bytes = 1024 + oInfo + kWsMaxStages * 4;
  static_assert(kStages >= 2, "a ring of two stages fits");
  static_assert(bytes <= kSmemMax, "the tiles fit in shared memory");
};

// An int in a tensor-map parameter a kernel does not otherwise use (the
// wide modes' head dim, in the dq map's place).
inline CUtensorMap int_map(int v) {
  CUtensorMap m{};
  std::memcpy(&m, &v, sizeof v);
  return m;
}

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
// first within groups of `group` heads.  F32 (the bf16 instances
// without a mask): dk and dv point at fp32 [nbh, sk, D], stored from the
// accumulators, and the dq partials are scaled here, so the fp32 dq
// accumulator is dq itself (ring attention's partials, never rounded to
// bf16).
template <int D, bool DQ, bool MASK, bool DROP, int OP = kOpBf16,
          bool F32 = false>
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
  static_assert(D == 64 || D == 128 || (OP != kOpBf16 && D == 256),
                "the instances' head dims");
  static_assert(OP == kOpBf16 || (!DQ && !MASK),
                "a wide mode is the dk/dv kernel and reads mask3 itself");
  static_assert(!F32 || (OP == kOpBf16 && !MASK),
                "fp32 outputs: the bf16 instances without a mask");
  if constexpr (OP != kOpBf16) {
    using T = WsWideTiles<D, OP>;
    constexpr bool F16 = OP == kOpWideF16 || OP == kOpWideF16Rows;
    constexpr bool ROWS = kOpRows<OP>;
    constexpr int NPL = T::NPL, BQ = T::BQ, DP = T::DP, S = T::kStages;
    constexpr int kPairs = NPL == 3 ? 6 : 1;   // products i in [6 - kPairs, 6)
    constexpr int kKS = D / 16;       // k16 steps of S^T and dP^T over d
    constexpr int kQS = BQ / 16;      // k16 steps of dV and dK over queries
    constexpr int kSN = BQ / 2;       // registers of an m64 x BQ accumulator
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* smem = smem_raw + (base - raw);
    const uint32_t sK = base + T::oK, sV = base + T::oV, sQ = base + T::oQ,
                   sO = base + T::oO;
    const uint32_t bKV = base + T::oBar, bFull = bKV + 8,
                   bEmpty = bFull + 8 * kWsMaxStages,
                   bPFull = bEmpty + 8 * kWsMaxStages;
    volatile int* info = reinterpret_cast<volatile int*>(smem + T::oInfo);
    // the real head dim rides in dq_map's first word, mask3 in `bits`
    const int d = *reinterpret_cast<const int*>(&dq_map);
    const unsigned char* mask3 = reinterpret_cast<const unsigned char*>(bits);

    // this block's key block kb of batch-head bh: the longest key blocks
    // first within groups of `group` heads
    const int nkt = (sk + kWideBK - 1) / kWideBK;
    const int hg = blockIdx.x / (group * nkt),
              hr = blockIdx.x % (group * nkt);
    const int gsize = min(group, nbh - hg * group);
    const int bh = hg * group + hr % gsize, kb = hr / gsize;
    const int k0 = kb * kWideBK;
    const int tid = threadIdx.x;
    const int kv_end = min(sk, valid_k), q_end = min(sq, valid_q);
    // the BQ-query steps that can see any of this block's keys
    int q_begin = causal ? max(0, k0 - off) : 0;
    q_begin = (q_begin / BQ) * BQ;
    int nq = (k0 < kv_end && q_begin < q_end)
                 ? (q_end - q_begin + BQ - 1) / BQ : 0;

    if (tid == 0) {
      mbar_init(bKV, ROWS ? kFwCopiers : 1);
      for (int st = 0; st < S; ++st) {
        // the TMA arrival (ROWS: a plain one and the copying threads'),
        // 32 cp.async
        mbar_init(bFull + 8 * st, 1 + 32 + (ROWS ? kFwCopiers : 0));
        mbar_init(bEmpty + 8 * st, kWsConsumers);
        mbar_init(bPFull + 8 * st, 128);
      }
      mbar_init_fence();
    }
    // mask3: a block whose keys mask3 masks for every query that can
    // see them is dead (a padding mask's last key blocks); `seen`: some
    // element is not masked, its rows read by every thread at once, four
    // bytes a load where they allow
    int seen = mask3 == nullptr || nq == 0;
    if (!seen) {
      const int kn = min(kWideBK, kv_end - k0), nr = q_end - q_begin;
      const unsigned char* mb =
          mask3 + ((size_t)(bh / md.mask_hper) * sq + q_begin) * sk + k0;
      if (!(sk & 3) && !(kn & 3) && !(reinterpret_cast<uintptr_t>(mb) & 3)) {
        const int wn = kn / 4;
#pragma unroll 4
        for (int i = tid; i < nr * wn; i += kWsThreads) {
          const unsigned w = __ldg(reinterpret_cast<const unsigned*>(
                                       mb + (size_t)(i / wn) * sk) + i % wn);
          seen |= !(w & 0xffu) || !(w & 0xff00u) || !(w & 0xff0000u) ||
                  !(w >> 24);
        }
      } else {
#pragma unroll 4
        for (int i = tid; i < nr * kn; i += kWsThreads)
          seen |= !__ldg(mb + (size_t)(i / kn) * sk + i % kn);
      }
    }
    if (!__syncthreads_or(seen)) nq = 0;

    if (tid >= kWsConsumers) {
      reg_dealloc<kWsCopyRegs>();
      const int w = (tid - kWsConsumers) >> 5, lane = tid & 31;
      if (nq == 0 || (!ROWS && w > 0)) return;
      if (w == 0) {
        // K and V once (plane pl of batch-head bh is the map's batch-head
        // bh + pl nbh), then each step's lse, delta, q and dO into stage
        // i % S
        if (!ROWS && lane == 0) {
          mbar_expect_tx(bKV, 2 * T::kKV);
          for (int pl = 0; pl < NPL; ++pl)
            for (int c = 0; c < DP / 64; ++c) {
              tma_load(sK + pl * T::kKVP + c * (kWideBK * 128), &tk, bKV,
                       c * 64, k0, bh + pl * nbh);
              tma_load(sV + pl * T::kKVP + c * (kWideBK * 128), &tv, bKV,
                       c * 64, k0, bh + pl * nbh);
            }
        }
        const float* lb = lse + (size_t)bh * sq;
        const float* db = delta + (size_t)bh * sq;
        const uint32_t sStats = base + T::oStats;
        for (int i = 0; i < nq; ++i) {
          const int q0 = q_begin + i * BQ, st = i % S, use = i / S;
          const uint32_t full = bFull + 8 * st;
          if (use > 0) mbar_wait(bEmpty + 8 * st, (use - 1) & 1);
#pragma unroll
          for (int h = 0; h < BQ / 32; ++h) {
            const int rr = lane + 32 * h;
            const bool live = q0 + rr < sq;
            cp_async4z(sStats + (st * 2 * BQ + rr) * 4,
                       live ? lb + q0 + rr : lb, live);
            cp_async4z(sStats + (st * 2 * BQ + BQ + rr) * 4,
                       live ? db + q0 + rr : db, live);
          }
          cp_async_arrive(full);
          if (lane == 0) {
            info[st] = q0;
            if constexpr (ROWS) {
              mbar_arrive(full);
            } else {
              mbar_expect_tx(full, 2 * T::kQ);
              for (int pl = 0; pl < NPL; ++pl)
                for (int cc = 0; cc < DP / 64; ++cc) {
                  tma_load(sQ + st * T::kQ + pl * T::kQP + cc * (BQ * 128),
                           &tq, full, cc * 64, q0, bh + pl * nbh);
                  tma_load(sO + st * T::kQ + pl * T::kQP + cc * (BQ * 128),
                           &tdo, full, cc * 64, q0, bh + pl * nbh);
                }
            }
          }
        }
      } else if constexpr (ROWS) {
        // the row-copying modes: warps 1-3 copy K and V, then each step's
        // q and dO, into the same swizzled tiles
        const int ci = (w - 1) * 32 + lane;
        const size_t ko = (size_t)bh * sk * d, qo = (size_t)bh * sq * d;
        copy_tile<kWideBK, DP>(sK, map_address(tk) + ko, k0, sk, d, ci);
        copy_tile<kWideBK, DP>(sV, map_address(tv) + ko, k0, sk, d, ci);
        mbar_arrive(bKV);
        for (int i = 0; i < nq; ++i) {
          const int q0 = q_begin + i * BQ, st = i % S, use = i / S;
          if (use > 0) mbar_wait(bEmpty + 8 * st, (use - 1) & 1);
          copy_tile<BQ, DP>(sQ + st * T::kQ, map_address(tq) + qo, q0, sq, d,
                            ci);
          copy_tile<BQ, DP>(sO + st * T::kQ, map_address(tdo) + qo, q0, sq,
                            d, ci);
          mbar_arrive(bFull + 8 * st);
        }
      }
      return;
    }
    reg_alloc<kWsRegs>();

    // warpgroup 0 accumulates dV, warpgroup 1 dK, over the same 64 keys:
    // thread t of either owns keys krow, krow + 8 and, in an m64 x BQ
    // accumulator, the same elements
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int grp = lane >> 2, tig = lane & 3, ct = tid & 127;
    const int krow = warp * 16 + grp;
    const float* stats = reinterpret_cast<const float*>(smem + T::oStats);
    // S^T (dP^T) = A B^T into acc: A this block's keys of K (V), B the
    // stage's Q (dO), both K-major over d; the plane pairs' products
    // smallest first
    auto ss_product = [&](auto& acc, uint32_t a, uint32_t b) {
#pragma unroll
      for (int i = 6 - kPairs; i < 6; ++i)
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks)
          wgmma_ss<0, 0, F16>(
              acc,
              gmma_desc(a + pair_a(i) * T::kKVP + (ks >> 2) * (kWideBK * 128)
                            + (ks & 3) * 32, 16, 1024),
              gmma_desc(b + pair_b(i) * T::kQP + (ks >> 2) * (BQ * 128)
                            + (ks & 3) * 32, 16, 1024),
              i > 6 - kPairs || ks > 0);
    };
    // acc += A B: A the register fragments a[plane][k-step] (P^T, dS^T), B
    // the stage's dO (Q) read N-major
    auto rs_product = [&](float (&acc)[DP / 2],
                          unsigned (&a)[NPL][kQS][4], uint32_t b) {
#pragma unroll
      for (int i = 6 - kPairs; i < 6; ++i)
#pragma unroll
        for (int t = 0; t < kQS; ++t)
          wgmma_rs<F16>(acc, a[pair_a(i)][t],
                        gmma_desc(b + pair_b(i) * T::kQP + t * 16 * 128,
                                  BQ * 128, 1024), 1);
    };
    // k-step t's A fragment u from two fp32 values: bf16 or fp16
    // (rounded), or the three bf16 planes of fp32
    auto pack_a = [&](unsigned (&a)[NPL][kQS][4], int t, int u, float lo,
                      float hi) {
      if constexpr (NPL == 3) {
        float l3[3], h3[3];
        split3(lo, l3);
        split3(hi, h3);
#pragma unroll
        for (int pl = 0; pl < 3; ++pl) a[pl][t][u] = pack_bf16(l3[pl], h3[pl]);
      } else if constexpr (F16) {
        a[0][t][u] = pack_f16(lo, hi);
      } else {
        a[0][t][u] = pack_bf16(lo, hi);
      }
    };

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    unsigned fa[NPL][kQS][4];     // P^T (warpgroup 0) or dS^T (1)
#pragma unroll
    for (int pl = 0; pl < NPL; ++pl)
#pragma unroll
      for (int t = 0; t < kQS; ++t)
        fa[pl][t][0] = fa[pl][t][1] = fa[pl][t][2] = fa[pl][t][3] = 0u;
    if (nq > 0) mbar_wait(bKV, 0);
    if (wg == 0) {
      // DROP: the seed's and batch-head's part of the keep hash, the
      // query offset, and the hash of this thread's two keys
      uint32_t hseed = 0u, hroff = 0u, hkey[2] = {0u, 0u};
      if constexpr (DROP) {
        hseed = drop_row((uint32_t)__ldg(md.seed3), (uint32_t)bh, 0u);
        hroff = (uint32_t)__ldg(md.seed3 + 1);
        const uint32_t coff = (uint32_t)__ldg(md.seed3 + 2);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          hkey[hf] = fold16(drop_col(coff + (uint32_t)(k0 + krow + hf * 8)));
      }
      const unsigned char* mrow =
          mask3 != nullptr ? mask3 + (size_t)(bh / md.mask_hper) * sq * sk
                           : nullptr;
      for (int n = 0; n < nq; ++n) {
        const int st = n % S;
        const uint32_t cQ = sQ + st * T::kQ, cO = sO + st * T::kQ;
        mbar_wait(bFull + 8 * st, (n / S) & 1);
        const int q0 = info[st];
        float s[kSN];
        undef(s);
        wgmma_fence();
        ss_product(s, sK, cQ);
        wgmma_commit();
        // while S^T runs: bit x of `dead` masks element x (query q0 + 8 j
        // + 2 tig + e, key k0 + krow + 8 hf, x = 4 j + 2 hf + e), bit x of
        // kbits keeps it (DROP: the query as the hash's row, the key as
        // its column)
        unsigned dead = 0u;
        if (mrow != nullptr || k0 + kWideBK > kv_end || q0 + BQ > q_end ||
            (causal && k0 + kWideBK - 1 > q0 + off)) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int qc = q0 + j * 8 + tig * 2 + e;
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int kr = k0 + krow + hf * 8;
                bool live = kr < kv_end && qc < q_end &&
                            (!causal || kr <= qc + off);
                if (live && mrow != nullptr)
                  live = !__ldg(mrow + (size_t)qc * sk + kr);
                dead |= (unsigned)!live << (j * 4 + hf * 2 + e);
              }
            }
        }
        unsigned kbits = 0u;
        if constexpr (DROP) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t hq = fold16(
                  hseed ^
                  ((hroff + (uint32_t)(q0 + j * 8 + tig * 2 + e)) * kH2));
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
                kbits |= (unsigned)drop_keep_folded(hq, hkey[hf], md.threshold)
                         << (j * 4 + hf * 2 + e);
            }
        }
        wgmma_wait<1>();              // the last step's dV is done
        keep(acc);
        keep(fa);
        if (n > 0) mbar_arrive(bEmpty + 8 * ((n - 1) % S));
        wgmma_wait<0>();
        keep(s);
        // P^T = exp2(S^T scale_log2 - lse[q]) where live (no element of
        // this thread dead: no test), handed to warpgroup 1 in this
        // thread's slots of the stage's P^T buffer, a dropped element
        // with its sign bit set
        const float* cl = stats + st * 2 * BQ;
        float* pbuf = reinterpret_cast<float*>(smem + T::oP + st * T::kP);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(cl + j * 8 + tig * 2);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float l = e ? l2.y : l2.x;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int x = j * 4 + hf * 2 + e;
              const float p =
                  dead == 0u ? exp2_ftz(s[x] * scale_log2 - l)
                  : (!((dead >> x) & 1u) && l > kMaskedRowThresh)
                      ? exp2_ftz(s[x] * scale_log2 - l) : 0.f;
              const bool kept = !DROP || ((kbits >> x) & 1u);
              pbuf[x * 128 + ct] = kept ? p : -p;
              s[x] = DROP ? (kept ? p * md.inv_keep : 0.f) : p;
            }
          }
        }
        mbar_arrive(bPFull + 8 * st);
        // dV += P^T dO, P^T dropped and rescaled, rounded to the operand
        // type as the A fragments of the query k-steps
#pragma unroll
        for (int t = 0; t < kQS; ++t)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            pack_a(fa, t, u, s[8 * t + 2 * u], s[8 * t + 2 * u + 1]);
        keep(acc);
        keep(fa);
        wgmma_fence();
        rs_product(acc, fa, cO);
        wgmma_commit();
      }
    } else {
      for (int n = 0; n < nq; ++n) {
        const int st = n % S;
        const uint32_t cQ = sQ + st * T::kQ, cO = sO + st * T::kQ;
        mbar_wait(bFull + 8 * st, (n / S) & 1);
        float dp[kSN];
        undef(dp);
        wgmma_fence();
        ss_product(dp, sV, cO);
        wgmma_commit();
        wgmma_wait<1>();              // the last step's dK is done
        keep(acc);
        keep(fa);
        if (n > 0) mbar_arrive(bEmpty + 8 * ((n - 1) % S));
        wgmma_wait<0>();
        keep(dp);
        // dS^T = P^T (dP^T - delta[q]) (DROP: dP^T of a dropped element 0,
        // of a kept one dP^T / (1 - rate)), once warpgroup 0 has handed
        // P^T over
        mbar_wait(bPFull + 8 * st, (n / S) & 1);
        const float* cd = stats + st * 2 * BQ + BQ;
        const float* pbuf =
            reinterpret_cast<const float*>(smem + T::oP + st * T::kP);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(cd + j * 8 + tig * 2);
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int x = j * 4 + hf * 2 + e;
              const float v = pbuf[x * 128 + ct];
              float g = dp[x];
              if constexpr (DROP)
                g = __float_as_uint(v) >> 31 ? 0.f : g * md.inv_keep;
              dp[x] = (DROP ? fabsf(v) : v) * (g - (e ? d2.y : d2.x));
            }
        }
        // dK += dS^T Q, dS^T rounded to the operand type
#pragma unroll
        for (int t = 0; t < kQS; ++t)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            pack_a(fa, t, u, dp[8 * t + 2 * u], dp[8 * t + 2 * u + 1]);
        keep(acc);
        keep(fa);
        wgmma_fence();
        rs_product(acc, fa, cQ);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    keep(acc);
    if (nq > 0) mbar_arrive(bEmpty + 8 * ((nq - 1) % S));

    // this block owns its keys' dv (warpgroup 0) and dk (1, times the
    // softmax scale), columns < d: plain stores, no atomics
    using Out = std::conditional_t<OP == kOpWideF32, float,
                                   std::conditional_t<F16, __half, bf16>>;
    Out* o = reinterpret_cast<Out*>(wg == 0 ? dv : dk) + (size_t)bh * sk * d;
    const float mul = wg == 0 ? 1.f : scale;
    const bool pair = !(d & 1);     // element pairs 2-element aligned
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kr = k0 + krow + hf * 8;
      if (kr >= sk) continue;
      Out* orow = o + (size_t)kr * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = j * 8 + tig * 2;
        const float lo = acc[j * 4 + hf * 2] * mul,
                    hi = acc[j * 4 + hf * 2 + 1] * mul;
        if (c + 1 < d && pair) {
          if constexpr (OP == kOpWideF32) {
            *reinterpret_cast<float2*>(orow + c) = make_float2(lo, hi);
          } else if constexpr (F16) {
            *reinterpret_cast<unsigned*>(orow + c) = pack_f16(lo, hi);
          } else {
            *reinterpret_cast<unsigned*>(orow + c) = pack_bf16(lo, hi);
          }
        } else {
          if (c < d) orow[c] = static_cast<Out>(lo);
          if (c + 1 < d) orow[c + 1] = static_cast<Out>(hi);
        }
      }
    }
  } else {
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
            reinterpret_cast<volatile int*>(smem + T::oInfo)[st] =
                q0 * 2 + part;
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
        const float2 d2 =
            *reinterpret_cast<const float2*>(cd + j * 8 + tig * 2);
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
                       "f"(F32 ? scale * dqa[j * 4 + hf * 2]
                               : dqa[j * 4 + hf * 2]),
                       "f"(F32 ? scale * dqa[j * 4 + hf * 2 + 1]
                               : dqa[j * 4 + hf * 2 + 1]));
        }
      }
      fence_async_smem();     // the partial, visible to the reductions
      mbar_arrive(bDqFull + 8 * (b * 2 + wg));
    }

    // this block owns its keys' dk and dv: plain stores, no atomics
    if constexpr (F32) {
      store_dkv_f32<D>(dk, dv, bh, sk, k0 + krow, tig, dka, dva, scale);
      return;
    }
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
// kernel over (key block, b*h) adding into it, dq cast from it.  F32
// (dropout, no mask): dq, dk and dv fp32, dq the accumulator itself
// (dq_acc unused, no cast: the kernel scales its partials).
template <int D, bool MASK, bool DROP, bool F32 = false>
int launch_one_pass_ws(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq_acc, void* dq, void* dk, void* dv, int bh,
                       int sq, int sk, int causal, int off, int valid_q,
                       int valid_k, float scale_log2, float scale,
                       cudaStream_t stream, const MdParams& md,
                       const void* bits) {
  if (!ws_operands_ok<MASK, DROP>(md, bits, bh))
    return (int)cudaErrorInvalidValue;
  static_assert(!(F32 && MASK), "fp32 outputs: the instances without a mask");
  const size_t n = (size_t)bh * sq * D;
  void* acc = F32 ? dq : dq_acc;
  cudaError_t err = cudaMemsetAsync(acc, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (sk > 0) {
    CUtensorMap tq, tk, tv, tdo, tdq;
    int e = dq_tensor_map(&tdq, acc, bh, sq, D);
    if (!e) e = bf16_tile_map(&tq, q, bh, sq, D, kBQ);
    if (!e) e = bf16_tile_map(&tdo, dout, bh, sq, D, kBQ);
    if (!e) e = bf16_tile_map(&tk, k, bh, sk, D, kBK);
    if (!e) e = bf16_tile_map(&tv, v, bh, sk, D, kBK);
    if (e) return e;
    const size_t bytes = WsTiles<D, true>::bytes;
    err = cudaFuncSetAttribute(
        flash_bwd_ws_kernel<D, true, MASK, DROP, kOpBf16, F32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((sk + kBK - 1) / kBK, bh);
    flash_bwd_ws_kernel<D, true, MASK, DROP, kOpBf16, F32>
        <<<grid, kWsThreads, bytes, stream>>>(
        tq, tk, tv, tdo, tdq, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), sq, sk, causal, off, valid_q, valid_k,
        scale_log2, scale, static_cast<const unsigned*>(bits), md, bh, 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (F32) return 0;
  return launch_dq_cast(dq_acc, dq, n, scale, stream);   // unscaled partials
}

// The split backward's dk/dv kernel with a mask and/or dropout (the
// pre-pass has run for MASK): one block a (key block, batch-head), the
// longest key blocks first within groups of heads whose q and dO fit half
// the L2.  F32 (dropout, no mask): dk and dv fp32.
template <int D, bool MASK, bool DROP, bool F32 = false>
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
  static_assert(!(F32 && MASK), "fp32 outputs: the instances without a mask");
  const size_t bytes = WsTiles<D, false>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_ws_kernel<D, false, MASK, DROP, kOpBf16, F32>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // heads in groups of near-equal size whose q and dO fit half the L2
  const long long qdo_bytes = 4LL * (sq > 0 ? sq : 1) * D * bh;
  const long long ngroups = (qdo_bytes + kL2Half - 1) / kL2Half;
  const int group = (int)((bh + ngroups - 1) / ngroups);
  const long long blocks = (long long)bh * ((sk + kBK - 1) / kBK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_ws_kernel<D, false, MASK, DROP, kOpBf16, F32>
      <<<(unsigned)blocks, kWsThreads, bytes, stream>>>(
      tq, tk, tv, tdo, tq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, sk, causal, off, valid_q, valid_k,
      scale_log2, scale, static_cast<const unsigned*>(bits), md, bh, group);
  return (int)cudaGetLastError();
}

}  // namespace
