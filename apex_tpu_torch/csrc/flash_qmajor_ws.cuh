// The flash-attention forward's dropout instances and the split
// backward's dq kernel with a mask or dropout for Hopper (sm_90a),
// warp-specialized on a persistent grid: flash_fwd_ws_kernel<D, MASK, DQ,
// DROP>, launched by flash_attention_md.cu for #3d and #3md (the forward:
// DQ false, always dropping) and #5md (DQ: mask and dropout, mask alone,
// dropout alone).  The forwards without dropout (#3, #3m) and the dq
// kernel without mask and dropout (#5) stay on flash_qmajor_kernel.  The
// wide family's forward and dq (#3w, #5w: flash_wide.cu through
// flash_wide_ws.cuh) are its other operand modes (OP, below): fp16
// operands, bf16 at head dim 256, fp32 as three bf16 planes.
//
// Replaces: apex_tpu/ops/attention.py :: _fwd_kernel (launched by _fwd
// through pl.pallas_call) with its dropout operand, with and without its
// mask3 operand, and _dq_kernel (launched by _bwd_impl past the 2 MiB
// gate) with mask3 and dropout.  The forward: same function, tiles and
// products as the query-major
// template's forward (flash_qmajor.cuh): a tile is 128 queries of one
// batch-head, two product warpgroups own 64 of them each and walk the
// 128-key tiles they can see, S = Q K^T from shared memory, O += P V with
// P as register A fragments, the online softmax in base 2 between them.
// Arranged for this card:
//
// - A persistent grid.  One block an SM walks the (batch-head, 128-query
//   block) tiles, heaviest first within each group of heads whose k and v
//   fit half the L2 (flash_qmajor.cuh's grouping): causal by the keys the
//   tile sees (the query blocks from the last); MASK by its live key tiles
//   in the pre-pass's classes, which every block sorts on the device in
//   its prologue (a stable counting sort of each group's (mask, query
//   block) entries, kFwOrderCap of them at most; past that the order is
//   the causal one).  Block b takes the group-ordered tiles b, 2G - 1 - b,
//   2G + b, ... (G blocks, a snake: heavy and light tiles alternate); the
//   dq mode's blocks take the next tile in that order from a counter in
//   device memory instead, each once its loads of the last one are
//   issued (each block the heaviest left: 1.05 -> 0.88 ms against the
//   snake at causal [1, 16, 8192, 128], whose windows of 2G tiles
//   straddle the L2 groups; taken two tiles ahead, 1.03).
// - Two copying warps.  One thread of the third warpgroup computes the
//   schedule and hands each tile's (batch-head, query block, live tiles)
//   to another through a two-entry queue in shared memory (each has only
//   24 registers: setmaxnreg gives the product warpgroups 240).  That one
//   issues every TMA load into two rings, K's and V's (a K tile is free
//   once its S product is done, a V tile only after its P V, a step
//   later), in the order they are needed: K_t beside V_{t-1}, each a
//   stage ahead, the next tile's first K before its Q, and its Q once the
//   current tile's last S product is done with Q (the "Q empty"
//   mbarrier).  It writes each tile's words beside Q and each step's (key
//   tile, partial, last) beside its K.  The mbarrier phases carry across
//   tiles.
// - Ping-pong.  The product warpgroups take turns on the tensor cores
//   (named barriers, bar.sync 1 + wg / bar.arrive 2 - wg, 256 threads):
//   one issues S_t and P_{t-1} V_{t-1} and hands the turn over, so its
//   softmax runs while the other's products hold the tensor cores.
// - The keep hash under the S product.  The keep bits depend only on
//   (seed, batch-head, row, key), so each thread hashes its 64 elements of
//   tile t right after issuing S_t, into two 32-bit words, and applies
//   them when P_t is packed into bf16 A fragments.  The words pass
//   through a shared-memory slot of the thread's own before the S wait:
//   without that store ptxas moves the hash past the wait (the SASS shows
//   it; tools/flash_bwd_probe.py --fwd reads where it sits).  The row's
//   and the column's parts are folded through the finalizer's first
//   xor-shift (fold16), the survivors compare h >= threshold << 8 (the
//   top 24 bits against the threshold, one shift fewer), and the 1 / (1 -
//   rate) scale costs no multiply an element: its log2 joins the
//   exponent's offset, O's division and lse take it back out (the bf16 p
//   of P V rounds p / (1 - rate), as the plain version's).  The row sums
//   take the clean p, only P V the dropped p.
// - O leaves through shared memory: each warpgroup writes its 64 rows
//   in the 128-byte swizzle and one thread issues TMA stores (rows past sq
//   are not written), waited on only when the buffer is needed again a
//   tile later.  lse (base 2) is stored directly.
//
// Shared memory: Q [128][D], (DQ) dO [128][D] and O [128][D] (the O store
// overlaps the next tile), the K and V rings of 128-key stages (DQ: 64),
// the MASK order table, the mbarriers, the schedule words and the hash's
// slots.  d 128: 2 stages a ring (a third does not fit beside separate Q
// and O buffers: 32 + 32 + 3 x 64 KB > 227 KB), 3 in the dq mode; d 64:
// 4.
//
// Masks and numbers as flash_qmajor_kernel's forward: base-2 scores, the
// causal offset and the validity window, the pre-pass's tile classes and
// bits for mask3 (batch-head bh reads mask bh / mask_hper); a fully
// masked row, and a tile with no live key tile, emit O 0 and lse -1e30.
// The keep mask is _keep_mask's bit for bit (hopper.cuh), from the seed
// operand [seed, row_off, col_off] read on the device.
//
// The dq mode (DQ) runs the same schedule, loads and turns over the same
// tiles (128 queries of a batch-head; Q and dO resident, lse and delta
// read once a row) in 64-key steps (S, dP and dQ's accumulators and dS's
// fragments fit a thread's registers; a 128-key step would spill), a
// step's K and V loaded together into their rings.  In its turn a
// warpgroup issues S_t = Q K_t^T, dP_t = dO V_t^T and dQ += dS_{t-1}
// K_{t-1} (at a tile's first step dS is 0, against K_t), hashes step t's
// keep bits while they run, takes P_t = exp2(S_t scale_log2 - lse) when S
// is done and dS_t = P_t (keep ? dP_t / (1 - rate) : 0 - delta) when dP
// and the last dQ product are (_dropped_dp).  V's stage is free once dP
// is done, K's a step later, once its dQ product is.  dq = scale dQ
// leaves as the forward's O does, written once a tile (no atomics: a
// second run gives the same bits).  A 64-key step reads half of a
// pre-pass tile's class and bits.
//
// The wide family's modes (OP != kOpBf16; launch_wide_ws in
// flash_wide_ws.cuh).  The operands come at their real head dim d
// (columns past d read as zero, the bucket D = 64, 128 or 256 being the
// tile's width), O and dq leave straight from the accumulators (columns
// < d, rows < sq: no O buffer), mask3 is read in place (a step's two
// rows' bytes a thread; no pre-pass, whose scratch the wide entries do
// not take) and the dq mode takes its tiles in the forward's snake (no
// counter).  16-bit rows that are not 16-byte multiples (d % 8 != 0) or
// not 16-byte aligned cannot be TMA boxes: the row-copying modes copy
// them with three warps of the copying warpgroup into the same swizzled
// tiles (copy_tile; the operands' addresses ride in the unused
// tensor-map parameters), the "full" mbarriers counting their 96
// arrivals.  fp16 runs the .f16
// products, p and dS packed as fp16 fragments (rounded where the plain
// versions round them).  fp32 (kOpWideF32) reads every operand as
// three bf16 planes x ~ x0 + x1 + x2 (hopper.cuh split3, made by
// flash_wide.cu's split kernel; a tile holds each operand's three) and
// runs each product as six bf16 ones, a0 b0 + a0 b1 + a1 b0 + a0 b2 + a1 b1
// + a2 b0, the small ones first, which keeps every term down to ~2^-16 of
// the product and drops those near 2^-24 and below; p and dS become three
// register planes.  Steps and stages (FwTiles): 16-bit d 256 64-key
// steps (32 in the dq mode), two stages; fp32 a 64-key step at d 64 and 32
// at d 128, whose dq mode runs ONE product warpgroup on 64-query tiles
// (NWG = 1: Q and dO's six planes of 128 queries do not fit beside a
// ring), no turns.
//
// What bounds it on the H100: the tensor-core products and, beside them,
// the hash on the CUDA cores (nine instructions an element, seven of them
// on the integer ALU); the design keeps the two in flight together.
// PERF.md records its times, and tools/flash_bwd_probe.py --fwd its phase
// clocks and what the sort of the masked tiles saves (nosort), and
// --split the dq mode's.
#pragma once

#include <cstring>
#include <type_traits>

#include "flash_qmajor.cuh"

namespace {

constexpr int kFwThreads = 384;      // two product warpgroups, one copying
constexpr int kFwConsumers = 256;
constexpr int kFwMaxStages = 4;
constexpr int kFwOrderCap = 4096;    // (mask, query block) entries sorted
constexpr int kFwHist = 256;         // weight classes of the sort
constexpr int kFwScratch = kFwHist * 4 + kFwOrderCap * 2;   // a warp's
constexpr int kFwTurn = 1;           // named barriers 1, 2: the turns
constexpr int kFwEpi = 3;            // 3, 4: a warpgroup's epilogue

// Operand modes: the bf16 instances (operands zero-padded to D by the
// wrapper, O and dq out by TMA stores, the dq mode's tiles from a
// counter), and the wide family's bf16, fp16 and fp32 (three planes); its
// 16-bit rows that TMA cannot copy (d % 8 != 0, or not 16-byte aligned)
// by threads instead (kOpWideBf16Rows, kOpWideF16Rows).
constexpr int kOpBf16 = 0, kOpWideBf16 = 1, kOpWideF16 = 2, kOpWideF32 = 3,
              kOpWideBf16Rows = 4, kOpWideF16Rows = 5;
template <int OP>
constexpr int kOpPlanes = OP == kOpWideF32 ? 3 : 1;
template <int OP>
constexpr bool kOpRows = OP == kOpWideBf16Rows || OP == kOpWideF16Rows;
// the row-copying modes' copying threads: warps 8, 10 and 11 (warp 9's
// first thread schedules)
constexpr int kFwCopiers = 96;
// keys a step of a wide mode: the most whose accumulators fit the
// registers and whose two stages fit beside Q (and dO)
constexpr int wide_bk(int D, bool DQ, int planes) {
  return planes == 3 ? (D <= 64 ? 64 : 32)
         : DQ ? (D <= 128 ? 64 : 32) : (D <= 128 ? kMaskTile : 64);
}
// The six products of two three-plane operands, smallest terms first:
// product i takes A's plane pair_a(i) and B's plane pair_b(i) (a1b1,
// a0b2, a2b0, a0b1, a1b0, a0b0); one-plane operands take i = 5 alone.
__host__ __device__ constexpr int pair_a(int i) {
  return i == 0 ? 1 : i == 2 ? 2 : i == 4 ? 1 : 0;
}
__host__ __device__ constexpr int pair_b(int i) {
  return i == 0 ? 1 : i == 1 ? 2 : i == 3 ? 1 : 0;
}

// Shared memory, byte offsets from a 1024-aligned base.  O is two
// warpgroup halves of [DP / 64 chunks][64 rows][64], the TMA store's
// boxes (none in a wide mode).  BK: keys a step; BQ: queries a tile (64
// a product warpgroup); a plane of Q, dO, or a K or V stage is kQP or
// kKVP bytes, an operand NPL planes.  F32 (fp32 O or dq, stored from the
// accumulators) has no O buffer either.
template <int D, bool MASK, bool DQ, int OP = kOpBf16, int NWG = 2,
          bool F32 = false>
struct FwTiles {
  static constexpr bool WIDE = OP != kOpBf16;
  static constexpr int NPL = kOpPlanes<OP>;
  static constexpr int BQ = 64 * NWG, NC = 128 * NWG;
  static constexpr int DP = kDP<D>;
  static constexpr int BK =
      WIDE ? wide_bk(D, DQ, NPL) : DQ ? 64 : kMaskTile;
  static constexpr int kQP = BQ * DP * 2;
  static constexpr int kQ = NPL * kQP;
  static constexpr int kKVP = BK * DP * 2;
  static constexpr int kKV = NPL * kKVP;
  static constexpr int kOrder = MASK ? kFwOrderCap * 2 : 0;
  // Q full and empty, K's and V's full and empty a stage, the schedule
  // queue's full and empty a slot
  static constexpr int kBars = 2 + 4 * kFwMaxStages + 4;
  // the tile's words (4), the queue (2 x 4), a word a K stage, the
  // schedule's state (4)
  static constexpr int kInfo = (16 + kFwMaxStages) * 4;
  static constexpr int kAnchor = NC * 8;   // the hash's slots
  static constexpr int oQ = 0, oDO = kQ, oO = (DQ ? 2 : 1) * kQ,
                       oK = oO + (WIDE || F32 ? 0 : kQ);
  static constexpr int kFit = (kSmemMax - 1024 - oK - kOrder - kBars * 8 -
                               kInfo - kAnchor) / (2 * kKV);
  static constexpr int kStages = kFit < kFwMaxStages ? kFit : kFwMaxStages;
  static constexpr int oV = oK + kStages * kKV, oOrder = oV + kStages * kKV,
                       oBar = oOrder + kOrder, oInfo = oBar + kBars * 8,
                       oAnchor = oInfo + kInfo;
  static constexpr size_t bytes = 1024 + oAnchor + kAnchor;
  static_assert(kStages >= 2, "a ring of two stages fits");
  static_assert(bytes <= kSmemMax, "the tiles fit in shared memory");
  static_assert(!MASK || 12 * kFwScratch <= oOrder,
                "the sort's scratch fits below the order table");
  static_assert(kMaskTile % BK == 0, "a step lies inside a pre-pass tile");
};

// The launch's shapes, masks, dropout and schedule.  Tiles come in groups
// of heads: group g covers masks [mg gm, mg gm + gm) (mg = g / nch, at
// most nmask) and, in each, heads [c hc, c hc + hc) (c = g % nch, at most
// hper); without a mask every head is its own "mask" (hc 1).  A wide mode
// (no MASK) holds its own operands in the slots of the pre-pass's: its
// output [nbh, sq, d] (O or dq, of the operands' type; fp32 for three
// planes) in `bits`'s, its head dim in `sorted`'s, mask3 [nbh / mhper,
// sq, sk] bytes (or null) in `cls`'s and mhper in `nkt`'s.  The struct
// stays 128 bytes: with the wide fields appended (152 bytes) #3d read
// 3.5% and #3md 11.7% slower in chip_smoke.py's md A/B, their code
// otherwise unchanged.
struct FwParams {
  int nbh, sq, sk, causal, off, valid_q, valid_k;
  float scale_log2, scale;
  const float* lse_in;      // DQ: the forward's base-2 lse [nbh, sq]
  const float* delta;       // and rowsum(dO * O) [nbh, sq]
  int nqb;
  union {
    int nkt;
    int mhper;
  };
  int hper, nmask, gm, hc, nch;
  union {
    int sorted;
    int d;
  };
  union {
    const unsigned char* cls;
    const unsigned char* mask3;
  };
  union {
    const unsigned* bits;
    void* out;
  };
  const int* seed3;
  unsigned threshold;
  float inv_keep;
  int* next_tile;           // DQ: the tile counter, 0 at the launch
};
static_assert(sizeof(FwParams) == 128, "the kernel's parameters as #3d's");

// The row-copying modes' operands: their addresses ride in the tensor-map
// parameters those modes do not use, as each map's first word.
inline CUtensorMap address_map(const void* ptr) {
  CUtensorMap m{};
  std::memcpy(&m, &ptr, sizeof ptr);
  return m;
}
__device__ __forceinline__ const uint16_t* map_address(const CUtensorMap& m) {
  return *reinterpret_cast<const uint16_t* const*>(&m);
}

// A row-copying mode's tile: rows [r0, r0 + ROWS) of one batch-head's [n,
// d] 16-bit matrix at src into the swizzled tile at dst (DP / 64 chunks of
// [ROWS][64], as TMA writes them; zeros past n rows and d columns), by the
// kFwCopiers copying threads (ci this one's index): element pairs where d
// is even and src 4-byte aligned (then every pair is), single elements
// otherwise; then the fence that shows these generic stores to the async
// proxy wgmma reads through.
template <int ROWS, int DP>
__device__ __forceinline__ void copy_tile(uint32_t dst, const uint16_t* src,
                                          int r0, int n, int d, int ci) {
  auto at = [&](int r, int c) {
    return dst + (c >> 6) * (ROWS * 128) + r * 128 +
           ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
  };
  if (!(d & 1) && !(reinterpret_cast<uintptr_t>(src) & 3)) {
    for (int i = ci; i < ROWS * DP / 2; i += kFwCopiers) {
      const int r = i / (DP / 2), c = (i - r * (DP / 2)) * 2;
      unsigned v = 0u;
      if (r0 + r < n && c < d)
        v = __ldg(reinterpret_cast<const unsigned*>(
            src + (size_t)(r0 + r) * d + c));
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at(r, c)), "r"(v)
                   : "memory");
    }
  } else {
    for (int i = ci; i < ROWS * DP; i += kFwCopiers) {
      const int r = i / DP, c = i - r * DP;
      unsigned short v = 0;
      if (r0 + r < n && c < d) v = __ldg(src + (size_t)(r0 + r) * d + c);
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(at(r, c)), "h"(v)
                   : "memory");
    }
  }
  fence_async_smem();
}

// 32-bit shared memory words by address (no 64-bit generic pointer held)
__device__ __forceinline__ void st_shared(uint32_t a, int v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_shared(uint32_t a) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ int ld_shared_u16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a) : "memory");
  return v;
}

// keys a tile of query block qb (BQ queries) may see: [0, return)
template <int BQ = kQmBQ>
__device__ __forceinline__ int fw_kend(const FwParams& p, int qb) {
  const int kend = min(p.sk, p.valid_k);
  return p.causal ? min(kend, qb * BQ + BQ + p.off) : kend;
}
// key tiles a tile of query block qb may see: [0, return)
template <int BQ = kQmBQ>
__device__ __forceinline__ int fw_tiles_seen(const FwParams& p, int qb) {
  const int kend = fw_kend<BQ>(p, qb);
  return (kend > 0 && qb * BQ < min(p.sq, p.valid_q))
             ? (kend + kMaskTile - 1) / kMaskTile : 0;
}

// group g's masks [ma, mb) and heads [ha, hb) within each
struct FwGroup {
  int ma, mb, ha, hb;
};
template <bool MASK>
__device__ __forceinline__ FwGroup fw_group(const FwParams& p, int g) {
  FwGroup r;
  if constexpr (MASK) {
    const int mg = g / p.nch, c = g - mg * p.nch;
    r.ma = mg * p.gm;
    r.ha = c * p.hc;
    r.hb = min(p.hper, r.ha + p.hc);
  } else {
    r.ma = g * p.gm;
    r.ha = 0;
    r.hb = 1;
  }
  r.mb = min(p.nmask, r.ma + p.gm);
  return r;
}
template <bool MASK>
__device__ __forceinline__ int fw_group_tiles(const FwParams& p, int g) {
  const FwGroup r = fw_group<MASK>(p, g);
  return (r.mb - r.ma) * p.nqb * (r.hb - r.ha);
}

// DQ false: out = O, lse_out the base-2 lse (or null), tdo unused; DQ:
// out = dq [nbh, sq, D] bf16 and tdo dO's map (128-row boxes), lse_out
// unused.  A wide mode (OP) writes p.out instead of `to`; NWG product
// warpgroups (NWG 1: the second warpgroup only gives its registers up).
// F32 (bf16 operands, no mask): O or dq fp32 [nbh, sq, D] in p.out,
// stored from the accumulators as a wide mode stores them (ring
// attention's partials, never rounded to bf16).
template <int D, bool MASK, bool DQ, bool DROP, int OP = kOpBf16,
          int NWG = 2, bool F32 = false>
__global__ void __launch_bounds__(kFwThreads, 1)
flash_fwd_ws_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to,
                    const __grid_constant__ CUtensorMap tdo,
                    float* __restrict__ lse_out, const FwParams p) {
  static_assert(D == 64 || D == 128 || (OP != kOpBf16 && D == 256),
                "the instances' head dims");
  static_assert(DQ || DROP || OP != kOpBf16,
                "the bf16 forward's instances always drop");
  static_assert(!(MASK && OP != kOpBf16), "a wide mode reads mask3 itself");
  static_assert(NWG == 2 || OP != kOpBf16, "the bf16 instances take turns");
  static_assert(!F32 || (OP == kOpBf16 && !MASK),
                "fp32 outputs: the bf16 instances without a mask");
  using T = FwTiles<D, MASK, DQ, OP, NWG, F32>;
  constexpr bool WIDE = T::WIDE,
                 F16 = OP == kOpWideF16 || OP == kOpWideF16Rows;
  constexpr bool ROWS = kOpRows<OP>;
  // arrivals that complete a load's "full" mbarrier, and the schedule
  // queue's "empty" ones: the copying thread (its TMA bytes), or each of
  // the row-copying threads
  constexpr int kLoaders = ROWS ? kFwCopiers : 1;
  constexpr int NPL = T::NPL, BQ = T::BQ, NC = T::NC;
  constexpr int kPairs = NPL == 3 ? 6 : 1;   // products i in [6 - kPairs, 6)
  constexpr int DP = T::DP, S = T::kStages, BK = T::BK;
  constexpr int kKS = D / 16;     // k16 steps of S over d
  constexpr int kPS = BK / 16;    // k16 steps of P V over keys
  constexpr int kSN = BK / 2;     // registers of an m64 x BK accumulator
  constexpr int kON = DP / 2;     // registers of the m64 x DP output
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + T::oQ, sDO = base + T::oDO, sO = base + T::oO,
                 sK = base + T::oK, sV = base + T::oV;
  // mbarriers: Q full and empty, each K stage's full and empty, each V
  // stage's, the schedule queue's
  const uint32_t bQFull = base + T::oBar, bQEmpty = bQFull + 8,
                 bKFull = bQFull + 16, bKEmpty = bKFull + 8 * kFwMaxStages,
                 bVFull = bKEmpty + 8 * kFwMaxStages,
                 bVEmpty = bVFull + 8 * kFwMaxStages,
                 bDesc = bVEmpty + 8 * kFwMaxStages;   // full [2], empty [2]
  // schedule words: the tile's batch-head, query block and live tiles
  // (words 0-2), the queue's two tiles (4-11: batch-head, query block,
  // the offset of its classes, live tiles), each K stage's key tile * 4 +
  // 2 last + partial (12 ..), the scheduling thread's state (4 words
  // after those)
  const uint32_t sInfo = base + T::oInfo, sDesc = sInfo + 16;
  volatile int* tinfo = reinterpret_cast<volatile int*>(smem + T::oInfo);
  volatile int* sinfo = tinfo + 12;
  uint16_t* order = reinterpret_cast<uint16_t*>(smem + T::oOrder);
  const uint32_t sOrder = base + T::oOrder;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bQFull, kLoaders);
    mbar_init(bQEmpty, NC);
    for (int st = 0; st < S; ++st) {
      mbar_init(bKFull + 8 * st, kLoaders);
      mbar_init(bKEmpty + 8 * st, NC);
      mbar_init(bVFull + 8 * st, kLoaders);
      mbar_init(bVEmpty + 8 * st, NC);
    }
    for (int i = 0; i < 4; ++i) mbar_init(bDesc + 8 * i, i < 2 ? 1 : kLoaders);
    mbar_init_fence();
  }
  if constexpr (MASK) {
    if (p.sorted) {
      // each warp sorts whole mask groups: entry e = (nqb - 1 - qb) gmc +
      // (m - ma) of group [ma, ma + gmc) by its live tiles, heaviest first,
      // stably, into order[ma nqb ..]; its histogram and weights in the
      // tiles' space (no copy has started)
      const int w = tid >> 5, lane = tid & 31;
      int* hist = reinterpret_cast<int*>(smem + w * kFwScratch);
      uint16_t* wt = reinterpret_cast<uint16_t*>(hist + kFwHist);
      const int nmg = (p.nmask + p.gm - 1) / p.gm;
      for (int mg = w; mg < nmg; mg += kFwThreads / 32) {
        const int ma = mg * p.gm, gmc = min(p.gm, p.nmask - ma);
        const int n = gmc * p.nqb;
        for (int b = lane; b < kFwHist; b += 32) hist[b] = 0;
        __syncwarp();
        for (int e = lane; e < n; e += 32) {
          const int qb = p.nqb - 1 - e / gmc, m = ma + e % gmc;
          const unsigned char* cl =
              p.cls + ((size_t)m * p.nqb + qb) * p.nkt;
          const int nk = fw_tiles_seen(p, qb);
          int wgt = 0;
          for (int kt = 0; kt < nk; ++kt) wgt += cl[kt] != kTileDead;
          wgt = min(wgt, kFwHist - 1);
          wt[e] = (uint16_t)wgt;
          atomicAdd(hist + wgt, 1);
        }
        __syncwarp();
        // hist[w] becomes the entries heavier than w: lane l holds weights
        // 255 - 8 l .. 248 - 8 l
        int v[8], sum = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          v[k] = hist[kFwHist - 1 - lane * 8 - k];
          sum += v[k];
        }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        int run = incl - sum;
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          hist[kFwHist - 1 - lane * 8 - k] = run;
          run += v[k];
        }
        __syncwarp();
        for (int c0 = 0; c0 < n; c0 += 32) {
          const int e = c0 + lane;
          const unsigned act = __ballot_sync(0xffffffffu, e < n);
          if (e < n) {
            const int wgt = wt[e];
            const unsigned peers = __match_any_sync(act, wgt);
            const int pos = hist[wgt] + __popc(peers & ((1u << lane) - 1u));
            order[ma * p.nqb + pos] = (uint16_t)e;
            __syncwarp(act);
            if (lane == __ffs(peers) - 1) hist[wgt] += __popc(peers);
          }
          __syncwarp();
        }
      }
    }
  }
  fence_async_smem();   // the sort's scratch, before the ring's copies
  __syncthreads();

  // the dq mode's tiles from the counter (the bf16 instances), else the
  // snake
  constexpr bool kCounter = DQ && !WIDE;
  if (tid >= kFwConsumers) {
    reg_dealloc<kQmCopyRegs>();
    if (tid == kFwConsumers + 32) {
      // the schedule: tile n into queue slot n % 2 (batch-head, query
      // block, the offset of its classes, live tiles; batch-head -1 past
      // the last).  Its state
      // lives in shared memory between tiles (this thread has 24
      // registers): the tile's place R in the group order, the group g
      // and its places [gstart, gend).
      const int b = (int)blockIdx.x;
      const uint32_t sState = sInfo + 48 + 4 * kFwMaxStages;
      st_shared(sState, b);
      st_shared(sState + 4, 0);
      st_shared(sState + 8, 0);
      st_shared(sState + 12, fw_group_tiles<MASK>(p, 0));
      for (int n = 0;; ++n) {
        if constexpr (kCounter) {
          // the next tile from the counter once the loader is done with
          // the last one's slot: a block holds the tile it computes and
          // a few steps of the next
          if (n >= 1)
            mbar_wait(bDesc + 16 + 8 * ((n - 1) & 1), ((n - 1) >> 1) & 1);
          st_shared(sState, atomicAdd(p.next_tile, 1));
        }
        int bh = -1, qb = 0, m = 0;
        const int R = ld_shared(sState);
        if (R < p.nbh * p.nqb) {
          int g = ld_shared(sState + 4), gstart = ld_shared(sState + 8);
          for (int gend = ld_shared(sState + 12); R >= gend;) {
            gstart = gend;
            gend += fw_group_tiles<MASK>(p, ++g);
            st_shared(sState + 4, g);
            st_shared(sState + 8, gstart);
            st_shared(sState + 12, gend);
          }
          const FwGroup gr = fw_group<MASK>(p, g);
          int i = R - gstart, hd = 0;
          if constexpr (MASK) {
            const int hcnt = gr.hb - gr.ha, pi = i / hcnt;
            hd = gr.ha + (i - pi * hcnt);
            i = p.sorted ? ld_shared_u16(sOrder + 2 * (gr.ma * p.nqb + pi))
                         : pi;
          }
          const int gmc = gr.mb - gr.ma, eq = i / gmc;
          qb = p.nqb - 1 - eq;
          m = gr.ma + (i - eq * gmc);
          bh = m * p.hper + hd;
        }
        // the snake: tiles b, 2G - 1 - b, 2G + b, ...
        if constexpr (!kCounter)
          st_shared(sState, R + ((n & 1) ? 2 * b + 1
                                         : 2 * ((int)gridDim.x - 1 - b) + 1));
        const int nk = bh < 0 ? 0 : fw_tiles_seen<BQ>(p, qb);
        const int cls0 = MASK ? (m * p.nqb + qb) * p.nkt : 0;  // its classes
        int nlive = nk;
        if constexpr (MASK) {
          nlive = 0;
          for (int kt = 0; kt < nk; ++kt)
            nlive += p.cls[(size_t)cls0 + kt] != kTileDead;
        }
        const uint32_t d = sDesc + 16 * (n & 1);
        if (!kCounter && n >= 2)
          mbar_wait(bDesc + 16 + 8 * (n & 1), ((n >> 1) - 1) & 1);
        st_shared(d, bh);
        st_shared(d + 4, qb);
        st_shared(d + 8, cls0);
        st_shared(d + 12, nlive);
        mbar_arrive(bDesc + 8 * (n & 1));
        if (bh < 0) break;
      }
      return;
    }
    if constexpr (ROWS) {
      if (tid >> 5 == 9) return;    // warp 9 but its scheduling thread
    } else {
      if (tid != kFwConsumers) return;
    }
    // ROWS: this thread's index among the copying threads
    const int ci = ((tid >> 5) == 8 ? 0 : (tid >> 5) - 9) * 32 + (tid & 31);
    // every load.  Step c (the live steps of all tiles in turn) takes K
    // stage and V stage c % S.  A tile's first K goes before its Q (which
    // waits until the last tile's S products are done with Q), each later
    // K beside the V of the step before, the last V after its K (DQ: each
    // step's V right after its K, the tile's Q and dO between the first
    // two).  The tile's words are read from its queue slot where they are
    // used (this thread has 24 registers); the slot is released after the
    // last load.
    int c = 0;                      // live steps so far
    for (int n = 0;; ++n) {
      const uint32_t d = sDesc + 16 * (n & 1);
      mbar_wait(bDesc + 8 * (n & 1), (n >> 1) & 1);
      // the tile's words beside Q, and Q (none for a tile with no live
      // key tile)
      auto begin_tile = [&](bool load) {
        if (n > 0) mbar_wait(bQEmpty, (n - 1) & 1);
        st_shared(sInfo, ld_shared(d));
        st_shared(sInfo + 4, ld_shared(d + 4));
        st_shared(sInfo + 8, ld_shared(d + 12));
        if (!load) {
          mbar_arrive(bQFull);
          return;
        }
        if constexpr (ROWS) {
          const size_t off = (size_t)ld_shared(d) * p.sq * p.d;
          copy_tile<BQ, DP>(sQ, map_address(tq) + off, ld_shared(d + 4) * BQ,
                            p.sq, p.d, ci);
          if constexpr (DQ)
            copy_tile<BQ, DP>(sDO, map_address(tdo) + off,
                              ld_shared(d + 4) * BQ, p.sq, p.d, ci);
          mbar_arrive(bQFull);
          return;
        }
        mbar_expect_tx(bQFull, (DQ ? 2 : 1) * T::kQ);
        // plane pl of batch-head bh is the map's batch-head bh + pl nbh
        for (int pl = 0; pl < NPL; ++pl)
          for (int cc = 0; cc < DP / 64; ++cc) {
            tma_load(sQ + pl * T::kQP + cc * (BQ * 128), &tq, bQFull,
                     cc * 64, ld_shared(d + 4) * BQ, ld_shared(d) + pl * p.nbh);
            if constexpr (DQ)
              tma_load(sDO + pl * T::kQP + cc * (BQ * 128), &tdo, bQFull,
                       cc * 64, ld_shared(d + 4) * BQ,
                       ld_shared(d) + pl * p.nbh);
          }
      };
      // V of step `step` (key block k) once its stage's last reader (P V;
      // DQ: dP) is done with it
      auto load_v = [&](int k, int step) {
        const int st = step % S, use = step / S;
        if (use > 0) mbar_wait(bVEmpty + 8 * st, (use - 1) & 1);
        if constexpr (ROWS) {
          copy_tile<BK, DP>(sV + st * T::kKV,
                            map_address(tv) + (size_t)ld_shared(d) * p.sk * p.d,
                            k * BK, p.sk, p.d, ci);
          mbar_arrive(bVFull + 8 * st);
          return;
        }
        mbar_expect_tx(bVFull + 8 * st, T::kKV);
        for (int pl = 0; pl < NPL; ++pl)
          for (int cc = 0; cc < DP / 64; ++cc)
            tma_load(sV + st * T::kKV + pl * T::kKVP + cc * (BK * 128), &tv,
                     bVFull + 8 * st, cc * 64, k * BK,
                     ld_shared(d) + pl * p.nbh);
      };
      int left = ld_shared(d + 12);  // live key tiles not yet loaded
      int prev = -1;                 // the last key block loaded
      const int nk = left > 0 ? fw_tiles_seen<BQ>(p, ld_shared(d + 4)) : 0;
      for (int kt = 0; kt < nk; ++kt) {
        int part = 0;
        if constexpr (MASK) {
          const unsigned char cl = p.cls[(size_t)ld_shared(d + 8) + kt];
          if (cl == kTileDead) continue;
          part = cl == kTilePartial;
        }
        --left;
        // the tile's steps: its BK-key blocks the tile sees
        for (int h = 0; h < kMaskTile / BK; ++h) {
          const int kb = kt * (kMaskTile / BK) + h;
          bool last = left == 0;
          if constexpr (BK < kMaskTile) {
            // the last live tile's last step: its last, or the one where
            // the keys end inside it
            const int kend = fw_kend<BQ>(p, ld_shared(d + 4));
            if (kb * BK >= kend) break;
            last = last && (h == kMaskTile / BK - 1 || (kb + 1) * BK >= kend);
          }
          // K of step c once its stage's last reader (S; DQ: dQ) is done
          // with it; the step's words beside it
          const int st = c % S, use = c / S;
          if (use > 0) mbar_wait(bKEmpty + 8 * st, (use - 1) & 1);
          st_shared(sInfo + 48 + 4 * st, kb * 4 + (last ? 2 : 0) + part);
          if constexpr (ROWS) {
            copy_tile<BK, DP>(
                sK + st * T::kKV,
                map_address(tk) + (size_t)ld_shared(d) * p.sk * p.d, kb * BK,
                p.sk, p.d, ci);
            mbar_arrive(bKFull + 8 * st);
          } else {
            mbar_expect_tx(bKFull + 8 * st, T::kKV);
            for (int pl = 0; pl < NPL; ++pl)
              for (int cc = 0; cc < DP / 64; ++cc)
                tma_load(sK + st * T::kKV + pl * T::kKVP + cc * (BK * 128),
                         &tk, bKFull + 8 * st, cc * 64, kb * BK,
                         ld_shared(d) + pl * p.nbh);
          }
          if (prev < 0)
            begin_tile(true);
          else if constexpr (!DQ)
            load_v(prev, c - 1);
          if constexpr (DQ) load_v(kb, c);
          ++c;
          prev = kb;
        }
      }
      if (prev >= 0) {
        if constexpr (!DQ) load_v(prev, c - 1);
      } else {
        begin_tile(false);
        if (ld_shared(d) < 0) break;
      }
      mbar_arrive(bDesc + 16 + 8 * (n & 1));   // the slot is free
    }
    return;
  }
  if constexpr (NWG == 1) {
    if (tid >= NC) {               // the idle warpgroup
      reg_dealloc<kQmCopyRegs>();
      return;
    }
  }
  reg_alloc<kQmRegs>();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int r16 = wg * 64 + warp * 16 + grp;   // this thread's row in the tile
  const int kv_end = min(p.sk, p.valid_k), q_end = min(p.sq, p.valid_q);
  const uint32_t sOw = sO + wg * (64 * DP * 2);  // this warpgroup's O half
  const uint32_t sAnchor = base + T::oAnchor + tid * 8;  // the hash's slot
  // A of S: this warpgroup's 64 rows of Q, k-step ks; B: the stage's K
  // tile, K-major over d
  auto a_desc = [&](int ks) {
    return gmma_desc(sQ + (ks >> 2) * (BQ * 128) + wg * (64 * 128) +
                         (ks & 3) * 32, 16, 1024);
  };
  auto b_desc = [&](uint32_t tile, int ks) {
    return gmma_desc(tile + (ks >> 2) * (BK * 128) + (ks & 3) * 32, 16, 1024);
  };
  // B of P V: the stage's V tile read N-major, key step t
  auto n_desc = [&](uint32_t tile, int t) {
    return gmma_desc(tile + t * 16 * 128, BK * 128, 1024);
  };
  // plane pl of Q or dO: its descriptors moved by the plane's bytes (the
  // start address field, in 16-byte units, never carries: shared memory
  // addresses stay under 2^18)
  auto qplane = [](int pl) { return (uint64_t)(pl * T::kQP) >> 4; };
  // S (DQ: and dP) = A B^T into acc: A this warpgroup's rows from `adesc`
  // (Q's or dO's), B the stage tile `tile` (K or V), K-major; the plane
  // pairs' products smallest first
  auto ss_product = [&](auto& acc, auto adesc, uint32_t tile) {
#pragma unroll
    for (int i = 6 - kPairs; i < 6; ++i)
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        wgmma_ss<0, 0, F16>(acc, adesc(ks) + qplane(pair_a(i)),
                            b_desc(tile + pair_b(i) * T::kKVP, ks),
                            i > 6 - kPairs || ks > 0);
  };
  // acc += A B: A the register fragments a[plane][k-step], B the stage
  // tile `tile` (V, or K for dQ) read N-major
  auto rs_product = [&](float (&acc)[DP / 2], unsigned (&a)[NPL][BK / 16][4],
                        uint32_t tile) {
#pragma unroll
    for (int i = 6 - kPairs; i < 6; ++i)
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
        wgmma_rs<F16>(acc, a[pair_a(i)][t],
                      n_desc(tile + pair_b(i) * T::kKVP, t), 1);
  };
  // k-step t's A fragment u from an accumulator's two fp32 values: bf16
  // or fp16 (rounded), or the three bf16 planes of fp32
  auto pack_a = [&](unsigned (&a)[NPL][BK / 16][4], int t, int u, float lo,
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
  // a wide mode's output row r (columns < d) from an accumulator's
  // columns 8 j + 2 tig + e of row half hf, times mul
  using Out = std::conditional_t<OP == kOpWideF32 || F32, float,
                                 std::conditional_t<F16, __half, bf16>>;
  auto store_row = [&](const float (&acc)[DP / 2], int bh, int r, int hf,
                       float mul) {
    if (r >= p.sq) return;
    Out* o = static_cast<Out*>(p.out) + ((size_t)bh * p.sq + r) * p.d;
    const bool pair = !(p.d & 1);   // element pairs 2-element aligned
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + tig * 2;
      const float lo = acc[j * 4 + hf * 2] * mul,
                  hi = acc[j * 4 + hf * 2 + 1] * mul;
      if (c + 1 < p.d && pair) {
        if constexpr (OP == kOpWideF32 || F32) {
          *reinterpret_cast<float2*>(o + c) = make_float2(lo, hi);
        } else if constexpr (F16) {
          *reinterpret_cast<unsigned*>(o + c) = pack_f16(lo, hi);
        } else {
          *reinterpret_cast<unsigned*>(o + c) = pack_bf16(lo, hi);
        }
      } else {
        if (c < p.d) o[c] = static_cast<Out>(lo);
        if (c + 1 < p.d) o[c + 1] = static_cast<Out>(hi);
      }
    }
  };
  // a wide mode's mask3 bits of rows row and row + 8 for the BK keys from
  // k0 (bit 2 j + e for key k0 + 8 j + 2 tig + e, 1 = masked), read in
  // place: two bytes at once where sk is even
  auto raw_bits = [&](const unsigned char* mrow, int row, int k0,
                      unsigned (&mw)[2]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row + hf * 8;
      unsigned w = 0u;
      if (r < p.sq) {
        const unsigned char* mr = mrow + (size_t)r * p.sk;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const int c = k0 + j * 8 + tig * 2;
          if (!(p.sk & 1) && c < p.sk) {
            const unsigned v = __ldg(
                reinterpret_cast<const unsigned short*>(mr + c));
            w |= ((unsigned)((v & 0xffu) != 0u) |
                  (unsigned)((v >> 8) != 0u) << 1) << (j * 2);
          } else {
            if (c < p.sk && __ldg(mr + c)) w |= 1u << (j * 2);
            if (c + 1 < p.sk && __ldg(mr + c + 1)) w |= 2u << (j * 2);
          }
        }
      }
      mw[hf] = w;
    }
  };
  if constexpr (DQ) {
    // the dq mode: A of dP, this warpgroup's 64 rows of dO
    auto o_desc = [&](int ks) {
      return gmma_desc(sDO + (ks >> 2) * (BQ * 128) + wg * (64 * 128) +
                           (ks & 3) * 32, 16, 1024);
    };
    uint32_t seed = 0u, roff = 0u, hcol0 = 0u, thr8 = 0u, kall = 0u;
    if constexpr (DROP) {
      seed = (uint32_t)__ldg(p.seed3);
      roff = (uint32_t)__ldg(p.seed3 + 1);
      hcol0 = (uint32_t)__ldg(p.seed3 + 2);
      thr8 = p.threshold << 8;
      // a threshold of 2^24 (rate within 2^-25 of 1) keeps nothing
      kall = p.threshold >= (1u << 24) ? 0u : 0xffffffffu;
    }
    if constexpr (NWG == 2)
      if (wg == 1) bar_arrive(kFwTurn, NC);
    int c = 0;                      // live steps so far: the ring's place
    for (int n = 0;; ++n) {
      mbar_wait(bQFull, n & 1);
      const int bh = tinfo[0], qb = tinfo[1], nlive = tinfo[2];
      if (bh < 0) break;
      const int q0 = qb * BQ, wq0 = q0 + wg * 64 + warp * 16;
      const int row = q0 + r16;     // and row + 8
      // is key block k0 inside every mask for this warp's 16 rows
      auto full_step = [&](int k0) {
        return k0 + BK <= kv_end && wq0 + 16 <= q_end &&
               (!p.causal || k0 + BK - 1 <= wq0 + p.off);
      };
      auto visible = [&](int r, int cc) {
        return cc < kv_end && r < q_end && (!p.causal || cc <= r + p.off);
      };
      // MASK: this thread's pre-pass bits of rows row and row + 8
      const unsigned* tbits =
          MASK ? p.bits + ((size_t)(bh / p.hper) * p.nqb + qb) * p.nkt *
                              kMaskWords + r16 * 4 + tig
               : nullptr;
      // a wide mode's mask3 rows of this batch-head
      const unsigned char* mrow =
          WIDE && p.mask3 != nullptr
              ? p.mask3 + (size_t)(bh / p.mhper) * p.sq * p.sk : nullptr;
      // rows row and row + 8: the keep hash's part (folded), lse (a
      // fully masked row's, and a row past sq's, as +inf: its p is 0
      // with no test an element), delta
      uint32_t hrow[2] = {0u, 0u};
      float lrow[2], drow[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row + hf * 8;
        if constexpr (DROP)
          hrow[hf] = fold16(drop_row(seed, (uint32_t)bh, roff + (uint32_t)r));
        lrow[hf] = r < p.sq ? __ldg(p.lse_in + (size_t)bh * p.sq + r)
                            : kNegInf;
        if (!(lrow[hf] > kMaskedRowThresh))
          lrow[hf] = __int_as_float(0x7f800000);
        drow[hf] = r < p.sq ? __ldg(p.delta + (size_t)bh * p.sq + r) : 0.f;
      }
      float acc[kON];               // dQ
#pragma unroll
      for (int i = 0; i < kON; ++i) acc[i] = 0.f;
      if (nlive > 0) {
        unsigned pa[NPL][kPS][4];   // dS_{t-1} as dQ's A (0 at first)
#pragma unroll
        for (int pl = 0; pl < NPL; ++pl)
#pragma unroll
          for (int u = 0; u < kPS; ++u)
            pa[pl][u][0] = pa[pl][u][1] = pa[pl][u][2] = pa[pl][u][3] = 0u;
        for (int i = 0;; ++i, ++c) {
          const int st = c % S;
          mbar_wait(bKFull + 8 * st, (c / S) & 1);
          mbar_wait(bVFull + 8 * st, (c / S) & 1);
          const int inf = sinfo[st];
          const int k0 = (inf >> 2) * BK;
          const bool last = inf & 2;
          // every element live by the causal and validity masks; fast:
          // and by the mask
          const bool cvfull = full_step(k0);
          bool fast = cvfull;
          unsigned mw[2] = {0u, 0u};  // MASK: rows row, row + 8's bits
          if constexpr (MASK) {
            if (inf & 1) {
              // the step's half of its pre-pass tile's words
              fast = false;
              const size_t w = (size_t)(k0 / kMaskTile) * kMaskWords;
              const int sh = (k0 % kMaskTile) / 4;
              mw[0] = __ldg(tbits + w) >> sh;
              mw[1] = __ldg(tbits + w + 32) >> sh;
            }
          }
          if constexpr (WIDE) {
            if (mrow != nullptr) {
              fast = false;
              raw_bits(mrow, row, k0, mw);
            }
          }
          float s[kSN], dp[kSN];      // overwritten by their first k-step
          undef(s);
          undef(dp);
          keep(acc);
          keep(pa);
          // DROP: the keep bits of this thread's 32 elements, bit 2 j + e
          // of word hf for row row + 8 hf, key k0 + 8 j + 2 tig + e,
          // through this thread's slot as the forward's
          uint32_t kb[2] = {0u, 0u};
          auto keep_bits = [&]() {
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const uint32_t cf = fold16(
                    drop_col(hcol0 + (uint32_t)(k0 + j * 8 + tig * 2 + e)));
#pragma unroll
                for (int hf = 0; hf < 2; ++hf)
                  kb[hf] |= (uint32_t)(drop_mix(hrow[hf] ^ cf) >= thr8)
                            << (j * 2 + e);
              }
            kb[0] &= kall;
            kb[1] &= kall;
            asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(sAnchor),
                         "r"(kb[0]), "r"(kb[1])
                         : "memory");
          };
          // this warpgroup's turn: S_t, dP_t and dQ += dS_{t-1} K_{t-1}
          // (at the tile's first step dS is 0, against K_t), the turn
          // handed over, the hash while they run
          const uint32_t pK = sK + ((i > 0 ? c - 1 : c) % S) * T::kKV;
          if constexpr (NWG == 2) bar_sync(kFwTurn + wg, NC);
          wgmma_fence();
          ss_product(s, a_desc, sK + st * T::kKV);
          wgmma_commit();
          ss_product(dp, o_desc, sV + st * T::kKV);
          wgmma_commit();
          rs_product(acc, pa, pK);
          wgmma_commit();
          if constexpr (NWG == 2) bar_arrive(kFwTurn + 1 - wg, NC);
          if constexpr (DROP) keep_bits();
          wgmma_wait<2>();            // S is done
          if constexpr (DROP)
            asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                         : "=r"(kb[0]), "=r"(kb[1])
                         : "r"(sAnchor)
                         : "memory");
          keep(s);

          // P = exp2(S * scale_log2 - lse) with the masks: a step inside
          // every mask for this warp's rows skips them, a step the causal
          // and validity masks leave whole tests the mask's bits alone
          if (fast) {
#pragma unroll
            for (int x = 0; x < kSN; ++x)
              s[x] = exp2_ftz(fmaf(s[x], p.scale_log2, -lrow[(x >> 1) & 1]));
          } else {
            unsigned dead[2] = {mw[0], mw[1]};
            if (!cvfull) {
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                  for (int e = 0; e < 2; ++e)
                    dead[hf] |= (unsigned)!visible(
                                    row + hf * 8, k0 + j * 8 + tig * 2 + e)
                                << (j * 2 + e);
            }
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
#pragma unroll
              for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int x = j * 4 + hf * 2 + e;
                  s[x] = (dead[hf] >> (j * 2 + e)) & 1u
                             ? 0.f
                             : exp2_ftz(fmaf(s[x], p.scale_log2, -lrow[hf]));
                }
          }
          wgmma_wait<1>();            // dP is done: V's stage is free
          keep(dp);
          mbar_arrive(bVEmpty + 8 * st);
          if (last) mbar_arrive(bQEmpty);   // the tile's S and dP are done
          wgmma_wait<0>();            // dQ_{t-1} is done: dQ and dS free
          keep(acc);
          keep(pa);
          if (i > 0) mbar_arrive(bKEmpty + 8 * ((c - 1) % S));
          // dS = P (dP - delta), the dP of a dropped element 0 and of a
          // kept one dP / (1 - rate), rounded to the operand type as dQ's
          // A (fp32: its three planes)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = j * 4 + hf * 2 + e;
                float g = dp[x];
                if constexpr (DROP)
                  g = (kb[hf] >> (j * 2 + e)) & 1u ? g * p.inv_keep : 0.f;
                dp[x] = s[x] * (g - drow[hf]);
              }
#pragma unroll
          for (int t = 0; t < kPS; ++t)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              pack_a(pa, t, u, dp[8 * t + 2 * u], dp[8 * t + 2 * u + 1]);
          if (last) break;
        }
        // the last step's dQ += dS K, in turn
        keep(acc);
        keep(pa);
        if constexpr (NWG == 2) bar_sync(kFwTurn + wg, NC);
        wgmma_fence();
        rs_product(acc, pa, sK + (c % S) * T::kKV);
        wgmma_commit();
        if constexpr (NWG == 2) bar_arrive(kFwTurn + 1 - wg, NC);
        wgmma_wait<0>();
        keep(acc);
        mbar_arrive(bKEmpty + 8 * (c % S));
        ++c;
      } else {
        mbar_arrive(bQEmpty);       // nothing read Q and dO
      }

      if constexpr (WIDE || F32) {
        // dq = scale dQ straight from the accumulator
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_row(acc, bh, row + hf * 8, hf, p.scale);
        continue;
      }
      // dq = scale dQ through this warpgroup's half of sO and a TMA store
      if ((tid & 127) == 0) bulk_wait_read();   // the last tile's dq is out
      bar_sync(kFwEpi + wg, 128);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int rr = warp * 16 + grp + hf * 8;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                           sOw + (j >> 3) * (64 * 128) + rr * 128 +
                           (((j & 7) ^ (rr & 7)) << 4) + tig * 4),
                       "r"(pack_bf16(p.scale * acc[j * 4 + hf * 2],
                                     p.scale * acc[j * 4 + hf * 2 + 1])));
        }
      fence_async_smem();     // dq, visible to the TMA store
      bar_sync(kFwEpi + wg, 128);
      if ((tid & 127) == 0 && q0 + wg * 64 < p.sq) {
#pragma unroll
        for (int cc = 0; cc < DP / 64; ++cc)
          tma_store(&to, sOw + cc * (64 * 128), cc * 64, q0 + wg * 64, bh);
        bulk_commit();
      }
    }
    // the first warpgroup's last turn was handed to it and never taken
    if constexpr (NWG == 2)
      if (wg == 0) bar_sync(kFwTurn, NC);
    if ((tid & 127) == 0) bulk_wait();
    return;
  }
  // p is exponentiated as p / (1 - rate) (log2 of the scale added to the
  // exponent's offset: no multiply an element), so the row sums l' = l /
  // (1 - rate) and P V's bf16 p's are those of the plain version; O's
  // division and lse take the scale back out.  Without dropout (a wide
  // mode's DROP false) every element is kept and the scale is 1.
  uint32_t seed = 0u, roff = 0u, hcol0 = 0u, thr8 = 0u, kall = 0u;
  float out_scale = 1.f, lc = 0.f;
  if constexpr (DROP) {
    seed = (uint32_t)__ldg(p.seed3);
    roff = (uint32_t)__ldg(p.seed3 + 1);
    hcol0 = (uint32_t)__ldg(p.seed3 + 2);
    thr8 = p.threshold << 8;
    // a threshold of 2^24 (rate within 2^-25 of 1) keeps nothing
    kall = p.threshold >= (1u << 24) ? 0u : 0xffffffffu;
    out_scale = p.inv_keep;
    lc = log2f(p.inv_keep);
  }
  // the first warpgroup takes the first turn
  if constexpr (NWG == 2)
    if (wg == 1) bar_arrive(kFwTurn, NC);

  int c = 0;                        // live steps so far: the ring's place
  for (int n = 0;; ++n) {
    mbar_wait(bQFull, n & 1);
    const int bh = tinfo[0], qb = tinfo[1], nlive = tinfo[2];
    if (bh < 0) break;
    const int q0 = qb * BQ, wq0 = q0 + wg * 64 + warp * 16;
    const int row = q0 + r16;       // and row + 8
    // is key tile k0 inside every mask for this warp's 16 rows
    auto full_tile = [&](int k0) {
      return k0 + BK <= kv_end && wq0 + 16 <= q_end &&
             (!p.causal || k0 + BK - 1 <= wq0 + p.off);
    };
    auto live = [&](int r, int cc) {
      return cc < kv_end && r < q_end && (!p.causal || cc <= r + p.off);
    };
    // MASK: this thread's pre-pass bits of rows row and row + 8
    const unsigned* tbits =
        MASK ? p.bits + ((size_t)(bh / p.hper) * p.nqb + qb) * p.nkt *
                            kMaskWords + r16 * 4 + tig
             : nullptr;
    // a wide mode's mask3 rows of this batch-head
    const unsigned char* mrow =
        WIDE && p.mask3 != nullptr
            ? p.mask3 + (size_t)(bh / p.mhper) * p.sq * p.sk : nullptr;
    // rows row and row + 8's part of the keep hash, folded
    uint32_t hrow[2] = {0u, 0u};
    if constexpr (DROP) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        hrow[hf] = fold16(drop_row(seed, (uint32_t)bh,
                                   roff + (uint32_t)(row + hf * 8)));
    }
    float acc[kON];
#pragma unroll
    for (int i = 0; i < kON; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // rows row, row + 8 (base 2, scaled)
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    if (nlive > 0) {
      unsigned pa[NPL][kPS][4];       // P as the next product's A
#pragma unroll
      for (int pl = 0; pl < NPL; ++pl)
#pragma unroll
        for (int u = 0; u < kPS; ++u)
          pa[pl][u][0] = pa[pl][u][1] = pa[pl][u][2] = pa[pl][u][3] = 0u;
      for (int i = 0;; ++i, ++c) {
        const int st = c % S;
        mbar_wait(bKFull + 8 * st, (c / S) & 1);
        if (i > 0) mbar_wait(bVFull + 8 * ((c - 1) % S), ((c - 1) / S) & 1);
        const int inf = sinfo[st];
        const int k0 = (inf >> 2) * BK;
        const bool last = inf & 2;
        bool fast = full_tile(k0);
        unsigned mw[2] = {0u, 0u};    // MASK: rows row, row + 8's bits
        if constexpr (MASK) {
          if (inf & 1) {
            fast = false;
            const size_t w = (size_t)(inf >> 2) * kMaskWords;
            mw[0] = __ldg(tbits + w);
            mw[1] = __ldg(tbits + w + 32);
          }
        }
        if constexpr (WIDE) {
          if (mrow != nullptr) {
            fast = false;
            raw_bits(mrow, row, k0, mw);
          }
        }
        float s[kSN];                 // overwritten by the first k-step
        undef(s);
        keep(acc);
        keep(pa);
        // while S runs: the keep bits of this thread's 64 elements, bit
        // 2 j + e of word hf for row row + 8 hf, key k0 + 8 j + 2 tig + e
        // (without dropout every bit set)
        uint32_t kb[2] = {0u, 0u};
        if constexpr (!DROP) kb[0] = kb[1] = 0xffffffffu;
        // the words through this thread's slot: stored before the S wait,
        // loaded after it
        auto kb_load = [&]() {
          asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                       : "=r"(kb[0]), "=r"(kb[1])
                       : "r"(sAnchor)
                       : "memory");
        };
        auto hash = [&]() {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t cf = fold16(
                  drop_col(hcol0 + (uint32_t)(k0 + j * 8 + tig * 2 + e)));
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
                kb[hf] |= (uint32_t)(drop_mix(hrow[hf] ^ cf) >= thr8)
                          << (j * 2 + e);
            }
          kb[0] &= kall;
          kb[1] &= kall;
          asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(sAnchor),
                       "r"(kb[0]), "r"(kb[1])
                       : "memory");
        };
        // this warpgroup's turn: S_t, and P_{t-1} V_{t-1}, then the turn
        // handed over and the hash while they run
        if constexpr (NWG == 2) bar_sync(kFwTurn + wg, NC);
        wgmma_fence();
        ss_product(s, a_desc, sK + st * T::kKV);
        wgmma_commit();
        if (i > 0) {
          rs_product(acc, pa, sV + ((c - 1) % S) * T::kKV);
          wgmma_commit();
          if constexpr (NWG == 2) bar_arrive(kFwTurn + 1 - wg, NC);
          if constexpr (DROP) hash();
          wgmma_wait<1>();            // S is done; P V may still run
        } else {
          if constexpr (NWG == 2) bar_arrive(kFwTurn + 1 - wg, NC);
          if constexpr (DROP) hash();
          wgmma_wait<0>();
        }
        if constexpr (DROP) kb_load();
        keep(s);
        mbar_arrive(bKEmpty + 8 * st);    // S is done with K
        if (last) mbar_arrive(bQEmpty);   // this tile's S products are done

        // the online softmax in base 2 on the accumulator layout (a row
        // spans the 4 threads of a quad); a tile inside every mask for
        // this warp's rows skips the per-element masks
        float alpha[2];
        if (fast) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            // the max of the raw scores (scale_log2 > 0), in 4 chains
            float mx[4] = {s[hf * 2], s[hf * 2 + 1], s[4 + hf * 2],
                           s[4 + hf * 2 + 1]};
#pragma unroll
            for (int j = 2; j < BK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                mx[(j & 1) * 2 + e] = fmaxf(mx[(j & 1) * 2 + e],
                                            s[j * 4 + hf * 2 + e]);
            float r = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
            r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
            r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
            const float m_new = fmaxf(m[hf], r * p.scale_log2);
            alpha[hf] = exp2_ftz(m[hf] - m_new);
            float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = j * 4 + hf * 2 + e;
                s[x] = exp2_ftz(fmaf(s[x], p.scale_log2, lc - m_new));
                rs[(j & 1) * 2 + e] += s[x];
              }
            l[hf] = l[hf] * alpha[hf] + ((rs[0] + rs[1]) + (rs[2] + rs[3]));
            m[hf] = m_new;
          }
        } else {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = j * 4 + hf * 2 + e;
                s[x] = live(row + hf * 8, k0 + j * 8 + tig * 2 + e) &&
                               !((mw[hf] >> (j * 2 + e)) & 1u)
                           ? s[x] * p.scale_log2 : kNegInf;
                mx = fmaxf(mx, s[x]);
              }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[hf], mx);
            alpha[hf] = exp2_ftz(m[hf] - m_new);
            const bool dead = m_new <= kMaskedRowThresh;  // fully masked so far
            const float mo = m_new - lc;
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = j * 4 + hf * 2 + e;
                s[x] = dead ? 0.f : exp2_ftz(s[x] - mo);
                rs += s[x];
              }
            l[hf] = l[hf] * alpha[hf] + rs;
            m[hf] = m_new;
          }
        }

        wgmma_wait<0>();              // P_{t-1} V_{t-1} is done: O, P free
        keep(acc);
        keep(pa);
        if (i > 0) mbar_arrive(bVEmpty + 8 * ((c - 1) % S));
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            acc[j * 4 + hf * 2] *= alpha[hf];
            acc[j * 4 + hf * 2 + 1] *= alpha[hf];
          }
        // P_t as A fragments: columns 16 t .. 16 t + 15 of the
        // accumulator are k-step t's A (a dropped element is 0)
#pragma unroll
        for (int t = 0; t < kPS; ++t)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int x = 8 * t + 2 * u;
            const uint32_t kw = kb[u & 1] >> (2 * (2 * t + (u >> 1)));
            pack_a(pa, t, u, (kw & 1u) ? s[x] : 0.f,
                   (kw & 2u) ? s[x + 1] : 0.f);
          }
        if (last) break;
      }
      // the last tile's P V, in turn
      mbar_wait(bVFull + 8 * (c % S), (c / S) & 1);
      keep(acc);
      keep(pa);
      if constexpr (NWG == 2) bar_sync(kFwTurn + wg, NC);
      wgmma_fence();
      rs_product(acc, pa, sV + (c % S) * T::kKV);
      wgmma_commit();
      if constexpr (NWG == 2) bar_arrive(kFwTurn + 1 - wg, NC);
      wgmma_wait<0>();
      keep(acc);
      mbar_arrive(bVEmpty + 8 * (c % S));
      ++c;
    } else {
      mbar_arrive(bQEmpty);           // nothing read Q
    }

    // out = O / l = O (1 / (1 - rate)) / l' (0 for fully masked rows),
    // lse = m + log2(l): lse stored directly, O through this warpgroup's
    // half of sO and a TMA store (a wide mode: straight from the
    // accumulator)
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[hf];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      lt = lt == 0.f ? 1.f : lt;
      inv[hf] = out_scale / lt;
      const int r = row + hf * 8;
      if (lse_out != nullptr && tig == 0 && r < p.sq)
        lse_out[(size_t)bh * p.sq + r] = m[hf] + (log2f(lt) - lc);
    }
    if constexpr (WIDE || F32) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store_row(acc, bh, row + hf * 8, hf, inv[hf]);
      continue;
    }
    if ((tid & 127) == 0) bulk_wait_read();   // the last tile's O is out
    bar_sync(kFwEpi + wg, 128);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rr = warp * 16 + grp + hf * 8;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                         sOw + (j >> 3) * (64 * 128) + rr * 128 +
                         (((j & 7) ^ (rr & 7)) << 4) + tig * 4),
                     "r"(pack_bf16(acc[j * 4 + hf * 2] * inv[hf],
                                   acc[j * 4 + hf * 2 + 1] * inv[hf])));
      }
    fence_async_smem();     // O, visible to the TMA store
    bar_sync(kFwEpi + wg, 128);
    if ((tid & 127) == 0 && q0 + wg * 64 < p.sq) {
#pragma unroll
      for (int cc = 0; cc < DP / 64; ++cc)
        tma_store(&to, sOw + cc * (64 * 128), cc * 64, q0 + wg * 64, bh);
      bulk_commit();
    }
  }
  // the first warpgroup's last turn was handed to it and never taken
  if constexpr (NWG == 2)
    if (wg == 0) bar_sync(kFwTurn, NC);
  if ((tid & 127) == 0) bulk_wait();
}

// flash_fwd_ws_kernel<D, MASK, DQ, DROP> over bh batch-heads (the
// pre-pass has run for MASK): the tensor maps, the groups and the grid.
// The forward: out = O, lse its lse (or null); DQ: out = dq, with dout,
// lse_in, delta and next_tile (one int of scratch, zeroed here).  F32:
// out is fp32 (no mask).
template <int D, bool MASK, bool DQ, bool DROP, bool F32 = false>
int launch_qm_ws(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse_in, const void* delta,
                 void* out, void* lse, int bh, int sq, int sk, int causal,
                 int off, int valid_q, int valid_k, float scale_log2,
                 float scale, cudaStream_t stream, const void* cls,
                 const void* bits, int mask_hper, const void* seed3,
                 unsigned threshold, float inv_keep,
                 void* next_tile = nullptr) {
  static_assert(!(F32 && MASK), "fp32 outputs: the instances without a mask");
  using T = FwTiles<D, MASK, DQ, kOpBf16, 2, F32>;
  if (MASK && (cls == nullptr || bits == nullptr || mask_hper < 1 ||
               bh % mask_hper))
    return (int)cudaErrorInvalidValue;
  if (DROP && seed3 == nullptr) return (int)cudaErrorInvalidValue;
  if (DQ && (dout == nullptr || lse_in == nullptr || delta == nullptr ||
             next_tile == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to, tdo;
  int e = bf16_tile_map(&tq, q, bh, sq, D, kQmBQ);
  // no keys: no tile loads k or v, whose maps then describe q
  if (!e) e = sk > 0 ? bf16_tile_map(&tk, k, bh, sk, D, T::BK)
                     : bf16_tile_map(&tk, q, bh, sq, D, T::BK);
  if (!e) e = sk > 0 ? bf16_tile_map(&tv, v, bh, sk, D, T::BK)
                     : bf16_tile_map(&tv, q, bh, sq, D, T::BK);
  // F32: O leaves from the accumulators (`to` unused, then q's)
  if (!e) e = bf16_tile_map(&to, F32 ? q : out, bh, sq, D, 64);
  if (!e) e = bf16_tile_map(&tdo, DQ ? dout : q, bh, sq, D, kQmBQ);
  if (e) return e;
  FwParams p;
  p.nbh = bh;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.off = off;
  p.valid_q = valid_q;
  p.valid_k = valid_k;
  p.scale_log2 = scale_log2;
  p.scale = scale;
  p.lse_in = static_cast<const float*>(lse_in);
  p.delta = static_cast<const float*>(delta);
  p.nqb = (sq + kQmBQ - 1) / kQmBQ;
  p.nkt = (sk + kMaskTile - 1) / kMaskTile;
  p.cls = static_cast<const unsigned char*>(cls);
  p.bits = static_cast<const unsigned*>(bits);
  p.seed3 = static_cast<const int*>(seed3);
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  p.next_tile = static_cast<int*>(next_tile);
  // heads in groups of near-equal size whose k and v fit half the L2
  const long long kv_bytes = 4LL * (sk > 0 ? sk : 1) * D * bh;
  const long long ng = (kv_bytes + kL2Half - 1) / kL2Half;
  const int group = (int)((bh + ng - 1) / ng);
  if (MASK) {
    // whole masks a group, as many as the group's heads and the order
    // table allow; a mask of more heads than that is cut into chunks
    p.hper = mask_hper;
    p.nmask = bh / mask_hper;
    p.sorted = (long long)p.nmask * p.nqb <= kFwOrderCap;
    if (group >= mask_hper) {
      p.gm = group / mask_hper;
      p.hc = mask_hper;
      p.nch = 1;
    } else {
      p.gm = 1;
      p.nch = (mask_hper + group - 1) / group;
      p.hc = (mask_hper + p.nch - 1) / p.nch;
    }
  } else {
    p.hper = 1;
    p.nmask = bh;
    p.sorted = 0;
    p.gm = group;
    p.hc = 1;
    p.nch = 1;
  }
  if (F32) {                // the wide modes' output slots (no mask)
    p.out = out;
    p.d = D;
  }
  const long long tiles = (long long)bh * p.nqb;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = T::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_ws_kernel<D, MASK, DQ, DROP, kOpBf16, 2, F32>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // one block an SM of the current device
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (DQ) {
    err = cudaMemsetAsync(next_tile, 0, sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (int)(tiles < sms ? tiles : sms);
  flash_fwd_ws_kernel<D, MASK, DQ, DROP, kOpBf16, 2, F32>
      <<<grid, kFwThreads, bytes, stream>>>(tq, tk, tv, to, tdo,
                                            static_cast<float*>(lse), p);
  return (int)cudaGetLastError();
}

}  // namespace
