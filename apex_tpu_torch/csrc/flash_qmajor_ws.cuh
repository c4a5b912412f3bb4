// The flash-attention forward's dropout instances for Hopper (sm_90a),
// warp-specialized on a persistent grid: flash_fwd_ws_kernel<D, MASK>,
// launched by flash_attention_md.cu for #3d and #3md (MASK).  It always
// drops: the forwards without dropout (#3, #3m) stay on
// flash_qmajor_kernel.
//
// Replaces: apex_tpu/ops/attention.py :: _fwd_kernel (launched by _fwd
// through pl.pallas_call) with its dropout operand, with and without its
// mask3 operand.  Same function, tiles and products as the query-major
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
//   2G + b, ... (G blocks, a snake: heavy and light tiles alternate).
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
// Shared memory: Q [128][D] and O [128][D] (the O store overlaps the next
// tile), the K and V rings of 128-key stages, the MASK order table, the
// mbarriers, the schedule words and the hash's slots.  d 128: 2 stages a
// ring (a third does not fit beside separate Q and O buffers: 32 + 32 +
// 3 x 64 KB > 227 KB); d 64: 4.
//
// Masks and numbers as flash_qmajor_kernel's forward: base-2 scores, the
// causal offset and the validity window, the pre-pass's tile classes and
// bits for mask3 (batch-head bh reads mask bh / mask_hper); a fully
// masked row, and a tile with no live key tile, emit O 0 and lse -1e30.
// The keep mask is _keep_mask's bit for bit (hopper.cuh), from the seed
// operand [seed, row_off, col_off] read on the device.
//
// What bounds it on the H100: the tensor-core products and, beside them,
// the hash on the CUDA cores (nine instructions an element, seven of them
// on the integer ALU); the design keeps the two in flight together.
// PERF.md records its times, and tools/flash_bwd_probe.py --fwd its phase
// clocks and what the sort of the masked tiles saves (nosort).
#pragma once

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

// Shared memory, byte offsets from a 1024-aligned base.  O is two
// warpgroup halves of [DP / 64 chunks][64 rows][64], the TMA store's
// boxes.
template <int D, bool MASK>
struct FwTiles {
  static constexpr int DP = kDP<D>;
  static constexpr int kQ = kQmBQ * DP * 2;
  static constexpr int kKV = kMaskTile * DP * 2;
  static constexpr int kOrder = MASK ? kFwOrderCap * 2 : 0;
  // Q full and empty, K's and V's full and empty a stage, the schedule
  // queue's full and empty a slot
  static constexpr int kBars = 2 + 4 * kFwMaxStages + 4;
  // the tile's words (4), the queue (2 x 4), a word a K stage, the
  // schedule's state (4)
  static constexpr int kInfo = (16 + kFwMaxStages) * 4;
  static constexpr int kAnchor = kFwConsumers * 8;   // the hash's slots
  static constexpr int oQ = 0, oO = kQ, oK = 2 * kQ;
  static constexpr int kFit = (kSmemMax - 1024 - oK - kOrder - kBars * 8 -
                               kInfo - kAnchor) / (2 * kKV);
  static constexpr int kStages = kFit < kFwMaxStages ? kFit : kFwMaxStages;
  static constexpr int oV = oK + kStages * kKV, oOrder = oV + kStages * kKV,
                       oBar = oOrder + kOrder, oInfo = oBar + kBars * 8,
                       oAnchor = oInfo + kInfo;
  static constexpr size_t bytes = 1024 + oAnchor + kAnchor;
  static_assert(kStages >= 2, "a ring of two stages fits");
  static_assert(bytes <= kSmemMax, "the tiles fit in shared memory");
  static_assert(!MASK || 12 * kFwScratch <= 2 * kStages * kKV,
                "the sort's scratch fits in the ring");
};

// The launch's shapes, masks, dropout and schedule.  Tiles come in groups
// of heads: group g covers masks [mg gm, mg gm + gm) (mg = g / nch, at
// most nmask) and, in each, heads [c hc, c hc + hc) (c = g % nch, at most
// hper); without a mask every head is its own "mask" (hper 1, hc 1).
struct FwParams {
  int nbh, sq, sk, causal, off, valid_q, valid_k;
  float scale_log2;
  int nqb, nkt, hper, nmask, gm, hc, nch, sorted;
  const unsigned char* cls;
  const unsigned* bits;
  const int* seed3;
  unsigned threshold;
  float inv_keep;
};

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

// key tiles a tile of query block qb may see: [0, return)
__device__ __forceinline__ int fw_tiles_seen(const FwParams& p, int qb) {
  const int q0 = qb * kQmBQ;
  int kend = min(p.sk, p.valid_k);
  if (p.causal) kend = min(kend, q0 + kQmBQ + p.off);
  return (kend > 0 && q0 < min(p.sq, p.valid_q))
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

template <int D, bool MASK>
__global__ void __launch_bounds__(kFwThreads, 1)
flash_fwd_ws_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to,
                    float* __restrict__ lse_out, const FwParams p) {
  static_assert(D == 64 || D == 128, "the dropout instances' head dims");
  using T = FwTiles<D, MASK>;
  constexpr int DP = T::DP, S = T::kStages, BK = kMaskTile;
  constexpr int kKS = D / 16;     // k16 steps of S over d
  constexpr int kPS = BK / 16;    // k16 steps of P V over keys
  constexpr int kSN = BK / 2;     // registers of an m64 x BK accumulator
  constexpr int kON = DP / 2;     // registers of the m64 x DP output
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + T::oQ, sO = base + T::oO, sK = base + T::oK,
                 sV = base + T::oV;
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
    mbar_init(bQFull, 1);
    mbar_init(bQEmpty, kFwConsumers);
    for (int st = 0; st < S; ++st) {
      mbar_init(bKFull + 8 * st, 1);
      mbar_init(bKEmpty + 8 * st, kFwConsumers);
      mbar_init(bVFull + 8 * st, 1);
      mbar_init(bVEmpty + 8 * st, kFwConsumers);
    }
    for (int i = 0; i < 4; ++i) mbar_init(bDesc + 8 * i, 1);
    mbar_init_fence();
  }
  if constexpr (MASK) {
    if (p.sorted) {
      // each warp sorts whole mask groups: entry e = (nqb - 1 - qb) gmc +
      // (m - ma) of group [ma, ma + gmc) by its live tiles, heaviest first,
      // stably, into order[ma nqb ..]; its histogram and weights in the
      // ring (no copy has started)
      const int w = tid >> 5, lane = tid & 31;
      int* hist = reinterpret_cast<int*>(smem + T::oK + w * kFwScratch);
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
        st_shared(sState, R + ((n & 1) ? 2 * b + 1
                                       : 2 * ((int)gridDim.x - 1 - b) + 1));
        const int nk = bh < 0 ? 0 : fw_tiles_seen(p, qb);
        const int cls0 = MASK ? (m * p.nqb + qb) * p.nkt : 0;  // its classes
        int nlive = nk;
        if constexpr (MASK) {
          nlive = 0;
          for (int kt = 0; kt < nk; ++kt)
            nlive += p.cls[(size_t)cls0 + kt] != kTileDead;
        }
        const uint32_t d = sDesc + 16 * (n & 1);
        if (n >= 2) mbar_wait(bDesc + 16 + 8 * (n & 1), ((n >> 1) - 1) & 1);
        st_shared(d, bh);
        st_shared(d + 4, qb);
        st_shared(d + 8, cls0);
        st_shared(d + 12, nlive);
        mbar_arrive(bDesc + 8 * (n & 1));
        if (bh < 0) break;
      }
      return;
    }
    if (tid != kFwConsumers) return;
    // every load.  Step c (the live steps of all tiles in turn) takes K
    // stage and V stage c % S.  A tile's first K goes before its Q (which
    // waits until the last tile's S products are done with Q), each later
    // K beside the V of the step before, the last V after its K.  The
    // tile's words are read from its queue slot where they are used (this
    // thread has 24 registers); the slot is released after the last load.
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
        mbar_expect_tx(bQFull, T::kQ);
        for (int cc = 0; cc < DP / 64; ++cc)
          tma_load(sQ + cc * (kQmBQ * 128), &tq, bQFull, cc * 64,
                   ld_shared(d + 4) * kQmBQ, ld_shared(d));
      };
      // V of step c - 1 (key tile k) once P V is done with its stage
      auto load_v = [&](int k) {
        const int st = (c - 1) % S, use = (c - 1) / S;
        if (use > 0) mbar_wait(bVEmpty + 8 * st, (use - 1) & 1);
        mbar_expect_tx(bVFull + 8 * st, T::kKV);
        for (int cc = 0; cc < DP / 64; ++cc)
          tma_load(sV + st * T::kKV + cc * (BK * 128), &tv, bVFull + 8 * st,
                   cc * 64, k * BK, ld_shared(d));
      };
      int left = ld_shared(d + 12);  // live key tiles not yet loaded
      int prev = -1;                 // the last one loaded
      const int nk = left > 0 ? fw_tiles_seen(p, ld_shared(d + 4)) : 0;
      for (int kt = 0; kt < nk; ++kt) {
        int part = 0;
        if constexpr (MASK) {
          const unsigned char cl = p.cls[(size_t)ld_shared(d + 8) + kt];
          if (cl == kTileDead) continue;
          part = cl == kTilePartial;
        }
        // K of step c once S is done with its stage; the step's words
        // beside it
        const int st = c % S, use = c / S;
        if (use > 0) mbar_wait(bKEmpty + 8 * st, (use - 1) & 1);
        st_shared(sInfo + 48 + 4 * st, kt * 4 + (--left == 0 ? 2 : 0) + part);
        mbar_expect_tx(bKFull + 8 * st, T::kKV);
        for (int cc = 0; cc < DP / 64; ++cc)
          tma_load(sK + st * T::kKV + cc * (BK * 128), &tk, bKFull + 8 * st,
                   cc * 64, kt * BK, ld_shared(d));
        if (prev < 0)
          begin_tile(true);
        else
          load_v(prev);
        ++c;
        prev = kt;
      }
      if (prev >= 0) {
        load_v(prev);
      } else {
        begin_tile(false);
        if (ld_shared(d) < 0) break;
      }
      mbar_arrive(bDesc + 16 + 8 * (n & 1));   // the slot is free
    }
    return;
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
    return gmma_desc(sQ + (ks >> 2) * (kQmBQ * 128) + wg * (64 * 128) +
                         (ks & 3) * 32, 16, 1024);
  };
  auto b_desc = [&](uint32_t tile, int ks) {
    return gmma_desc(tile + (ks >> 2) * (BK * 128) + (ks & 3) * 32, 16, 1024);
  };
  // B of P V: the stage's V tile read N-major, key step t
  auto n_desc = [&](uint32_t tile, int t) {
    return gmma_desc(tile + t * 16 * 128, BK * 128, 1024);
  };
  // p is exponentiated as p / (1 - rate) (log2 of the scale added to the
  // exponent's offset: no multiply an element), so the row sums l' = l /
  // (1 - rate) and P V's bf16 p's are those of the plain version; O's
  // division and lse take the scale back out
  const uint32_t seed = (uint32_t)__ldg(p.seed3),
                 roff = (uint32_t)__ldg(p.seed3 + 1),
                 hcol0 = (uint32_t)__ldg(p.seed3 + 2),
                 thr8 = p.threshold << 8;
  // a threshold of 2^24 (rate within 2^-25 of 1) keeps nothing
  const uint32_t kall = p.threshold >= (1u << 24) ? 0u : 0xffffffffu;
  const float out_scale = p.inv_keep, lc = log2f(p.inv_keep);
  // the first warpgroup takes the first turn
  if (wg == 1) bar_arrive(kFwTurn, kFwConsumers);

  int c = 0;                        // live steps so far: the ring's place
  for (int n = 0;; ++n) {
    mbar_wait(bQFull, n & 1);
    const int bh = tinfo[0], qb = tinfo[1], nlive = tinfo[2];
    if (bh < 0) break;
    const int q0 = qb * kQmBQ, wq0 = q0 + wg * 64 + warp * 16;
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
    // rows row and row + 8's part of the keep hash, folded
    uint32_t hrow[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      hrow[hf] = fold16(drop_row(seed, (uint32_t)bh,
                                 roff + (uint32_t)(row + hf * 8)));
    float acc[kON];
#pragma unroll
    for (int i = 0; i < kON; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // rows row, row + 8 (base 2, scaled)
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    if (nlive > 0) {
      unsigned pa[kPS][4];            // P as the next product's A
#pragma unroll
      for (int u = 0; u < kPS; ++u)
        pa[u][0] = pa[u][1] = pa[u][2] = pa[u][3] = 0u;
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
        float s[kSN];                 // overwritten by the first k-step
        undef(s);
        keep(acc);
        keep(pa);
        // while S runs: the keep bits of this thread's 64 elements, bit
        // 2 j + e of word hf for row row + 8 hf, key k0 + 8 j + 2 tig + e
        uint32_t kb[2] = {0u, 0u};
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
        bar_sync(kFwTurn + wg, kFwConsumers);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks)
          wgmma_ss<0, 0>(s, a_desc(ks), b_desc(sK + st * T::kKV, ks), ks > 0);
        wgmma_commit();
        if (i > 0) {
          const uint32_t pV = sV + ((c - 1) % S) * T::kKV;
#pragma unroll
          for (int t = 0; t < kPS; ++t) wgmma_rs(acc, pa[t], n_desc(pV, t), 1);
          wgmma_commit();
          bar_arrive(kFwTurn + 1 - wg, kFwConsumers);
          hash();
          wgmma_wait<1>();            // S is done; P V may still run
        } else {
          bar_arrive(kFwTurn + 1 - wg, kFwConsumers);
          hash();
          wgmma_wait<0>();
        }
        kb_load();
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
        // P_t as bf16 A fragments: columns 16 t .. 16 t + 15 of the
        // accumulator are k-step t's A (a dropped element is 0)
#pragma unroll
        for (int t = 0; t < kPS; ++t)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int x = 8 * t + 2 * u;
            const uint32_t kw = kb[u & 1] >> (2 * (2 * t + (u >> 1)));
            pa[t][u] = pack_bf16((kw & 1u) ? s[x] : 0.f,
                                 (kw & 2u) ? s[x + 1] : 0.f);
          }
        if (last) break;
      }
      // the last tile's P V, in turn
      mbar_wait(bVFull + 8 * (c % S), (c / S) & 1);
      keep(acc);
      keep(pa);
      bar_sync(kFwTurn + wg, kFwConsumers);
      wgmma_fence();
      {
        const uint32_t pV = sV + (c % S) * T::kKV;
#pragma unroll
        for (int t = 0; t < kPS; ++t) wgmma_rs(acc, pa[t], n_desc(pV, t), 1);
      }
      wgmma_commit();
      bar_arrive(kFwTurn + 1 - wg, kFwConsumers);
      wgmma_wait<0>();
      keep(acc);
      mbar_arrive(bVEmpty + 8 * (c % S));
      ++c;
    } else {
      mbar_arrive(bQEmpty);           // nothing read Q
    }

    // out = O / l = O (1 / (1 - rate)) / l' (0 for fully masked rows),
    // lse = m + log2(l): lse stored directly, O through this warpgroup's
    // half of sO and a TMA store
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
  if (wg == 0) bar_sync(kFwTurn, kFwConsumers);
  if ((tid & 127) == 0) bulk_wait();
}

// flash_fwd_ws_kernel<D, MASK> over bh batch-heads (the pre-pass has run
// for MASK): the tensor maps, the groups and the grid.
template <int D, bool MASK>
int launch_fwd_ws(const void* q, const void* k, const void* v, void* out,
                  void* lse, int bh, int sq, int sk, int causal, int off,
                  int valid_q, int valid_k, float scale_log2,
                  cudaStream_t stream, const void* cls, const void* bits,
                  int mask_hper, const void* seed3, unsigned threshold,
                  float inv_keep) {
  if (MASK && (cls == nullptr || bits == nullptr || mask_hper < 1 ||
               bh % mask_hper))
    return (int)cudaErrorInvalidValue;
  if (seed3 == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  int e = bf16_tile_map(&tq, q, bh, sq, D, kQmBQ);
  // no keys: no tile loads k or v, whose maps then describe q
  if (!e) e = sk > 0 ? bf16_tile_map(&tk, k, bh, sk, D, kMaskTile)
                     : bf16_tile_map(&tk, q, bh, sq, D, kMaskTile);
  if (!e) e = sk > 0 ? bf16_tile_map(&tv, v, bh, sk, D, kMaskTile)
                     : bf16_tile_map(&tv, q, bh, sq, D, kMaskTile);
  if (!e) e = bf16_tile_map(&to, out, bh, sq, D, 64);
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
  p.nqb = (sq + kQmBQ - 1) / kQmBQ;
  p.nkt = (sk + kMaskTile - 1) / kMaskTile;
  p.cls = static_cast<const unsigned char*>(cls);
  p.bits = static_cast<const unsigned*>(bits);
  p.seed3 = static_cast<const int*>(seed3);
  p.threshold = threshold;
  p.inv_keep = inv_keep;
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
  const long long tiles = (long long)bh * p.nqb;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = FwTiles<D, MASK>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_ws_kernel<D, MASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // one block an SM of the current device
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  flash_fwd_ws_kernel<D, MASK><<<grid, kFwThreads, bytes, stream>>>(
      tq, tk, tv, to, static_cast<float*>(lse), p);
  return (int)cudaGetLastError();
}

}  // namespace
