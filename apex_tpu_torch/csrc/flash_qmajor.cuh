// The query-major flash-attention kernels for Hopper (sm_90a): the
// forward (DQ = false) and the split backward's dq kernel (DQ = true)
// are one template, flash_qmajor_kernel<D, DQ, BK>.  A block holds 128
// queries resident in shared memory (q, and for dq also dO) and streams
// the k/v tiles they can see past them, BK keys a step; two warpgroups
// own 64 queries each, and a thread the rows grp and grp + 8 of its
// warp's 16, as wgmma's accumulator layout places them.
//
// Blocks run heaviest first (the last rows see the most keys) within a
// group of heads whose k and v fit half the L2; groups run in turn.
//
// Per step (t the key tile, each warpgroup on its own 64 rows):
//   forward:  S_t = Q K_t^T (wgmma, both operands from shared memory)
//             and O += P_{t-1} V_{t-1} (wgmma, P from registers) are
//             issued together; the softmax of S_t runs while the P V
//             product is still on the tensor cores; then O is rescaled
//             and P_t packed for the next step.
//   dq:       S_t = Q K_t^T and dP_t = dO V_t^T, one commit group each
//             (P_t's exp runs while dP_t is on the tensor cores), then
//             dS_t = P_t (dP_t - delta) and dQ += dS_t K_t (dS from
//             registers, K read N-major from the tile that was S's
//             K-major B), done before the next step (left in flight into
//             the next step's products, it made ptxas serialise them,
//             C7515, and measured slower).
// A third warpgroup only copies: one of its threads issues TMA loads of
// the resident tiles and of each k/v tile into a 3-stage ring (2 stages
// where 3 do not fit; in the 128-byte swizzle wgmma reads), each stage
// with a "full" mbarrier (the copies' bytes) and an "empty" one (every
// product thread's arrival once the products that read the stage are
// done), and gives its registers to the two product warpgroups
// (setmaxnreg).  No block-wide barrier runs in
// the loop, so the two product warpgroups drift apart and one's softmax
// overlaps the other's products.
//
// Masks and numbers as _fwd / _dq_reference: base-2 scores (log2(e)
// folded into scale_log2), the causal offset (key c visible to query r
// when c <= r + off) and the validity window; tiles with nothing visible
// to the block are never loaded.  The forward's MASK instance also
// applies the boolean mask3 operand (_fwd_kernel's mask_ref, True =
// masked, batch-head bh reading mask bh / mask_hper) through what the
// masked launch's pre-pass (mask_tiles_kernel, below) made
// of it: a class a (mask, 128-query block, key tile) and the tile's mask
// bits in the product threads' order.  Both warpgroups walk only the
// tiles that are not dead (the copies never load a dead tile), a full
// tile takes the unmasked fast path where the causal and validity masks
// allow, and a partial tile reads two 32-bit words a thread (its rows'
// bits), not a byte an element.  p, and dS, are rounded to bf16 before
// their product (the forward's row sum keeps the fp32 p); a fully masked
// row emits 0 and lse -1e30 (so does a block whose tiles are all dead),
// and gets dq 0 where its lse < -0.5e30.
//
// MASK serves the forward alone: the mask and dropout instances of the
// forward and of the split dq kernel are flash_qmajor_ws.cuh's.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int kQmBQ = 128;       // queries a block: two warpgroups of 64
constexpr int kQmConsumers = 256; // the two product warpgroups
constexpr int kQmThreads = 384;   // and the copying warpgroup
constexpr int kQmStages = 3;      // the k/v ring, where it fits
constexpr int kSmemMax = 232448;  // shared memory a block may take
constexpr long long kL2Half = 25LL << 20;  // half the H100's 50 MB L2
constexpr int kQmRegs = 240;      // registers of a product thread
constexpr int kQmCopyRegs = 24;   // and of a copying thread
// the mask pre-pass's tile classes, and its bits: a 32-bit word a (row,
// tig) of a 128-query x 128-key tile, bit 2 j + e for key j * 8 + 2 tig
// + e (the keys a product thread's accumulator holds), 1 = masked
constexpr unsigned char kTileDead = 0, kTilePartial = 1, kTileFull = 2;
constexpr int kMaskTile = 128;
constexpr int kMaskWords = kQmBQ * 4;

// Shared memory, byte offsets from a 1024-aligned base: sQ [128][DP],
// with DQ sO (dO) [128][DP], then sK [stages][BK][DP] and sV
// [stages][BK][DP], every tile swizzled (hopper.cuh); then the mbarriers:
// the resident tiles', and each stage's full and empty.
template <int D, bool DQ, int BK>
struct QmTiles {
  static constexpr int DP = kDP<D>;
  static constexpr int kQ = kQmBQ * DP * 2;
  static constexpr int kKV = BK * DP * 2;
  static constexpr int oQ = 0, oO = kQ, oK = (DQ ? 2 : 1) * kQ;
  static constexpr int kStages =
      kSmemMax - 1024 - oK - (1 + 2 * kQmStages) * 8 >= kQmStages * 2 * kKV
          ? kQmStages : 2;
  static constexpr int oV = oK + kStages * kKV, oBar = oV + kStages * kKV;
  static constexpr size_t bytes = 1024 + oBar + (1 + 2 * kStages) * 8;
  static_assert(bytes <= kSmemMax, "the tiles fit in shared memory");
};

// Row r of batch-head bh of an fp32 [bh, sq, D] output from a product
// thread's accumulator half hf (columns 8 j + 2 tig + e), times mul.
template <int D, int N>
__device__ __forceinline__ void store_f32_row(float* out, int bh, int sq,
                                              int r, int tig,
                                              const float (&acc)[N], int hf,
                                              float mul) {
  float* o = out + ((size_t)bh * sq + r) * D + tig * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<float2*>(o + j * 8) =
        make_float2(acc[j * 4 + hf * 2] * mul, acc[j * 4 + hf * 2 + 1] * mul);
}

// DQ = false: out = softmax(...) V [bh, sq, D] bf16 and lse_out (base 2,
// fp32 [bh, sq], may be null); dout, lse_in, delta and scale unused.
// DQ = true: out = dq [bh, sq, D] bf16, written once; lse_out unused.
// F32: out holds fp32 [bh, sq, D] instead, stored from the fp32
// accumulators without a round to bf16 (ring attention's partials); the
// instances without it are unchanged.
// The operands come as tensor maps (bf16_tile_map): q and dO with
// 128-row boxes, k and v with BK-row boxes.  MASK (the forward only):
// mask [bh / mask_hper, sq, sk] bytes, nonzero = masked, as the pre-pass's
// classes cls [nmask, nqb, nkt] and bits [nmask, nqb, nkt, kMaskWords]
// (nqb query blocks of 128, nkt key tiles of 128; a BK-key step reads its
// tile's).
template <int D, bool DQ, int BK, bool MASK = false, bool F32 = false>
__global__ void __launch_bounds__(kQmThreads, 1)
flash_qmajor_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse_in,
                    const float* __restrict__ delta, bf16* __restrict__ out,
                    float* __restrict__ lse_out, int nbh, int group, int sq,
                    int sk, int causal, int off, int valid_q, int valid_k,
                    float scale_log2, float scale,
                    const unsigned char* __restrict__ cls,
                    const unsigned* __restrict__ bits, int mask_hper,
                    int nkt) {
  static_assert(kMaskTile % BK == 0, "a step lies inside a pre-pass tile");
  static_assert(!(DQ && MASK),
                "the dq kernel's mask instances are flash_qmajor_ws.cuh's");
  // the pre-pass tiles hold kStepsPerTile key steps each
  constexpr int kStepsPerTile = kMaskTile / BK;
  using T = QmTiles<D, DQ, BK>;
  constexpr int DP = T::DP;
  constexpr int kKS = D / 16;     // k16 steps of S (and dP) over d
  constexpr int kPS = BK / 16;    // k16 steps of P V (dS K) over keys
  constexpr int kSN = BK / 2;     // registers of an m64 x BK accumulator
  constexpr int kON = DP / 2;     // registers of the m64 x DP output
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + T::oQ, sO = base + T::oO, sK = base + T::oK,
                 sV = base + T::oV;
  // mbarriers: the resident tiles, then each stage's full and empty
  const uint32_t bQ = base + T::oBar, bFull = bQ + 8,
                 bEmpty = bFull + 8 * T::kStages;

  // Heads in groups of `group` (as many as keep their k and v within
  // half the L2): within a group the heaviest causal tiles (the last
  // rows, the most keys) of every head come first.
  const int nqb = (sq + kQmBQ - 1) / kQmBQ;
  const int g = blockIdx.x / (group * nqb), r = blockIdx.x % (group * nqb);
  const int gsize = min(group, nbh - g * group);
  const int bh = g * group + r % gsize;
  const int q0 = (nqb - 1 - r / gsize) * kQmBQ;
  const int tid = threadIdx.x;

  const int kv_end = min(sk, valid_k);
  const int q_end = min(sq, valid_q);
  // keys any query of this block may see: [0, kend)
  int kend = kv_end;
  if (causal) kend = min(kend, q0 + kQmBQ + off);
  const int nk = (kend > 0 && q0 < q_end) ? (kend + BK - 1) / BK : 0;
  // MASK: this block's tile classes and bits, and the tiles it loads
  const size_t mtile = MASK ? ((size_t)(bh / mask_hper) * nqb + q0 / kQmBQ) *
                                  nkt : 0;
  const unsigned char* tcls = MASK ? cls + mtile : nullptr;
  int nlive = nk;
  if constexpr (MASK) {
    nlive = 0;
    for (int kt = 0; kt < nk; ++kt)
      nlive += tcls[kt / kStepsPerTile] != kTileDead;
  }

  if (tid == 0) {
    mbar_init(bQ, 1);
    for (int st = 0; st < T::kStages; ++st) {
      mbar_init(bFull + 8 * st, 1);
      mbar_init(bEmpty + 8 * st, kQmConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kQmConsumers) {
    // the copying warpgroup: one thread issues every load (none where the
    // block sees no key: then nothing is in flight when it exits)
    reg_dealloc<kQmCopyRegs>();
    if (tid == kQmConsumers && nlive > 0) {
      mbar_expect_tx(bQ, (DQ ? 2 : 1) * T::kQ);
      for (int c = 0; c < DP / 64; ++c) {
        tma_load(sQ + c * (kQmBQ * 128), &tq, bQ, c * 64, q0, bh);
        if constexpr (DQ)
          tma_load(sO + c * (kQmBQ * 128), &tdo, bQ, c * 64, q0, bh);
      }
      // i: the ordinal of tile kt among those loaded (MASK: not dead)
      for (int kt = 0, i = 0; kt < nk; ++kt) {
        if constexpr (MASK)
          if (tcls[kt / kStepsPerTile] == kTileDead) continue;
        const int st = i % T::kStages, use = i / T::kStages;
        ++i;
        // the stage's last tile is released by every product thread
        if (use > 0) mbar_wait(bEmpty + 8 * st, (use - 1) & 1);
        mbar_expect_tx(bFull + 8 * st, 2 * T::kKV);
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(sK + st * T::kKV + c * (BK * 128), &tk, bFull + 8 * st,
                   c * 64, kt * BK, bh);
          tma_load(sV + st * T::kKV + c * (BK * 128), &tv, bFull + 8 * st,
                   c * 64, kt * BK, bh);
        }
      }
    }
    return;
  }
  reg_alloc<kQmRegs>();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wq0 = q0 + wg * 64 + warp * 16;   // this warp's first row
  const int row = wq0 + grp;                  // and row + 8
  // wait for tile kt's k and v, and release the stage of tile kt
  auto wait_kv = [&](int kt) {
    mbar_wait(bFull + 8 * (kt % T::kStages), (kt / T::kStages) & 1);
  };
  auto release_kv = [&](int kt) { mbar_arrive(bEmpty + 8 * (kt % T::kStages)); };
  if (nlive > 0) mbar_wait(bQ, 0);

  // A of S (and dP): this warpgroup's 64 rows of the resident tile, k-step
  // ks; B: the stage's K (V) tile, K-major over d
  auto a_desc = [&](uint32_t tile, int ks) {
    return gmma_desc(tile + (ks >> 2) * (kQmBQ * 128) + wg * (64 * 128) +
                         (ks & 3) * 32, 16, 1024);
  };
  auto b_desc = [&](uint32_t tile, int ks) {
    return gmma_desc(tile + (ks >> 2) * (BK * 128) + (ks & 3) * 32, 16, 1024);
  };
  // B of P V (dS K): the stage's V (K) tile read N-major, key step t
  auto n_desc = [&](uint32_t tile, int t) {
    return gmma_desc(tile + t * 16 * 128, BK * 128, 1024);
  };
  // is key tile k0 inside every mask for this warp's 16 rows
  auto full_tile = [&](int k0) {
    return k0 + BK <= kv_end && wq0 + 16 <= q_end &&
           (!causal || k0 + BK - 1 <= wq0 + off);
  };
  auto live = [&](int r, int c) {
    return c < kv_end && r < q_end && (!causal || c <= r + off);
  };
  // MASK: this thread's bits of rows row and row + 8 in each tile
  const unsigned* tbits =
      MASK ? bits + mtile * kMaskWords + (row - q0) * 4 + tig : nullptr;
  // MASK: false where key step kt is dead; else `fast` cleared unless the
  // step is full, and rows row and row + 8's bits of a partial step in
  // mw (bit 2 j + e for the step's key j * 8 + 2 tig + e)
  auto step_mask = [&](int kt, bool& fast, unsigned (&mw)[2]) {
    const unsigned char c = tcls[kt / kStepsPerTile];
    fast = fast && c == kTileFull;
    if (c != kTileDead && !fast) {
      const size_t w = (size_t)(kt / kStepsPerTile) * kMaskWords;
      const int sh = 2 * (BK / 8) * (kt % kStepsPerTile);
      mw[0] = __ldg(tbits + w) >> sh;
      mw[1] = __ldg(tbits + w + 32) >> sh;
    }
    return c != kTileDead;
  };
  float acc[kON];                 // O, or dQ
#pragma unroll
  for (int i = 0; i < kON; ++i) acc[i] = 0.f;
  unsigned pa[kPS][4];            // P (dS) as the next product's A
#pragma unroll
  for (int t = 0; t < kPS; ++t) pa[t][0] = pa[t][1] = pa[t][2] = pa[t][3] = 0u;

  if constexpr (!DQ) {
    float s[kSN];
    float m[2] = {kNegInf, kNegInf};  // rows row, row + 8 (base 2, scaled)
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    int taken = 0;                    // MASK: tiles taken so far
    for (int kt = 0; kt < nk; ++kt) {
      const int i = MASK ? taken : kt;  // the tile's place in the ring
      unsigned mw[2] = {0u, 0u};      // MASK: rows row, row + 8's bits
      bool fast = full_tile(kt * BK);
      if constexpr (MASK)
        if (!step_mask(kt, fast, mw)) continue;
      const int st = i % T::kStages;
      wait_kv(i);
#pragma unroll
      for (int x = 0; x < kSN; ++x) s[x] = 0.f;
      keep(s);
      keep(acc);
      keep(pa);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        wgmma_ss<0, 0>(s, a_desc(sQ, ks), b_desc(sK + st * T::kKV, ks),
                       ks > 0);
      wgmma_commit();
      if (i > 0) {
        const uint32_t pV = sV + ((i - 1) % T::kStages) * T::kKV;
#pragma unroll
        for (int t = 0; t < kPS; ++t) wgmma_rs(acc, pa[t], n_desc(pV, t), 1);
        wgmma_commit();
        wgmma_wait<1>();      // S is done; P V may still run
      } else {
        wgmma_wait<0>();
      }
      keep(s);

      // the online softmax in base 2 on the accumulator layout (a row
      // spans the 4 threads of a quad); a tile inside every mask for this
      // warp's rows skips the per-element masks
      const int k0 = kt * BK;
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
          const float m_new = fmaxf(m[hf], r * scale_log2);
          alpha[hf] = exp2_ftz(m[hf] - m_new);
          float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = j * 4 + hf * 2 + e;
              s[x] = exp2_ftz(fmaf(s[x], scale_log2, -m_new));
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
                         ? s[x] * scale_log2 : kNegInf;
              mx = fmaxf(mx, s[x]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[hf], mx);
          alpha[hf] = exp2_ftz(m[hf] - m_new);
          const bool dead = m_new <= kMaskedRowThresh;  // fully masked so far
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = j * 4 + hf * 2 + e;
              s[x] = dead ? 0.f : exp2_ftz(s[x] - m_new);
              rs += s[x];
            }
          l[hf] = l[hf] * alpha[hf] + rs;
          m[hf] = m_new;
        }
      }
      wgmma_wait<0>();        // P_{t-1} V_{t-1} is done: O and P are free
      keep(acc);
      keep(pa);
      if (i > 0) release_kv(i - 1);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          acc[j * 4 + hf * 2] *= alpha[hf];
          acc[j * 4 + hf * 2 + 1] *= alpha[hf];
        }
      to_a_frags(pa, s);
      if constexpr (MASK) ++taken;
    }
    const int ntaken = MASK ? taken : nk;
    if (ntaken > 0) {         // the last tile's P V
      const uint32_t pV = sV + ((ntaken - 1) % T::kStages) * T::kKV;
      keep(acc);
      keep(pa);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kPS; ++t) wgmma_rs(acc, pa[t], n_desc(pV, t), 1);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
    }

    // out = O / l (0 for fully masked rows), lse = m + log2(l)
    bf16* ob = out + bh * (size_t)sq * D;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[hf];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / (lt == 0.f ? 1.f : lt);
      const int r = row + hf * 8;
      if (r < sq) {
        if constexpr (F32) {
          store_f32_row<D>(reinterpret_cast<float*>(out), bh, sq, r, tig,
                           acc, hf, inv);
        } else {
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * D + j * 8 +
                                               tig * 2) =
                __floats2bfloat162_rn(acc[j * 4 + hf * 2] * inv,
                                      acc[j * 4 + hf * 2 + 1] * inv);
        }
        if (lse_out != nullptr && tig == 0)
          lse_out[bh * (size_t)sq + r] = m[hf] + log2f(lt == 0.f ? 1.f : lt);
      }
    }
  } else {
    // this thread's rows: lse and delta, read once
    float lrow[2], drow[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row + hf * 8;
      lrow[hf] = r < sq ? lse_in[bh * (size_t)sq + r] : kNegInf;
      drow[hf] = r < sq ? delta[bh * (size_t)sq + r] : 0.f;
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int i = kt;               // the tile's place in the ring
      const bool fast = full_tile(kt * BK);
      float s[kSN], dp[kSN];  // overwritten by their first k-step
      const int st = i % T::kStages;
      const uint32_t cK = sK + st * T::kKV, cV = sV + st * T::kKV;
      wait_kv(i);

      // S = Q K^T and dP = dO V^T, one commit group each
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        wgmma_ss<0, 0>(s, a_desc(sQ, ks), b_desc(cK, ks), ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        wgmma_ss<0, 0>(dp, a_desc(sO, ks), b_desc(cV, ks), ks > 0);
      wgmma_commit();
      wgmma_wait<1>();        // S is done
      keep(s);

      // P = exp2(S * scale_log2 - lse) with the masks (a tile inside
      // both masks for this warp's rows, whose lse is then finite, skips
      // them)
      const int k0 = kt * BK;
      if (fast) {
#pragma unroll
        for (int x = 0; x < kSN; ++x)
          s[x] = exp2_ftz(fmaf(s[x], scale_log2, -lrow[(x >> 1) & 1]));
      } else {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = j * 4 + hf * 2 + e;
              s[x] = (live(row + hf * 8, k0 + j * 8 + tig * 2 + e) &&
                      lrow[hf] > kMaskedRowThresh)
                         ? exp2_ftz(s[x] * scale_log2 - lrow[hf])
                         : 0.f;
            }
      }
      wgmma_wait<0>();        // dP done
      keep(dp);
      // dS = P (dP - delta), rounded to bf16 as dQ's A
#pragma unroll
      for (int x = 0; x < kSN; ++x)
        dp[x] = s[x] * (dp[x] - drow[(x >> 1) & 1]);
      to_a_frags(pa, dp);

      // dQ += dS K: K read N-major from this stage's tile
      keep(acc);
      keep(pa);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kPS; ++t) wgmma_rs(acc, pa[t], n_desc(cK, t), 1);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(pa);
      release_kv(i);
    }

    // this block owns its queries' dq: plain stores, no atomics
    bf16* qb = out + bh * (size_t)sq * D;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row + hf * 8;
      if (r < sq) {
        if constexpr (F32) {
          store_f32_row<D>(reinterpret_cast<float*>(out), bh, sq, r, tig,
                           acc, hf, scale);
        } else {
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(qb + (size_t)r * D + j * 8 +
                                               tig * 2) =
                __floats2bfloat162_rn(scale * acc[j * 4 + hf * 2],
                                      scale * acc[j * 4 + hf * 2 + 1]);
        }
      }
    }
  }
}

// The mask pre-pass: block (kt, qb, m) classifies key tile kt of query
// block qb of mask m (flash_qmajor.cuh: kTileDead / Partial / Full) over
// the elements the causal and validity masks leave live, and writes the
// tile's bits (1 = masked; out of range reads as masked).  Thread t
// reads row t / 2, keys 64 (t % 2) .. + 64 (four 16-byte loads where
// the rows are 16-byte aligned), and the two threads of a row combine
// their halves of each word.  A tile the kernels never visit (past the
// causal diagonal or the windows) is left alone.  The mask's rows are
// ld bytes apart (ld >= sk).
__global__ void __launch_bounds__(256)
mask_tiles_kernel(const unsigned char* __restrict__ mask,
                  unsigned char* __restrict__ cls,
                  unsigned* __restrict__ bits, int sq, int sk, int ld,
                  int causal, int off, int valid_q, int valid_k) {
  const int kt = blockIdx.x, qb = blockIdx.y, m = blockIdx.z;
  const int nkt = gridDim.x, nqb = gridDim.y;
  const int q0 = qb * kQmBQ, k0 = kt * kMaskTile;
  const int q_end = min(sq, valid_q), kv_end = min(sk, valid_k);
  int kend = kv_end;
  if (causal) kend = min(kend, q0 + kQmBQ + off);
  if (q0 >= q_end || k0 >= kend) return;
  const size_t tile = ((size_t)m * nqb + qb) * nkt + kt;
  const int t = threadIdx.x, r = t >> 1, half = t & 1;
  const int row = q0 + r, c0 = k0 + half * 64;
  // the 64 mask bytes of this thread, 4 to a word (out of range: masked)
  unsigned w[16];
  const unsigned char* src = mask + ((size_t)m * sq + row) * ld + c0;
  if (row < sq && c0 + 64 <= sk && (ld & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(mask) & 15) == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(src) + u);
      w[4 * u] = x.x; w[4 * u + 1] = x.y; w[4 * u + 2] = x.z;
      w[4 * u + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      unsigned x = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = c0 + 4 * u + b;
        const unsigned byte = (row < sq && c < sk) ? src[4 * u + b] : 1u;
        x |= (byte & 0xffu) << (8 * b);
      }
      w[u] = x;
    }
  }
  // word tig: bit 2 j + e for key 8 j + 2 tig + e; this half holds keys
  // 64 half .. + 64, that is j = 8 half .. + 8
  unsigned word[4] = {0u, 0u, 0u, 0u};
  int any_vis = 0, any_msk = 0;
#pragma unroll
  for (int cc = 0; cc < 64; ++cc) {
    const int c = c0 + cc;
    const bool masked = ((w[cc >> 2] >> (8 * (cc & 3))) & 0xffu) != 0;
    const bool lv = row < q_end && c < kv_end && (!causal || c <= row + off);
    any_vis |= lv && !masked;
    any_msk |= lv && masked;
    const int j = half * 8 + (cc >> 3), tig = (cc & 7) >> 1, e = cc & 1;
    word[tig] |= (unsigned)masked << (2 * j + e);
  }
  unsigned* out = bits + tile * kMaskWords + r * 4;
#pragma unroll
  for (int tig = 0; tig < 4; ++tig) {
    const unsigned both = word[tig] | __shfl_xor_sync(0xffffffffu,
                                                      word[tig], 1);
    if ((tig >> 1) == half) out[tig] = both;
  }
  any_vis = __syncthreads_or(any_vis);
  any_msk = __syncthreads_or(any_msk);
  if (t == 0)
    cls[tile] = !any_vis ? kTileDead : any_msk ? kTilePartial : kTileFull;
}

// The pre-pass over nmask masks of [sq, ld] bytes into cls [nmask, nqb,
// nkt] and bits [nmask, nqb, nkt, kMaskWords].
inline int launch_mask_tiles(const void* mask, void* cls, void* bits,
                             int nmask, int sq, int sk, int ld, int causal,
                             int off, int valid_q, int valid_k,
                             cudaStream_t stream) {
  const int nqb = (sq + kQmBQ - 1) / kQmBQ;
  const int nkt = (sk + kMaskTile - 1) / kMaskTile;
  if (nkt == 0) return 0;
  if (mask == nullptr || cls == nullptr || bits == nullptr || ld < sk)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nkt, nqb, nmask);
  mask_tiles_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const unsigned char*>(mask),
      static_cast<unsigned char*>(cls), static_cast<unsigned*>(bits), sq, sk,
      ld, causal, off, valid_q, valid_k);
  return (int)cudaGetLastError();
}

// flash_qmajor_kernel<D, DQ, BK, MASK, F32>, one block per (b*h,
// 128-query block); the operands' tensor maps are encoded here.
template <int D, bool DQ, int BK, bool MASK = false, bool F32 = false>
int launch_qmajor(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse_in, const void* delta,
                  void* out, void* lse_out, int bh, int sq, int sk,
                  int causal, int off, int valid_q, int valid_k,
                  float scale_log2, float scale, cudaStream_t stream,
                  const void* cls = nullptr, const void* bits = nullptr,
                  int mask_hper = 1) {
  CUtensorMap tq, tk, tv, tdo;
  int e = bf16_tile_map(&tq, q, bh, sq, D, kQmBQ);
  // no keys: no block loads k or v, whose maps then describe q
  if (!e) e = sk > 0 ? bf16_tile_map(&tk, k, bh, sk, D, BK)
                     : bf16_tile_map(&tk, q, bh, sq, D, BK);
  if (!e) e = sk > 0 ? bf16_tile_map(&tv, v, bh, sk, D, BK)
                     : bf16_tile_map(&tv, q, bh, sq, D, BK);
  if (!e) e = DQ ? bf16_tile_map(&tdo, dout, bh, sq, D, kQmBQ)
                 : bf16_tile_map(&tdo, q, bh, sq, D, kQmBQ);
  if (e) return e;
  if (MASK && (cls == nullptr || bits == nullptr || mask_hper < 1 ||
               bh % mask_hper))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = QmTiles<D, DQ, BK>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_qmajor_kernel<D, DQ, BK, MASK, F32>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)bh * ((sq + kQmBQ - 1) / kQmBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // heads in groups of near-equal size whose k and v fit half the L2
  const long long kv_bytes = 4LL * (sk > 0 ? sk : 1) * D * bh;
  const long long ngroups = (kv_bytes + kL2Half - 1) / kL2Half;
  const int group = (int)((bh + ngroups - 1) / ngroups);
  const dim3 grid((unsigned)blocks);
  flash_qmajor_kernel<D, DQ, BK, MASK, F32>
      <<<grid, kQmThreads, bytes, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse_in),
      static_cast<const float*>(delta), static_cast<bf16*>(out),
      static_cast<float*>(lse_out), bh, group, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, scale,
      static_cast<const unsigned char*>(cls),
      static_cast<const unsigned*>(bits), mask_hper,
      (sk + kMaskTile - 1) / kMaskTile);
  return (int)cudaGetLastError();
}

}  // namespace
