// Single-token decode attention against a KV cache for Hopper (sm_90a),
// fp32 math: the kernel template shared by paged decode
// (csrc/paged_attention.cu, the bf16 pool through the page table), the
// dense slot cache's decode (csrc/flash_attention.cu, DENSE = true: the
// slot's own rows, PS at a time, from one layer's strided view of the
// [slots, layers, kv_heads, S, d] cache) and the wide paged decode's
// TMA modes (csrc/paged_wide_tc_*.cu, OP != kDecBf16: #7w's fp16 and
// bf16 pools at the groups, head dims and page sizes #7 lacks, and fp32
// pools).  The design notes are paged_attention.cu's; the dense instance
// differs only in where the producer's boxes come from (no page table:
// box (c, r, kv head, slot) of a 4-d tensor map over [slots, kv heads, S,
// d]) and in its window (the cache's S; a last tile past S reads zeros,
// masked by the length).  The wide modes' notes stand above
// paged_wide_body.

#pragma once

#include <atomic>
#include <mutex>

#include "hopper.cuh"
#include "paged_wide_tc.cuh"

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

// ---------------------------------------------------------------------
// The wide operand modes (#7w): what paged_decode_kernel runs for OP !=
// kDecBf16 (kDecBf16 is #7's instance and the dense decode's, whose code
// is the kernel's else branch).
//
// Replaces: apex_tpu/ops/paged_attention.py :: _paged_kernel (#7w) for
// the pools #7's instance does not take: fp16 pools, bf16 pools at the
// groups, head dims and page sizes it lacks, fp32 pools up to head dim
// 128; a query of any float type.  The function is #7's: p rounded to
// the pool's type for P.V (fp32: not rounded), the normalizer from the
// fp32 p, an empty slot 0, a length past the window scoring the window.
//
// What bounds it on the H100: bytes, as #7 (each live token's k and v
// read once per kv head and row chunk).  So the modes keep #7's shape --
// a producer warp issuing TMA boxes into an mbarrier ring, eight
// consumer warps with their own softmax state and no block barrier until
// the merge, the splits merged in the launch -- and change only what the
// pool needs:
// - the pool's real head dim d (d x element a multiple of 16 bytes) in
//   boxes of 128 bytes a row (64 16-bit or 32 fp32 columns): TMA fills
//   the columns past d with zeros in shared memory, and a box wholly
//   past d is not loaded, so the device memory read is the real d's;
//   the instance is the next head-dim bucket D;
// - a stage of SR rows holds nseg boxes of seg rows (seg the largest
//   multiple of 8 that divides the page and is at most SR), in token
//   order: several pages of a small page, or a part of a large one; the
//   producer reads the page table once per page; rows past the last box
//   are dead and masked;
// - 16-bit pools: S^T = K Q^T and O^T = V^T P^T on mma.sync (bf16 or
//   fp16) with the tokens on M and the kv head's query rows as R / 8
//   n = 8 operands (R rows a block; a group past R runs as row chunks,
//   each a block with its own merge counter); a query of another type
//   enters as two planes of the pool's type (hi + lo, two products a
//   product), so it is never rounded to one 16-bit value;
// - fp32 pools: the products on the CUDA cores in fp32 from the staged
//   page (the tensor cores have no fp32 product, and at g / 2 flops a
//   byte the CUDA cores keep up to group ~40): 8-row tiles, so that two
//   stages a warp group fit the ring at head dim 128; a score four lanes
//   over interleaved 16-byte units (conflict-free in the swizzle), four
//   independent sums each, q broadcast from shared memory; P.V a 16-byte
//   unit of v a lane, p shuffled from its token's lane;
// - the producer warp's lanes start a stage's boxes at once (a stage of
//   8-row pages is 32 boxes).  #7's shape gives each warp group two
//   stages in flight at head dim 128, but one at 16-bit head dim 256
//   (8 warps' 16-row tiles in two stages would need 256 KB).
// ---------------------------------------------------------------------

constexpr int kDecBf16 = 0, kDecWideBf16 = 1, kDecWideF16 = 2,
              kDecWideF32 = 3;

constexpr int cgcd(int a, int b) { return b ? cgcd(b, a % b) : a; }

// c += A B, m16n8k16, fp16 in, fp32 accumulate
__device__ __forceinline__ void mma16816_f16(float (&c)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <bool F16>
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  if constexpr (F16) mma16816_f16(c, a, b0, b1);
  else mma16816(c, a, b0, b1);
}
// x rounded to the 16-bit type, and two values packed in it
template <bool F16>
__device__ __forceinline__ float round16(float x) {
  if constexpr (F16) return __half2float(__float2half_rn(x));
  else return __bfloat162float(__float2bfloat16_rn(x));
}
template <bool F16>
__device__ __forceinline__ unsigned pack16(float lo, float hi) {
  if constexpr (F16) return pack_f16(lo, hi);
  else return pack_bf16(lo, hi);
}
__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float as_f32(__half x) { return __half2float(x); }
// A block's query rows q [row0, row0 + gr) of [.., d] elements of type T
// into qs [R][D] fp32, zero past gr and d, by the block's threads: the
// loads of one type in one loop, several in flight
template <int R, int D, typename T>
__device__ __forceinline__ void stage_q(float* qs, const T* q, size_t row0,
                                        int gr, int d) {
#pragma unroll 4
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int g = i / D, c = i % D;
    qs[i] = g < gr && c < d ? as_f32(q[(row0 + g) * d + c]) : 0.f;
  }
}
// x stored as element i of out, of type code t (0 fp32, 1 bf16, 2 fp16)
__device__ __forceinline__ void store_f32(void* p, int t, size_t i,
                                          float x) {
  if (t == 0) static_cast<float*>(p)[i] = x;
  else if (t == 1) static_cast<bf16*>(p)[i] = __float2bfloat16_rn(x);
  else static_cast<__half*>(p)[i] = __float2half_rn(x);
}

// What a wide launch adds to #7's arguments.
struct WideDecode {
  int d;         // the real head dim (at most D)
  int ps;        // the page size
  int seg;       // rows a box: a multiple of 8 dividing ps, at most SR
  int spp;       // boxes a page (ps / seg)
  int nseg;      // boxes a stage (SR / seg)
  int group;     // query rows a kv head
  int rchunks;   // blocks of R rows a kv head (ceil(group / R))
  int q_dtype;   // q's and out's type: 0 fp32, 1 bf16, 2 fp16
  int q_planes;  // 16-bit pools: 1 (q of the pool's type) or 2 (hi + lo)
  float scale_log2;
};

// The kernel's last argument: #7's scale_log2, or a wide mode's
// WideDecode (which carries it), so #7's instances keep their arguments.
template <int OP>
struct DecodeLast {
  using type = WideDecode;
};
template <>
struct DecodeLast<kDecBf16> {
  using type = float;
};

// Shared memory of a wide block: the ring of stages, each SR rows of k
// then of v as D / (128 / element) swizzled [SR][128-byte] chunks; the
// stages' mbarriers; the block's query rows [R][D] fp32; the merge flag.  The
// warps' states merge through the stages once the ring is drained.  The
// consumer warps share stages as #7's share pages (kPageWarps warps a
// stage, kWT tiles of kTR rows each, kGroups groups in turn, the stage
// count a multiple of the groups).
template <int OP, int R, int D, int SR>
struct WideSmem {
  static constexpr int kE = OP == kDecWideF32 ? 4 : 2;  // bytes an element
  static constexpr int kCW = 128 / kE;                  // columns a chunk
  static constexpr int kChunk = SR * 128;               // bytes a chunk
  static constexpr int kOperand = D / kCW * kChunk;     // a stage of k
  static constexpr int kStage = 2 * kOperand;
  static constexpr int kTR = OP == kDecWideF32 ? 8 : 16;  // rows a tile
  static constexpr int kTiles = SR / kTR;
  static constexpr int kPageWarps = cgcd(kTiles, kWarps);
  static constexpr int kWT = kTiles / kPageWarps;
  static constexpr int kGroups = kWarps / kPageWarps;
  static_assert(SR % kTR == 0 && D % kCW == 0, "whole tiles and chunks");
  static constexpr int kFit = kStageBudget / kStage / kGroups * kGroups;
  static constexpr int kStages = kFit < kGroups ? kGroups
                                 : kFit > 8 ? (kGroups > 8 ? kGroups : 8)
                                            : kFit;
  static constexpr int oBar = kStages * kStage;  // full[kStages], empty[...]
  static constexpr int oQ = oBar + 16 * kStages;
  static constexpr int oFlag = oQ + 4 * R * D;
  static constexpr size_t bytes = 1024 + oFlag + 16;
  // the merge: acc [kWarps][R][D], m and l [kWarps][R]; the last block's
  // split weights, 2 R splits + R floats
  static_assert(sizeof(float) * kWarps * R * (D + 2) <= (size_t)oBar,
                "the warps' states fit in the stages");
  static_assert(bytes <= 232448, "a block's shared memory");
  static constexpr int kMaxSplits = (oBar / 4 - R) / (2 * R);
};

// The wide modes' block: split blockIdx.x, (kv head, row chunk)
// blockIdx.y, slot blockIdx.z.  A block whose split holds no live token
// returns (split 0 of an empty slot writes its zeros).
template <int OP, int R, int D, int SR>
__device__ __forceinline__ void paged_wide_body(
    const CUtensorMap* kmap, const CUtensorMap* vmap, const void* q,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    void* out, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ counters, int kvh, int mpps, int pps, int window,
    const WideDecode& w) {
  using S = WideSmem<OP, R, D, SR>;
  constexpr bool F32 = OP == kDecWideF32, F16 = OP == kDecWideF16;
  constexpr int kWT = S::kWT;
  const int split = blockIdx.x, slot = blockIdx.z, nsplit = gridDim.x;
  const int kh = blockIdx.y / w.rchunks, rc = blockIdx.y % w.rchunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = w.d, gr = min(R, w.group - rc * R);  // this chunk's rows
  const size_t row0 = ((size_t)slot * kvh + kh) * w.group + (size_t)rc * R;
  const int len = min(lengths[slot], window);
  const int per = pps * w.ps;                 // tokens a split
  const int t0 = split * per;
  if (t0 >= len) {
    if (split == 0)
      for (int i = tid; i < gr * d; i += kThreads)
        store_f32(out, w.q_dtype, row0 * d + i, 0.f);
    return;
  }
  const int ntok = min(per, len - t0);        // this split's live tokens
  const int nbox = (ntok + w.seg - 1) / w.seg;
  const int n = (nbox + w.nseg - 1) / w.nseg; // its stages
  const int stok = w.nseg * w.seg;            // tokens a stage
  const int n_live_splits = (len + per - 1) / per;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);   // generic view
  const uint32_t bFull = base + S::oBar, bEmpty = bFull + 8 * S::kStages;
  int* flag = reinterpret_cast<int*>(gbase + S::oFlag);
  float* qs = reinterpret_cast<float*>(gbase + S::oQ);   // [R][D]
  if (tid == 0) {
    for (int st = 0; st < S::kStages; ++st) {
      mbar_init(bFull + 8 * st, 1);
      mbar_init(bEmpty + 8 * st, S::kPageWarps);
    }
    mbar_init_fence();
  }
  if (w.q_dtype == 0)
    stage_q<R, D>(qs, static_cast<const float*>(q), row0, gr, d);
  else if (w.q_dtype == 1)
    stage_q<R, D>(qs, static_cast<const bf16*>(q), row0, gr, d);
  else
    stage_q<R, D>(qs, static_cast<const __half*>(q), row0, gr, d);
  __syncthreads();
  float* rAcc = reinterpret_cast<float*>(gbase);       // [kWarps][R][D]
  float* rM = rAcc + kWarps * R * D;                   // [kWarps][R]
  float* rL = rM + kWarps * R;

  const int grp = warp / S::kPageWarps;
  const int r0 = (warp % S::kPageWarps) * kWT * S::kTR;   // this warp's rows
  if (warp == kWarps) {
    // the producer warp: the lanes find a stage's boxes (one (box of
    // rows, 128-byte chunk holding columns < d, k or v) a lane, its page
    // read from the page table) before the stage is free, then lane 0
    // arms its barrier and the lanes start the boxes at once
    constexpr int kLB = (2 * (SR / 8) * (D * S::kE / 128) + 31) / 32;
    const int* row = page_table + (size_t)slot * mpps;
    const int box0 = t0 / w.seg;              // t0 is a multiple of ps
    const int chunks = (d * S::kE + 127) / 128;
    const uint32_t box = w.seg * 128;         // bytes a box
    for (int i = 0; i < n; ++i) {
      const int st = i % S::kStages;
      const int nb = 2 * min(w.nseg, nbox - i * w.nseg) * chunks;
      int page[kLB], r[kLB], col[kLB];
      uint32_t dst[kLB];
#pragma unroll
      for (int x = 0; x < kLB; ++x) {
        const int j = lane + 32 * x;
        if (j < nb) {
          const int sg = j / (2 * chunks), c = (j >> 1) % chunks;
          const int b = box0 + i * w.nseg + sg, pg = b / w.spp;
          page[x] = row[pg];
          r[x] = (b - pg * w.spp) * w.seg;
          col[x] = c * S::kCW;
          dst[x] = (j & 1) * S::kOperand + c * S::kChunk + sg * box;
        }
      }
      if (i >= S::kStages)
        mbar_wait(bEmpty + 8 * st, ((i / S::kStages) - 1) & 1);
      if (lane == 0) mbar_expect_tx(bFull + 8 * st, nb * box);
      __syncwarp();
      const uint32_t sk = base + st * S::kStage;
#pragma unroll
      for (int x = 0; x < kLB; ++x) {
        const int j = lane + 32 * x;
        if (j < nb)
          tma_load4(sk + dst[x], j & 1 ? vmap : kmap, bFull + 8 * st,
                    col[x], r[x], kh, page[x]);
      }
    }
    __syncwarp();
  } else if constexpr (F32) {
    // fp32: a warp's 8-row tile scored by lane quarters (token lane % 8,
    // every fourth 16-byte unit of its row from lane / 8: conflict-free
    // in the swizzle), four independent sums a row; P.V a 16-byte unit of
    // v a lane, p shuffled from its token's lane
    constexpr int UR = D / 4;                   // 16-byte units a row
    constexpr int LPR = UR < 32 ? UR : 32;      // lanes a row in P.V
    constexpr int TP = 32 / LPR;                // tokens at once in P.V
    constexpr int UPL = UR / LPR;               // units a lane in P.V
    const int ud = d / 4;                       // units holding columns < d
    const int tk = lane & 7, part = lane >> 3;
    float acc[R][UPL * 4];
    float m[R], l[R];
#pragma unroll
    for (int g = 0; g < R; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int x = 0; x < UPL * 4; ++x) acc[g][x] = 0.f;
    }
    for (int i = grp; i < n; i += S::kGroups) {
      const int st = i % S::kStages;
      mbar_wait(bFull + 8 * st, (i / S::kStages) & 1);
      const unsigned char* gk = gbase + st * S::kStage;
      const unsigned char* gv = gk + S::kOperand;
      const int live = min(stok, ntok - i * stok) - r0;  // live rows of ours
      float sc[kWT][R];
#pragma unroll
      for (int t = 0; t < kWT; ++t) {
        const int r = r0 + t * 8 + tk;
        float4 s4[R];
#pragma unroll
        for (int g = 0; g < R; ++g) s4[g] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < UR / 4; ++j) {
          if (4 * j < ud) {
            const int u = 4 * j + part;
            const float4 kv =
                *reinterpret_cast<const float4*>(gk + sw128<SR>(r, u));
#pragma unroll
            for (int g = 0; g < R; ++g)
              if (g < gr) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(qs + g * D + 4 * u);
                s4[g].x = fmaf(qv.x, kv.x, s4[g].x);
                s4[g].y = fmaf(qv.y, kv.y, s4[g].y);
                s4[g].z = fmaf(qv.z, kv.z, s4[g].z);
                s4[g].w = fmaf(qv.w, kv.w, s4[g].w);
              }
          }
        }
        const bool on = t * 8 + tk < live;
#pragma unroll
        for (int g = 0; g < R; ++g) {
          float x = (s4[g].x + s4[g].y) + (s4[g].z + s4[g].w);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          sc[t][g] = on ? x * w.scale_log2 : kNegInf;
        }
      }
      float p[kWT][R];
#pragma unroll
      for (int g = 0; g < R; ++g) {
#pragma unroll
        for (int t = 0; t < kWT; ++t) p[t][g] = 0.f;
        if (g >= gr) continue;
        float mx = kNegInf;
#pragma unroll
        for (int t = 0; t < kWT; ++t) mx = fmaxf(mx, sc[t][g]);
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m[g], mx);
        const float al = exp2_ftz(m[g] - mn);
        m[g] = mn;
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < kWT; ++t) {
          p[t][g] = sc[t][g] == kNegInf ? 0.f : exp2_ftz(sc[t][g] - mn);
          sum += p[t][g];
        }
        l[g] = l[g] * al + sum;
#pragma unroll
        for (int x = 0; x < UPL * 4; ++x) acc[g][x] *= al;
      }
#pragma unroll
      for (int t = 0; t < kWT; ++t)
#pragma unroll
        for (int tt = 0; tt < 8; tt += TP) {
          const int my = tt + lane / LPR;       // this lane's token
          const bool on = t * 8 + my < live;
          const int r = r0 + t * 8 + my;
          float4 vv[UPL];
#pragma unroll
          for (int j = 0; j < UPL; ++j) {
            const int u = lane % LPR + 32 * j;
            vv[j] = on && u < ud ? *reinterpret_cast<const float4*>(
                                       gv + sw128<SR>(r, u))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int g = 0; g < R; ++g)
            if (g < gr) {
              const float pv = __shfl_sync(0xffffffffu, p[t][g], my);
#pragma unroll
              for (int j = 0; j < UPL; ++j) {
                acc[g][4 * j] = fmaf(pv, vv[j].x, acc[g][4 * j]);
                acc[g][4 * j + 1] = fmaf(pv, vv[j].y, acc[g][4 * j + 1]);
                acc[g][4 * j + 2] = fmaf(pv, vv[j].z, acc[g][4 * j + 2]);
                acc[g][4 * j + 3] = fmaf(pv, vv[j].w, acc[g][4 * j + 3]);
              }
            }
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(bEmpty + 8 * st);
    }
    // l over the tokens (the quarters hold the same p), acc over the
    // token classes of P.V
#pragma unroll
    for (int g = 0; g < R; ++g) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
      if constexpr (TP > 1)
#pragma unroll
        for (int x = 0; x < UPL * 4; ++x)
          acc[g][x] += __shfl_xor_sync(0xffffffffu, acc[g][x], 16);
    }
    bar_sync(1, kWarps * 32);   // every stage consumed: the stages are free
    if (lane < LPR)
#pragma unroll
      for (int g = 0; g < R; ++g)
#pragma unroll
        for (int j = 0; j < UPL; ++j)
          *reinterpret_cast<float4*>(rAcc + (warp * R + g) * D +
                                     4 * (lane + 32 * j)) =
              make_float4(acc[g][4 * j], acc[g][4 * j + 1],
                          acc[g][4 * j + 2], acc[g][4 * j + 3]);
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < R; ++g) {
        rM[warp * R + g] = m[g];
        rL[warp * R + g] = l[g];
      }
  } else {
    // 16-bit: #7's products with R / 8 n-tiles of query rows
    constexpr int NT = R / 8, kK = D / 16;
    const int gq = lane >> 2, tig = lane & 3;
    const int kd = (d + 15) / 16;   // k steps and m tiles holding columns < d
    // up to the bucket 128 every chunk holds a column < d, so it is loaded
    // (zeros past d) and every k step and m tile can run; at 256 a chunk
    // wholly past d is not loaded, and its steps are skipped
    constexpr bool kWhole = D <= 128;
    // q as the B operand of S^T = K Q^T, in one or two planes: query row
    // 8 nt + lane / 4 of the chunk, dims 2 (lane % 4) + {0, 1} and + 8 of
    // each k16 step (zero past the rows and past d)
    unsigned qf[2][kK][NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int ks = 0; ks < kK; ++ks) {
        const int g = nt * 8 + gq;
        float hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x =
              qs[g * D + ks * 16 + 2 * tig + (e & 1) + (e >> 1) * 8];
          hi[e] = round16<F16>(x);
          lo[e] = x - hi[e];
        }
        qf[0][ks][nt][0] = pack16<F16>(hi[0], hi[1]);
        qf[0][ks][nt][1] = pack16<F16>(hi[2], hi[3]);
        qf[1][ks][nt][0] = pack16<F16>(lo[0], lo[1]);
        qf[1][ks][nt][1] = pack16<F16>(lo[2], lo[3]);
      }
    float acc[kK][NT][4];
    float m[NT][2], l[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      m[nt][0] = m[nt][1] = kNegInf;
      l[nt][0] = l[nt][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < kK; ++mt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] =
            0.f;
    }
    for (int i = grp; i < n; i += S::kGroups) {
      const int st = i % S::kStages;
      mbar_wait(bFull + 8 * st, (i / S::kStages) & 1);
      const uint32_t sk = base + st * S::kStage, sv = sk + S::kOperand;
      const int live = min(stok, ntok - i * stok) - r0;  // live rows of ours
      if (live < kWT * 16) {
        // rows past the live ones must still multiply p = 0 by finite
        // values, so this warp's such v rows are zeroed
        unsigned char* gv = gbase + st * S::kStage + S::kOperand;
        const int from = live < 0 ? 0 : live;
        for (int u = lane; u < (kWT * 16 - from) * (D / 8); u += 32) {
          const int r = r0 + from + u / (D / 8), c = (u % (D / 8)) / 8,
                    k = u % 8;
          *reinterpret_cast<uint4*>(gv + c * S::kChunk + r * 128 + k * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        fence_async_smem();   // before the stage goes back to the copies
        __syncwarp();
      }
      // S^T: token rows r0 + 16 t + (lane / 4, + 8), query rows 8 nt +
      // 2 (lane % 4) and + 1; even and odd k steps (and the two planes)
      // into two sums, so the dependent products run two chains
      float sc[kWT][NT][4];
#pragma unroll
      for (int t = 0; t < kWT; ++t) {
        float sa[NT][4], sb[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[nt][e] = sb[nt][e] = 0.f;
        const int tok = r0 + t * 16 + (lane & 15);
#pragma unroll
        for (int ks = 0; ks < kK; ++ks) {
          if (kWhole || ks < kd) {
            unsigned a[4];
            ldsm_x4(a, sk + sw128<SR>(tok, ks * 2 + (lane >> 4)));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const unsigned* h = qf[0][ks][nt];
              const unsigned* o = qf[1][ks][nt];
              if (ks & 1) {
                mma16<F16>(sb[nt], a, h[0], h[1]);
                if (w.q_planes > 1) mma16<F16>(sa[nt], a, o[0], o[1]);
              } else {
                mma16<F16>(sa[nt], a, h[0], h[1]);
                if (w.q_planes > 1) mma16<F16>(sb[nt], a, o[0], o[1]);
              }
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool on = t * 16 + gq + (e >> 1) * 8 < live;
            const float x = sa[nt][e] + sb[nt][e];
            sc[t][nt][e] = on ? x * w.scale_log2 : kNegInf;
          }
      }
      // the online softmax a query row; p (fp32 into l, the pool's type
      // into P^T by one movmatrix per 8 x 8 block)
      unsigned pb[kWT][NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int t = 0; t < kWT; ++t) {
          mx0 = fmaxf(mx0, fmaxf(sc[t][nt][0], sc[t][nt][2]));
          mx1 = fmaxf(mx1, fmaxf(sc[t][nt][1], sc[t][nt][3]));
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        const float mn0 = fmaxf(m[nt][0], mx0), mn1 = fmaxf(m[nt][1], mx1);
        const float al0 = exp2_ftz(m[nt][0] - mn0);
        const float al1 = exp2_ftz(m[nt][1] - mn1);
        m[nt][0] = mn0;
        m[nt][1] = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int t = 0; t < kWT; ++t) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[e] = sc[t][nt][e] == kNegInf
                       ? 0.f
                       : exp2_ftz(sc[t][nt][e] - (e & 1 ? mn1 : mn0));
          ps0 += p[0] + p[2];
          ps1 += p[1] + p[3];
          pb[t][nt][0] = movmatrix_t(pack16<F16>(p[0], p[1]));
          pb[t][nt][1] = movmatrix_t(pack16<F16>(p[2], p[3]));
        }
        l[nt][0] = l[nt][0] * al0 + ps0;
        l[nt][1] = l[nt][1] * al1 + ps1;
#pragma unroll
        for (int mt = 0; mt < kK; ++mt) {
          acc[mt][nt][0] *= al0;
          acc[mt][nt][1] *= al1;
          acc[mt][nt][2] *= al0;
          acc[mt][nt][3] *= al1;
        }
      }
      // O^T += V^T P^T: dims 16 mt + lane / 4 (+ 8), query rows as above
#pragma unroll
      for (int t = 0; t < kWT; ++t) {
        const int tok = r0 + t * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
        for (int mt = 0; mt < kK; ++mt) {
          if (kWhole || mt < kd) {
            unsigned a[4];
            ldsm_x4_t(a, sv + sw128<SR>(tok, mt * 2 + ((lane >> 3) & 1)));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma16<F16>(acc[mt][nt], a, pb[t][nt][0], pb[t][nt][1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bEmpty + 8 * st);
    }
    // this warp's l over its lanes (m is the same on them already)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        l[nt][0] += __shfl_xor_sync(0xffffffffu, l[nt][0], o);
        l[nt][1] += __shfl_xor_sync(0xffffffffu, l[nt][1], o);
      }
    bar_sync(1, kWarps * 32);   // every stage consumed: the stages are free
#pragma unroll
    for (int mt = 0; mt < kK; ++mt)
      if (kWhole || mt < kd)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rAcc[(warp * R + nt * 8 + 2 * tig + (e & 1)) * D + mt * 16 + gq +
                 (e >> 1) * 8] = acc[mt][nt][e];
    if (gq == 0)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          rM[warp * R + nt * 8 + 2 * tig + j] = m[nt][j];
          rL[warp * R + nt * 8 + 2 * tig + j] = l[nt][j];
        }
  }
  __syncthreads();

  // the warps' states, merged in warp order
  for (int i = tid; i < gr * d; i += kThreads) {
    const int g = i / d, e = i % d;
    float mx = kNegInf;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, rM[v * R + g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float f = exp2_ftz(rM[v * R + g] - mx);
      l += f * rL[v * R + g];
      a += f * rAcc[(v * R + g) * D + e];
    }
    const size_t qrow = row0 + g;
    if (n_live_splits == 1) {
      store_f32(out, w.q_dtype, qrow * d + e, a / l);
    } else {
      part_acc[(qrow * nsplit + split) * d + e] = a;
      if (e == 0) {
        part_ml[(qrow * nsplit + split) * 2] = mx;
        part_ml[(qrow * nsplit + split) * 2 + 1] = l;
      }
    }
  }
  if (n_live_splits == 1) return;

  // the last live split of this (slot, kv head, row chunk) to finish
  // merges them, as #7's
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + ((size_t)slot * kvh + kh) * w.rchunks + rc;
    const int last = atomicAdd(ctr, 1) == n_live_splits - 1;
    if (last) *ctr = 0;   // ready for the next launch
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const int ns = n_live_splits;
  float* wM = rAcc;                   // [gr][ns] m, then the weights
  float* wL = wM + R * ns;            // [gr][ns] l
  float* wSum = wL + R * ns;          // [gr]
  for (int i = tid; i < gr * ns; i += kThreads) {
    const float* ml = part_ml + ((row0 + i / ns) * nsplit + i % ns) * 2;
    wM[i] = __ldcg(ml);
    wL[i] = __ldcg(ml + 1);
  }
  __syncthreads();
  if (tid < gr) {
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
  for (int i = tid; i < gr * d; i += kThreads) {
    const int g = i / d, e = i % d;
    const size_t qrow = row0 + g;
    const float* pa = part_acc + qrow * nsplit * d + e;
    float a = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < ns; ++sp)
      a += wM[g * ns + sp] * __ldcg(pa + (size_t)sp * d);
    store_f32(out, w.q_dtype, qrow * d + e, a / wSum[g]);
  }
}

// #7's instance (OP = kDecBf16) and, for OP != kDecBf16, the wide modes
// (G the rows a block, PS the rows a stage, a WideDecode in scale_log2's
// place: paged_wide_body)
template <int G, int D, int PS, bool DENSE = false, int OP = kDecBf16>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const bf16* __restrict__ q,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, bf16* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ counters, int kvh, int mpps, int pps,
                    int window,
                    const typename DecodeLast<OP>::type scale_log2) {
  if constexpr (OP != kDecBf16) {
    static_assert(!DENSE, "a wide mode reads the pool");
    paged_wide_body<OP, G, D, PS>(&kmap, &vmap, q, page_table, lengths, out,
                                  part_acc, part_ml, counters, kvh, mpps,
                                  pps, window, scale_log2);
  } else {
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
}

// The tensor map of a [n, kvh, rows, d] bf16 view (rows contiguous,
// `head_stride` elements from head to head, `outer_stride` from one
// outer index to the next) for boxes of [box_rows][64] columns in the
// 128-byte swizzle: paged decode's one layer of the pool ([pages, kvh,
// ps, d], head stride ps * d, boxes of a page) and the dense decode's
// one layer of the slot cache ([slots, kvh, S, d], boxes of PS rows).
// `kind` 1 maps an fp16 view the same way, 2 an fp32 view in boxes of
// [box_rows][32] columns (128 bytes a row too): the wide modes' pools.
int kv_map(CUtensorMap* map, const void* p, int d, long long rows, int kvh,
           long long n, long long head_stride, long long outer_stride,
           int box_rows, int kind = 0) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t e = kind == 2 ? 4 : 2;   // bytes an element
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)kvh, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)d * e,
                                 (cuuint64_t)head_stride * e,
                                 (cuuint64_t)outer_stride * e};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / e), (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      kind == 2   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : kind == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 4,
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
  int d, kvh, box_rows, kind;
  bool operator==(const MapKey& o) const {
    return p == o.p && rows == o.rows && n == o.n &&
           head_stride == o.head_stride && outer_stride == o.outer_stride &&
           d == o.d && kvh == o.kvh && box_rows == o.box_rows &&
           kind == o.kind;
  }
};
constexpr int kMapCache = 256;
std::mutex g_map_mu;
MapKey g_map_key[kMapCache];
CUtensorMap g_map[kMapCache];
int g_map_used = 0, g_map_next = 0;

int cached_kv_map(CUtensorMap* map, const void* p, int d, long long rows,
                  int kvh, long long n, long long head_stride,
                  long long outer_stride, int box_rows, int kind = 0) {
  const MapKey key{p, rows, n, head_stride, outer_stride,
                   d, kvh, box_rows, kind};
  std::lock_guard<std::mutex> lock(g_map_mu);
  for (int i = 0; i < g_map_used; ++i)
    if (g_map_key[i] == key) {
      *map = g_map[i];
      return 0;
    }
  const int e = kv_map(map, p, d, rows, kvh, n, head_stride, outer_stride,
                       box_rows, kind);
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

// The rows of a wide mode's box: the largest multiple of 8 that divides
// the page size ps and is at most the stage's sr rows (0: none does).
inline int wide_box_rows(int ps, int sr) {
  for (int r = sr / 8 * 8; r >= 8; r -= 8)
    if (ps % r == 0) return r;
  return 0;
}

// One launch of wide mode OP at R rows a block, head-dim bucket D and
// stages of SR rows: the tensor maps of the pool's layer view (its real
// d, boxes of wide_box_rows(ps, SR) rows), one block per (split, kv head
// and row chunk, slot).
template <int OP, int R, int D, int SR>
int launch_paged_wide(const PagedWideTcArgs& a, cudaStream_t stream) {
  using S = WideSmem<OP, R, D, SR>;
  const int seg = wide_box_rows(a.ps, SR);
  const int rchunks = (a.group + R - 1) / R;
  if (!seg || a.rows != R || a.d < 1 || a.d > D ||
      a.d * S::kE % 16 || a.page_stride * S::kE % 16 ||
      a.nsplit > S::kMaxSplits || (long long)a.kvh * rchunks > 65535 ||
      a.q_planes < 1 || a.q_planes > 2)
    return (int)cudaErrorInvalidValue;
  constexpr int kind = OP == kDecWideF32 ? 2 : OP == kDecWideF16 ? 1 : 0;
  CUtensorMap km, vm;
  int e = cached_kv_map(&km, a.k, a.d, a.ps, a.kvh, a.pages,
                        (long long)a.ps * a.d, a.page_stride, seg, kind);
  if (!e) e = cached_kv_map(&vm, a.v, a.d, a.ps, a.kvh, a.pages,
                            (long long)a.ps * a.d, a.page_stride, seg, kind);
  if (e) return e;
  static std::atomic<unsigned> allowed{0};
  e = allow_smem(paged_decode_kernel<R, D, SR, false, OP>, S::bytes,
                 allowed);
  if (e) return e;
  const WideDecode w{a.d,     a.ps,    seg,       a.ps / seg, SR / seg,
                     a.group, rchunks, a.q_dtype, a.q_planes, a.scale_log2};
  const dim3 grid(a.nsplit, a.kvh * rchunks, a.slots);
  paged_decode_kernel<R, D, SR, false, OP>
      <<<grid, kThreads, S::bytes, stream>>>(
          km, vm, static_cast<const bf16*>(a.q), a.pt, a.lengths,
          static_cast<bf16*>(a.out), a.part_acc, a.part_ml, a.counters,
          a.kvh, a.mpps, a.pps, a.mpps * a.ps, w);
  return (int)cudaGetLastError();
}

// The wide modes' instances, by head dim and rows a block: 16-bit pools
// at the buckets 64, 128 and 256 with 32, 16 and 8 rows a block at most
// (R x D <= 2048: a warp's O^T in 64 registers a thread), 8, 16 or 32
// rows (the group rounded up to n = 8 tiles), stages of 64 rows; fp32
// pools at 64 and 128, 8 rows, stages of 32 rows (16 and 32 KB).
template <int OP>
int launch_paged_wide_d(const PagedWideTcArgs& a, cudaStream_t s) {
  if constexpr (OP == kDecWideF32) {
    if (a.d <= 64) return launch_paged_wide<OP, 8, 64, 32>(a, s);
    if (a.d <= 128) return launch_paged_wide<OP, 8, 128, 32>(a, s);
  } else if (a.d <= 64) {
    if (a.rows == 8) return launch_paged_wide<OP, 8, 64, 64>(a, s);
    if (a.rows == 16) return launch_paged_wide<OP, 16, 64, 64>(a, s);
    return launch_paged_wide<OP, 32, 64, 64>(a, s);
  } else if (a.d <= 128) {
    if (a.rows == 8) return launch_paged_wide<OP, 8, 128, 64>(a, s);
    return launch_paged_wide<OP, 16, 128, 64>(a, s);
  } else if (a.d <= 256) {
    return launch_paged_wide<OP, 8, 256, 64>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
