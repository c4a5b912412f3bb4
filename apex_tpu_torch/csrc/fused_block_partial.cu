// Fused-block decode, a tensor-parallel rank's attention half, for Hopper
// (sm_90a): one launch a layer for every slot; bf16 in, fp32 math.
//
// Replaces: apex_tpu/ops/paged_attention.py :: _fused_block_kernel with
// partial_out=True (launched by fused_block_decode through
// pl.pallas_call; the early return after the o product).  Same function
// and rounding points as the whole layer's attention half
// (csrc/fused_block_decode.cu): h1 = norm1(x) in fp32 (RMSNorm; GPT:
// LayerNorm with fp32 affine); q, k, v = bf16(h1) @ W with fp32 sums
// (GPT: + the fp32 biases); RoPE in fp32 (LLaMA); scores bf16(q) . k over
// the slot's live pages in a base-2 online softmax, bf16(p) . v with the
// normaliser from fp32 p; the current token folded in as one more column
// from the unrounded fp32 q, k and v; y = bf16(bf16(ctx) @ wo) with NO
// residual and no bo: the caller all-reduces the ranks' y.  The rank's
// weights are column slices of wq, wk, wv and a row slice of wo, so h d
// is hidden / tp (Llama-3-8B at tp = 2: wq [4096, 2048], wo [2048, 4096],
// 16 heads over 4 kv heads).  The current token's k (after RoPE) and v
// leave as bf16 for the caller's pool append.
//
// What bounds it on the H100: bytes (a Llama-3-8B tp = 2 shard reads 41.9
// MB of weights plus its heads' live k/v, ~0.019 ms at 3.35 TB/s).  At a
// shard this small the whole layer's design (fused_block_kernel: phases
// behind grid-wide barriers) pays mostly fixed costs: every barrier waits
// for the slowest block, every phase starts its loads cold, and its
// attention phase is cp.async staging with CUDA-core scores.  So this
// kernel has no grid barrier and no phase:
// - One persistent cooperative grid (one block an SM, every block
//   resident) takes ITEMS in topological order: the q/k/v GEMV items (a
//   256-column tile x a chunk of input rows; each block's first item is
//   its own index, the rest come from one device counter), attention
//   items (slot, kv head, run of pages), then the o GEMV items.  (norm1's
//   statistics, 2 hidden bytes a slot, every block computes as it
//   starts.)  An item waits only on the counters of what it reads:
//   producers publish with a release reduction (red.release.gpu by one
//   thread after a block barrier), a consumer's thread spins on an
//   ld.acquire.gpu with __nanosleep.  Every block is resident and an item
//   depends only on items dealt before it, so the smallest unfinished item
//   can always run: no deadlock.  (A wait past 4 s traps, so a broken
//   launch fails instead of hanging the card.)
// - No sum has a phase of its own, and every sum runs in a fixed order, so
//   the kernel repeats bit for bit: an attention item sums the q/k/v
//   product's split-K partials of the rows it reads in chunk order and
//   applies RoPE (GPT: the biases) itself; the last attention item of a
//   (slot, kv head) to finish (an acquire-release count) merges the splits
//   in split order and folds the current token, writing bf16 ctx once,
//   which the o items read as their activations; the last chunk of an o
//   tile to finish sums the tile's partials in chunk order into y.
// - Attention runs on #7's machinery (csrc/kv_decode.cuh): pages come by
//   TMA boxes (4-d maps over the strided pool view) into the ring, scores
//   S^T = K Q^T and O^T = V^T P^T on mma.sync with the tokens on M and the
//   kv head's G query rows as the n = 8 columns; each warp keeps its own
//   softmax state, merged once.  Items are sized on the device from the
//   lengths: runs of boxes doubled until there is at most one item an SM.
// - A producer warp deals the block's next item and issues its loads
//   while the eight consumer warps finish the current one: the weight
//   tiles and the pages depend on nothing computed in the launch, so an
//   item's loads stream while its block waits on its dependencies.  The
//   producer deals the next item only once the consumers have passed the
//   current item's wait, so a waiting block holds one item and the rest go
//   to blocks that can start them.  The weights and pages, read once, load
//   with an L2 evict-first policy.  The ring is 32 KB slots (a GEMV stage:
//   64 weight rows x 256 columns; an attention stage: 64 tokens of k and v
//   at head dim 128, 128 at 64): 6 at query groups 2 and 4, 4 at group 1
//   and at group 8, whose attention scratch leaves no room for more.
// The sums over a runtime count of partials load in predicated batches of
// 8 (all in flight), and the lengths load before the norm statistics:
// both measured faster.  Measured on the H100 and left out (slower at the
// tp = 2 shards): each q/k/v tile's partials summed by its last chunk (a
// block's serial sums on the attention items' path); norm1 statistics as
// an item of their own (x's loads queued behind every block's weights);
// L2 prefetches of a dealt item's loads; the producer holding its first
// loads (or all but the first stage) until the statistics; two blocks an
// SM with 2 slots; attention items two an SM, or one per two SMs, or
// sized by single stages; slots with the most items dealt first; a
// separate fence before each count.
// Page geometry: a box is `seg` rows of one page (the largest multiple of
// 8 dividing the page and at most a stage; a page that is not a multiple
// of 8 rows takes boxes of its size rounded up to 8, the rows past the
// page zero-filled by the TMA and masked), `nseg` boxes a stage.  Rows
// past the length are masked and their v rows zeroed in shared memory.
//
// Counters: g_pctr, in device memory, zero when no launch runs: the last
// block to leave resets every counter it used, so the next launch on the
// stream finds them zero at no cost (no memset node).  Two launches of
// this kernel must therefore not run at once on one device.
//
// Plain C interface (loaded with ctypes): apex_fused_block_decode_partial
// and apex_fused_block_decode_gpt_partial launch on the caller's stream
// and return cudaGetLastError(); with a null workspace they only report
// the workspace bytes they need.

#include "kv_decode.cuh"
#include "fused_block_common.cuh"

namespace {

constexpr int kCons = kWarps * 32;     // consumer threads (eight warps)
constexpr int kMaxRing = 6;            // ring slots, at most (PParams::ring)
constexpr int kSlotBytes = 32768;      // a ring slot
constexpr int kPSlots = 8;             // slots a GEMV pass (the n = 8 side)
constexpr int kPTile = 256;            // output columns a GEMV item
constexpr int kPRows = 64;             // weight rows a GEMV stage
constexpr int kPBox = kPRows * 128;    // one [64 rows][64 columns] box
constexpr int kPMaxChunk = 512;        // input rows a GEMV item, at most
constexpr int kMaxSplits = 128;        // attention items a (slot, kv head)
constexpr int kPBlocksPerSM = 1;       // the ring and scratch fill an SM
// the sums over a runtime count of partials issue their loads in
// predicated batches of kBatch, all in flight before the adds
constexpr int kBatch = 8;
// a counter wait's sleep between polls (ns)
constexpr int kPollNs = 32;
constexpr int kCounters = 8192;
constexpr unsigned long long kHangNs = 4000000000ull;
static_assert(kPTile == 4 * 64 && 4 * kPBox == kSlotBytes,
              "a GEMV stage is four [64][64] boxes");
static_assert(kPTile == 32 * kWarps, "a warp owns 32 columns of the tile");

// the counters: the deal, the blocks that left, then one a q/k/v tile, a
// (slot, kv head)'s attention items, a kv head's merged slots and an o
// tile
constexpr int kDeal = 0, kExit = 1, kQkv = 2;
__device__ unsigned g_pctr[kCounters];

// the phase clock: [0] the start, [1] the last block's norm1 statistics,
// [2..4] the last end of a q/k/v, attention and o item, [5] the last
// block's exit; then for each of the three item classes the sums over its
// items of the time spent working and waiting on counters, and its count
constexpr int kClsStats = 1, kClsQkv = 2, kClsAttn = 3, kClsO = 4,
              kClockEnd = 5, kClockSums = 6;

struct PParams {
  const bf16* x;            // [slots, hidden]
  const float* cos;         // [slots, d] RoPE rows (LLaMA)
  const float* sin;
  const void* ln1_w;        // [hidden], bf16 or fp32 (ln_fp32; GPT fp32)
  const float* ln1_b;       // GPT: [hidden]
  const float* bq;          // GPT: [h d], [kvh d], [kvh d]
  const float* bk;
  const float* bv;
  const int* page_table;    // [slots, mpps]
  const int* lengths;       // [slots], before this token's append
  bf16* y;                  // [slots, hidden]
  bf16* kt;                 // [slots, kvh, d]
  bf16* vt;
  // workspace
  float* p_qkv;             // [ks_qkv, slots, h d + 2 kvh d]
  float* part_acc;          // [slots h, nsplit, d]
  float* part_ml;           // [slots h, nsplit, 2]
  bf16* ctx;                // [slots, h d]
  float* p_o;               // [ks_o, slots, hidden]
  unsigned* ctr;            // g_pctr
  unsigned long long* clock;  // optional [15], see kClockSums
  int slots, hidden, kvh, ps, mpps;
  int ks_qkv, ch_qkv, ks_o, ch_o;
  int seg, spp, nseg, bpi_min, nsplit;
  int ln_fp32, scr_off, sl_off, ring;
  float eps, scale_log2;
};

// the weights' 2-d maps (boxes of 64 rows x 64 columns) and the pool
// view's 4-d maps (boxes of seg rows x 64 columns of one page and kv head)
struct PMaps {
  CUtensorMap q, k, v, o, kp, vp;
};

__device__ __forceinline__ void cons_sync() { bar_sync(1, kCons); }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// spin (one thread) until *c reaches want; trap after kHangNs
__device__ __forceinline__ void wait_count(const unsigned* c, unsigned want) {
  if (ld_acquire(c) >= want) return;
  const unsigned long long t0 = globaltimer();
  for (;;) {
    __nanosleep(kPollNs);
    if (ld_acquire(c) >= want) return;
    if (globaltimer() - t0 > kHangNs) __trap();
  }
}

// publish the consumers' writes and count one: a release reduction by
// one thread after cons_sync (the barrier orders the other threads'
// writes before it, and a release is cumulative over them)
__device__ __forceinline__ void publish(unsigned* c) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(c)
               : "memory");
}

// publish, count one and learn whether this was the last of n (its
// acquire makes the others' writes visible after cons_sync)
__device__ __forceinline__ bool arrive_last(unsigned* c, int n) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(c)
               : "memory");
  return (int)old == n - 1;
}

__device__ __forceinline__ void mbar_arrive_n(uint32_t bar, int n) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(n)
               : "memory");
}

struct PSeg {
  const CUtensorMap* tm;  // the [K, n] row-major ([in, out]) weight
  int n;                  // columns
  int col_off;            // first column of this weight in the partial rows
};

// One GEMV item: segment si, its column tile c0, chunk kc of the input
// rows [k0, k1), nst ring stages of kPRows rows a slot pass; tile: the
// tile's index over all segments (its counter).  Items are dealt
// tile-fastest.
struct PItem {
  PSeg sg;
  int si, tile, c0, kc, k0, k1, nst;
};

__device__ __forceinline__ int ptiles(int n) { return (n + kPTile - 1) / kPTile; }

__device__ __forceinline__ PItem pgemv_item(const PSeg* segs, int total,
                                            int K, int chunk, int it) {
  int t = it % total, si = 0;
  PItem g;
  g.tile = t;
  while (t >= ptiles(segs[si].n)) t -= ptiles(segs[si++].n);
  g.sg = segs[si];
  g.si = si;
  g.c0 = t * kPTile;
  g.kc = it / total;
  g.k0 = g.kc * chunk;
  g.k1 = min(K, g.k0 + chunk);
  g.nst = (g.k1 - g.k0 + kPRows - 1) / kPRows;
  return g;
}

// the geometry every block derives alike
struct Geo {
  int S, H, h, hd, kvd, nqkv;
  int tq, n_qkv, n_att, to, n_o, total;
  int perkh, bpi;
  int c_merge, c_ctx, c_o, nctr;
};

// TMA loads with an L2 cache policy: the weights and pages are read once a
// launch, so they go first (createpolicy ... evict_first) and the
// partials, ctx and the counters stay in L2
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}
__device__ __forceinline__ void tma_load2_hint(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int c, int r,
                                               uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar), "l"(pol)
      : "memory");
}
__device__ __forceinline__ void tma_load4_hint(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int c, int r,
                                               int h, int pg, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(h), "r"(pg),
      "r"(bar), "l"(pol)
      : "memory");
}

// The producer's stages of a GEMV item: for each pass of 8 slots, nst
// stages of up to four boxes; lane 0 issues, every lane keeps the count.
__device__ __forceinline__ void produce_gemv(const PItem& g, int slots,
                                             unsigned& ring, uint32_t rbase,
                                             uint32_t full0, uint32_t empty0,
                                             int nr) {
  const int lane = threadIdx.x & 31;
  const int boxes = min(4, (g.sg.n - g.c0 + 63) / 64);
  for (int sb = 0; sb < slots; sb += kPSlots)
    for (int st = 0; st < g.nst; ++st) {
      const unsigned q = ring++, s = q % nr;
      if (q >= nr) mbar_wait(empty0 + 8 * s, ((q / nr) - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full0 + 8 * s, boxes * kPBox);
        const uint64_t pol = evict_first_policy();
        for (int b = 0; b < boxes; ++b)
          tma_load2_hint(rbase + s * kSlotBytes + b * kPBox, g.sg.tm,
                         full0 + 8 * s, g.c0 + b * 64, g.k0 + st * kPRows,
                         pol);
      }
      __syncwarp();
    }
}

// An attention item: kv head kh of `slot`, its boxes [split bpi, + nbi).
// The items are dealt slot by slot (sPre: the items of one kv head before
// each slot), a slot's split by split with its kv heads side by side.
struct AItem {
  int kh, slot, split, nbi, nst, ni;
};

__device__ __forceinline__ AItem attn_item(int j, const Geo& g, const int* sPre,
                                           const int* sNbox, int kvh, int nseg) {
  AItem a;
  int lo = 0, hi = g.S;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (sPre[mid] * kvh <= j) lo = mid;
    else hi = mid;
  }
  const int r = j - sPre[lo] * kvh;
  a.slot = lo;
  a.kh = r % kvh;
  a.split = r / kvh;
  a.ni = sPre[lo + 1] - sPre[lo];
  a.nbi = max(0, min(g.bpi, sNbox[a.slot] - a.split * g.bpi));
  a.nst = (a.nbi + nseg - 1) / nseg;
  return a;
}

// The producer's stages of an attention item: each stage nb boxes of seg
// rows of k and of v, D / 64 chunks each (at most 32 boxes: one a lane),
// the page of each box read from the page table by its lane.
template <int D>
__device__ __forceinline__ void produce_attn(const AItem& a, const PParams& p,
                                             const PMaps& tm, int bpi,
                                             unsigned& ring, uint32_t rbase,
                                             uint32_t full0, uint32_t empty0) {
  constexpr int ST = 8192 / D, kChunks = D / 64;
  constexpr int kOperand = ST * D * 2, kChunkB = ST * 128;
  const int lane = threadIdx.x & 31;
  const int* row = p.page_table + (size_t)a.slot * p.mpps;
  for (int i = 0; i < a.nst; ++i) {
    const unsigned q = ring++, s = q % p.ring;
    const int nb = min(p.nseg, a.nbi - i * p.nseg);
    const int nops = nb * kChunks * 2;
    int page = 0, r = 0, col = 0;
    uint32_t dst = 0;
    if (lane < nops) {
      const int b = lane / (2 * kChunks), c = (lane >> 1) % kChunks;
      const int B = a.split * bpi + i * p.nseg + b;
      const int pg = B / p.spp;
      page = __ldg(row + pg);
      r = (B - pg * p.spp) * p.seg;
      col = c * 64;
      dst = (lane & 1) * kOperand + c * kChunkB + b * p.seg * 128;
    }
    if (q >= p.ring) mbar_wait(empty0 + 8 * s, ((q / p.ring) - 1) & 1);
    if (lane == 0) mbar_expect_tx(full0 + 8 * s, nops * p.seg * 128);
    __syncwarp();
    if (lane < nops)
      tma_load4_hint(rbase + s * kSlotBytes + dst, lane & 1 ? &tm.vp : &tm.kp,
                     full0 + 8 * s, col, r, a.kh, page, evict_first_policy());
    __syncwarp();
  }
}

// A = bf16(ctx), the o product's input (merged and folded already)
struct BuildCtx {
  const bf16* ctx;
  int hd;
  __device__ float4 operator()(int slot, int k) const {
    return bf16x4(__ldcg(reinterpret_cast<const uint2*>(
        ctx + (size_t)slot * hd + k)));
  }
};

// The consumers' part of a GEMV item: for each pass of 8 slots, the
// activations [8 slots][nst * 64 rows] as bf16 (zero past k1 and the
// last slot), then the stages: per 16 rows ldmatrix.trans turns the
// [in, out] rows (read through the boxes' 128-byte swizzle) into the
// m16n8k16 A operand and the tensor cores multiply it into the 8 slots;
// each warp owns 32 of the tile's 256 columns; the partial of chunk kc
// is stored for its readers (the attention items, or the o tile's last
// chunk).
template <class Build>
__device__ void consume_gemv(const PItem& g, int slots, float* part, int ldo,
                             bf16* sX, unsigned& ring, uint32_t rbase,
                             uint32_t full0, uint32_t empty0,
                             const Build& build, int nr) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int width = g.nst * kPRows;
  const int ldx = width + 8;   // bf16 per A row (a 4-bank shift per slot)
  for (int sb = 0; sb < slots; sb += kPSlots) {
    const int groups = width / 4 * kPSlots;
    for (int i0 = tid; i0 < groups; i0 += 4 * kCons) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kCons;
        const int s = i / (width / 4), k = (i % (width / 4)) * 4;
        v[u] = (i < groups && sb + s < slots && g.k0 + k < g.k1)
                   ? build(sb + s, g.k0 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kCons;
        if (i < groups) {
          uint2 packed;
          packed.x = pack_bf16(v[u].x, v[u].y);
          packed.y = pack_bf16(v[u].z, v[u].w);
          *reinterpret_cast<uint2*>(sX + (i / (width / 4)) * ldx +
                                    (i % (width / 4)) * 4) = packed;
        }
      }
    }
    cons_sync();
    float acc[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
    for (int st = 0; st < g.nst; ++st) {
      const unsigned q = ring++, s = q % nr;
      mbar_wait(full0 + 8 * s, (q / nr) & 1);
      const uint32_t ws = rbase + s * kSlotBytes;
#pragma unroll
      for (int kk = 0; kk < kPRows; kk += 16) {
        const bf16* xr = sX + gq * ldx + st * kPRows + kk + 2 * tig;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(xr);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(xr + 8);
        const int r = kk + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int c = warp * 32 + m * 16 + ((lane >> 3) & 1) * 8;
          unsigned a[4];
          ldmatrix_x4_trans(a, ws + (c >> 6) * kPBox + r * 128 +
                                   ((((c & 63) >> 3) ^ (r & 7)) << 4));
          mma_bf16(acc[m], a, b0, b1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    // rows of acc: columns gq and gq + 8 of each 16; its columns: slots
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = g.c0 + warp * 32 + m * 16 + gq + (j >> 1) * 8;
        const int slot = sb + 2 * tig + (j & 1);
        if (col < g.sg.n && slot < slots)
          __stcg(part + ((size_t)g.kc * slots + slot) * ldo + g.sg.col_off +
                     col,
                 acc[m][j]);
      }
    cons_sync();   // A is rebuilt by the next pass
  }
}

// The o tile's finisher: y = bf16(the split-K sum in chunk order), no
// residual, no bias
__device__ void finish_o(const PParams& p, const PItem& g) {
  const int cols = min(kPTile, p.hidden - g.c0);
  const int q4 = cols / 4;
  const size_t stride = (size_t)p.slots * p.hidden;
  for (int i = threadIdx.x; i < p.slots * q4; i += kCons) {
    const int slot = i / q4, col = g.c0 + (i % q4) * 4;
    const float* part = p.p_o + (size_t)slot * p.hidden + col;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cb = 0; cb < p.ks_o; cb += kBatch) {
      float4 xs[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (cb + u < p.ks_o)
          xs[u] = __ldcg(reinterpret_cast<const float4*>(
              part + (size_t)(cb + u) * stride));
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (cb + u < p.ks_o) {
          a.x += xs[u].x; a.y += xs[u].y; a.z += xs[u].z; a.w += xs[u].w;
        }
    }
    *reinterpret_cast<uint2*>(p.y + (size_t)slot * p.hidden + col) =
        make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  }
}

// the attention consumers' shared memory (the scratch region)
template <int G, int D>
struct AttnScr {
  // [8][G][D] the warps' states; first the q/k/v sums' parts
  static constexpr int acc = 0;
  static constexpr int m = acc + (kWarps * G * D > 8 * kCons ? kWarps * G * D
                                                            : 8 * kCons);
  static constexpr int l = m + kWarps * G;               // [8][G]
  static constexpr int f = l + kWarps * G;               // [8][G] weights
  static constexpr int snew = f + kWarps * G;            // [G]
  static constexpr int mx = snew + G;                    // [G]
  static constexpr int lsum = mx + G;                    // [G]
  static constexpr int q = lsum + G;                     // [G][D]
  static constexpr int k = q + G * D;                    // [D]
  static constexpr int v = k + D;                        // [D]
  static constexpr int w = v + D;                        // [G][splits]
  static constexpr int floats(int nsplit) { return w + G * nsplit; }
};

// ctx of rows g < G of (slot, kv head) from (a, mx, l) and the current
// token: ctx = bf16((a alpha + p_new v) / (l alpha + p_new))
template <int G, int D>
__device__ __forceinline__ void fold_store(const PParams& p, const Geo& geo,
                                           const AItem& a, const float* sc,
                                           int g, int e, float acc) {
  using A = AttnScr<G, D>;
  const float s_new = sc[A::snew + g], mx = sc[A::mx + g], l = sc[A::lsum + g];
  const float m_new = fmaxf(mx, s_new);
  const float alpha = exp2f(mx - m_new), p_new = exp2f(s_new - m_new);
  const float v = sc[A::v + e];
  p.ctx[(size_t)a.slot * geo.hd + ((size_t)a.kh * G + g) * D + e] =
      __float2bfloat16((acc * alpha + p_new * v) / (l * alpha + p_new));
}

// the current token's score against each row's fp32 q (warps 0..G-1)
template <int G, int D>
__device__ __forceinline__ void new_scores(const PParams& p, float* sc) {
  using A = AttnScr<G, D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= G) return;
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < D / 32; ++j)
    dot += sc[A::q + warp * D + lane + 32 * j] * sc[A::k + lane + 32 * j];
  dot = warp_sum(dot);
  if (lane == 0) sc[A::snew + warp] = dot * p.scale_log2;
}

// q of the item's G heads and k, v of its kv head for its slot: the q/k/v
// product's split-K partials summed in chunk order, RoPE on q and k
// (half rotation: element e pairs with e + d/2; GPT: the biases), into
// the scratch in fp32; split 0 of each (slot, kv head) also stores k and
// v as bf16 for the caller's append.  (There is no phase for these sums:
// every attention item sums what it reads.)  A task is four elements and
// their RoPE partners; the chunks are cut into `parts` runs, each run a
// thread with all its loads in flight, and the runs' sums are added in
// run order.
template <int G, int D, bool GPT>
__device__ void qkv_rows(const PParams& p, const Geo& geo, const AItem& a,
                         float* sc) {
  using A = AttnScr<G, D>;
  constexpr int kHalf = D / 2, kTasks = (G + 2) * kHalf / 4;
  constexpr int kParts = kCons / kTasks < 8 ? kCons / kTasks : 8;
  static_assert(kParts >= 1, "a thread a task at least");
  const int tid = threadIdx.x;
  const size_t stride = (size_t)p.slots * geo.nqkv;
  const float* part = p.p_qkv + (size_t)a.slot * geo.nqkv;
  auto col_of = [&](int t) {
    const int r = t / (kHalf / 4), e = (t % (kHalf / 4)) * 4;
    return r < G ? (a.kh * G + r) * D + e
                 : geo.hd + (r - G) * geo.kvd + a.kh * D + e;
  };
  if (tid < kTasks * kParts) {
    const int t = tid % kTasks, run = tid / kTasks;
    const int per = (p.ks_qkv + kParts - 1) / kParts;
    const int c0 = run * per, c1 = min(p.ks_qkv, c0 + per);
    const float* src = part + col_of(t);
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    for (int cb = c0; cb < c1; cb += kBatch) {
      float4 xs[kBatch], ys[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (cb + u < c1) {
          const float* q = src + (size_t)(cb + u) * stride;
          xs[u] = __ldcg(reinterpret_cast<const float4*>(q));
          ys[u] = __ldcg(reinterpret_cast<const float4*>(q + kHalf));
        }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (cb + u < c1) {
          lo.x += xs[u].x; lo.y += xs[u].y; lo.z += xs[u].z; lo.w += xs[u].w;
          hi.x += ys[u].x; hi.y += ys[u].y; hi.z += ys[u].z; hi.w += ys[u].w;
        }
    }
    float4* out = reinterpret_cast<float4*>(sc + A::acc) + 2 * tid;
    out[0] = lo;
    out[1] = hi;
  }
  cons_sync();
  if (tid < kTasks) {
    const int r = tid / (kHalf / 4), e = (tid % (kHalf / 4)) * 4;
    const int si = r < G ? 0 : r - G + 1;     // 0 q, 1 k, 2 v
    float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
    for (int run = 0; run < kParts; ++run) {
      const float* v = sc + A::acc + 8 * (run * kTasks + tid);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] += v[j];
        hi[j] += v[4 + j];
      }
    }
    if constexpr (GPT) {
      const float* bias = si == 0 ? p.bq : si == 1 ? p.bk : p.bv;
      const int bc = (si == 0 ? (a.kh * G + r) : a.kh) * D + e;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] += __ldg(bias + bc + j);
        hi[j] += __ldg(bias + bc + kHalf + j);
      }
    } else if (si < 2) {
      const float* cs = p.cos + (size_t)a.slot * D;
      const float* sn = p.sin + (size_t)a.slot * D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = lo[j], y = hi[j];
        lo[j] = x * __ldg(cs + e + j) + -y * __ldg(sn + e + j);
        hi[j] = y * __ldg(cs + e + kHalf + j) + x * __ldg(sn + e + kHalf + j);
      }
    }
    float* dst = sc + (si == 0 ? A::q + r * D : si == 1 ? A::k : A::v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[e + j] = lo[j];
      dst[e + kHalf + j] = hi[j];
    }
    if (si > 0 && a.split == 0) {
      bf16* o = (si == 1 ? p.kt : p.vt) + ((size_t)a.slot * p.kvh + a.kh) * D;
      *reinterpret_cast<uint2*>(o + e) =
          make_uint2(pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]));
      *reinterpret_cast<uint2*>(o + e + kHalf) =
          make_uint2(pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]));
    }
  }
}

// The consumers' part of an attention item: #7's product warps
// (csrc/kv_decode.cuh) over this item's stages, then the warps' states
// merged in warp order; one item a (slot, kv head) folds the current
// token and writes ctx at once, otherwise each writes its partial and the
// last to finish merges them in split order and folds.
template <int G, int D, bool GPT>
__device__ void consume_attn(const PParams& p, const Geo& geo, const AItem& a,
                             float* sc, unsigned& ring, uint32_t rbase,
                             uint32_t full0, uint32_t empty0, int* sFlag) {
  constexpr int ST = 8192 / D, kTiles = ST / 16;
  constexpr int kPW = kTiles < kWarps ? kTiles : kWarps;   // warps a stage
  constexpr int kGroups = kWarps / kPW;
  constexpr int kK = D / 16;
  constexpr int kOperand = ST * D * 2, kChunkB = ST * 128;
  static_assert(kTiles == kPW, "a warp takes one 16-token tile a stage");
  using A = AttnScr<G, D>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int len = min(p.lengths[a.slot], p.mpps * p.ps);
  const size_t row0 = (size_t)a.slot * geo.h + (size_t)a.kh * G;  // q row
  qkv_rows<G, D, GPT>(p, geo, a, sc);
  cons_sync();

  // q as the B operand of S^T = K Q^T: query row lane / 4 (zero past the
  // group) rounded to bf16, dims 2 (lane % 4) + {0, 1} and + 8 of each k16
  unsigned qf[kK][2];
#pragma unroll
  for (int ks = 0; ks < kK; ++ks) {
    if (gq < G) {
      const float* qr = sc + A::q + gq * D + ks * 16 + 2 * tig;
      qf[ks][0] = pack_bf16(qr[0], qr[1]);
      qf[ks][1] = pack_bf16(qr[8], qr[9]);
    } else {
      qf[ks][0] = qf[ks][1] = 0u;
    }
  }
  float acc[kK][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int mt = 0; mt < kK; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  const int grp = warp / kPW, r0 = (warp % kPW) * 16;
  for (int i = 0; i < a.nst; ++i) {
    const unsigned q = ring + i, s = q % p.ring;
    // a stage's group by its ring position, so a group keeps its slots
    if ((int)(q % kGroups) != grp) continue;
    mbar_wait(full0 + 8 * s, (q / p.ring) & 1);
    const uint32_t sk = rbase + s * kSlotBytes, sv = sk + kOperand;
    // which of this warp's 16 rows hold a live token
    const int nb = min(p.nseg, a.nbi - i * p.nseg);
    const int box0 = a.split * geo.bpi + i * p.nseg;
    bool ok = false;
    if (lane < 16) {
      const int r = r0 + lane, b = r / p.seg;
      if (b < nb) {
        const int B = box0 + b, pg = B / p.spp;
        const int rip = (B - pg * p.spp) * p.seg + (r - b * p.seg);
        ok = rip < p.ps && pg * p.ps + rip < len;
      }
    }
    const unsigned live = __ballot_sync(0xffffffffu, ok) & 0xffffu;
    if (live != 0xffffu) {
      // a row with no live token must still multiply p = 0 by finite
      // values, so this warp's such v rows are zeroed
      unsigned char* gv = reinterpret_cast<unsigned char*>(sc) -
                          p.scr_off + s * kSlotBytes + kOperand;
      for (int u = lane; u < 16 * (D / 8); u += 32) {
        const int rr = u / (D / 8);
        if (!((live >> rr) & 1)) {
          const int c = (u % (D / 8)) / 8, k = u % 8;
          *reinterpret_cast<uint4*>(gv + c * kChunkB + (r0 + rr) * 128 +
                                    k * 16) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      fence_async_smem();   // before the slot goes back to the copies
      __syncwarp();
    }
    // S^T: token rows r0 + (lane / 4, + 8), query rows 2 (lane % 4), + 1;
    // even and odd k steps into two sums (two chains of products)
    float sc4[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const int tok = r0 + (lane & 15);
#pragma unroll
      for (int ks = 0; ks < kK; ++ks) {
        unsigned af[4];
        ldsm_x4(af, sk + sw128<ST>(tok, ks * 2 + (lane >> 4)));
        mma16816(ks & 1 ? sb : sc4, af, qf[ks][0], qf[ks][1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool on = (live >> (gq + (e >> 1) * 8)) & 1;
      sc4[e] = on ? (sc4[e] + sb[e]) * p.scale_log2 : kNegInf;
    }
    float mx0 = fmaxf(sc4[0], sc4[2]), mx1 = fmaxf(sc4[1], sc4[3]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2_ftz(m0 - mn0), al1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // p (fp32 into l, bf16 into P^T: one movmatrix per 8 x 8 block)
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pr[e] = sc4[e] == kNegInf ? 0.f : exp2_ftz(sc4[e] - (e & 1 ? m1 : m0));
    l0 = l0 * al0 + (pr[0] + pr[2]);
    l1 = l1 * al1 + (pr[1] + pr[3]);
    const unsigned pb0 = movmatrix_t(pack_bf16(pr[0], pr[1]));
    const unsigned pb1 = movmatrix_t(pack_bf16(pr[2], pr[3]));
    // O^T += V^T P^T: dims 16 mt + lane / 4 (+ 8), query rows as above
    const int tok = r0 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
    for (int mt = 0; mt < kK; ++mt) {
      acc[mt][0] *= al0;
      acc[mt][1] *= al1;
      acc[mt][2] *= al0;
      acc[mt][3] *= al1;
      unsigned af[4];
      ldsm_x4_t(af, sv + sw128<ST>(tok, mt * 2 + ((lane >> 3) & 1)));
      mma16816(acc[mt], af, pb0, pb1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive_n(empty0 + 8 * s, kGroups);
  }
  ring += a.nst;
  // this warp's l over its lanes (m is the same on them already)
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  // the warps' states (rows < G) into the scratch
#pragma unroll
  for (int mt = 0; mt < kK; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int g = 2 * tig + (e & 1);
      if (g < G)
        sc[A::acc + (warp * G + g) * D + mt * 16 + gq + (e >> 1) * 8] =
            acc[mt][e];
    }
  if (gq == 0) {
    if (2 * tig < G) {
      sc[A::m + warp * G + 2 * tig] = m0;
      sc[A::l + warp * G + 2 * tig] = l0;
    }
    if (2 * tig + 1 < G) {
      sc[A::m + warp * G + 2 * tig + 1] = m1;
      sc[A::l + warp * G + 2 * tig + 1] = l1;
    }
  }
  cons_sync();
  // each row's warp weights 2^(m_w - M) and normaliser, in warp order
  if (tid < G) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sc[A::m + w * G + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2_ftz(sc[A::m + w * G + tid] - mx);
      sc[A::f + w * G + tid] = f;
      l += f * sc[A::l + w * G + tid];
    }
    sc[A::mx + tid] = mx;
    sc[A::lsum + tid] = l;
  }
  if (a.ni == 1) new_scores<G, D>(p, sc);
  cons_sync();
  if (a.ni == 1) {
    for (int i = tid; i < G * D; i += kCons) {
      const int g = i / D, e = i % D;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        v += sc[A::f + w * G + g] * sc[A::acc + (w * G + g) * D + e];
      fold_store<G, D>(p, geo, a, sc, g, e, v);
    }
    return;
  }
  // this split's partial, then the last split of the (slot, kv head)
  // merges them all in split order
  for (int i = tid; i < G * D; i += kCons) {
    const int g = i / D, e = i % D;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      v += sc[A::f + w * G + g] * sc[A::acc + (w * G + g) * D + e];
    const size_t pr = (row0 + g) * p.nsplit + a.split;
    __stcg(p.part_acc + pr * D + e, v);
    if (e == 0) {
      __stcg(p.part_ml + pr * 2, sc[A::mx + g]);
      __stcg(p.part_ml + pr * 2 + 1, sc[A::lsum + g]);
    }
  }
  cons_sync();
  if (tid == 0)
    *sFlag = arrive_last(p.ctr + geo.c_merge + a.slot * p.kvh + a.kh, a.ni);
  cons_sync();
  if (!*sFlag) return;
  new_scores<G, D>(p, sc);
  // each split's weight 2^(m_s - M) (0 for a split without a live
  // token), a warp a row and a lane a split, and the normaliser summed in
  // split order
  if (warp < G) {
    const float* ml = p.part_ml + (row0 + warp) * p.nsplit * 2;
    float mx = kNegInf;
    for (int s = lane; s < a.ni; s += 32)
      if (__ldcg(ml + 2 * s + 1) > 0.f) mx = fmaxf(mx, __ldcg(ml + 2 * s));
    mx = warp_max(mx);
    float l = 0.f;
    for (int s0 = 0; s0 < a.ni; s0 += 32) {
      const int s = s0 + lane;
      float w = 0.f, ls = 0.f;
      if (s < a.ni) {
        ls = __ldcg(ml + 2 * s + 1);
        if (ls > 0.f) w = exp2f(__ldcg(ml + 2 * s) - mx);
        sc[A::w + warp * p.nsplit + s] = w;
      }
      const int n = min(32, a.ni - s0);
      for (int j = 0; j < n; ++j) l += __shfl_sync(0xffffffffu, w * ls, j);
    }
    if (lane == 0) {
      sc[A::mx + warp] = mx;
      sc[A::lsum + warp] = l;
    }
  }
  cons_sync();
  for (int i = tid; i < G * D; i += kCons) {
    const int g = i / D, e = i % D;
    const float* pa = p.part_acc + (row0 + g) * p.nsplit * D + e;
    float v = 0.f;
    for (int sb = 0; sb < a.ni; sb += kBatch) {
      float xs[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (sb + u < a.ni) xs[u] = __ldcg(pa + (size_t)(sb + u) * D);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (sb + u < a.ni) v += sc[A::w + g * p.nsplit + sb + u] * xs[u];
    }
    fold_store<G, D>(p, geo, a, sc, g, e, v);
  }
}

// norm1's statistics of every slot (a warp a slot) into sR (and sMu):
// rsqrt(mean x^2 + eps); GPT: the mean, then rsqrt(mean (x - mean)^2 +
// eps).  Every block computes them as it starts (the consumer warps,
// while the producer deals and loads): x is 2 hidden bytes a slot, and
// an item that computed them once would hold every q/k/v item behind the
// weights' first loads.
template <bool GPT>
__device__ void norm1_stats(const PParams& p, float* sR, float* sMu) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kU = 16;  // a lane's 16-byte units in flight at once
  for (int s = warp; s < p.slots; s += kWarps) {
    const bf16* xr = p.x + (size_t)s * p.hidden;
    float mu = 0.f;
    if constexpr (GPT) {
      float sum = 0.f;
      for (int k0 = lane * 8; k0 < p.hidden; k0 += kU * 32 * 8) {
        uint4 raw[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int k = k0 + u * 32 * 8;
          raw[u] = k < p.hidden
                       ? __ldg(reinterpret_cast<const uint4*>(xr + k))
                       : make_uint4(0u, 0u, 0u, 0u);
        }

#pragma unroll
        for (int u = 0; u < kU; ++u) {
          float f[8];
          unpack8(raw[u], f);
#pragma unroll
          for (int j = 0; j < 8; ++j) sum += f[j];
        }
      }
      mu = warp_sum(sum) / p.hidden;
    }
    float ss = 0.f;
    for (int k0 = lane * 8; k0 < p.hidden; k0 += kU * 32 * 8) {
      uint4 raw[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * 32 * 8;
        raw[u] = k < p.hidden ? __ldg(reinterpret_cast<const uint4*>(xr + k))
                              : make_uint4(0u, 0u, 0u, 0u);
      }

#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (k0 + u * 32 * 8 >= p.hidden) break;
        float f[8];
        unpack8(raw[u], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) ss += (f[j] - mu) * (f[j] - mu);
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) {
      sR[s] = rsqrtf(ss / p.hidden + p.eps);
      sMu[s] = mu;
    }
  }
}

template <int G, int D, bool GPT>
__global__ void __launch_bounds__(kThreads, kPBlocksPerSM)
fused_block_partial_kernel(const PParams p, const __grid_constant__ PMaps tm) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  __shared__ __align__(8) unsigned long long bars[2 * kMaxRing + 6];
  __shared__ int sItem[2], sFlag, sBpi, sPerKh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (p.clock && blockIdx.x == 0 && tid == 0) p.clock[0] = globaltimer();
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * kMaxRing;
  const uint32_t qfull0 = empty0 + 8 * kMaxRing, qempty0 = qfull0 + 16;
  const uint32_t qstart0 = qempty0 + 16;   // the consumers passed the wait
  if (tid == 0) {
    for (int i = 0; i < p.ring; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kWarps);
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(qfull0 + 8 * k, 1);
      mbar_init(qempty0 + 8 * k, 1);
      mbar_init(qstart0 + 8 * k, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int S = p.slots;
  int* sNbox = reinterpret_cast<int*>(smem + p.sl_off);      // [S]
  int* sPre = sNbox + S;                                     // [S + 1]
  float* sR = reinterpret_cast<float*>(sPre + S + 1);        // [S]
  float* sMu = sR + S;                                       // [S]
  Geo geo;
  geo.S = S;
  geo.H = p.hidden;
  geo.h = p.kvh * G;
  geo.hd = geo.h * D;
  geo.kvd = p.kvh * D;
  geo.nqkv = geo.hd + 2 * geo.kvd;
  geo.tq = ptiles(geo.hd) + 2 * ptiles(geo.kvd);
  geo.n_qkv = p.ks_qkv * geo.tq;
  geo.to = ptiles(geo.H);
  geo.n_o = p.ks_o * geo.to;
  geo.c_merge = kQkv + geo.tq;
  geo.c_ctx = geo.c_merge + S * p.kvh;
  geo.c_o = geo.c_ctx + p.kvh;
  geo.nctr = geo.c_o + geo.to;
  geo.bpi = geo.perkh = geo.n_att = 0;
  geo.total = geo.n_qkv;   // until the attention items are planned
  // the attention items' geometry, from the lengths (the consumers find
  // it as they start; the producer reads it after barrier 2)
  auto attn_geo = [&]() {
    geo.bpi = sBpi;
    geo.perkh = sPerKh;
    geo.n_att = p.kvh * geo.perkh;
    geo.total = geo.n_qkv + geo.n_att + geo.n_o;
  };
  const PSeg s_qkv[3] = {{&tm.q, geo.hd, 0}, {&tm.k, geo.kvd, geo.hd},
                         {&tm.v, geo.kvd, geo.hd + geo.kvd}};
  const PSeg s_o[1] = {{&tm.o, geo.H, 0}};
  const uint32_t rbase = smem_addr(smem);
  unsigned ring = 0;

  if (warp == kWarps) {
    // the producer: deal the next item (each block's first is its own
    // index, then the counter's), hand it over, issue its loads; a q/k/v
    // item needs nothing the consumers find first
    bool geo_ready = false;
    for (int n = 0;; ++n) {
      const int k = n & 1;
      if (n >= 2) mbar_wait(qempty0 + 8 * k, ((n >> 1) - 1) & 1);
      if (n >= 1) mbar_wait(qstart0 + 8 * (k ^ 1), ((n - 1) >> 1) & 1);
      int it = blockIdx.x;
      if (n > 0) {
        if (lane == 0) it = gridDim.x + (int)atomicAdd(p.ctr + kDeal, 1u);
        it = __shfl_sync(0xffffffffu, it, 0);
      }
      if (it >= geo.n_qkv && !geo_ready) {
        bar_sync(2, kThreads);
        attn_geo();
        geo_ready = true;
      }
      if (lane == 0) {
        sItem[k] = it;
        mbar_arrive(qfull0 + 8 * k);
      }
      if (it >= geo.total) break;
      int j = it;
      if (j < geo.n_qkv) {
        produce_gemv(pgemv_item(s_qkv, geo.tq, geo.H, p.ch_qkv, j), S, ring,
                     rbase, full0, empty0, p.ring);
      } else if ((j -= geo.n_qkv) < geo.n_att) {
        produce_attn<D>(attn_item(j, geo, sPre, sNbox, p.kvh, p.nseg), p, tm,
                        geo.bpi, ring, rbase, full0, empty0);
      } else {
        j -= geo.n_att;
        produce_gemv(pgemv_item(s_o, geo.to, geo.hd, p.ch_o, j), S, ring,
                     rbase, full0, empty0, p.ring);
      }
    }
    if (!geo_ready) bar_sync(2, kThreads);
  } else {
    float* sc = reinterpret_cast<float*>(smem + p.scr_off);
    bf16* sX = reinterpret_cast<bf16*>(smem + p.scr_off);
    // norm1's statistics; each slot's live boxes, the attention items'
    // size (runs of boxes doubled from bpi_min until at most one item a
    // block, or a window an item) and each slot's first item
    // (the lengths' loads go out before the statistics')
    const int window = p.mpps * p.ps;
    const int len0 = tid < S ? p.lengths[tid] : 0;
    norm1_stats<GPT>(p, sR, sMu);
    for (int s = tid; s < S; s += kCons) {
      const int len = min(s == tid ? len0 : p.lengths[s], window);
      const int full = len / p.ps;
      sNbox[s] = full * p.spp + (len - full * p.ps + p.seg - 1) / p.seg;
    }
    cons_sync();
    if (tid == 0) {
      int bpi = p.bpi_min;
      const int cap = p.mpps * p.spp;
      for (;;) {
        long long n = 0;
        for (int s = 0; s < S; ++s) n += max(1, (sNbox[s] + bpi - 1) / bpi);
        if (n * p.kvh <= gridDim.x || bpi >= cap) break;
        bpi *= 2;
      }
      sBpi = bpi;
    }
    cons_sync();
    if (tid == 0) {
      sPre[0] = 0;
      for (int s = 0; s < S; ++s)
        sPre[s + 1] = sPre[s] + max(1, (sNbox[s] + sBpi - 1) / sBpi);
      sPerKh = sPre[S];
      if (p.clock) atomicMax(p.clock + kClsStats, globaltimer());
    }
    cons_sync();
    bar_arrive(2, kThreads);
    attn_geo();
    for (int n = 0;; ++n) {
      const int k = n & 1;
      mbar_wait(qfull0 + 8 * k, (n >> 1) & 1);
      const int it = sItem[k];
      if (it >= geo.total) break;
      const unsigned long long t0 = p.clock && tid == 0 ? globaltimer() : 0;
      unsigned long long t1 = t0;
      const uint32_t started = qstart0 + 8 * k;
      int cls, j = it;
      if (j < geo.n_qkv) {
        cls = kClsQkv;
        if (tid == 0) mbar_arrive(started);
        const PItem g = pgemv_item(s_qkv, geo.tq, geo.H, p.ch_qkv, j);
        consume_gemv(g, S, p.p_qkv, geo.nqkv, sX, ring, rbase, full0, empty0,
                     BuildNorm<GPT>{p.x, nullptr, sR, p.ln1_w, p.ln_fp32,
                                    geo.H, S, sMu, p.ln1_b}, p.ring);
        if (tid == 0) publish(p.ctr + kQkv + g.tile);
      } else if ((j -= geo.n_qkv) < geo.n_att) {
        cls = kClsAttn;
        const AItem a = attn_item(j, geo, sPre, sNbox, p.kvh, p.nseg);
        if (tid == 0) {
          // every chunk of its heads' q tiles and of its kv head's k and v
          // tiles
          for (int t = a.kh * G * D / kPTile;
               t <= ((a.kh + 1) * G * D - 1) / kPTile; ++t)
            wait_count(p.ctr + kQkv + t, p.ks_qkv);
          const int tk = ptiles(geo.hd) + a.kh * D / kPTile;
          wait_count(p.ctr + kQkv + tk, p.ks_qkv);
          wait_count(p.ctr + kQkv + tk + ptiles(geo.kvd), p.ks_qkv);
          mbar_arrive(started);
          if (p.clock) t1 = globaltimer();
        }
        cons_sync();
        consume_attn<G, D, GPT>(p, geo, a, sc, ring, rbase, full0, empty0,
                                &sFlag);
        cons_sync();
        if (tid == 0 && (a.ni == 1 || sFlag)) publish(p.ctr + geo.c_ctx + a.kh);
      } else {
        cls = kClsO;
        j -= geo.n_att;
        const PItem g = pgemv_item(s_o, geo.to, geo.hd, p.ch_o, j);
        if (tid == 0) {
          // the kv heads whose ctx rows this chunk reads, merged for
          // every slot
          for (int kh = g.k0 / D / G; kh <= (g.k1 - 1) / D / G; ++kh)
            wait_count(p.ctr + geo.c_ctx + kh, S);
          mbar_arrive(started);
          if (p.clock) t1 = globaltimer();
        }
        cons_sync();
        consume_gemv(g, S, p.p_o, geo.H, sX, ring, rbase, full0, empty0,
                     BuildCtx{p.ctx, geo.hd}, p.ring);
        if (tid == 0) sFlag = arrive_last(p.ctr + geo.c_o + g.tile, p.ks_o);
        cons_sync();
        if (sFlag) finish_o(p, g);
      }
      cons_sync();
      if (tid == 0) {
        if (p.clock) {
          const unsigned long long t2 = globaltimer();
          unsigned long long* sums = p.clock + kClockSums + 3 * (cls - kClsQkv);
          atomicMax(p.clock + cls, t2);
          atomicAdd(sums, t2 - t1);
          atomicAdd(sums + 1, t1 - t0);
          atomicAdd(sums + 2, 1ull);
        }
        mbar_arrive(qempty0 + 8 * k);
      }
    }
  }
  __syncthreads();
  // the last block to leave resets the counters for the next launch (the
  // count's acquire-release orders every block's counter updates before
  // the reset; the launch's end orders the reset before the next launch)
  if (tid == 0 && arrive_last(p.ctr + kExit, gridDim.x)) {
    for (int i = 0; i < geo.nctr; ++i) p.ctr[i] = 0u;
    if (p.clock) p.clock[kClockEnd] = globaltimer();
  }
}

// ------------------------------------------------------------------ host

// split-K of a K-row product over `tiles` column tiles: about one item a
// block, chunks of whole 64-row stages, at most kPMaxChunk rows
void split_kp(int K, int tiles, int grid, int* ks, int* chunk) {
  int k = grid / tiles > 1 ? grid / tiles : 1;
  const int lo = (K + kPMaxChunk - 1) / kPMaxChunk;
  k = k > lo ? k : lo;
  const int hi = (K + kPRows - 1) / kPRows;
  k = k < hi ? k : hi;
  const int c = ((K + k - 1) / k + kPRows - 1) / kPRows * kPRows;
  *ks = (K + c - 1) / c;
  *chunk = c;
}

int htiles(int n) { return (n + kPTile - 1) / kPTile; }

struct PLayout {
  int grid, smem;
  size_t total;
};

// the attention item's box geometry: rows a box, boxes a page, boxes a
// stage of ST rows
void box_geometry(int ps, int st, int* seg, int* spp, int* nseg) {
  if (ps % 8 == 0) {
    *seg = wide_box_rows(ps, st);
  } else {
    const int p8 = (ps + 7) / 8 * 8;
    *seg = p8 <= st ? p8 : st;
  }
  *spp = (ps + *seg - 1) / *seg;
  *nseg = st / *seg;
}

template <int G, int D, bool GPT>
int plan_partial(PParams& p, unsigned char* base, PLayout* out) {
  static int sms[64], blocks_at[64], smem_at[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr int ST = 8192 / D;
  const int S = p.slots, H = p.hidden, h = p.kvh * G;
  const int hd = h * D, kvd = p.kvh * D;
  box_geometry(p.ps, ST, &p.seg, &p.spp, &p.nseg);
  const int nbw = p.mpps * p.spp;   // boxes of a window
  p.bpi_min = p.nseg;
  while ((nbw + p.bpi_min - 1) / p.bpi_min > kMaxSplits) p.bpi_min *= 2;
  p.nsplit = (nbw + p.bpi_min - 1) / p.bpi_min;
  const int tq = htiles(hd) + 2 * htiles(kvd), to = htiles(H);
  if (kQkv + tq + (long long)S * p.kvh + p.kvh + to > kCounters)
    return (int)cudaErrorInvalidValue;
  using A = AttnScr<G, D>;
  const size_t gemv_scr = sizeof(bf16) * kPSlots * (kPMaxChunk + 8);
  const size_t attn_scr = sizeof(float) * A::floats(p.nsplit);
  const size_t scr = gemv_scr > attn_scr ? gemv_scr : attn_scr;
  // the ring: 6 slots where the group's scratch leaves room for them and
  // they measured faster (groups 2 and 4), else 4 (group 8: no room;
  // group 1: measured faster with 4)
  p.ring = G == 2 || G == 4 ? 6 : 4;
  p.scr_off = p.ring * kSlotBytes;
  p.sl_off = (int)((p.scr_off + scr + 15) / 16 * 16);
  // + each slot's boxes, first item, statistics; + the 1024-byte slack
  const int smem = p.sl_off + (int)(sizeof(int) * (2 * S + 1) +
                                    sizeof(float) * 2 * S) + 1024;
  if (smem_at[dev] != smem) {
    err = cudaFuncSetAttribute(fused_block_partial_kernel<G, D, GPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_at[dev], fused_block_partial_kernel<G, D, GPT>, kThreads,
        smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks_at[dev] < 1) return (int)cudaErrorInvalidConfiguration;
    smem_at[dev] = smem;
  }
  const int blocks = blocks_at[dev];
  const int grid = (blocks < kPBlocksPerSM ? blocks : kPBlocksPerSM) * sms[dev];
  split_kp(H, tq, grid, &p.ks_qkv, &p.ch_qkv);
  split_kp(hd, to, grid, &p.ks_o, &p.ch_o);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* ptr = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return ptr;
  };
  const size_t f = sizeof(float);
  p.p_qkv = reinterpret_cast<float*>(take(f * p.ks_qkv * S * (hd + 2 * kvd)));
  p.part_acc = reinterpret_cast<float*>(take(f * S * h * p.nsplit * D));
  p.part_ml = reinterpret_cast<float*>(take(f * S * h * p.nsplit * 2));
  p.ctx = reinterpret_cast<bf16*>(take(sizeof(bf16) * S * hd));
  p.p_o = reinterpret_cast<float*>(take(f * p.ks_o * S * H));
  out->grid = grid;
  out->smem = smem;
  out->total = off;
  return 0;
}

template <int G, int D, bool GPT>
int run_partial(PParams& p, const void* wq, const void* wk, const void* wv,
                const void* wo, const void* kp, const void* vp,
                long long page_stride, void* ws, long long* ws_bytes,
                cudaStream_t stream) {
  PLayout lay;
  int err = plan_partial<G, D, GPT>(p, static_cast<unsigned char*>(ws), &lay);
  if (err) return err;
  if (ws == nullptr) {
    if (ws_bytes) *ws_bytes = (long long)lay.total;
    return 0;
  }
  const int H = p.hidden, hd = p.kvh * G * D, kvd = p.kvh * D;
  PMaps tm = {};
  err = weight_map(&tm.q, wq, H, hd, kPRows);
  if (!err) err = weight_map(&tm.k, wk, H, kvd, kPRows);
  if (!err) err = weight_map(&tm.v, wv, H, kvd, kPRows);
  if (!err) err = weight_map(&tm.o, wo, hd, H, kPRows);
  // the pool view [pages, kvh, ps, d] (its page count is not passed: the
  // page table addresses it, so the map's extent is a bound that keeps
  // the view inside the address space)
  const long long pages =
      (1ll << 46) / (page_stride * 2) < (1ll << 30)
          ? (1ll << 46) / (page_stride * 2) : (1ll << 30);
  if (!err) err = cached_kv_map(&tm.kp, kp, D, p.ps, p.kvh, pages,
                                (long long)p.ps * D, page_stride, p.seg);
  if (!err) err = cached_kv_map(&tm.vp, vp, D, p.ps, p.kvh, pages,
                                (long long)p.ps * D, page_stride, p.seg);
  if (err) return err;
  // the counters' address, asked once a device
  static unsigned* ctr_at[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!ctr_at[dev]) {
    e = cudaGetSymbolAddress(reinterpret_cast<void**>(&ctr_at[dev]), g_pctr);
    if (e != cudaSuccess) return (int)e;
  }
  p.ctr = ctr_at[dev];
  void* args[] = {&p, &tm};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_block_partial_kernel<G, D, GPT>),
      dim3(lay.grid), dim3(kThreads), args, lay.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D>
int run_partial_d(int group, PParams& p, const void* wq, const void* wk,
                  const void* wv, const void* wo, const void* kp,
                  const void* vp, long long ps_stride, void* ws,
                  long long* ws_bytes, cudaStream_t s) {
  switch (group) {
    case 1: return run_partial<1, D, false>(p, wq, wk, wv, wo, kp, vp,
                                            ps_stride, ws, ws_bytes, s);
    case 2: return run_partial<2, D, false>(p, wq, wk, wv, wo, kp, vp,
                                            ps_stride, ws, ws_bytes, s);
    case 4: return run_partial<4, D, false>(p, wq, wk, wv, wo, kp, vp,
                                            ps_stride, ws, ws_bytes, s);
    case 8: return run_partial<8, D, false>(p, wq, wk, wv, wo, kp, vp,
                                            ps_stride, ws, ws_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The rank-partial LLaMA layer: x [slots, hidden] bf16; cos/sin [slots,
// d] fp32; ln1_w [hidden] bf16 (fp32 with ln_fp32); a rank's wq [hidden,
// h d], wk/wv [hidden, kvh d], wo [h d, hidden] bf16, contiguous; k/v
// pages [pages, kvh, ps, d] bf16 with heads and rows contiguous and page
// stride `page_stride` elements (a multiple of 8); page_table [slots,
// mpps] and lengths [slots] int32 (lengths before this token's append);
// y [slots, hidden] = bf16(ctx @ wo) (no residual), kt/vt [slots, kvh, d]
// bf16.  Group h / kvh 1, 2, 4 or 8; d 64 or 128; hidden a multiple of 8;
// pointers 16-byte aligned.  ws: the workspace; with ws null nothing is
// launched and *ws_bytes receives its size.  clock: null, or 15 zeroed
// uint64 that receive, in ns, the start, the last block's norm1
// statistics, the last end of a q/k/v, an attention and an o item, and
// the last block's end; then for q/k/v, attention and o items in turn
// the sums of their items' time working and waiting on counters, and
// their count.
extern "C" int apex_fused_block_decode_partial(
    const void* x, const void* cos, const void* sin, const void* ln1_w,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const void* k_pages, const void* v_pages, const void* page_table,
    const void* lengths, void* y, void* kt, void* vt, void* ws,
    long long* ws_bytes, void* clock, int slots, int hidden, int heads,
    int kvh, int d, int ps, int mpps, long long page_stride, int ln_fp32,
    float eps, float scale_log2, void* stream) {
  cudaGetLastError();
  if (slots <= 0 || hidden <= 0 || hidden % 8 || kvh <= 0 || heads % kvh ||
      ps <= 0 || mpps <= 0 || page_stride <= 0 || page_stride % 8)
    return (int)cudaErrorInvalidValue;
  PParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.ln1_w = ln1_w;
  p.page_table = static_cast<const int*>(page_table);
  p.lengths = static_cast<const int*>(lengths);
  p.y = static_cast<bf16*>(y);
  p.kt = static_cast<bf16*>(kt);
  p.vt = static_cast<bf16*>(vt);
  p.clock = static_cast<unsigned long long*>(clock);
  p.slots = slots;
  p.hidden = hidden;
  p.kvh = kvh;
  p.ps = ps;
  p.mpps = mpps;
  p.ln_fp32 = ln_fp32;
  p.eps = eps;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = heads / kvh;
  switch (d) {
    case 64: return run_partial_d<64>(group, p, wq, wk, wv, wo, k_pages,
                                      v_pages, page_stride, ws, ws_bytes, s);
    case 128: return run_partial_d<128>(group, p, wq, wk, wv, wo, k_pages,
                                        v_pages, page_stride, ws, ws_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The rank-partial GPT layer: x [slots, hidden] bf16; ln1_w/ln1_b
// [hidden], bq/bk/bv [h d] / [kvh d] fp32; a rank's wq, wk, wv [hidden,
// h d], wo [h d, hidden] bf16; the pool, page table, lengths, outputs,
// workspace and clock as apex_fused_block_decode_partial's; y = bf16(ctx
// @ wo): no residual, no bo.  h = kvh (group 1); d 64 or 128.
extern "C" int apex_fused_block_decode_gpt_partial(
    const void* x, const void* ln1_w, const void* ln1_b, const void* wq,
    const void* bq, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* wo, const void* k_pages,
    const void* v_pages, const void* page_table, const void* lengths,
    void* y, void* kt, void* vt, void* ws, long long* ws_bytes, void* clock,
    int slots, int hidden, int heads, int kvh, int d, int ps, int mpps,
    long long page_stride, float eps, float scale_log2, void* stream) {
  cudaGetLastError();
  if (slots <= 0 || hidden <= 0 || hidden % 8 || kvh <= 0 || heads != kvh ||
      ps <= 0 || mpps <= 0 || page_stride <= 0 || page_stride % 8)
    return (int)cudaErrorInvalidValue;
  PParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.ln1_w = ln1_w;
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.bq = static_cast<const float*>(bq);
  p.bk = static_cast<const float*>(bk);
  p.bv = static_cast<const float*>(bv);
  p.page_table = static_cast<const int*>(page_table);
  p.lengths = static_cast<const int*>(lengths);
  p.y = static_cast<bf16*>(y);
  p.kt = static_cast<bf16*>(kt);
  p.vt = static_cast<bf16*>(vt);
  p.clock = static_cast<unsigned long long*>(clock);
  p.slots = slots;
  p.hidden = hidden;
  p.kvh = kvh;
  p.ps = ps;
  p.mpps = mpps;
  p.ln_fp32 = 1;
  p.eps = eps;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return run_partial<1, 64, true>(p, wq, wk, wv, wo, k_pages,
                                             v_pages, page_stride, ws,
                                             ws_bytes, s);
    case 128: return run_partial<1, 128, true>(p, wq, wk, wv, wo, k_pages,
                                               v_pages, page_stride, ws,
                                               ws_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
