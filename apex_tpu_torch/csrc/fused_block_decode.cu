// Fused-block decode for Hopper (sm_90a): one whole LLaMA decoder layer
// for every slot in ONE cooperative launch; bf16 in, fp32 math.
//
// Replaces: apex_tpu/ops/paged_attention.py :: _fused_block_kernel
// (launched by fused_block_decode through pl.pallas_call).  Same
// function and the same rounding points: h1 = x rsqrt(mean x^2 + eps) w
// in fp32; q, k, v = bf16(h1) @ W with fp32 sums; RoPE in fp32 (half
// rotation) on q and k; scores bf16(q) . k over the slot's live pages in
// a base-2 online softmax, bf16(p) . v with the normaliser from fp32 p;
// then the CURRENT token folded in as one more column from the
// unrounded fp32 q, k and v; x2 = x + bf16(ctx) @ wo with the residual
// in fp32; h2 = rmsnorm(x2); y = x2 + bf16(silu(bf16(h2) @ wg) *
// (bf16(h2) @ wu)) @ wd, rounded to bf16.  The current token's k (after
// RoPE) and v leave as bf16 for the caller's pool append.
//
// Translation: the TPU kernel walks a (slots, pages) grid with the
// layer's weights resident in VMEM.  An SM has 227 KB, and one
// Llama-3-8B layer is 436 MB of bf16 weights, so here nothing is
// resident: the weights stream from device memory once per launch for
// ALL slots together (a per-slot grid would read them once per slot).
// The layer is cut into phases separated by grid-wide barriers (the
// grid is sized from the occupancy calculator and launched with
// cudaLaunchCooperativeKernel, so every block is resident and an
// atomic barrier cannot deadlock):
//   1. norm1 statistics (every block, from x), the q/k/v products;
//   2. q, k, v: the products' split-K sums, RoPE (k, v also leave as
//      bf16 for the caller's append);
//   3. paged attention, one item per (slot, kv head, 256-token split),
//      taken from a counter, reading the strided pool view in place
//      (csrc/paged_attention.cu's chunk loop);
//   4. the o product, whose input is built by merging each (slot,
//      head)'s splits and folding the current token in: the merge has no
//      phase and no barrier of its own, each block merges the heads of
//      its chunk of the o product's rows;
//   5. x2 = x + o, norm2 sums per 256 columns; 6. norm2 statistics, the
//      gate/up products; 7. silu(g) u, the down product; 8. y = x2 +
//      down.
// Every product is a GEMV phase: a block owns a tile of 256 output
// columns of the [in, out] weight and a chunk of its input rows
// (split-K).  The tile streams through a ring of shared-memory stages:
// one thread issues TMA loads (a 2-d tensor map a weight, encoded once
// per weight by the host, four boxes of 32 rows x 64 columns a stage in
// the 128-byte swizzle) that complete on the stage's mbarrier, and a
// block barrier a stage frees the stage before it for its refill.  The
// tensor cores multiply the tile into all 8 slots at once: ldmatrix.trans
// turns 16 rows x 16 columns of the [in, out] tile into the A operand of
// an m16n8k16 mma.sync whose N = 8 are the slots (the activations sit in
// shared memory as bf16 [8 slots][rows], the B operand).  Each warp owns
// 32 of the 256 columns, so no warp's sum meets another's; each split-K
// chunk writes an fp32 partial that the next phase sums in a fixed order
// (no atomics: the result is the same from run to run).  More than 8
// slots run as groups of 8 over each item.
//
// What bounds it on the H100: bytes.  A Llama-3-8B layer reads 218.1 M
// bf16 weights (436.2 MB) plus the live k/v pages, and does 2 flops per
// weight per slot: at 8 slots, 16 flops per 2 bytes, far below the
// ~295 flop/byte balance point, so the floor is ~0.130 ms per layer at
// 3.35 TB/s.  The design reads each weight byte once, keeps three ring
// stages of 16 KB in flight (two blocks an SM), leaves the arithmetic to
// the tensor cores, and keeps the intermediates (partials, q, k, v, x2:
// a few MB) in L2.  At GPT's widths a GEMV phase costs ~7 us beyond its
// bytes (the barrier, the ring's first loads, the activations' build,
// the slowest block), and the phases that move no weights (the sums,
// x2, y) and attention (split by 256 tokens over ~1.5 items a block) are
// what the layer's small products cannot hide.  Measured no faster on
// the card, and left out: the first stages of the next product issued
// before a grid barrier, or between a block's arrival and its wait
// (cp.async, bulk row copies or TMA boxes: the issuing thread stalls
// about as long as the loads then save); 128-token attention items; a
// 3-stage attention ring; taking an attention item's successor, and
// loading its first chunk, during its last chunk; a deeper ring (GPT's
// 100.7 MB layer gives a block one item of at most 8 stages; 5 in
// flight read the same as 3).
//
// The GPT instance (fused_block_kernel<1, D, true>, kind="gpt" of the
// TPU kernel): the same phases with LayerNorm in place of RMSNorm (two
// statistics a norm: the mean, then the mean of squared deviations;
// norm2's from per-256-column sums and squared deviations merged in a
// fixed order), an fp32 bias added after each product's split-K sum
// (q, k, v, o, up, down), no RoPE, and bf16(gelu(up)) as the down
// product's input, GELU in its tanh approximation as jax.nn.gelu
// computes it (phase 6 is one product, up; there is no gate).  Its
// norm weights and biases are fp32.  A GPT-3 1.3B layer reads 50.3 M
// bf16 weights (100.7 MB) plus the live pages.
//
// Every product sizes its rows and columns from hidden, h d and kvh d
// apart.  A tensor-parallel rank's attention half (partial_out=True of
// the TPU kernel) is a kernel of its own, csrc/fused_block_partial.cu;
// the helpers both use are csrc/fused_block_common.cuh's.
//
// Plain C interface (loaded with ctypes): apex_fused_block_decode and
// apex_fused_block_decode_gpt launch on the caller's stream and return
// cudaGetLastError(); with a null workspace they only report the
// workspace bytes they need.

#include "fused_block_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;          // slots per GEMV pass (accumulator rows)
constexpr int kTile = 256;         // output columns per GEMV item: 8 warps x 32
constexpr int kKS = 32;            // weight rows per GEMV ring stage
// a ring stage: the tile's 256 columns as 4 TMA boxes of [32 rows][64
// columns] in the 128-byte swizzle
constexpr int kBox = kKS * 64 * 2;
constexpr int kStageBytes = 4 * kBox;
constexpr int kChunk = 64;         // tokens per staged attention chunk
constexpr int kSplitTokens = 256;  // window positions per attention item
constexpr int kStages = 4;         // GEMV ring stages (3 in flight)
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMaxChunk = 2048;    // input rows per GEMV item
static_assert(kTile == 4 * 64, "a stage is four 64-column boxes");
constexpr int kRowBlock = kThreads;  // columns per residual item
constexpr int kMaxBlocksPerSM = 2;
constexpr int kPhases = 8;         // clock: [0] start, [1..7] barriers, [8] end

static_assert(kTile == 32 * kWarps, "a warp owns 32 columns of the tile");
static_assert(kThreads / kChunk == 4, "four threads score one token");

// arrivals and generation of the grid barrier; zero when no launch is
// inside a barrier (each barrier's last arrival resets the count)
__device__ unsigned g_barrier[2];

// The products' weights as 2-d tensor maps ([in, out], boxes of 32 rows
// x 64 columns): q, k, v, o, gate, up, down (unused ones unset).  A
// kernel parameter of its own (__grid_constant__, so the TMA reads it in
// place), apart from Params, whose fields the phases read as ordinary
// parameters.
struct WeightMaps {
  CUtensorMap q, k, v, o, g, u, d;
};

struct Params {
  const bf16* x;            // [slots, hidden]
  const float* cos;         // [slots, d] RoPE rows at each slot's position
  const float* sin;
  const void* ln1_w;        // [hidden], bf16 or fp32 (ln_fp32)
  const void* ln2_w;
  const bf16* wq;           // [hidden, h d]
  const bf16* wk;           // [hidden, kvh d]
  const bf16* wv;
  const bf16* wo;           // [h d, hidden]
  const bf16* wg;           // [hidden, ffn]
  const bf16* wu;
  const bf16* wd;           // [ffn, hidden]
  // GPT only (fp32): LayerNorm biases [hidden], q/k/v biases [h d] /
  // [kvh d], the o, up and down biases [hidden] / [ffn] / [hidden]
  const float* ln1_b;
  const float* ln2_b;
  const float* bq;
  const float* bk;
  const float* bv;
  const float* bo;
  const float* bu;
  const float* bd;
  const bf16* kp;           // pool view [pages, kvh, ps, d], page stride
  const bf16* vp;
  const int* page_table;    // [slots, mpps]
  const int* lengths;       // [slots], before this token's append
  bf16* y;                  // [slots, hidden]
  bf16* kt;                 // [slots, kvh, d]
  bf16* vt;
  // workspace (fp32 unless noted)
  float* p_qkv;             // [ks_qkv, slots, h d + 2 kvh d]
  float* q32;               // [slots, h, d] after RoPE
  float* kn32;              // [slots, kvh, d] after RoPE
  float* vn32;              // [slots, kvh, d]
  float* part_acc;          // [slots h, nsplit, d]
  float* part_ml;           // [slots h, nsplit, 2]
  float* p_o;               // [ks_o, slots, hidden]
  float* x2;                // [slots, hidden]
  float* ss2;               // [slots, ceil(hidden / 256)] (GPT: x 2)
  float* p_gu;              // [ks_gu, slots, 2 ffn] (GPT: ffn)
  float* p_d;               // [ks_d, slots, hidden]
  unsigned* work;           // the attention phase's item counter
  unsigned long long* clock;  // optional [kPhases + 1] phase end times (ns)
  long long page_stride;
  int slots, hidden, kvh, ffn, ps, mpps, nsplit;
  int ks_qkv, ks_o, ks_gu, ks_d;
  int ch_qkv, ch_o, ch_gu, ch_d;
  int ln_fp32, fuse_mlp, r_off;
  int m_off, merge_nh;      // the merge factors' shared memory, its heads
  float eps, scale_log2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
// Grid-wide barrier.  Every block is resident (cooperative launch).
// Thread 0 reads the generation, publishes the block's writes (fence),
// arrives; the last arrival resets the count and advances the
// generation, the others wait for it.  Data written before the barrier
// by other blocks is read after it from L2 (__ldcg / cp.async.cg).
__device__ __forceinline__ void grid_sync() {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = &g_barrier[1];
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(&g_barrier[0], 1u) == gridDim.x - 1) {
      atomicExch(&g_barrier[0], 0u);
      __threadfence();
      atomicAdd(&g_barrier[1], 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// ---------------------------------------------------------------- GEMV

struct Seg {
  const CUtensorMap* tm;  // the [K, n] row-major ([in, out]) weight
  int n;                  // columns (a multiple of 8)
  int col_off;            // first column of this weight in the partial rows
};

// A = bf16(ctx), the o product's input, merged here from the attention
// phase's split partials (there is no merge phase, and no barrier
// between attention and o).  prepare() computes, one warp a (slot, head)
// of the pass's chunk, what the merge needs beside the partials: each
// live split's weight 2^(m_s - max m), the current token's score folded
// in as one more online-softmax column from the fp32 q, k, v (alpha and
// p_new) and the normaliser l, into shared memory [8 slots][merge_nh
// heads][4 + nsplit]; operator() then sums four columns' partials in
// split order: ctx = bf16((sum_s w_s acc_s alpha + p_new v) / l), the
// merge's arithmetic in its order (l > 0: the token is always live).
// Every split below nlive was written by the attention phase.
template <int D>
struct BuildMerge {
  const float* q32;
  const float* kn32;
  const float* vn32;
  const float* part_acc;
  const float* part_ml;
  const int* lengths;
  float* scratch;
  int slots, h, kvh, group, nsplit, window, nh;
  float scale_log2;

  __device__ void prepare(int sb, int k0, int k1) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int h0 = k0 / D, nhead = (k1 - 1) / D - h0 + 1;
    for (int it = warp; it < kSlots * nhead; it += kWarps) {
      const int slot = sb + it / nhead, head = h0 + it % nhead;
      if (slot >= slots) continue;
      float* f = scratch + ((it / nhead) * nh + head % nh) * (4 + nsplit);
      const int len = min(lengths[slot], window);
      const int nlive = max(1, (len + kSplitTokens - 1) / kSplitTokens);
      const size_t qrow = (size_t)slot * h + head;
      const size_t kv_off = ((size_t)slot * kvh + head / group) * D;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j)
        dot += __ldcg(q32 + qrow * D + lane + 32 * j) *
               __ldcg(kn32 + kv_off + lane + 32 * j);
      const float s_new = warp_sum(dot) * scale_log2;
      const float* ml = part_ml + qrow * nsplit * 2;
      float mx = kNegInf;
      for (int sp = lane; sp < nlive; sp += 32)
        if (__ldcg(ml + 2 * sp + 1) > 0.f) mx = fmaxf(mx, __ldcg(ml + 2 * sp));
      mx = warp_max(mx);
      // each split's weight, and the normaliser summed in split order
      float l = 0.f;
      for (int s0 = 0; s0 < nlive; s0 += 32) {
        const int sp = s0 + lane;
        float wgt = 0.f, ls = 0.f;
        if (sp < nlive) {
          ls = __ldcg(ml + 2 * sp + 1);
          if (ls > 0.f) wgt = exp2f(__ldcg(ml + 2 * sp) - mx);
          f[4 + sp] = wgt;
        }
        const int n = min(32, nlive - s0);
        for (int j = 0; j < n; ++j)
          l += __shfl_sync(0xffffffffu, wgt * ls, j);
      }
      if (lane == 0) {
        const float m_new = fmaxf(mx, s_new);
        const float alpha = exp2f(mx - m_new);
        const float p_new = exp2f(s_new - m_new);
        f[0] = alpha;
        f[1] = p_new;
        f[2] = l * alpha + p_new;
        f[3] = (float)nlive;
      }
    }
  }
  __device__ float4 operator()(int slot, int k) const {
    const int head = k / D, e = k % D;
    const float* f = scratch + ((slot % kSlots) * nh + head % nh) * (4 + nsplit);
    const float alpha = f[0], p_new = f[1], l = f[2];
    const int nlive = (int)f[3];
    const size_t qrow = (size_t)slot * h + head;
    const float* a = part_acc + qrow * nsplit * D + e;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < nlive; ++sp) {
      const float w = f[4 + sp];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(a + (size_t)sp * D));
      acc.x += w * x.x; acc.y += w * x.y; acc.z += w * x.z; acc.w += w * x.w;
    }
    const float4 v = __ldcg(reinterpret_cast<const float4*>(
        vn32 + ((size_t)slot * kvh + head / group) * D + e));
    return make_float4(bf16_round((acc.x * alpha + p_new * v.x) / l),
                       bf16_round((acc.y * alpha + p_new * v.y) / l),
                       bf16_round((acc.z * alpha + p_new * v.z) / l),
                       bf16_round((acc.w * alpha + p_new * v.w) / l));
  }
};

// A = bf16(silu(g) u) from the gate/up partials, the down product's input
struct BuildAct {
  const float* p_gu;
  int ks, ffn, slots;
  __device__ void prepare(int, int, int) const {}
  __device__ float4 operator()(int slot, int k) const {
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f), u = g;
#pragma unroll 4
    for (int c = 0; c < ks; ++c) {
      const float* row = p_gu + ((size_t)c * slots + slot) * 2 * ffn + k;
      const float4 gc = __ldcg(reinterpret_cast<const float4*>(row));
      const float4 uc = __ldcg(reinterpret_cast<const float4*>(row + ffn));
      g.x += gc.x; g.y += gc.y; g.z += gc.z; g.w += gc.w;
      u.x += uc.x; u.y += uc.y; u.z += uc.z; u.w += uc.w;
    }
    return make_float4(silu_mul(g.x, u.x), silu_mul(g.y, u.y),
                       silu_mul(g.z, u.z), silu_mul(g.w, u.w));
  }
  __device__ static float silu_mul(float g, float u) {
    return bf16_round(g * (1.f / (1.f + expf(-g))) * u);
  }
};

// GPT: A = bf16(gelu(up + bu)) from the up partials, the down product's
// input; gelu in the tanh approximation (jax.nn.gelu)
struct BuildGelu {
  const float* p_u;
  const float* bu;
  int ks, ffn, slots;
  __device__ void prepare(int, int, int) const {}
  __device__ float4 operator()(int slot, int k) const {
    float4 u = __ldg(reinterpret_cast<const float4*>(bu + k));
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < ks; ++c) {
      const float4 uc = __ldcg(reinterpret_cast<const float4*>(
          p_u + ((size_t)c * slots + slot) * ffn + k));
      s.x += uc.x; s.y += uc.y; s.z += uc.z; s.w += uc.w;
    }
    return make_float4(gelu(s.x + u.x), gelu(s.y + u.y), gelu(s.z + u.z),
                       gelu(s.w + u.w));
  }
  __device__ static float gelu(float x) {
    const float cdf =
        0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
    return bf16_round(x * cdf);
  }
};

// One GEMV item: the segment, its column tile and chunk kc of the input
// rows [k0, k1), nst ring stages of kKS rows.  Items are dealt
// tile-fastest, so blocks that run together read neighbouring slices of
// the same weight rows.
struct GemvItem {
  Seg sg;
  int c0, kc, k0, k1, nst;
};

__device__ __forceinline__ int gemv_items(const Seg* segs, int nseg, int ks,
                                          int* total) {
  *total = 0;
  for (int i = 0; i < nseg; ++i) *total += (segs[i].n + kTile - 1) / kTile;
  return *total * ks;
}

__device__ __forceinline__ GemvItem gemv_item(const Seg* segs, int total,
                                              int K, int chunk, int it) {
  int t = it % total, si = 0;
  while (t >= (segs[si].n + kTile - 1) / kTile)
    t -= (segs[si++].n + kTile - 1) / kTile;
  GemvItem g;
  g.sg = segs[si];
  g.c0 = t * kTile;
  g.kc = it / total;
  g.k0 = g.kc * chunk;
  g.k1 = min(K, g.k0 + chunk);
  g.nst = (g.k1 - g.k0 + kKS - 1) / kKS;
  return g;
}

// Stage st of item g into ring slot q % kStages (q: the stage's place in
// the block's sequence of stages, which every thread counts alike), by
// thread 0: one TMA box for each 64 columns of the tile that start
// before n, weight rows k0 + st kKS .. + kKS, completing on the slot's
// mbarrier.
// Rows past K and columns past n read as zeros; rows past k1 (the next
// chunk's) are read as they are and meet zero activations; the columns
// of a box left out are never stored, and no other column's sum reads
// them.
__device__ __forceinline__ void gemv_stage(const GemvItem& g, int st,
                                           unsigned q, uint32_t rbase,
                                           uint32_t bar0) {
  const unsigned slot = q % kStages, bar = bar0 + 8 * slot;
  const int boxes = min(4, (g.sg.n - g.c0 + 63) / 64);
  mbar_expect_tx(bar, boxes * kBox);
  for (int b = 0; b < boxes; ++b)
    tma_load2(rbase + slot * kStageBytes + b * kBox, g.sg.tm, bar,
              g.c0 + b * 64, g.k0 + st * kKS);
}

// The ring's prologue of a pass (thread 0): the first kStages - 1 stages,
// after a proxy fence (the ring's memory was last written by other
// phases' plain stores)
__device__ __forceinline__ void gemv_prologue(const GemvItem& g, unsigned q0,
                                              uint32_t rbase, uint32_t bar0) {
  fence_async_smem();
  const int n = min(kStages - 1, g.nst);
  for (int st = 0; st < n; ++st)
    gemv_stage(g, st, q0 + st, rbase, bar0);
}

// part[kc][slot][col_off + c] = sum over k in chunk kc of A[slot][k] w[k][c]
// for every segment; items (column tile, chunk) are dealt to the blocks.
// The weight tile streams through a ring of kStages shared-memory stages
// of kKS rows (TMA boxes issued by thread 0, each stage completing on its
// mbarrier; a block barrier a stage frees the stage before for its
// refill); A sits in shared memory as bf16 [8 slots][chunk].  Each warp
// owns 32 of the tile's 256 columns: per 16 rows, ldmatrix.trans turns
// the [in, out] rows (read through the boxes' 128-byte swizzle, so the
// eight rows of a matrix hit eight banks) into the m16n8k16 A operand
// (16 columns x 16 rows) and the tensor cores multiply it into the 8
// slots (N = 8), so a warp's result needs no reduction with the others.
// ring: the block's count of stages, advanced by each pass.
template <class Build>
__device__ void gemv(const Seg* segs, int nseg, int K, int ks, int chunk,
                     float* part, int ldo, int slots, unsigned char* smem,
                     uint32_t bar0, unsigned& ring, const Build& build) {
  int total;
  const int items = gemv_items(segs, nseg, ks, &total);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int ldx = chunk + 8;   // bf16 per A row (4-bank shift per slot)
  const uint32_t rbase = smem_addr(smem);   // the ring's shared address
  bf16* sX = reinterpret_cast<bf16*>(smem + kStages * kStageBytes);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const GemvItem gi = gemv_item(segs, total, K, chunk, it);
    const Seg& sg = gi.sg;
    const int c0 = gi.c0, kc = gi.kc, k0 = gi.k0, k1 = gi.k1, nst = gi.nst;

    for (int sb = 0; sb < slots; sb += kSlots) {
      const unsigned q0 = ring;
      if (tid == 0) gemv_prologue(gi, q0, rbase, bar0);
      // the activations of this chunk for slots sb..sb+7 as bf16 (their
      // values are bf16 already), zero past k1 and past the last slot;
      // four groups of four inputs a thread at a time, so their L2 reads
      // overlap (after what the build prepares for the pass)
      build.prepare(sb, k0, k1);
      __syncthreads();
      const int groups = chunk / 4 * kSlots;
      for (int i0 = tid; i0 < groups; i0 += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kThreads;
          const int s = i / (chunk / 4), k = (i % (chunk / 4)) * 4;
          v[u] = (i < groups && sb + s < slots && k0 + k < k1)
                     ? build(sb + s, k0 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kThreads;
          if (i < groups) {
            __nv_bfloat162 lo = __floats2bfloat162_rn(v[u].x, v[u].y);
            __nv_bfloat162 hi = __floats2bfloat162_rn(v[u].z, v[u].w);
            uint2 packed;
            packed.x = *reinterpret_cast<unsigned*>(&lo);
            packed.y = *reinterpret_cast<unsigned*>(&hi);
            *reinterpret_cast<uint2*>(
                sX + (i / (chunk / 4)) * ldx + (i % (chunk / 4)) * 4) = packed;
          }
        }
      }
      float acc[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
      for (int st = 0; st < nst; ++st) {
        __syncthreads();  // A is built; stage st - 1's slot is free
        if (tid == 0 && st + kStages - 1 < nst)
          gemv_stage(gi, st + kStages - 1, q0 + st + kStages - 1, rbase,
                     bar0);
        const unsigned q = q0 + st;
        mbar_wait(bar0 + 8 * (q % kStages), (q / kStages) & 1);
        const uint32_t ws = rbase + (q % kStages) * kStageBytes;
#pragma unroll
        for (int kk = 0; kk < kKS; kk += 16) {
          const bf16* xr = sX + g * ldx + st * kKS + kk + 2 * tig;
          const unsigned b0 = *reinterpret_cast<const unsigned*>(xr);
          const unsigned b1 = *reinterpret_cast<const unsigned*>(xr + 8);
          const int r = kk + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // column c of the tile: box c / 64, 16-byte unit (c % 64) / 8
            // of the row, XORed by the row (the 128-byte swizzle)
            const int c = warp * 32 + m * 16 + ((lane >> 3) & 1) * 8;
            unsigned a[4];
            ldmatrix_x4_trans(a, ws + (c >> 6) * kBox + r * 128 +
                                     ((((c & 63) >> 3) ^ (r & 7)) << 4));
            mma_bf16(acc[m], a, b0, b1);
          }
        }
      }
      ring = q0 + nst;
      // rows of acc: columns g and g + 8 of each 16; its columns: slots
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + warp * 32 + m * 16 + g + (j >> 1) * 8;
          const int slot = sb + 2 * tig + (j & 1);
          if (col < sg.n && slot < slots)
            __stcg(part + ((size_t)kc * slots + slot) * ldo + sg.col_off + col,
                   acc[m][j]);
        }
      }
      __syncthreads();  // the ring and A are rewritten by the next pass
    }
  }
}

// ----------------------------------------------------------- attention

template <int G, int D>
struct AttnSmem {
  static constexpr int LDK = D + 8;  // bf16 per staged row (16-byte pad)
  static constexpr size_t kv_stage = sizeof(bf16) * kChunk * LDK;
  static constexpr size_t k_off = 0;                 // sK[2][kChunk][LDK]
  static constexpr size_t v_off = k_off + 2 * kv_stage;
  static constexpr size_t q_off = v_off + 2 * kv_stage;
  static constexpr size_t s_off = q_off + sizeof(float) * G * D;
  static constexpr size_t m_off = s_off + sizeof(float) * G * kChunk;
  static constexpr size_t l_off = m_off + sizeof(float) * G;
  static constexpr size_t a_off = l_off + sizeof(float) * G;
  static constexpr size_t bytes = a_off + sizeof(float) * G;
  static_assert(sizeof(float) * (kThreads / (D / 2)) * G * D <= q_off,
                "reduction scratch must fit in the k/v stages");
};
// Stage the k and v rows of tokens [c0, c0 + kChunk) into one stage;
// rows at or past t_end are zeroed (a masked token still multiplies a
// finite v row).
template <int D>
__device__ __forceinline__ void stage_chunk(
    bf16* sk, bf16* sv, const bf16* __restrict__ kp,
    const bf16* __restrict__ vp, const int* __restrict__ row, int c0,
    int t_end, int ps, long long page_stride, size_t head_off) {
  constexpr int kSegs = D / 8;
  constexpr int LDK = D + 8;
  for (int i = threadIdx.x; i < kChunk * kSegs; i += kThreads) {
    const int r = i / kSegs, seg = (i % kSegs) * 8;
    const int t = c0 + r;
    bf16* dk = sk + r * LDK + seg;
    bf16* dv = sv + r * LDK + seg;
    if (t < t_end) {
      const long long page = row[t / ps];
      const size_t off = page * page_stride + head_off +
                         (size_t)(t % ps) * D + seg;
      cp_async16(dk, kp + off);
      cp_async16(dv, vp + off);
    } else {
      *reinterpret_cast<uint4*>(dk) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// q | k | v of every slot: the sums of the product's split-K partials,
// RoPE on q and k in fp32 (half rotation: element e pairs with e ^ d/2;
// GPT: no RoPE, the fp32 bias added to the sum); q, k, v stay fp32 for
// the attention and the fold, k and v also leave as bf16 for the
// caller's pool append.
template <int D, bool GPT>
__device__ void qkv_phase(const Params& p, int h) {
  const int kvh = p.kvh;
  const int nqkv = (h + 2 * kvh) * D;
  const int n = p.slots * nqkv;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int slot = i / nqkv, col = i % nqkv;
    const int head = col / D, e = col % D;
    const float* part = p.p_qkv + (size_t)slot * nqkv;
    const size_t stride = (size_t)p.slots * nqkv;
    float a = 0.f, b = 0.f;
    const bool roped = !GPT && head < h + kvh;
#pragma unroll 4
    for (int c = 0; c < p.ks_qkv; ++c) {
      a += __ldcg(part + c * stride + col);
      if (roped) b += __ldcg(part + c * stride + (col ^ (D / 2)));
    }
    if constexpr (GPT) {
      const int hd = h * D, kvd = kvh * D;
      a += head < h ? __ldg(p.bq + col)
                    : head < h + kvh ? __ldg(p.bk + col - hd)
                                     : __ldg(p.bv + col - hd - kvd);
    } else if (roped) {
      a = a * __ldg(p.cos + (size_t)slot * D + e) +
          (e < D / 2 ? -b : b) * __ldg(p.sin + (size_t)slot * D + e);
    }
    if (head < h) {
      __stcg(p.q32 + (size_t)slot * h * D + col, a);
    } else {
      const int kv = head < h + kvh ? head - h : head - h - kvh;
      const size_t idx = ((size_t)slot * kvh + kv) * D + e;
      if (head < h + kvh) {
        __stcg(p.kn32 + idx, a);
        p.kt[idx] = __float2bfloat16(a);
      } else {
        __stcg(p.vn32 + idx, a);
        p.vt[idx] = __float2bfloat16(a);
      }
    }
  }
}

template <int G, int D>
__device__ void attention_phase(const Params& p, unsigned char* smem) {
  using S = AttnSmem<G, D>;
  constexpr int kPairs = D / 2;              // threads per v row in P.V
  constexpr int kLanes = kThreads / kPairs;  // token stripes in P.V
  bf16* sK = reinterpret_cast<bf16*>(smem + S::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::v_off);
  float* sQ = reinterpret_cast<float*>(smem + S::q_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  float* sM = reinterpret_cast<float*>(smem + S::m_off);
  float* sL = reinterpret_cast<float*>(smem + S::l_off);
  float* sA = reinterpret_cast<float*>(smem + S::a_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = p.kvh, h = kvh * G;
  const int items = p.slots * kvh * p.nsplit;
  __shared__ int s_item;
  // items are taken from a counter, split-major, so the live splits
  // (low split numbers) go first and spread over the blocks by how
  // long each block's earlier items took
  for (;;) {
    if (tid == 0) s_item = (int)atomicAdd(p.work, 1u);
    __syncthreads();
    const int it = s_item;
    __syncthreads();
    if (it >= items) break;
    const int kh = it % kvh;
    const int slot = (it / kvh) % p.slots;
    const int split = it / (kvh * p.slots);
    // a length past the window scores the whole window and never reads
    // past the page-table row
    const int len = min(p.lengths[slot], p.mpps * p.ps);
    const int t_begin = split * kSplitTokens;
    if (split > 0 && t_begin >= len) continue;  // merge skips dead splits
    const int t_end = min(len, t_begin + kSplitTokens);
    const int n_chunks =
        t_end > t_begin ? (t_end - t_begin + kChunk - 1) / kChunk : 0;
    const int* row = p.page_table + (size_t)slot * p.mpps;
    const size_t head_off = (size_t)kh * p.ps * D;
    if (n_chunks > 0) {
      stage_chunk<D>(sK, sV, p.kp, p.vp, row, t_begin, t_end, p.ps,
                     p.page_stride, head_off);
      cp_async_commit();
    }
    // the group's q rows (RoPE'd by the previous phase), rounded to bf16
    // for the scores
    for (int i = tid; i < G * D; i += kThreads)
      sQ[i] = bf16_round(
          __ldcg(p.q32 + ((size_t)slot * h + (size_t)kh * G) * D + i));
    if (tid < G) {
      sM[tid] = kNegInf;
      sL[tid] = 0.f;
    }
    const int pair = tid % kPairs, tl = tid / kPairs;
    float acc[G][2];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
      const int c0 = t_begin + c * kChunk;
      const int live = min(kChunk, t_end - c0);
      const int st = c & 1;
      if (c + 1 < n_chunks) {
        stage_chunk<D>(sK + (st ^ 1) * kChunk * S::LDK,
                       sV + (st ^ 1) * kChunk * S::LDK, p.kp, p.vp, row,
                       c0 + kChunk, t_end, p.ps, p.page_stride, head_off);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* ck = sK + st * kChunk * S::LDK;
      const bf16* cv = sV + st * kChunk * S::LDK;

      // scores: four threads score token r, each every fourth 8-dim
      // segment of the row (the four read different banks of q)
      {
        const int r = tid >> 2, part = tid & 3;
        const bf16* kr = ck + r * S::LDK;
        float dot[G];
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
          const int e = (j * 4 + part) * 8;
          float kf[8];
          unpack8(*reinterpret_cast<const uint4*>(kr + e), kf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 qa = *reinterpret_cast<const float4*>(sQ + g * D + e);
            const float4 qb =
                *reinterpret_cast<const float4*>(sQ + g * D + e + 4);
            dot[g] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] +
                      qa.w * kf[3] + qb.x * kf[4] + qb.y * kf[5] +
                      qb.z * kf[6] + qb.w * kf[7];
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = dot[g] + __shfl_xor_sync(0xffffffffu, dot[g], 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          if (part == 0)
            sS[g * kChunk + r] = r < live ? d * p.scale_log2 : kNegInf;
        }
      }
      __syncthreads();

      // online softmax, one warp per query row; lane owns tokens lane and
      // lane + 32; p is rounded to bf16 for P.V, the sum keeps fp32 p
      for (int g = warp; g < G; g += kWarps) {
        const float s0 = sS[g * kChunk + lane];
        const float s1 = sS[g * kChunk + lane + 32];
        const float mx = warp_max(fmaxf(s0, s1));
        const float m_prev = sM[g];
        const float m_new = fmaxf(m_prev, mx);
        const float p0 = lane < live ? exp2f(s0 - m_new) : 0.f;
        const float p1 = lane + 32 < live ? exp2f(s1 - m_new) : 0.f;
        sS[g * kChunk + lane] = bf16_round(p0);
        sS[g * kChunk + lane + 32] = bf16_round(p1);
        const float psum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float alpha = exp2f(m_prev - m_new);
          sA[g] = alpha;
          sL[g] = sL[g] * alpha + psum;
          sM[g] = m_new;
        }
      }
      __syncthreads();

      // P.V: this thread's two dims of every row, over its token stripe
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[g][0] *= sA[g];
        acc[g][1] *= sA[g];
      }
#pragma unroll 4
      for (int i = tl; i < live; i += kLanes) {
        const float2 vf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(cv + i * S::LDK +
                                                     2 * pair));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pg = sS[g * kChunk + i];
          acc[g][0] += pg * vf.x;
          acc[g][1] += pg * vf.y;
        }
      }
      __syncthreads();  // the stage and sS are rewritten next iteration
    }

    // merge the token stripes (in the k/v stages) and write this split's
    // partial state; the o product's build merges the splits and folds
    // the new token
    float* sRed = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sRed[(tl * G + g) * D + 2 * pair] = acc[g][0];
      sRed[(tl * G + g) * D + 2 * pair + 1] = acc[g][1];
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int l2 = 0; l2 < kLanes; ++l2) a += sRed[l2 * G * D + i];
      const int g = i / D, e = i % D;
      const size_t qrow = (size_t)slot * h + (size_t)kh * G + g;
      __stcg(p.part_acc + (qrow * p.nsplit + split) * D + e, a);
      if (e == 0) {
        __stcg(p.part_ml + (qrow * p.nsplit + split) * 2, sM[g]);
        __stcg(p.part_ml + (qrow * p.nsplit + split) * 2 + 1, sL[g]);
      }
    }
    __syncthreads();  // the next item restages this memory
  }
}

// rsqrt(mean(x^2) + eps) of every slot's bf16 row (one warp a slot);
// GPT: the mean into sMu, then rsqrt(mean((x - mean)^2) + eps)
template <bool GPT>
__device__ void norm1_stats(const Params& p, float* sR, float* sMu) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < p.slots; s += kWarps) {
    const bf16* xr = p.x + (size_t)s * p.hidden;
    if constexpr (GPT) {
      float sum = 0.f;
      for (int k = lane * 8; k < p.hidden; k += 32 * 8) {
        float f[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(xr + k)), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += f[j];
      }
      const float mu = warp_sum(sum) / p.hidden;
      float ss = 0.f;
      for (int k = lane * 8; k < p.hidden; k += 32 * 8) {
        float f[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(xr + k)), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) ss += (f[j] - mu) * (f[j] - mu);
      }
      ss = warp_sum(ss);
      if (lane == 0) {
        sMu[s] = mu;
        sR[s] = rsqrtf(ss / p.hidden + p.eps);
      }
      continue;
    }
    float ss = 0.f;
    for (int k = lane * 8; k < p.hidden; k += 32 * 8) {
      float f[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(xr + k)), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
    }
    ss = warp_sum(ss);
    if (lane == 0) sR[s] = rsqrtf(ss / p.hidden + p.eps);
  }
}

// a grid barrier, and the phase clock's reading of it (block 0)
__device__ __forceinline__ void phase_end(const Params& p, int i) {
  grid_sync();
  if (p.clock && blockIdx.x == 0 && threadIdx.x == 0) p.clock[i] = globaltimer();
}

// the last block to finish sets the clock's end
__device__ __forceinline__ void kernel_end(const Params& p) {
  if (p.clock && threadIdx.x == 0) atomicMax(p.clock + kPhases, globaltimer());
}

template <int G, int D, bool GPT>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
fused_block_kernel(const Params p, const __grid_constant__ WeightMaps tm) {
  // dynamic shared memory from a 1024-byte boundary (the swizzled boxes')
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  __shared__ float red[kWarps];
  __shared__ __align__(8) unsigned long long ring_bar[kStages];
  float* sR = reinterpret_cast<float*>(smem + p.r_off);  // [slots]
  float* sMu = sR + p.slots;                              // GPT: [slots]
  const int S = p.slots, H = p.hidden, tid = threadIdx.x;
  const int h = p.kvh * G, hd = h * D, kvd = p.kvh * D;
  const int nqkv = hd + 2 * kvd;
  const int nblk = (H + kRowBlock - 1) / kRowBlock;
  // the products' weights: q | k | v, o, gate | up (GPT: up), down
  const Seg s_qkv[3] = {{&tm.q, hd, 0}, {&tm.k, kvd, hd},
                        {&tm.v, kvd, hd + kvd}};
  const Seg s_o[1] = {{&tm.o, H, 0}};
  const Seg s_gu[2] = {{GPT ? &tm.u : &tm.g, p.ffn, 0}, {&tm.u, p.ffn, p.ffn}};
  const Seg s_d[1] = {{&tm.d, H, 0}};

  if (blockIdx.x == 0 && tid == 0) {
    *p.work = 0u;        // published by the first barrier
    if (p.clock) p.clock[0] = globaltimer();
  }
  // the GEMV ring's mbarriers (a full barrier a stage), and the block's
  // count of stages through them
  const uint32_t bar0 = smem_addr(ring_bar);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  unsigned ring = 0;
  // 1. norm1 statistics, then q | k | v = bf16(h1) @ [wq | wk | wv]
  norm1_stats<GPT>(p, sR, sMu);
  __syncthreads();
  gemv(s_qkv, 3, H, p.ks_qkv, p.ch_qkv, p.p_qkv, nqkv, S, smem, bar0,
           ring, BuildNorm<GPT>{p.x, nullptr, sR, p.ln1_w, p.ln_fp32, H, S,
                                sMu, p.ln1_b});
  phase_end(p, 1);
  // 2. q, k, v: the partials' sums, RoPE (GPT: the biases)
  qkv_phase<D, GPT>(p, h);
  phase_end(p, 2);
  // 3. paged attention over the live pages, split by 256 tokens
  attention_phase<G, D>(p, smem);
  phase_end(p, 3);
  // 4. o = bf16(ctx) @ wo, ctx merged from the splits with the current
  //    token folded in as the product's input is built
  gemv(s_o, 1, hd, p.ks_o, p.ch_o, p.p_o, H, S, smem, bar0, ring,
           BuildMerge<D>{p.q32, p.kn32, p.vn32, p.part_acc, p.part_ml,
                         p.lengths,
                         reinterpret_cast<float*>(smem + p.m_off), S, h,
                         p.kvh, G, p.nsplit, p.mpps * p.ps, p.merge_nh,
                         p.scale_log2});
  phase_end(p, 4);
  // 5. x2 = x + o (fp32; GPT: x + (o + bo)); norm2's sums of squares
  //    per 256 columns (GPT: the sums and the squared deviations from
  //    their own mean).  Without the MLP, y = x2 and the layer ends here.
  for (int it = blockIdx.x; it < S * nblk; it += gridDim.x) {
    const int slot = it / nblk, b = it % nblk;
    const int col = b * kRowBlock + tid;
    float v = 0.f;
    if (col < H) {
      const size_t i = (size_t)slot * H + col;
      if constexpr (GPT) {
        float o = 0.f;
#pragma unroll 4
        for (int c = 0; c < p.ks_o; ++c)
          o += __ldcg(p.p_o + ((size_t)c * S + slot) * H + col);
        v = __bfloat162float(p.x[i]) + (o + __ldg(p.bo + col));
      } else {
        v = __bfloat162float(p.x[i]);
#pragma unroll 4
        for (int c = 0; c < p.ks_o; ++c)
          v += __ldcg(p.p_o + ((size_t)c * S + slot) * H + col);
      }
      if (p.fuse_mlp)
        __stcg(p.x2 + i, v);
      else
        p.y[i] = __float2bfloat16(v);
    }
    if (p.fuse_mlp) {
      if constexpr (GPT) {
        const float sum = block_sum(v, red);
        const int n = min(kRowBlock, H - b * kRowBlock);
        const float dv = col < H ? v - sum / n : 0.f;
        const float m2 = block_sum(dv * dv, red);
        if (tid == 0) {
          __stcg(p.ss2 + ((size_t)slot * nblk + b) * 2, sum);
          __stcg(p.ss2 + ((size_t)slot * nblk + b) * 2 + 1, m2);
        }
      } else {
        const float ss = block_sum(v * v, red);
        if (tid == 0) __stcg(p.ss2 + (size_t)slot * nblk + b, ss);
      }
    }
  }
  if (!p.fuse_mlp) {
    kernel_end(p);
    return;
  }
  phase_end(p, 5);
  // 6. norm2 statistics, then g | u = bf16(h2) @ [wg | wu] (GPT: the
  //    per-block sums and deviations merged in block order, then u =
  //    bf16(h2) @ wu)
  for (int s = tid; s < S; s += kThreads) {
    if constexpr (GPT) {
      float sum = 0.f;
      for (int b = 0; b < nblk; ++b)
        sum += __ldcg(p.ss2 + ((size_t)s * nblk + b) * 2);
      const float mu = sum / H;
      float m2 = 0.f;
      for (int b = 0; b < nblk; ++b) {
        const int n = min(kRowBlock, H - b * kRowBlock);
        const float dm = __ldcg(p.ss2 + ((size_t)s * nblk + b) * 2) / n - mu;
        m2 += __ldcg(p.ss2 + ((size_t)s * nblk + b) * 2 + 1) + n * dm * dm;
      }
      sMu[s] = mu;
      sR[s] = rsqrtf(m2 / H + p.eps);
    } else {
      float ss = 0.f;
      for (int b = 0; b < nblk; ++b) ss += __ldcg(p.ss2 + (size_t)s * nblk + b);
      sR[s] = rsqrtf(ss / H + p.eps);
    }
  }
  __syncthreads();
  if constexpr (GPT)
    gemv(s_gu, 1, H, p.ks_gu, p.ch_gu, p.p_gu, p.ffn, S, smem, bar0,
             ring, BuildNorm<true>{nullptr, p.x2, sR, p.ln2_w, 1, H, S, sMu,
                                   p.ln2_b});
  else
    gemv(s_gu, 2, H, p.ks_gu, p.ch_gu, p.p_gu, 2 * p.ffn, S, smem, bar0,
             ring, BuildNorm<false>{nullptr, p.x2, sR, p.ln2_w, p.ln_fp32, H,
                                    S, nullptr, nullptr});
  phase_end(p, 6);
  // 7. down = bf16(silu(g) u) @ wd (GPT: bf16(gelu(u + bu)) @ wd)
  if constexpr (GPT)
    gemv(s_d, 1, p.ffn, p.ks_d, p.ch_d, p.p_d, H, S, smem, bar0, ring,
             BuildGelu{p.p_gu, p.bu, p.ks_gu, p.ffn, S});
  else
    gemv(s_d, 1, p.ffn, p.ks_d, p.ch_d, p.p_d, H, S, smem, bar0, ring,
             BuildAct{p.p_gu, p.ks_gu, p.ffn, S});
  phase_end(p, 7);
  // 8. y = x2 + down (GPT: x2 + (down + bd))
  for (int i = blockIdx.x * kThreads + tid; i < S * H; i += gridDim.x * kThreads) {
    const int slot = i / H, col = i % H;
    if constexpr (GPT) {
      float dn = 0.f;
#pragma unroll 4
      for (int c = 0; c < p.ks_d; ++c)
        dn += __ldcg(p.p_d + ((size_t)c * S + slot) * H + col);
      p.y[i] = __float2bfloat16(__ldcg(p.x2 + i) + (dn + __ldg(p.bd + col)));
    } else {
      float v = __ldcg(p.x2 + i);
#pragma unroll 4
      for (int c = 0; c < p.ks_d; ++c)
        v += __ldcg(p.p_d + ((size_t)c * S + slot) * H + col);
      p.y[i] = __float2bfloat16(v);
    }
  }
  kernel_end(p);
}

// ------------------------------------------------------------------ host

// split-K of a K-row product over `tiles` column tiles: about one item
// per block, chunks of at most max_chunk rows, a multiple of 32 rows
// (8 warps x 4 rows) each, no empty chunk.  (More, smaller chunks to
// even out the blocks' loads cost more in the consumer, which sums one
// partial per chunk, than they save.)
void split_k(int K, int tiles, int grid, int max_chunk, int* ks, int* chunk) {
  int k = grid / tiles > 1 ? grid / tiles : 1;
  k = k > (K + max_chunk - 1) / max_chunk ? k : (K + max_chunk - 1) / max_chunk;
  k = k < (K + 31) / 32 ? k : (K + 31) / 32;
  const int c = ((K + k - 1) / k + 31) / 32 * 32;
  *ks = (K + c - 1) / c;
  *chunk = c;
}

int tiles_of(int n) { return (n + kTile - 1) / kTile; }

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

struct Layout {
  int grid, smem;
  size_t total;
};

// grid, split-K counts and workspace offsets (in p's pointers, relative
// to `base`) of one geometry
template <int G, int D, bool GPT>
int plan(Params& p, unsigned char* base, Layout* out) {
  // per device (and per instantiation): the SM count, and the blocks per
  // SM at the shared-memory size last asked for
  static int sms[64], blocks_at[64], smem_at[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int S = p.slots, H = p.hidden, h = p.kvh * G;
  const int hd = h * D, kvd = p.kvh * D;
  p.nsplit = (p.mpps * p.ps + kSplitTokens - 1) / kSplitTokens;
  // the o product's merge factors: the heads one chunk of its input rows
  // spans, at most, are those of the chunk at the smallest grid (one
  // block an SM), plus one where a chunk starts inside a head
  int ks_lo, ch_lo;
  split_k(hd, tiles_of(H), sms[dev], kMaxChunk, &ks_lo, &ch_lo);
  p.merge_nh = (ch_lo + D - 1) / D + 1;
  const size_t sx_end = kRingBytes + sizeof(bf16) * kSlots * (kMaxChunk + 8);
  p.m_off = (int)((sx_end + 15) / 16 * 16);
  const size_t gemv_bytes =
      p.m_off + sizeof(float) * kSlots * p.merge_nh * (4 + p.nsplit);
  size_t region = AttnSmem<G, D>::bytes;
  region = region > gemv_bytes ? region : gemv_bytes;
  p.r_off = (int)((region + 15) / 16 * 16);
  // + the slack that aligns the kernel's base to 1024 bytes
  const int smem =
      p.r_off + (int)sizeof(float) * p.slots * (GPT ? 2 : 1) + 1024;
  if (smem_at[dev] != smem) {
    err = cudaFuncSetAttribute(fused_block_kernel<G, D, GPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_at[dev], fused_block_kernel<G, D, GPT>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks_at[dev] < 1) return (int)cudaErrorInvalidConfiguration;
    smem_at[dev] = smem;
  }
  const int blocks = blocks_at[dev];
  const int grid = (blocks < kMaxBlocksPerSM ? blocks : kMaxBlocksPerSM) * sms[dev];

  const int mc = kMaxChunk;
  split_k(H, tiles_of(hd) + 2 * tiles_of(kvd), grid, mc, &p.ks_qkv,
          &p.ch_qkv);
  split_k(hd, tiles_of(H), grid, mc, &p.ks_o, &p.ch_o);
  const int gu = GPT ? 1 : 2;    // up, or gate and up
  split_k(H, gu * tiles_of(p.ffn), grid, mc, &p.ks_gu, &p.ch_gu);
  split_k(p.ffn, tiles_of(H), grid, mc, &p.ks_d, &p.ch_d);
  const int nblk = (H + kRowBlock - 1) / kRowBlock;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* ptr = base ? base + off : nullptr;
    off += align256(bytes);
    return ptr;
  };
  const size_t f = sizeof(float);
  p.p_qkv = reinterpret_cast<float*>(take(f * p.ks_qkv * S * (hd + 2 * kvd)));
  p.q32 = reinterpret_cast<float*>(take(f * S * hd));
  p.kn32 = reinterpret_cast<float*>(take(f * S * kvd));
  p.vn32 = reinterpret_cast<float*>(take(f * S * kvd));
  p.part_acc = reinterpret_cast<float*>(take(f * S * h * p.nsplit * D));
  p.part_ml = reinterpret_cast<float*>(take(f * S * h * p.nsplit * 2));
  p.p_o = reinterpret_cast<float*>(take(f * p.ks_o * S * H));
  p.x2 = reinterpret_cast<float*>(take(f * S * H));
  p.ss2 = reinterpret_cast<float*>(take(f * S * nblk * (GPT ? 2 : 1)));
  p.p_gu = reinterpret_cast<float*>(take(f * p.ks_gu * S * gu * p.ffn));
  p.p_d = reinterpret_cast<float*>(take(f * p.ks_d * S * H));
  p.work = reinterpret_cast<unsigned*>(take(sizeof(unsigned)));
  out->grid = grid;
  out->smem = smem;
  out->total = off;
  return 0;
}

template <int G, int D, bool GPT = false>
int run(Params& p, void* ws, long long* ws_bytes, cudaStream_t stream) {
  Layout lay;
  int err = plan<G, D, GPT>(p, static_cast<unsigned char*>(ws), &lay);
  if (err) return err;
  if (ws == nullptr) {
    if (ws_bytes) *ws_bytes = (long long)lay.total;
    return 0;
  }
  const int H = p.hidden, hd = p.kvh * G * D, kvd = p.kvh * D;
  WeightMaps tm = {};
  err = weight_map(&tm.q, p.wq, H, hd, kKS);
  if (!err) err = weight_map(&tm.k, p.wk, H, kvd, kKS);
  if (!err) err = weight_map(&tm.v, p.wv, H, kvd, kKS);
  if (!err) err = weight_map(&tm.o, p.wo, hd, H, kKS);
  if (!err && p.fuse_mlp) {
    if (!GPT) err = weight_map(&tm.g, p.wg, H, p.ffn, kKS);
    if (!err) err = weight_map(&tm.u, p.wu, H, p.ffn, kKS);
    if (!err) err = weight_map(&tm.d, p.wd, p.ffn, H, kKS);
  }
  if (err) return err;
  void* args[] = {&p, &tm};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_block_kernel<G, D, GPT>), dim3(lay.grid),
      dim3(kThreads), args, lay.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D>
int run_d(int group, Params& p, void* ws, long long* ws_bytes,
          cudaStream_t s) {
  switch (group) {
    case 1: return run<1, D>(p, ws, ws_bytes, s);
    case 2: return run<2, D>(p, ws, ws_bytes, s);
    case 4: return run<4, D>(p, ws, ws_bytes, s);
    case 8: return run<8, D>(p, ws, ws_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [slots, hidden] bf16; cos/sin [slots, d] fp32; ln1_w/ln2_w [hidden]
// bf16 (fp32 with ln_fp32); wq [hidden, h d], wk/wv [hidden, kvh d], wo
// [h d, hidden], wg/wu [hidden, ffn], wd [ffn, hidden] bf16, all
// contiguous; k/v pages [pages, kvh, ps, d] bf16 with heads and rows
// contiguous and page stride `page_stride` elements; page_table [slots,
// mpps] and lengths [slots] int32 (lengths before this token's append);
// y [slots, hidden], kt/vt [slots, kvh, d] bf16.  Group h / kvh 1, 2, 4
// or 8; d 64 or 128; hidden, h d and ffn multiples of 8, pointers
// 16-byte aligned.  With fuse_mlp 0, y = x + attention and the MLP
// weights are not read.  ws: the workspace; with ws null nothing is
// launched and *ws_bytes receives its size.  clock: null, or 10 uint64
// that receive the start, the end of each phase as block 0 leaves its
// barrier, and (atomicMax: zero it first) the last block's end, in ns.
extern "C" int apex_fused_block_decode(
    const void* x, const void* cos, const void* sin, const void* ln1_w,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const void* ln2_w, const void* wg, const void* wu, const void* wd,
    const void* k_pages, const void* v_pages, const void* page_table,
    const void* lengths, void* y, void* kt, void* vt, void* ws,
    long long* ws_bytes, void* clock, int slots, int hidden, int heads, int kvh, int d,
    int ffn, int ps, int mpps, long long page_stride, int fuse_mlp,
    int ln_fp32, float eps, float scale_log2, void* stream) {
  cudaGetLastError();
  if (slots <= 0 || hidden <= 0 || hidden % 8 || kvh <= 0 || heads % kvh ||
      ps <= 0 || mpps <= 0 || (fuse_mlp && (ffn <= 0 || ffn % 8)))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = static_cast<const bf16*>(x);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.ln1_w = ln1_w;
  p.ln2_w = ln2_w;
  p.wq = static_cast<const bf16*>(wq);
  p.wk = static_cast<const bf16*>(wk);
  p.wv = static_cast<const bf16*>(wv);
  p.wo = static_cast<const bf16*>(wo);
  p.wg = static_cast<const bf16*>(wg);
  p.wu = static_cast<const bf16*>(wu);
  p.wd = static_cast<const bf16*>(wd);
  p.kp = static_cast<const bf16*>(k_pages);
  p.vp = static_cast<const bf16*>(v_pages);
  p.page_table = static_cast<const int*>(page_table);
  p.lengths = static_cast<const int*>(lengths);
  p.y = static_cast<bf16*>(y);
  p.kt = static_cast<bf16*>(kt);
  p.vt = static_cast<bf16*>(vt);
  p.clock = static_cast<unsigned long long*>(clock);
  p.page_stride = page_stride;
  p.slots = slots;
  p.hidden = hidden;
  p.kvh = kvh;
  p.ffn = fuse_mlp ? ffn : 8;
  p.ps = ps;
  p.mpps = mpps;
  p.ln_fp32 = ln_fp32;
  p.fuse_mlp = fuse_mlp;
  p.eps = eps;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = heads / kvh;
  switch (d) {
    case 64: return run_d<64>(group, p, ws, ws_bytes, s);
    case 128: return run_d<128>(group, p, ws, ws_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The GPT layer: x [slots, hidden] bf16; ln1_w/ln1_b/ln2_w/ln2_b
// [hidden], bq/bk/bv [h d] / [kvh d], bo/bd [hidden], bu [ffn], all fp32;
// wq, wk, wv, wo, wu [hidden, ffn], wd [ffn, hidden] bf16; the pool,
// page table, lengths, outputs, workspace and clock as
// apex_fused_block_decode's.  h = kvh (group 1); d 64 or 128.  With
// fuse_mlp 0, y = x + (o + bo) and ln2, wu, bu, wd, bd are not read.
extern "C" int apex_fused_block_decode_gpt(
    const void* x, const void* ln1_w, const void* ln1_b, const void* wq,
    const void* bq, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* wo, const void* bo, const void* ln2_w,
    const void* ln2_b, const void* wu, const void* bu, const void* wd,
    const void* bd, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* y, void* kt,
    void* vt, void* ws, long long* ws_bytes, void* clock, int slots,
    int hidden, int heads, int kvh, int d, int ffn, int ps, int mpps,
    long long page_stride, int fuse_mlp, float eps, float scale_log2,
    void* stream) {
  cudaGetLastError();
  if (slots <= 0 || hidden <= 0 || hidden % 8 || kvh <= 0 || heads != kvh ||
      ps <= 0 || mpps <= 0 || (fuse_mlp && (ffn <= 0 || ffn % 8)))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = static_cast<const bf16*>(x);
  p.ln1_w = ln1_w;
  p.ln2_w = ln2_w;
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.wq = static_cast<const bf16*>(wq);
  p.wk = static_cast<const bf16*>(wk);
  p.wv = static_cast<const bf16*>(wv);
  p.wo = static_cast<const bf16*>(wo);
  p.wu = static_cast<const bf16*>(wu);
  p.wd = static_cast<const bf16*>(wd);
  p.bq = static_cast<const float*>(bq);
  p.bk = static_cast<const float*>(bk);
  p.bv = static_cast<const float*>(bv);
  p.bo = static_cast<const float*>(bo);
  p.bu = static_cast<const float*>(bu);
  p.bd = static_cast<const float*>(bd);
  p.kp = static_cast<const bf16*>(k_pages);
  p.vp = static_cast<const bf16*>(v_pages);
  p.page_table = static_cast<const int*>(page_table);
  p.lengths = static_cast<const int*>(lengths);
  p.y = static_cast<bf16*>(y);
  p.kt = static_cast<bf16*>(kt);
  p.vt = static_cast<bf16*>(vt);
  p.clock = static_cast<unsigned long long*>(clock);
  p.page_stride = page_stride;
  p.slots = slots;
  p.hidden = hidden;
  p.kvh = kvh;
  p.ffn = fuse_mlp ? ffn : 8;
  p.ps = ps;
  p.mpps = mpps;
  p.ln_fp32 = 1;
  p.fuse_mlp = fuse_mlp;
  p.eps = eps;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return run<1, 64, true>(p, ws, ws_bytes, s);
    case 128: return run<1, 128, true>(p, ws, ws_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
