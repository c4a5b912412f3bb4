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
//   4. per (slot, head): merge the splits and fold the current token;
//   5. the o product; 6. x2 = x + o, norm2 sums per 256 columns;
//   7. norm2 statistics, the gate/up products; 8. silu(g) u, the down
//      product; 9. y = x2 + down.
// Every product is a GEMV phase: a block owns a tile of 256 output
// columns of the [in, out] weight and a chunk of its input rows
// (split-K).  The tile streams through a ring of shared-memory stages
// (cp.async, each warp copying whole 512-byte rows), and the tensor
// cores multiply it into all 8 slots at once: ldmatrix.trans turns 16
// rows x 16 columns of the [in, out] tile into the A operand of an
// m16n8k16 mma.sync whose N = 8 are the slots (the activations sit in
// shared memory as bf16 [8 slots][rows], the B operand).  Each warp
// owns 32 of the 256 columns, so no warp's sum meets another's; each
// split-K chunk writes an fp32 partial that the next phase sums in a
// fixed order (no atomics: the result is the same from run to run).
// More than 8 slots run as groups of 8 over each item.
//
// What bounds it on the H100: bytes.  A Llama-3-8B layer reads 218.1 M
// bf16 weights (436.2 MB) plus the live k/v pages, and does 2 flops per
// weight per slot: at 8 slots, 16 flops per 2 bytes, far below the
// ~295 flop/byte balance point, so the floor is ~0.130 ms per layer at
// 3.35 TB/s.  The design reads each weight byte once, in wide coalesced
// 16-byte copies, keeps three ring stages (48 KB a block, two blocks an
// SM) in flight, leaves the arithmetic to the tensor cores (on fp32
// FMAs it is 4 FMAs per weight byte at 8 slots; that version was no
// faster, so issue is not what limits), and keeps the intermediates
// (partials, q, k, v, context, x2: a few MB) in L2.  On the H100 the
// products stream at a little over 2 TB/s; a deeper ring, 1 KB row
// slices and L2 prefetch of the next product's weights each measured
// slower (PERF.md).  No wgmma, no TMA yet.
//
// Plain C interface (loaded with ctypes): apex_fused_block_decode
// launches on the caller's stream and returns cudaGetLastError(); with
// a null workspace it only reports the workspace bytes it needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;          // slots per GEMV pass (accumulator rows)
constexpr int kTile = 256;         // output columns per GEMV item: 8 warps x 32
constexpr int kKS = 32;            // weight rows per GEMV ring stage
constexpr int kStages = 4;         // ring stages (3 in flight)
constexpr int kLDW = kTile + 8;    // bf16 per staged row: conflict-free ldmatrix
constexpr int kGemvRingBytes = kStages * kKS * kLDW * 2;
constexpr int kMaxChunk = 2048;    // input rows per GEMV item
constexpr int kChunk = 64;         // tokens per staged attention chunk
constexpr int kSplitTokens = 256;  // window positions per attention item
constexpr int kRowBlock = kThreads;  // columns per residual item
constexpr int kMaxBlocksPerSM = 2;
constexpr float kNegInf = -1e30f;  // attention.py _NEG_INF
constexpr int kPhases = 9;         // clock: [0] start, [1..8] barriers, [9] end

static_assert(kTile == 32 * kWarps, "a warp owns 32 columns of the tile");
static_assert(kThreads / kChunk == 4, "four threads score one token");

// arrivals and generation of the grid barrier; zero when no launch is
// inside a barrier (each barrier's last arrival resets the count)
__device__ unsigned g_barrier[2];

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
  bf16* ctx;                // [slots, h d]
  float* p_o;               // [ks_o, slots, hidden]
  float* x2;                // [slots, hidden]
  float* ss2;               // [slots, ceil(hidden / 256)]
  float* p_gu;              // [ks_gu, slots, 2 ffn]
  float* p_d;               // [ks_d, slots, hidden]
  unsigned* work;           // the attention phase's item counter
  unsigned long long* clock;  // optional [kPhases + 1] phase end times (ns)
  long long page_stride;
  int slots, hidden, kvh, ffn, ps, mpps, nsplit;
  int ks_qkv, ks_o, ks_gu, ks_d;
  int ch_qkv, ch_o, ch_gu, ch_d;
  int ln_fp32, fuse_mlp, r_off;
  float eps, scale_log2;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h2[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
  const bf16* w;  // [K, n] row-major ([in, out])
  int n;          // columns (a multiple of 8)
  int col_off;    // first column of this weight in the partial rows
};

// The GEMV's activations, four consecutive inputs k .. k + 3 of one slot
// at a time (k a multiple of 4; K is a multiple of 8).

__device__ __forceinline__ float4 bf16x4(uint2 raw) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// A = bf16(v * r[slot] * w[k]) with v from the bf16 x or the fp32 x2:
// the normalised activations the q/k/v and gate/up products read.
struct BuildNorm {
  const bf16* xb;
  const float* xf;
  const float* r;
  const void* w;
  int ln_fp32, hidden, slots;
  __device__ float4 operator()(int slot, int k) const {
    const size_t i = (size_t)slot * hidden + k;
    const float4 v =
        xb ? bf16x4(__ldg(reinterpret_cast<const uint2*>(xb + i)))
           : __ldcg(reinterpret_cast<const float4*>(xf + i));
    const float4 w4 =
        ln_fp32 ? __ldg(reinterpret_cast<const float4*>(w) + k / 4)
                : bf16x4(__ldg(reinterpret_cast<const uint2*>(
                      static_cast<const bf16*>(w) + k)));
    const float rs = r[slot];
    return make_float4(bf16_round(v.x * rs * w4.x), bf16_round(v.y * rs * w4.y),
                       bf16_round(v.z * rs * w4.z), bf16_round(v.w * rs * w4.w));
  }
};

// A = bf16(ctx), the o product's input
struct BuildCtx {
  const bf16* ctx;
  int width;
  __device__ float4 operator()(int slot, int k) const {
    return bf16x4(__ldcg(
        reinterpret_cast<const uint2*>(ctx + (size_t)slot * width + k)));
  }
};

// A = bf16(silu(g) u) from the gate/up partials, the down product's input
struct BuildAct {
  const float* p_gu;
  int ks, ffn, slots;
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

// zero-filling 16-byte copy: `bytes` 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 sums (tensor cores)
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// part[kc][slot][col_off + c] = sum over k in chunk kc of A[slot][k] w[k][c]
// for every segment; items (column tile, chunk) are dealt to the blocks.
// The weight tile streams through a ring of kStages shared-memory stages
// of kKS rows (cp.async, 16 bytes a thread, a warp's 32 copies one
// 512-byte row); A sits in shared memory as bf16 [8 slots][chunk].  Each
// warp owns 32 of the tile's 256 columns: per 16 rows, ldmatrix.trans
// turns the [in, out] rows into the m16n8k16 A operand (16 columns x 16
// rows) and the tensor cores multiply it into the 8 slots (N = 8), so a
// warp's result needs no reduction with the others.
template <class Build>
__device__ void gemv(const Seg* segs, int nseg, int K, int ks, int chunk,
                     float* part, int ldo, int slots, unsigned char* smem,
                     const Build& build) {
  int tiles[3];
  int total = 0;
  for (int i = 0; i < nseg; ++i) {
    tiles[i] = (segs[i].n + kTile - 1) / kTile;
    total += tiles[i];
  }
  const int items = total * ks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int ldx = chunk + 8;   // bf16 per A row (4-bank shift per slot)
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* sX = reinterpret_cast<bf16*>(smem + kGemvRingBytes);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    // tile-fastest: blocks that run together read neighbouring slices
    // of the same weight rows
    int t = it % total;
    const int kc = it / total;
    int si = 0;
    while (t >= tiles[si]) t -= tiles[si++];
    const Seg sg = segs[si];
    const int c0 = t * kTile;
    const int k0 = kc * chunk, k1 = min(K, k0 + chunk);
    const int nst = (k1 - k0 + kKS - 1) / kKS;

    // stage st: weight rows k0 + st kKS .. + kKS, tile columns; rows past
    // k1 and columns past n are zero-filled
    auto load_stage = [&](int st) {
      bf16* dst = sW + (st % kStages) * kKS * kLDW;
      for (int i = tid; i < kKS * (kTile / 8); i += kThreads) {
        const int r = i / (kTile / 8), seg = (i % (kTile / 8)) * 8;
        const int k = k0 + st * kKS + r, c = c0 + seg;
        const bool ok = k < k1 && c < sg.n;
        cp_async16_zfill(dst + r * kLDW + seg,
                         ok ? sg.w + (size_t)k * sg.n + c : sg.w, ok ? 16 : 0);
      }
    };

    for (int sb = 0; sb < slots; sb += kSlots) {
#pragma unroll
      for (int st = 0; st < kStages - 1; ++st) {
        if (st < nst) load_stage(st);
        cp_async_commit();
      }
      // the activations of this chunk for slots sb..sb+7 as bf16 (their
      // values are bf16 already), zero past k1 and past the last slot;
      // four groups of four inputs a thread at a time, so their L2 reads
      // overlap
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
        cp_async_wait<kStages - 2>();
        __syncthreads();  // stage st landed for all; stage st - 1 is free
        if (st + kStages - 1 < nst) load_stage(st + kStages - 1);
        cp_async_commit();
        const bf16* ws = sW + (st % kStages) * kKS * kLDW;
#pragma unroll
        for (int kk = 0; kk < kKS; kk += 16) {
          const bf16* xr = sX + g * ldx + st * kKS + kk + 2 * tig;
          const unsigned b0 = *reinterpret_cast<const unsigned*>(xr);
          const unsigned b1 = *reinterpret_cast<const unsigned*>(xr + 8);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            unsigned a[4];
            ldmatrix_x4_trans(
                a, ws + (kk + (lane & 7) + ((lane >> 4) << 3)) * kLDW +
                       warp * 32 + m * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(acc[m], a, b0, b1);
          }
        }
      }
      cp_async_wait<0>();
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
// RoPE on q and k in fp32 (half rotation: element e pairs with e ^ d/2);
// q, k, v stay fp32 for the attention and the fold, k and v also leave
// as bf16 for the caller's pool append.
template <int D>
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
    const bool roped = head < h + kvh;
#pragma unroll 4
    for (int c = 0; c < p.ks_qkv; ++c) {
      a += __ldcg(part + c * stride + col);
      if (roped) b += __ldcg(part + c * stride + (col ^ (D / 2)));
    }
    if (roped) {
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
    // partial state; the merge phase folds the splits and the new token
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

// One warp per (slot, head): merge the live splits (m_s, l_s, acc_s),
// then fold the current token as one more online-softmax column from
// the fp32 q, k, v; ctx = acc / l (l > 0: the token is always live).
template <int D>
__device__ void merge_phase(const Params& p, int group) {
  constexpr int kPer = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kvh = p.kvh, h = kvh * group;
  const int items = p.slots * h;
  for (int it = blockIdx.x * kWarps + warp; it < items;
       it += gridDim.x * kWarps) {
    const int slot = it / h, head = it % h, kh = head / group;
    const int len = min(p.lengths[slot], p.mpps * p.ps);
    const int nlive = max(1, (len + kSplitTokens - 1) / kSplitTokens);
    const size_t qrow = (size_t)slot * h + head;
    const float* q = p.q32 + qrow * D;
    const size_t kv_off = ((size_t)slot * kvh + kh) * D;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      dot += __ldcg(q + lane + 32 * j) * __ldcg(p.kn32 + kv_off + lane + 32 * j);
    const float s_new = warp_sum(dot) * p.scale_log2;
    const float* ml = p.part_ml + qrow * p.nsplit * 2;
    float mx = kNegInf;
#pragma unroll 4
    for (int s = 0; s < nlive; ++s)
      if (__ldcg(ml + 2 * s + 1) > 0.f) mx = fmaxf(mx, __ldcg(ml + 2 * s));
    float l = 0.f, acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int s = 0; s < nlive; ++s) {
      const float ls = __ldcg(ml + 2 * s + 1);
      if (ls > 0.f) {
        const float wgt = exp2f(__ldcg(ml + 2 * s) - mx);
        l += wgt * ls;
        const float* a = p.part_acc + (qrow * p.nsplit + s) * D;
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[j] += wgt * __ldcg(a + lane + 32 * j);
      }
    }
    const float m_new = fmaxf(mx, s_new);
    const float alpha = exp2f(mx - m_new);
    const float p_new = exp2f(s_new - m_new);
    l = l * alpha + p_new;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = lane + 32 * j;
      const float a = acc[j] * alpha + p_new * __ldcg(p.vn32 + kv_off + e);
      p.ctx[(size_t)slot * h * D + (size_t)head * D + e] = __float2bfloat16(a / l);
    }
  }
}

// rsqrt(mean(x^2) + eps) of every slot's bf16 row (one warp a slot)
__device__ void norm1_stats(const Params& p, float* sR) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < p.slots; s += kWarps) {
    const bf16* xr = p.x + (size_t)s * p.hidden;
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

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
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

template <int G, int D>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
fused_block_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  float* sR = reinterpret_cast<float*>(smem + p.r_off);  // [slots]
  const int S = p.slots, H = p.hidden, tid = threadIdx.x;
  const int h = p.kvh * G, hd = h * D, kvd = p.kvh * D;
  const int nqkv = hd + 2 * kvd;
  const int nblk = (H + kRowBlock - 1) / kRowBlock;

  if (blockIdx.x == 0 && tid == 0) {
    *p.work = 0u;        // published by the first barrier
    if (p.clock) p.clock[0] = globaltimer();
  }
  // 1. norm1 statistics, then q | k | v = bf16(h1) @ [wq | wk | wv]
  norm1_stats(p, sR);
  __syncthreads();
  {
    const Seg segs[3] = {{p.wq, hd, 0}, {p.wk, kvd, hd}, {p.wv, kvd, hd + kvd}};
    gemv(segs, 3, H, p.ks_qkv, p.ch_qkv, p.p_qkv, nqkv, S, smem,
         BuildNorm{p.x, nullptr, sR, p.ln1_w, p.ln_fp32, H, S});
  }
  phase_end(p, 1);
  // 2. q, k, v: the partials' sums, RoPE
  qkv_phase<D>(p, h);
  phase_end(p, 2);
  // 3. paged attention over the live pages, split by 256 tokens
  attention_phase<G, D>(p, smem);
  phase_end(p, 3);
  // 4. merge the splits, fold the current token: ctx
  merge_phase<D>(p, G);
  phase_end(p, 4);
  // 5. o = bf16(ctx) @ wo
  {
    const Seg segs[1] = {{p.wo, H, 0}};
    gemv(segs, 1, hd, p.ks_o, p.ch_o, p.p_o, H, S, smem, BuildCtx{p.ctx, hd});
  }
  phase_end(p, 5);
  // 6. x2 = x + o (fp32); norm2's sums of squares per 256 columns.
  //    Without the MLP, y = x2 and the layer ends here.
  for (int it = blockIdx.x; it < S * nblk; it += gridDim.x) {
    const int slot = it / nblk, b = it % nblk;
    const int col = b * kRowBlock + tid;
    float v = 0.f;
    if (col < H) {
      const size_t i = (size_t)slot * H + col;
      v = __bfloat162float(p.x[i]);
#pragma unroll 4
      for (int c = 0; c < p.ks_o; ++c)
        v += __ldcg(p.p_o + ((size_t)c * S + slot) * H + col);
      if (p.fuse_mlp)
        __stcg(p.x2 + i, v);
      else
        p.y[i] = __float2bfloat16(v);
    }
    if (p.fuse_mlp) {
      const float ss = block_sum(v * v, red);
      if (tid == 0) __stcg(p.ss2 + (size_t)slot * nblk + b, ss);
    }
  }
  if (!p.fuse_mlp) {
    kernel_end(p);
    return;
  }
  phase_end(p, 6);
  // 7. norm2 statistics, then g | u = bf16(h2) @ [wg | wu]
  for (int s = tid; s < S; s += kThreads) {
    float ss = 0.f;
    for (int b = 0; b < nblk; ++b) ss += __ldcg(p.ss2 + (size_t)s * nblk + b);
    sR[s] = rsqrtf(ss / H + p.eps);
  }
  __syncthreads();
  {
    const Seg segs[2] = {{p.wg, p.ffn, 0}, {p.wu, p.ffn, p.ffn}};
    gemv(segs, 2, H, p.ks_gu, p.ch_gu, p.p_gu, 2 * p.ffn, S, smem,
         BuildNorm{nullptr, p.x2, sR, p.ln2_w, p.ln_fp32, H, S});
  }
  phase_end(p, 7);
  // 8. down = bf16(silu(g) u) @ wd
  {
    const Seg segs[1] = {{p.wd, H, 0}};
    gemv(segs, 1, p.ffn, p.ks_d, p.ch_d, p.p_d, H, S, smem,
         BuildAct{p.p_gu, p.ks_gu, p.ffn, S});
  }
  phase_end(p, 8);
  // 9. y = x2 + down
  for (int i = blockIdx.x * kThreads + tid; i < S * H; i += gridDim.x * kThreads) {
    const int slot = i / H, col = i % H;
    float v = __ldcg(p.x2 + i);
#pragma unroll 4
    for (int c = 0; c < p.ks_d; ++c)
      v += __ldcg(p.p_d + ((size_t)c * S + slot) * H + col);
    p.y[i] = __float2bfloat16(v);
  }
  kernel_end(p);
}

// ------------------------------------------------------------------ host

// split-K of a K-row product over `tiles` column tiles: about one item
// per block, chunks of at most kMaxChunk rows, a multiple of 32 rows
// (8 warps x 4 rows) each, no empty chunk.  (More, smaller chunks to
// even out the blocks' loads cost more in the consumer, which sums one
// partial per chunk, than they save.)
void split_k(int K, int tiles, int grid, int* ks, int* chunk) {
  int k = grid / tiles > 1 ? grid / tiles : 1;
  k = k > (K + kMaxChunk - 1) / kMaxChunk ? k : (K + kMaxChunk - 1) / kMaxChunk;
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
template <int G, int D>
int plan(Params& p, unsigned char* base, Layout* out) {
  // per device (and per instantiation): the SM count, and the blocks per
  // SM at the shared-memory size last asked for
  static int sms[64], blocks_at[64], smem_at[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  size_t region = AttnSmem<G, D>::bytes;
  const size_t gemv_bytes =
      kGemvRingBytes + sizeof(bf16) * kSlots * (kMaxChunk + 8);
  region = region > gemv_bytes ? region : gemv_bytes;
  p.r_off = (int)((region + 15) / 16 * 16);
  const int smem = p.r_off + (int)sizeof(float) * p.slots;
  if (smem_at[dev] != smem) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fused_block_kernel<G, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_at[dev], fused_block_kernel<G, D>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks_at[dev] < 1) return (int)cudaErrorInvalidConfiguration;
    smem_at[dev] = smem;
  }
  const int blocks = blocks_at[dev];
  const int grid = (blocks < kMaxBlocksPerSM ? blocks : kMaxBlocksPerSM) * sms[dev];

  const int S = p.slots, H = p.hidden, h = p.kvh * G;
  const int hd = h * D, kvd = p.kvh * D;
  split_k(H, tiles_of(hd) + 2 * tiles_of(kvd), grid, &p.ks_qkv, &p.ch_qkv);
  split_k(hd, tiles_of(H), grid, &p.ks_o, &p.ch_o);
  split_k(H, 2 * tiles_of(p.ffn), grid, &p.ks_gu, &p.ch_gu);
  split_k(p.ffn, tiles_of(H), grid, &p.ks_d, &p.ch_d);
  p.nsplit = (p.mpps * p.ps + kSplitTokens - 1) / kSplitTokens;
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
  p.ctx = reinterpret_cast<bf16*>(take(sizeof(bf16) * S * hd));
  p.p_o = reinterpret_cast<float*>(take(f * p.ks_o * S * H));
  p.x2 = reinterpret_cast<float*>(take(f * S * H));
  p.ss2 = reinterpret_cast<float*>(take(f * S * nblk));
  p.p_gu = reinterpret_cast<float*>(take(f * p.ks_gu * S * 2 * p.ffn));
  p.p_d = reinterpret_cast<float*>(take(f * p.ks_d * S * H));
  p.work = reinterpret_cast<unsigned*>(take(sizeof(unsigned)));
  out->grid = grid;
  out->smem = smem;
  out->total = off;
  return 0;
}

template <int G, int D>
int run(Params& p, void* ws, long long* ws_bytes, cudaStream_t stream) {
  Layout lay;
  int err = plan<G, D>(p, static_cast<unsigned char*>(ws), &lay);
  if (err) return err;
  if (ws == nullptr) {
    if (ws_bytes) *ws_bytes = (long long)lay.total;
    return 0;
  }
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_block_kernel<G, D>), dim3(lay.grid),
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
