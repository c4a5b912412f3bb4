// Flash-attention backward for Hopper (sm_90a), bf16 in, fp32 accumulate:
// the one-pass kernel and the split pair.
//
// Replaces: apex_tpu/ops/attention.py :: _bwd_fused_kernel (launched by
// _bwd_impl through pl.pallas_call), the one-pass backward, and the
// split backward's _dq_kernel and _dkv_kernel (the same _bwd_impl takes
// those when sq * d * 4 > _FUSED_BWD_MAX_BYTES, and so does the port's
// _bwd).  Same function, per (batch * head): with lse the forward's BASE-2
// log-sum-exp and delta = rowsum(dO * O) (computed by the caller),
//   p   = exp2(scale * log2(e) * q k^T - lse)     (masked entries 0;
//         rows whose lse is below -0.5e30 -- fully masked -- give 0),
//   dv += p^T dO,   dp = dO v^T,   ds = p (dp - delta),
//   dk += scale * ds^T q,   dq += scale * ds k,
// with the causal offset (key c is visible to query r when c <= r + off)
// and the validity window (queries >= valid_q and keys >= valid_k are
// masked) of _recompute_p.  p and ds are rounded to bf16 before their
// tensor-core products, as the TPU kernel feeds its MXU.
//
// Translation: the TPU kernel walks (key tile, query tile) pairs in a
// sequential grid and carries a full-sequence [sq, d] fp32 dq in VMEM,
// which limits it to sq * d * 4 <= 2 MB.  Here the grid is (key block,
// b*h), every block independent and the heaviest (first) key blocks of
// the causal mask launched first: a block keeps its 128 keys' k and v in
// shared memory and its dk and dv accumulators in registers, loops over
// the 64-query steps that can see those keys (k-major), and adds its dq
// contributions into an fp32 [b*h, sq, d] buffer (zeroed first; a last
// small kernel casts it to bf16).  So every sequence length the forward
// takes is taken; dq's last bits depend on the order the blocks add in.
//
// The one-pass kernel and the split dk/dv kernel are one template,
// flash_bwd_kernel<D, DQ>: the dk/dv kernel is DQ = false, the same
// blocks, loops and products without the dq half, so split and one-pass
// dk and dv are the same bits and repeat from run to run.
//
// What bounds it on the H100: operations.  A causal backward at s = 2048,
// 32 heads, d = 128 is 2.5x the forward's flops (five products per tile
// pair instead of two) over ~0.1 GB of q/k/v/o/dO/dq/dk/dv; the one-pass
// kernel also moves its fp32 dq partials through L2 (64 x d x 4 bytes
// per key block and query step: 0.29 GB at that shape).  The first
// version ran FlashAttention-2's scheme on mma.sync m16n8k16 with four
// warps of 16 keys and 32-query steps and added dq with per-thread fp32
// atomics; it reached 10-15% of the bound (latency: small steps with
// barriers, every B fragment re-read by each warp through ldmatrix, lse
// and delta read from global memory inside the loop, twice the dq
// traffic as per-thread reductions).  This design:
// - all five products run on wgmma (the only path to the card's bf16
//   rate): two warpgroups of 64 keys each, 64-query steps.  S^T = K Q^T
//   and dP^T = V dO^T read both operands from shared memory (K-major);
//   the bf16 P^T and dS^T fragments of those accumulators are the
//   REGISTER A operand of dV += P^T dO and dK += dS^T Q (Q and dO read
//   N-major from the same tiles); dk and dv stay in registers and are
//   written once;
// - q, dO and the step's lse and delta rows are copied with cp.async
//   into a 2-stage ring, prefetched one step ahead; tiles are held in
//   the 128-byte-swizzle layout wgmma reads (64-column chunks, the
//   16-byte units of row r XORed by r mod 8), which the copies write;
// - the softmax recompute is short: one ex2 instruction an element, and
//   without the dq half S^T and dP^T are two commit groups, so P^T and
//   the dV product run while dP^T is still on the tensor cores;
// - dq: dS^T is staged once in shared memory (bf16, swizzled) and each
//   warpgroup takes 64 of dq's d columns of dQ = dS K with one more
//   wgmma (dS read M-major, K N-major); the scaled 64 x d fp32 partial
//   goes to the accumulator as d / 32 bulk tensor reductions
//   (cp.reduce.async.bulk.tensor .add, 64 x 32 boxes of a tensor map in
//   the 128-byte swizzle, rows past sq clipped by the map) issued by one
//   thread, in place of per-thread atomics.
// Head dims 32, 64 and 128 share the template; a head dim under 64 is
// held zero-padded to one 64-column chunk (the swizzle's row).  Not yet
// used: TMA loads, a producer warp, setmaxnreg, overlap of one step's
// softmax with the next step's S^T (no registers left: dk, dv, S^T and
// dP^T hold 192 a thread).  PERF.md records the times.
//
// The split dq kernel is query-major: the forward's template with its
// dq half, flash_qmajor_kernel<D, true, kDqBK> (flash_qmajor.cuh).  A
// block keeps 128 queries' q and dO in shared memory (TMA loads by a
// copying warpgroup) and their lse and delta in registers, streams the
// key tiles they can see (64 keys a step, a 3-stage ring guarded by
// mbarriers), runs S = Q K^T and dP = dO V^T on wgmma as two commit
// groups (P's exp2 overlaps dP), and dQ += dS K with dS from registers
// and K read N-major from the tile that was S's B; it writes its
// queries' dq once (no atomics: the same bits from run to run).  Bound
// at causal [1, 32, 8192, 128]: operations, three products, 0.834 ms.
// The first version ran mma.sync m16n8k16 with four warps of 16
// queries, lse and delta read from global memory, and each K tile
// fetched twice through ldmatrix (plain and transposed): 3.51 ms there.
// Measured slower or refused (PERF.md): 128-key steps (ptxas spills at
// d = 128), the dQ product left in flight into the next step, the two
// product warpgroups taking turns to issue their products.
//
// Plain C interface (loaded with ctypes): apex_flash_attention_bwd,
// apex_flash_attention_bwd_dq and apex_flash_attention_bwd_dkv launch on
// the caller's stream and return cudaGetLastError().

#include "flash_qmajor.cuh"

namespace {

// ---------------------------------------------------------------------
// The one-pass kernel and the split dk/dv kernel: wgmma

constexpr int kBQ = 64;             // queries per step

// Two warpgroups a block, 64 keys each (one warpgroup a block, two blocks
// an SM, measured slower).
constexpr int kBK = 128;            // keys per block
constexpr int kThreads = 256;

// Shared memory, byte offsets from a 1024-aligned base (the swizzle's
// period).  Tiles of bf16 [rows][DP] are held as DP / 64 chunks of
// [rows][64] in the 128-byte-swizzle layout: sK, sV [kBK], sQ, sO [2
// stages][kBQ], then fp32 lse and delta [2 stages][kBQ] each, and with
// the dq half dS^T [kBK keys][kBQ queries] (one chunk) and the fp32 dq
// partial [kBQ][D] as D / 32 chunks of [kBQ][32] in the tensor map's
// 128-byte swizzle.
template <int D>
struct Tiles {
  static constexpr int DP = kDP<D>;
  static constexpr int kKV = kBK * DP * 2;
  static constexpr int kQ = kBQ * DP * 2;
  static constexpr int kDS = kBK * kBQ * 2;
  static constexpr int oK = 0, oV = kKV, oQ = 2 * kKV, oO = oQ + 2 * kQ,
                       oStats = oO + 2 * kQ, oDS = oStats + 4 * kBQ * 4,
                       oDQ = oDS + kDS;
  static constexpr size_t bytes(bool dq) {
    return 1024 + (dq ? oDQ + kBQ * D * 4 : oDS);
  }
};

// The dq map's box at (column c, row r, head bh) += the swizzled fp32
// tile at src: one bulk tensor reduction (rows past sq are not written).
__device__ __forceinline__ void tensor_add_f32(const CUtensorMap* map, int c,
                                               int r, int bh, uint32_t src) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(r), "r"(bh), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// DQ: the one-pass kernel (dq added into dq_acc through dq_map); without
// it the split dk/dv kernel (dq_map unused).  Warpgroup wg owns keys
// k0 + 64 wg .. + 63; within it warp w owns 16 of them, and a thread the
// rows grp and grp + 8 of those, as wgmma's accumulator layout places
// them.
template <int D, bool DQ>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const __grid_constant__ CUtensorMap dq_map,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                 int causal, int off, int valid_q, int valid_k,
                 float scale_log2, float scale) {
  using T = Tiles<D>;
  constexpr int DP = T::DP;
  constexpr int kKS = D / 16;        // k16 steps of S^T and dP^T over d
  constexpr int kQS = kBQ / 16;      // k16 steps of dV and dK over queries
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base + T::oK, sV = base + T::oV, sQ = base + T::oQ,
                 sO = base + T::oO, sStats = base + T::oStats,
                 sDS = base + T::oDS, sDQ = base + T::oDQ;
  const float* stats = reinterpret_cast<const float*>(smem + T::oStats);

  const int k0 = blockIdx.x * kBK;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * (size_t)sq * D;
  const bf16* ob = dout + bh * (size_t)sq * D;
  const float* lb = lse + bh * (size_t)sq;
  const float* db = delta + bh * (size_t)sq;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int krow = wg * 64 + warp * 16 + grp;   // and krow + 8

  const int kv_end = min(sk, valid_k);
  const int q_end = min(sq, valid_q);
  // query rows that can see any of this block's keys: [q_begin, q_end)
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - off);
  q_begin = (q_begin / kBQ) * kBQ;
  const int nq = (k0 < kv_end && q_begin < q_end)
                     ? (q_end - q_begin + kBQ - 1) / kBQ : 0;

  // one step's q, dO, lse and delta into stage st
  auto load_step = [&](int q0, int st) {
    load_sw<D, kBQ, kThreads>(sQ + st * T::kQ, qb, q0, sq);
    load_sw<D, kBQ, kThreads>(sO + st * T::kQ, ob, q0, sq);
    if (tid < 2 * kBQ) {
      const int i = tid % kBQ, which = tid / kBQ;
      const float* src = which ? db : lb;
      const bool live = q0 + i < sq;
      cp_async4z(sStats + ((which * 2 + st) * kBQ + i) * 4,
                 live ? src + q0 + i : src, live);
    }
  };
  load_sw<D, kBK, kThreads>(sK, k + bh * (size_t)sk * D, k0, sk);
  load_sw<D, kBK, kThreads>(sV, v + bh * (size_t)sk * D, k0, sk);
  if (nq > 0) load_step(q_begin, 0);
  cp_async_commit();

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  unsigned pa[kQS][4], da[kQS][4];

  for (int it = 0; it < nq; ++it) {
    const int q0 = q_begin + it * kBQ;
    const int st = it & 1;
    cp_async_wait<0>();
    fence_async_smem();     // the copies, visible to wgmma's async reads
    __syncthreads();
    if (it + 1 < nq) load_step(q0 + kBQ, st ^ 1);
    cp_async_commit();
    const uint32_t cQ = sQ + st * T::kQ, cO = sO + st * T::kQ;

    // S^T = K Q^T and dP^T = V dO^T over this warpgroup's 64 keys, one
    // commit group each (the first k-step overwrites the accumulators)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    keep(s);
    keep(dp);
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
    // without the dq half, P^T and dV overlap the dP^T product; with it
    // the step measured faster with both products done first (and dV
    // issued beside dK)
    constexpr bool kEarlyDV = !DQ;
    wgmma_wait<kEarlyDV ? 1 : 0>();
    keep(s);

    // P^T = exp2(S^T * scale_log2 - lse[q]) with the masks; a tile inside
    // every mask skips the per-element test
    const float* cl = stats + st * kBQ;
    const float* cd = stats + (2 + st) * kBQ;
    const int wk0 = k0 + wg * 64;
    const bool full = wk0 + 64 <= kv_end && q0 + kBQ <= q_end &&
                      (!causal || wk0 + 63 <= q0 + off);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(cl + j * 8 + tig * 2);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = q0 + j * 8 + tig * 2 + e;
        const float l = e ? l2.y : l2.x;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kr = k0 + krow + hf * 8;
          const bool live = full || (kr < kv_end && qc < q_end &&
                                     (!causal || kr <= qc + off));
          const int x = j * 4 + hf * 2 + e;
          s[x] = (live && l > kMaskedRowThresh)
                     ? exp2_ftz(s[x] * scale_log2 - l)
                     : 0.f;
        }
      }
    }
    // the accumulator fragments of query columns 16t .. 16t + 15 are the
    // A fragment of k-step t, rounded to bf16
#pragma unroll
    for (int t = 0; t < kQS; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[t][i] = pack_bf16(s[8 * t + 2 * i], s[8 * t + 2 * i + 1]);

    // dV += P^T dO: A from registers, dO read N-major from the step's
    // tile (LBO: the 64-column chunk stride)
    auto issue_dv = [&] {
#pragma unroll
      for (int t = 0; t < kQS; ++t)
        wgmma_rs(dva, pa[t], gmma_desc(cO + t * 16 * 128, kBQ * 128, 1024),
                 1);
    };
    if constexpr (kEarlyDV) {
      keep(dva);
      keep(pa);
      wgmma_fence();
      issue_dv();
      wgmma_commit();
      wgmma_wait<1>();        // dP^T is done; dV may still run
    }
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
          dp[x] = s[x] * (dp[x] - (e ? d2.y : d2.x));
        }
    }
#pragma unroll
    for (int t = 0; t < kQS; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        da[t][i] = pack_bf16(dp[8 * t + 2 * i], dp[8 * t + 2 * i + 1]);
    float dqa[32];     // dQ's partial (the dq half)
    if constexpr (DQ) {
      // stage dS^T [keys][queries] for dQ = dS K: query column pair
      // (8j + 2 tig, +1) of key rows krow, krow + 8
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = krow + hf * 8;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                           sDS + sw128<kBK>(r, j) + tig * 4),
                       "r"(da[j >> 1][(j & 1) * 2 + hf]));
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
      keep(dqa);
    }

    // dK += dS^T Q: as dV, Q read N-major
    keep(dva);
    keep(dka);
    keep(pa);
    keep(da);
    wgmma_fence();
    if constexpr (!kEarlyDV) issue_dv();
#pragma unroll
    for (int t = 0; t < kQS; ++t)
      wgmma_rs(dka, da[t], gmma_desc(cQ + t * 16 * 128, kBQ * 128, 1024), 1);
    wgmma_commit();

    if constexpr (DQ) {
      fence_async_smem();                 // dS^T, visible to wgmma
      if (tid == 0) bulk_wait_read();     // the dq tile is free again
      __syncthreads();
      // dQ[:, 64 wg ..] = dS K: dS^T read M-major, K N-major (with
      // DP = 64 the second warpgroup has no columns)
      if (wg * 64 < DP) {
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < kBK / 16; ++kt)
          wgmma_ss<1, 1>(
              dqa, gmma_desc(sDS + kt * 16 * 128, kBK * 128, 1024),
              gmma_desc(sK + wg * (kBK * 128) + kt * 16 * 128, kBK * 128,
                        1024),
              kt > 0);
        wgmma_commit();
      }
      wgmma_wait_all();
      keep(dqa);
      keep(dva);
      keep(dka);
      keep(pa);
      keep(da);
      if (wg * 64 < DP) {
        // the scaled partial into the tensor map's swizzled [32-column
        // chunk][kBQ][32] tile
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wg * 64 + j * 8 + tig * 2;
          if (col < D) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = warp * 16 + grp + hf * 8, c = col & 31;
              const uint32_t a = sDQ + (col >> 5) * (kBQ * 128) + r * 128 +
                                 ((((c >> 2) ^ (r & 7))) << 4) + (c & 3) * 4;
              asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
                           "f"(scale * dqa[j * 4 + hf * 2]),
                           "f"(scale * dqa[j * 4 + hf * 2 + 1]));
            }
          }
        }
      }
      fence_async_smem();                 // the dq tile, visible to the
      if (tid < 32) {                     // bulk reductions
        bar_sync(1, kThreads);
        if (tid == 0) {
#pragma unroll
          for (int c = 0; c < D / 32; ++c)
            tensor_add_f32(&dq_map, c * 32, q0, (int)bh,
                           sDQ + c * (kBQ * 128));
          bulk_commit();
        }
      } else {
        bar_arrive(1, kThreads);
      }
    } else {
      wgmma_wait_all();
      keep(dva);
      keep(dka);
      keep(pa);
      keep(da);
    }
  }
  if (DQ && tid == 0) bulk_wait();
  cp_async_wait<0>();  // nq == 0: the k/v copies may still be in flight

  // this block owns its keys' dk and dv: plain stores, no atomics
  bf16* dkb = dk + bh * (size_t)sk * D;
  bf16* dvb = dv + bh * (size_t)sk * D;
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

// dq (bf16) = the fp32 accumulator, 8 elements per thread (n % 8 == 0).
__global__ void dq_cast_kernel(const float* __restrict__ src,
                               bf16* __restrict__ dst, size_t n8) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 a = reinterpret_cast<const float4*>(src)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(src)[2 * i + 1];
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(a.x, a.y);
    h[1] = __floats2bfloat162_rn(a.z, a.w);
    h[2] = __floats2bfloat162_rn(b.x, b.y);
    h[3] = __floats2bfloat162_rn(b.z, b.w);
    reinterpret_cast<uint4*>(dst)[i] = raw;
  }
}

// The tensor map of the fp32 dq accumulator [bh, sq, d] for the kernel's
// bulk reductions: boxes of 64 rows x 32 columns, 128-byte swizzle.
int dq_tensor_map(CUtensorMap* map, void* dq_acc, int bh, int sq, int d) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)sq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                 (cuuint64_t)sq * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)kBQ, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dq_acc,
                            dims, strides, box, one,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// flash_bwd_kernel<D, DQ> over (key block, b*h).
template <int D, bool DQ>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const CUtensorMap& map,
               void* dk, void* dv, int bh, int sq, int sk, int causal,
               int off, int valid_q, int valid_k, float scale_log2,
               float scale, cudaStream_t stream) {
  const size_t bytes = Tiles<D>::bytes(DQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D, DQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + kBK - 1) / kBK, bh);
  flash_bwd_kernel<D, DQ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), map,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, causal, off,
      valid_q, valid_k, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq_acc, void* dq,
           void* dk, void* dv, int bh, int sq, int sk, int causal, int off,
           int valid_q, int valid_k, float scale_log2, float scale,
           cudaStream_t stream) {
  const size_t n = (size_t)bh * sq * D;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (sk > 0) {
    CUtensorMap map;
    const int e = dq_tensor_map(&map, dq_acc, bh, sq, D);
    if (e) return e;
    const int r = launch_bwd<D, true>(
        q, k, v, dout, lse, delta, map, dk, dv, bh, sq, sk, causal, off,
        valid_q, valid_k, scale_log2, scale, stream);
    if (r) return r;
  }
  const size_t n8 = n / 8;
  const int blocks = (int)((n8 + 255) / 256 < 4096 ? (n8 + 255) / 256 : 4096);
  dq_cast_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), n8);
  return (int)cudaGetLastError();
}

// The split pair: dq from the query-major kernel (flash_qmajor.cuh, the
// forward's template with its dq half), dk and dv from the one-pass
// kernel without its dq half.
constexpr int kDqBK = 64;    // keys a step of the dq kernel

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq,
              int sk, int causal, int off, int valid_q, int valid_k,
              float scale_log2, float scale, cudaStream_t stream) {
  return launch_qmajor<D, true, kDqBK>(
      q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, scale, stream);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int sq, int sk, int causal, int off, int valid_q, int valid_k,
               float scale_log2, float scale, cudaStream_t stream) {
  CUtensorMap unused{};
  return launch_bwd<D, false>(
      q, k, v, dout, lse, delta, unused, dk, dv, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, scale, stream);
}

}  // namespace

// q, dout [bh, sq, d], k, v [bh, sk, d] contiguous, 16-byte aligned bf16;
// lse, delta [bh, sq] fp32 (lse in base 2); dq_acc [bh, sq, d] fp32
// scratch; dq [bh, sq, d], dk, dv [bh, sk, d] bf16 outputs.  d must be
// 32, 64 or 128.
extern "C" int apex_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq_acc, void* dq, void* dk,
    void* dv, int bh, int sq, int sk, int d, int causal, int off,
    int valid_q, int valid_k, float scale_log2, float scale, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh,
                        sq, sk, causal, off, valid_q, valid_k, scale_log2,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh,
                        sq, sk, causal, off, valid_q, valid_k, scale_log2,
                        scale, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh,
                         sq, sk, causal, off, valid_q, valid_k, scale_log2,
                         scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The split backward's dq: operands as apex_flash_attention_bwd's; dq
// [bh, sq, d] bf16, written once (no scratch, no atomics).
extern "C" int apex_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
    int d, int causal, int off, int valid_q, int valid_k, float scale_log2,
    float scale, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal,
                           off, valid_q, valid_k, scale_log2, scale, s);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal,
                           off, valid_q, valid_k, scale_log2, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                            causal, off, valid_q, valid_k, scale_log2, scale,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The split backward's dk and dv: operands as apex_flash_attention_bwd's;
// dk, dv [bh, sk, d] bf16.
extern "C" int apex_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
    int sk, int d, int causal, int off, int valid_q, int valid_k,
    float scale_log2, float scale, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sk <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                            causal, off, valid_q, valid_k, scale_log2, scale,
                            s);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                            causal, off, valid_q, valid_k, scale_log2, scale,
                            s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                             causal, off, valid_q, valid_k, scale_log2, scale,
                             s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
