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
// which limits it to sq * d * 4 <= 2 MB.  Here the grid is (key tile,
// b*h), every block independent: a block keeps its 64 keys' k and v in
// shared memory and its dk and dv accumulators in registers, loops over
// the query tiles that can see those keys (k-major), and adds its dq
// contributions into an fp32 [b*h, sq, d] buffer with vector atomics.
// A last small kernel casts that buffer to bf16.  So every sequence
// length the forward takes is taken; the atomics make dq's last bits
// depend on the order the blocks finish in.
//
// The split pair computes the same function in two launches, neither
// with atomics, so dq, dk and dv repeat bit for bit from run to run:
// - the dk/dv kernel is this kernel with its dq half compiled out
//   (flash_bwd_kernel<D, false>): the same blocks, loops and products,
//   so its dk and dv have the one-pass kernel's bits;
// - the dq kernel is query-major, one block per (64-query tile, b*h):
//   it keeps its queries' q and dO in shared memory, loops over the key
//   tiles they can see (double-buffered k and v), recomputes
//   S = Q K^T and dP = dO V^T, p and ds = p (dP - delta) with the same
//   masks, and accumulates dq = scale * dS K in registers, written once.
//   It recomputes S and dP, which the one-pass kernel shares with
//   dk/dv: the pair does 7 tile products where the one-pass kernel does
//   5, the price of owning every output in one block.
//
// What bounds it on the H100: operations.  A causal backward at s = 2048,
// 32 heads, d = 128 is 2.5x the forward's flops (five products per tile
// pair instead of two) over ~0.1 GB of q/k/v/o/dO/dq/dk/dv.  The design
// is FlashAttention-2's backward on mma.sync m16n8k16 (bf16 in, fp32
// accumulate): four warps each own 16 keys; S^T, P^T, dP^T and dS^T of a
// (64-key, 32-query) tile live in registers -- the S^T accumulator
// fragment is the A operand of dV and dK, so P and dS never go through
// shared memory for those -- and dS^T is staged once in shared memory
// for the dq product, which is query-major.  q and dO tiles are copied
// with cp.async into a double buffer.  Not yet used: wgmma, TMA, warp
// specialisation; PERF.md records this version's time.
//
// Plain C interface (loaded with ctypes): apex_flash_attention_bwd,
// apex_flash_attention_bwd_dq and apex_flash_attention_bwd_dkv launch on
// the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;            // keys per block
constexpr int kBQ = 32;            // queries per inner step
constexpr int kWarps = kBK / 16;   // each warp owns 16 keys
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kMaskedRowThresh = -0.5e30f;
constexpr int kLDS = kBQ + 8;      // dS^T tile row stride (bf16)

// Shared tiles, bf16, row stride D + 8 (16 bytes of padding, so the
// eight rows an ldmatrix phase reads fall in distinct bank groups):
// sK [kBK], sV [kBK], sQ [2][kBQ], sO [2][kBQ] (dO), and with the dq half
// sDS [kBK][kLDS].
template <int D>
struct Layout {
  static constexpr int LD = D + 8;
  static constexpr size_t bytes(bool dq) {
    return sizeof(bf16) *
           ((2 * kBK + 4 * kBQ) * LD + (dq ? kBK * kLDS : 0));
  }
};

// The dq kernel's tiles: 64 queries a block (four warps of 16 rows), key
// tiles of 64; sQ [kDqBQ], sO [kDqBQ] (dO), sK [2][kDqBK], sV [2][kDqBK].
constexpr int kDqBQ = 64;
constexpr int kDqBK = 64;
static_assert(kDqBQ / 16 * 32 == kThreads, "one warp per 16 dq rows");
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (2 * kDqBQ + 4 * kDqBK) * Layout<D>::LD;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d += a * b for one 16x8 fp32 tile: a 16x16 bf16 (row), b 16x8 (col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Rows [r0, r0 + ROWS) of a contiguous [n, D] bf16 matrix into a padded
// shared tile with cp.async; rows >= n are zeroed.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int n) {
  constexpr int kPerRow = D / 8;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 8;
    bf16* d = dst + r * Layout<D>::LD + c;
    if (r0 + r < n)
      cp_async16(d, src + (size_t)(r0 + r) * D + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void atomic_add2(float* p, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
#endif
}

// DQ: the one-pass kernel (dq added into dq_acc); without it the split
// dk/dv kernel (dq_acc unused).
template <int D, bool DQ>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                 int causal, int off, int valid_q, int valid_k,
                 float scale_log2, float scale) {
  constexpr int LD = Layout<D>::LD;
  constexpr int kDT = D / 8;       // 8-wide d column tiles
  constexpr int kQT = kBQ / 8;     // 8-wide query column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBK * LD;
  bf16* sQ = sV + kBK * LD;
  bf16* sO = sQ + 2 * kBQ * LD;
  bf16* sDS = sO + 2 * kBQ * LD;

  const int k0 = blockIdx.x * kBK;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * (size_t)sq * D;
  const bf16* ob = dout + bh * (size_t)sq * D;
  const float* lb = lse + bh * (size_t)sq;
  const float* db = delta + bh * (size_t)sq;
  float* dqb = DQ ? dq_acc + bh * (size_t)sq * D : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * 16;
  const int grp = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;

  const int kv_end = min(sk, valid_k);
  const int q_end = min(sq, valid_q);
  // query rows that can see any of this block's keys: [q_begin, q_end)
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - off);
  q_begin = (q_begin / kBQ) * kBQ;
  const int nq = (k0 < kv_end && q_begin < q_end)
                     ? (q_end - q_begin + kBQ - 1) / kBQ : 0;

  load_tile<D, kBK>(sK, k + bh * (size_t)sk * D, k0, sk);
  load_tile<D, kBK>(sV, v + bh * (size_t)sk * D, k0, sk);
  if (nq > 0) {
    load_tile<D, kBQ>(sQ, qb, q_begin, sq);
    load_tile<D, kBQ>(sO, ob, q_begin, sq);
  }
  cp_async_commit();

  float dka[kDT][4], dva[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int q0 = q_begin + it * kBQ;
    const int st = it & 1;
    if (it + 1 < nq) {
      load_tile<D, kBQ>(sQ + (st ^ 1) * kBQ * LD, qb, q0 + kBQ, sq);
      load_tile<D, kBQ>(sO + (st ^ 1) * kBQ * LD, ob, q0 + kBQ, sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + st * kBQ * LD;
    const bf16* cO = sO + st * kBQ * LD;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries per warp
    float s[kQT][4], dp[kQT][4];
#pragma unroll
    for (int j = 0; j < kQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned ka[4], va[4];
      ldmatrix_x4(ka, sK + (wrow + (mat & 1) * 8 + mrow) * LD + kk * 16 +
                          (mat >> 1) * 8);
      ldmatrix_x4(va, sV + (wrow + (mat & 1) * 8 + mrow) * LD + kk * 16 +
                          (mat >> 1) * 8);
#pragma unroll
      for (int jp = 0; jp < kQT / 2; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, cQ + (jp * 16 + (mat >> 1) * 8 + mrow) * LD +
                           kk * 16 + (mat & 1) * 8);
        mma_bf16(s[2 * jp], ka, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], ka, b[2], b[3]);
        ldmatrix_x4(b, cO + (jp * 16 + (mat >> 1) * 8 + mrow) * LD +
                           kk * 16 + (mat & 1) * 8);
        mma_bf16(dp[2 * jp], va, b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], va, b[2], b[3]);
      }
    }

    // P^T = exp2(S^T * scale_log2 - lse[q]) with the masks, then
    // dS^T = P^T (dP^T - delta[q]); a tile inside every mask skips the
    // per-element test
    const bool full = k0 + kBK <= kv_end && q0 + kBQ <= q_end &&
                      (!causal || k0 + kBK - 1 <= q0 + off);
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = q0 + j * 8 + tig * 2 + e;
        const bool qin = qc < sq;
        const float l = qin ? lb[qc] : kNegInf;
        const float dl = qin ? db[qc] : 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kr = k0 + wrow + grp + hf * 8;
          const bool live = full || (kr < kv_end && qc < q_end &&
                                     (!causal || kr <= qc + off));
          const float p = (live && l > kMaskedRowThresh)
                              ? exp2f(s[j][hf * 2 + e] * scale_log2 - l)
                              : 0.f;
          s[j][hf * 2 + e] = p;
          dp[j][hf * 2 + e] = p * (dp[j][hf * 2 + e] - dl);
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q: the accumulator fragments of query
    // tiles 2t, 2t + 1 are the A fragment of query step t
#pragma unroll
    for (int t = 0; t < kBQ / 16; ++t) {
      unsigned pa[4], da[4];
      pa[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
      pa[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
      pa[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
      pa[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
      da[0] = pack_bf16(dp[2 * t][0], dp[2 * t][1]);
      da[1] = pack_bf16(dp[2 * t][2], dp[2 * t][3]);
      da[2] = pack_bf16(dp[2 * t + 1][0], dp[2 * t + 1][1]);
      da[3] = pack_bf16(dp[2 * t + 1][2], dp[2 * t + 1][3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, cO + (t * 16 + (mat & 1) * 8 + mrow) * LD +
                                 np * 16 + (mat >> 1) * 8);
        mma_bf16(dva[2 * np], pa, b[0], b[1]);
        mma_bf16(dva[2 * np + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, cQ + (t * 16 + (mat & 1) * 8 + mrow) * LD +
                                 np * 16 + (mat >> 1) * 8);
        mma_bf16(dka[2 * np], da, b[0], b[1]);
        mma_bf16(dka[2 * np + 1], da, b[2], b[3]);
      }
      // stage dS^T [keys][queries] for the query-major dq product
      if constexpr (DQ) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            *reinterpret_cast<unsigned*>(
                sDS + (wrow + grp + hf * 8) * kLDS + (2 * t + jj) * 8 +
                tig * 2) = da[jj * 2 + hf];
      }
    }

    // dQ[32 q, D] += dS K: warp (mg, nh) owns query rows mg*16.. and the
    // d columns nh*D/2..; A is dS = (dS^T)^T through ldmatrix.trans
    if constexpr (DQ) {
      __syncthreads();
      const int mg = warp & 1, nh = warp >> 1;
      constexpr int kHT = D / 16;          // 8-wide tiles in half of D
      float acc[kHT][4];
#pragma unroll
      for (int j = 0; j < kHT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        unsigned a[4];
        ldmatrix_x4_trans(a, sDS + (kk * 16 + (mat >> 1) * 8 + mrow) * kLDS +
                                 mg * 16 + (mat & 1) * 8);
#pragma unroll
        for (int np = 0; np < kHT / 2; ++np) {
          unsigned b[4];
          ldmatrix_x4_trans(b, sK + (kk * 16 + (mat & 1) * 8 + mrow) * LD +
                                   nh * (D / 2) + np * 16 + (mat >> 1) * 8);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int qr = q0 + mg * 16 + grp + hf * 8;
        if (qr < sq) {
#pragma unroll
          for (int j = 0; j < kHT; ++j)
            atomic_add2(dqb + (size_t)qr * D + nh * (D / 2) + j * 8 + tig * 2,
                        scale * acc[j][hf * 2], scale * acc[j][hf * 2 + 1]);
        }
      }
    }
    __syncthreads();  // sQ/sO stage and sDS are reused next step
  }
  cp_async_wait<0>();  // nq == 0: the k/v copies may still be in flight

  // this block owns its keys' dk and dv: plain stores, no atomics
  bf16* dkb = dk + bh * (size_t)sk * D;
  bf16* dvb = dv + bh * (size_t)sk * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kr = k0 + wrow + grp + hf * 8;
    if (kr < sk) {
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const size_t o = (size_t)kr * D + j * 8 + tig * 2;
        *reinterpret_cast<__nv_bfloat162*>(dkb + o) = __floats2bfloat162_rn(
            scale * dka[j][hf * 2], scale * dka[j][hf * 2 + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + o) = __floats2bfloat162_rn(
            dva[j][hf * 2], dva[j][hf * 2 + 1]);
      }
    }
  }
}

// The split backward's dq: one block per (64-query tile, b*h), four
// warps of 16 query rows.  The query tiles are taken heaviest first (the
// last rows see the most keys under the causal mask), as the forward
// does.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int sq, int sk, int causal, int off, int valid_q,
                    int valid_k, float scale_log2, float scale) {
  constexpr int LD = Layout<D>::LD;
  constexpr int kDT = D / 8;        // 8-wide dq column tiles
  constexpr int kST = kDqBK / 8;    // 8-wide key column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kDqBQ * LD;
  bf16* sK = sO + kDqBQ * LD;
  bf16* sV = sK + 2 * kDqBK * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqBQ;
  const size_t bh = blockIdx.y;
  const bf16* kb = k + bh * (size_t)sk * D;
  const bf16* vb = v + bh * (size_t)sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * 16;
  const int grp = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;

  const int kv_end = min(sk, valid_k);
  const int q_end = min(sq, valid_q);
  // keys any query of this tile may see: [0, kend) -- the TPU kernel's
  // run condition ki * bk <= qi * bq + bq - 1 + off
  int kend = kv_end;
  if (causal) kend = min(kend, q0 + kDqBQ + off);
  const int nk = (kend > 0 && q0 < q_end) ? (kend + kDqBK - 1) / kDqBK : 0;

  load_tile<D, kDqBQ>(sQ, q + bh * (size_t)sq * D, q0, sq);
  load_tile<D, kDqBQ>(sO, dout + bh * (size_t)sq * D, q0, sq);
  if (nk > 0) {
    load_tile<D, kDqBK>(sK, kb, 0, sk);
    load_tile<D, kDqBK>(sV, vb, 0, sk);
  }
  cp_async_commit();

  // this thread's rows (grp and grp + 8 of its warp's 16): lse, delta
  float lrow[2], drow[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + wrow + grp + hf * 8;
    lrow[hf] = r < sq ? lse[bh * (size_t)sq + r] : kNegInf;
    drow[hf] = r < sq ? delta[bh * (size_t)sq + r] : 0.f;
  }

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kDqBK;
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile<D, kDqBK>(sK + (st ^ 1) * kDqBK * LD, kb, k0 + kDqBK, sk);
      load_tile<D, kDqBK>(sV + (st ^ 1) * kDqBK * LD, vb, k0 + kDqBK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + st * kDqBK * LD;
    const bf16* cV = sV + st * kDqBK * LD;

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp
    float s[kST][4], dp[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned qa[4], oa[4];
      ldmatrix_x4(qa, sQ + (wrow + (mat & 1) * 8 + mrow) * LD + kk * 16 +
                          (mat >> 1) * 8);
      ldmatrix_x4(oa, sO + (wrow + (mat & 1) * 8 + mrow) * LD + kk * 16 +
                          (mat >> 1) * 8);
#pragma unroll
      for (int jp = 0; jp < kST / 2; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, cK + (jp * 16 + (mat >> 1) * 8 + mrow) * LD +
                           kk * 16 + (mat & 1) * 8);
        mma_bf16(s[2 * jp], qa, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa, b[2], b[3]);
        ldmatrix_x4(b, cV + (jp * 16 + (mat >> 1) * 8 + mrow) * LD +
                           kk * 16 + (mat & 1) * 8);
        mma_bf16(dp[2 * jp], oa, b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], oa, b[2], b[3]);
      }
    }

    // P = exp2(S * scale_log2 - lse) with the masks and the fully
    // masked row guard, then dS = P (dP - delta), kept in s
    const bool full = k0 + kDqBK <= kv_end && q0 + kDqBQ <= q_end &&
                      (!causal || k0 + kDqBK - 1 <= q0 + off);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qr = q0 + wrow + grp + hf * 8;
#pragma unroll
      for (int j = 0; j < kST; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = k0 + j * 8 + tig * 2 + e;
          const bool live = full || (kc < kv_end && qr < q_end &&
                                     (!causal || kc <= qr + off));
          const float p = (live && lrow[hf] > kMaskedRowThresh)
                              ? exp2f(s[j][hf * 2 + e] * scale_log2 -
                                      lrow[hf])
                              : 0.f;
          s[j][hf * 2 + e] = p * (dp[j][hf * 2 + e] - drow[hf]);
        }
      }
    }

    // dQ += dS K: the dS fragments of key tiles 2t, 2t + 1 are the A
    // fragment of key step t (rounded to bf16 here, as the TPU kernel
    // feeds its MXU); K through the transposing ldmatrix
#pragma unroll
    for (int t = 0; t < kDqBK / 16; ++t) {
      unsigned da[4];
      da[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
      da[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
      da[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
      da[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, cK + (t * 16 + (mat & 1) * 8 + mrow) * LD +
                                 np * 16 + (mat >> 1) * 8);
        mma_bf16(acc[2 * np], da, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this k/v stage
  }
  cp_async_wait<0>();  // nk == 0: the q/dO copies may still be in flight

  // this block owns its queries' dq: plain stores, no atomics
  bf16* dqb = dq + bh * (size_t)sq * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qr = q0 + wrow + grp + hf * 8;
    if (qr < sq) {
#pragma unroll
      for (int j = 0; j < kDT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)qr * D + j * 8 +
                                           tig * 2) =
            __floats2bfloat162_rn(scale * acc[j][hf * 2],
                                  scale * acc[j][hf * 2 + 1]);
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

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq_acc, void* dq,
           void* dk, void* dv, int bh, int sq, int sk, int causal, int off,
           int valid_q, int valid_k, float scale_log2, float scale,
           cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes(true);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)bh * sq * D;
  err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (sk > 0) {
    dim3 grid((sk + kBK - 1) / kBK, bh);
    flash_bwd_kernel<D, true><<<grid, kThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), sq, sk, causal, off, valid_q, valid_k,
        scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t n8 = n / 8;
  const int blocks = (int)((n8 + 255) / 256 < 4096 ? (n8 + 255) / 256 : 4096);
  dq_cast_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), n8);
  return (int)cudaGetLastError();
}

// The split pair: dq from flash_bwd_dq_kernel, dk and dv from the
// one-pass kernel without its dq half.
template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq,
              int sk, int causal, int off, int valid_q, int valid_k,
              float scale_log2, float scale, cudaStream_t stream) {
  const size_t bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kDqBQ - 1) / kDqBQ, bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), sq, sk, causal, off, valid_q, valid_k,
      scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int sq, int sk, int causal, int off, int valid_q, int valid_k,
               float scale_log2, float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes(false);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + kBK - 1) / kBK, bh);
  flash_bwd_kernel<D, false><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk,
      causal, off, valid_q, valid_k, scale_log2, scale);
  return (int)cudaGetLastError();
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
