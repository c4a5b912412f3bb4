// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces: apex_tpu/ops/attention.py :: _fwd_kernel (launched by _fwd
// through pl.pallas_call).  Same function: out = softmax(scale * Q K^T
// + masks) V per (batch * head), with an online softmax in BASE 2 --
// log2(e) folded into the score scale and exp2 everywhere -- and the
// row log-sum-exp emitted in base 2 (fp32 [b*h, sq]), as _fwd returns
// it; the ring merge and the backward of later slices consume that.
// Masks: causal with the offset sk - sq (column c is visible to row r
// when c <= r + off) and a validity window (rows >= valid_q and columns
// >= valid_k are masked).  A fully masked row emits 0 and lse -1e30.
// p is rounded to bf16 for the P.V product (the TPU kernel feeds its
// MXU the same way); the row sum keeps the fp32 p.
//
// Translation: the Pallas kernel's sequential k grid axis becomes a
// loop over k tiles inside the block; the grid is (q tile, b*h), every
// block independent.  Tiles above the causal diagonal (and past the
// validity window) are never loaded.
//
// What bounds it on the H100: operations.  A causal prefill of s = 2048,
// 32 heads, d = 128 is ~34 GFLOP against ~0.05 GB of q/k/v/o, far above
// the ~295 flops/byte balance point, so the tensor cores are the limit.
// The design is FlashAttention-2's: four warps per 64-row q tile,
// each warp owning 16 rows; mma.sync m16n8k16 (bf16 in, fp32
// accumulate) for both products, with the scores, the probabilities and
// the output accumulator kept in registers -- the S accumulator
// fragment is the P operand fragment, so P never goes through shared
// memory.  Operands reach the tensor cores through ldmatrix (the
// transposing form for V) from padded, bank-conflict-free shared tiles,
// and the next k/v tile is copied in with cp.async while the current
// one is computed.  The heaviest causal tiles (the last rows) are
// scheduled first, so the short ones fill the tail.  Measured and
// slower on this card (PERF.md): 128-row tiles, and per-warp skipping
// of the tiles above a warp's diagonal.
// Not yet used: wgmma, TMA and warp specialisation, which the card's
// full rate needs -- later work; PERF.md records this version's time.
//
// Plain C interface (loaded with ctypes): apex_flash_attention_fwd
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kWarps = kBQ / 16; // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;            // attention.py _NEG_INF
constexpr float kMaskedRowThresh = -0.5e30f; // _MASKED_ROW_THRESH

// Shared tiles, bf16, row stride D + 8 (16 bytes of padding: the eight
// 16-byte rows an ldmatrix phase reads fall in eight different bank
// groups).  sQ [kBQ], then sK [2][kBK], then sV [2][kBK].
template <int D>
struct Layout {
  static constexpr int LD = D + 8;
  static constexpr size_t bytes = sizeof(bf16) * (kBQ + 4 * kBK) * LD;
};

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

// Copy rows [r0, r0 + ROWS) of a contiguous [n, D] bf16 matrix into a
// padded shared tile with cp.async, 16 bytes per thread per step; rows
// >= n are zeroed (a masked column must still multiply a finite value).
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int causal, int off,
                 int valid_q, int valid_k, float scale_log2) {
  constexpr int LD = Layout<D>::LD;
  constexpr int kDT = D / 8;     // 8-wide output column tiles
  constexpr int kST = kBK / 8;   // 8-wide score column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * LD;
  bf16* sV = sK + 2 * kBK * LD;

  // the heaviest causal tiles (the last rows, the most k tiles) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * (size_t)sq * D;
  const bf16* kb = k + bh * (size_t)sk * D;
  const bf16* vb = v + bh * (size_t)sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * 16;          // this warp's first row in the tile
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int mat = lane >> 3, mrow = lane & 7; // ldmatrix address roles

  // columns any row of this tile may see: [0, kend)
  int kend = min(sk, valid_k);
  if (causal) kend = min(kend, q0 + kBQ + off);
  const int nk = (kend > 0 && q0 < valid_q) ? (kend + kBK - 1) / kBK : 0;

  load_tile<D, kBQ>(sQ, qb, q0, sq);
  if (nk > 0) {
    load_tile<D, kBK>(sK, kb, 0, sk);
    load_tile<D, kBK>(sV, vb, 0, sk);
  }
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf};  // rows grp and grp + 8
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  unsigned qf[D / 16][4];

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile<D, kBK>(sK + (st ^ 1) * kBK * LD, kb, k0 + kBK, sk);
      load_tile<D, kBK>(sV + (st ^ 1) * kBK * LD, vb, k0 + kBK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (wrow + (mat & 1) * 8 + mrow) * LD +
                                kk * 16 + (mat >> 1) * 8);
    }
    const bf16* cK = sK + st * kBK * LD;
    const bf16* cV = sV + st * kBK * LD;

    // S = Q K^T: 16 rows x 64 keys per warp, in registers
    float s[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kST / 2; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, cK + (jp * 16 + (mat >> 1) * 8 + mrow) * LD +
                           kk * 16 + (mat & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // masks and the online softmax in base 2, per row half; a tile
    // wholly inside every mask skips the per-element test
    const bool full = k0 + kBK <= min(sk, valid_k) &&
                      q0 + kBQ <= valid_q &&
                      (!causal || k0 + kBK - 1 <= q0 + off);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int grow = q0 + wrow + grp + hf * 8;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kST; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gcol = k0 + j * 8 + tig * 2 + e;
          const bool live = full || (gcol < sk && gcol < valid_k &&
                                     grow < valid_q &&
                                     (!causal || gcol <= grow + off));
          const float x = live ? s[j][hf * 2 + e] * scale_log2 : kNegInf;
          s[j][hf * 2 + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      const float alpha = exp2f(m[hf] - m_new);
      const bool dead = m_new <= kMaskedRowThresh;  // fully masked so far
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kST; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = dead ? 0.f : exp2f(s[j][hf * 2 + e] - m_new);
          s[j][hf * 2 + e] = p;
          rs += p;
        }
      }
      l[hf] = l[hf] * alpha + rs;
      m[hf] = m_new;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        acc[j][hf * 2] *= alpha;
        acc[j][hf * 2 + 1] *= alpha;
      }
    }

    // O += P V: the score fragments of key tiles 2t, 2t + 1 are the
    // A fragment of key step t
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
      pa[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
      pa[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
      pa[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, cV + (t * 16 + (mat & 1) * 8 + mrow) * LD +
                                 np * 16 + (mat >> 1) * 8);
        mma_bf16(acc[2 * np], pa, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this k/v stage
  }
  cp_async_wait<0>();  // nk == 0: the q copy may still be in flight

  // finish: out = O / l (0 for fully masked rows), lse = m + log2(l)
  bf16* ob = o + bh * (size_t)sq * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    const int grow = q0 + wrow + grp + hf * 8;
    if (grow < sq) {
#pragma unroll
      for (int j = 0; j < kDT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)grow * D + j * 8 +
                                           tig * 2) =
            __floats2bfloat162_rn(acc[j][hf * 2] * inv,
                                  acc[j][hf * 2 + 1] * inv);
      if (lse != nullptr && tig == 0)
        lse[bh * (size_t)sq + grow] = m[hf] + log2f(lt == 0.f ? 1.f : lt);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int sq, int sk, int causal, int off, int valid_q,
           int valid_k, float scale_log2, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), sq, sk, causal, off, valid_q, valid_k,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q [bh, sq, d], k/v [bh, sk, d] contiguous, 16-byte aligned bf16; o
// [bh, sq, d] bf16; lse [bh, sq] fp32 or null.  d must be 32, 64 or 128.
extern "C" int apex_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int sq, int sk, int d,
                                        int causal, int off, int valid_q,
                                        int valid_k, float scale_log2,
                                        void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, lse, bh, sq, sk, causal, off, valid_q,
                        valid_k, scale_log2, s);
    case 64:
      return launch<64>(q, k, v, o, lse, bh, sq, sk, causal, off, valid_q,
                        valid_k, scale_log2, s);
    case 128:
      return launch<128>(q, k, v, o, lse, bh, sq, sk, causal, off, valid_q,
                         valid_k, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
