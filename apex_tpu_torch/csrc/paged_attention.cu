// Ragged paged decode attention for Hopper (sm_90a), bf16 in, fp32 math.
//
// Replaces: apex_tpu/ops/paged_attention.py :: _paged_kernel (launched
// by _paged_kernel_call through pl.pallas_call).  Same function: one
// query token per slot attends to the slot's live tokens, which live in
// fixed-size pages of a shared pool reached through the slot's row of
// the page table; grouped-query scoring per kv head (the `group = h /
// kvh` query rows of a kv head score its k rows once, no broadcast); an
// fp32 online softmax in base 2 with an fp32 accumulator, p rounded to
// bf16 for the P.V product as the TPU kernel feeds its MXU; a slot of
// length 0 emits zeros.
//
// Translation: the TPU kernel gets the page table and lengths as scalar
// prefetch and walks a sequential (slots, pages) grid carrying the
// softmax state in VMEM.  Blocks here run in parallel and carry
// nothing, so the work is split flash-decoding style: one block per
// (kv head, slot, split), each split a fixed stretch of the slot's
// virtual window.  A block reads the slot's length and page-table row
// itself, resolves each live token to (page, row), and skips everything
// past the length -- dead pages and dead splits cost nothing.  With one
// split the block writes the output directly; otherwise it writes its
// partial (m, l, acc) and a small second kernel merges the splits.  The
// k/v operands are one layer's STRIDED view of the [pages, layers,
// kv_heads, page_size, head_dim] pool: the kernel takes the page stride
// and indexes the pool in place; nothing is gathered or copied.
//
// What bounds it on the H100: bytes.  Each live token's k and v rows
// are read once (2 * head_dim * 2 bytes per kv head per layer) and
// scored with ~4 * group * head_dim flops, far below the balance point.
// So the design keeps many bytes in flight and reads each one once, in
// wide coalesced requests: a block stages 64-token chunks of k and v
// rows into shared memory with cp.async (16 bytes a thread, a row's
// segments on neighbouring threads), double-buffered so the next
// chunk's copy runs under this chunk's arithmetic.  From shared memory,
// two threads score one token (half a row each, q in fp32 shared
// memory, one shuffle to join the halves), one warp per query row runs
// the softmax, and for P.V each thread owns two head dims of every
// query row in registers over a stripe of the chunk's tokens.  The
// splits give slots * kv_heads * splits blocks to fill the 132 SMs.
//
// Plain C interface (loaded with ctypes): apex_paged_decode_attention
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;         // tokens per staged chunk (2 threads each)
constexpr float kNegInf = -1e30f;  // attention.py _NEG_INF

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

// Shared-memory layout for G query rows per kv head and head dim D.
// k/v rows are padded by 16 bytes so the score reads (16 rows x 2 halves
// per warp) spread over all banks; q keeps its two halves 4 banks apart.
template <int G, int D>
struct Smem {
  static constexpr int LDK = D + 8;             // bf16 per staged row
  static constexpr int LDQ = D + 8;             // fp32 per q row
  static constexpr int QHALF = D / 2 + 4;       // offset of q's 2nd half
  static constexpr size_t kv_stage = sizeof(bf16) * kChunk * LDK;
  static constexpr size_t k_off = 0;            // sK[2][kChunk][LDK]
  static constexpr size_t v_off = k_off + 2 * kv_stage;
  static constexpr size_t q_off = v_off + 2 * kv_stage;
  static constexpr size_t s_off = q_off + sizeof(float) * G * LDQ;
  static constexpr size_t m_off = s_off + sizeof(float) * G * kChunk;
  static constexpr size_t l_off = m_off + sizeof(float) * G;
  static constexpr size_t a_off = l_off + sizeof(float) * G;
  static constexpr size_t bytes = a_off + sizeof(float) * G;
  // the token lanes' partial accumulators reuse the k/v stages at the end
  static_assert(sizeof(float) * (kThreads / (D / 2)) * G * D <= q_off,
                "reduction scratch must fit in the k/v stages");
};

// Stage the k and v rows of tokens [c0, c0 + kChunk) into one stage;
// rows at or past t_end are zeroed (a masked token must still multiply
// a finite v row).
template <int D>
__device__ __forceinline__ void stage_chunk(
    bf16* sk, bf16* sv, const bf16* __restrict__ kp,
    const bf16* __restrict__ vp, const int* __restrict__ row, int c0,
    int t_end, int ps, long long page_stride, size_t head_off) {
  constexpr int kSegs = D / 8;                  // 16-byte segments per row
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

template <int G, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                    const bf16* __restrict__ vp,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, bf16* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int kvh, int ps, int mpps, long long page_stride,
                    int split_tokens, float scale_log2) {
  using S = Smem<G, D>;
  constexpr int kHalf = D / 2;                  // dims per scoring thread
  constexpr int kPairs = D / 2;                 // threads per v row in P.V
  constexpr int kLanes = kThreads / kPairs;     // token stripes in P.V
  static_assert(kThreads % kPairs == 0 && kLanes >= 1, "D must be 64 or 128");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + S::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::v_off);
  float* sQ = reinterpret_cast<float*>(smem + S::q_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  float* sM = reinterpret_cast<float*>(smem + S::m_off);
  float* sL = reinterpret_cast<float*>(smem + S::l_off);
  float* sA = reinterpret_cast<float*>(smem + S::a_off);

  const int kh = blockIdx.x, slot = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int h = kvh * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a length past the virtual window scores the whole window, as the
  // plain version does, and never reads past the page-table row
  const int len = min(lengths[slot], mpps * ps);
  const int t_begin = split * split_tokens;
  const int t_end = min(len, t_begin + split_tokens);
  const int n_chunks = t_end > t_begin ? (t_end - t_begin + kChunk - 1) / kChunk
                                       : 0;
  const int* row = page_table + (size_t)slot * mpps;
  const size_t head_off = (size_t)kh * ps * D;

  if (n_chunks > 0) {
    stage_chunk<D>(sK, sV, kp, vp, row, t_begin, t_end, ps, page_stride,
                   head_off);
    cp_async_commit();
  }
  const bf16* qs = q + ((size_t)slot * h + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, e = i % D;
    sQ[g * S::LDQ + e + (e >= kHalf ? S::QHALF - kHalf : 0)] =
        __bfloat162float(qs[i]);
  }
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
                     sV + (st ^ 1) * kChunk * S::LDK, kp, vp, row,
                     c0 + kChunk, t_end, ps, page_stride, head_off);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ck = sK + st * kChunk * S::LDK;
    const bf16* cv = sV + st * kChunk * S::LDK;

    // scores: threads 2r and 2r + 1 score token r, half a row each
    {
      const int r = tid >> 1, half = tid & 1;
      const bf16* kr = ck + r * S::LDK + half * kHalf;
      const float* qh = sQ + half * S::QHALF;
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
      for (int e = 0; e < kHalf; e += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + e);
        const __nv_bfloat162* k2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(k2[j]);
          kf[2 * j] = f.x;
          kf[2 * j + 1] = f.y;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qa = *reinterpret_cast<const float4*>(
              qh + g * S::LDQ + e);
          const float4 qb = *reinterpret_cast<const float4*>(
              qh + g * S::LDQ + e + 4);
          dot[g] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] +
                    qa.w * kf[3] + qb.x * kf[4] + qb.y * kf[5] +
                    qb.z * kf[6] + qb.w * kf[7];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float d = dot[g] + __shfl_xor_sync(0xffffffffu, dot[g], 1);
        if (half == 0) sS[g * kChunk + r] = r < live ? d * scale_log2 : kNegInf;
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
      sS[g * kChunk + lane] = __bfloat162float(__float2bfloat16(p0));
      sS[g * kChunk + lane + 32] = __bfloat162float(__float2bfloat16(p1));
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
        const float p = sS[g * kChunk + i];
        acc[g][0] += p * vf.x;
        acc[g][1] += p * vf.y;
      }
    }
    __syncthreads();  // the stage and sS are rewritten next iteration
  }

  // merge the token stripes' partial accumulators (in the k/v stages)
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
    if (nsplit == 1) {
      const float l = sL[g];
      out[qrow * D + e] = __float2bfloat16(a / (l == 0.f ? 1.f : l));
    } else {
      part_acc[(qrow * nsplit + split) * D + e] = a;
      if (e == 0) {
        part_ml[(qrow * nsplit + split) * 2] = sM[g];
        part_ml[(qrow * nsplit + split) * 2 + 1] = sL[g];
      }
    }
  }
}

// Merge the splits of one query row: out = sum_s 2^(m_s - M) acc_s /
// sum_s 2^(m_s - M) l_s; a row whose every split is empty emits 0.
__global__ void paged_merge_kernel(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml,
                                   bf16* __restrict__ out, int nsplit, int d) {
  const size_t qrow = blockIdx.x;
  const float* ml = part_ml + qrow * nsplit * 2;
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s)
    if (ml[2 * s + 1] > 0.f) l += exp2f(ml[2 * s] - mx) * ml[2 * s + 1];
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s)
      if (ml[2 * s + 1] > 0.f)
        a += exp2f(ml[2 * s] - mx) * part_acc[(qrow * nsplit + s) * d + e];
    out[qrow * d + e] = __float2bfloat16(a / (l == 0.f ? 1.f : l));
  }
}

template <int G, int D>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* lengths, void* out, void* part_acc, void* part_ml,
           int slots, int kvh, int ps, int mpps, long long page_stride,
           int nsplit, int split_tokens, float scale_log2,
           cudaStream_t stream) {
  const size_t bytes = Smem<G, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kvh, slots, nsplit);
  paged_decode_kernel<G, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(lengths), static_cast<bf16*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), kvh, ps,
      mpps, page_stride, split_tokens, scale_log2);
  if (nsplit > 1) {
    paged_merge_kernel<<<slots * kvh * G, 128, 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<bf16*>(out), nsplit,
        D);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int group, const void* q, const void* k, const void* v,
             const void* pt, const void* lengths, void* out, void* part_acc,
             void* part_ml, int slots, int kvh, int ps, int mpps,
             long long page_stride, int nsplit, int split_tokens,
             float scale_log2, cudaStream_t s) {
  switch (group) {
#define APEX_PAGED_GROUP(G)                                                 \
  case G:                                                                   \
    return launch<G, D>(q, k, v, pt, lengths, out, part_acc, part_ml, slots, \
                        kvh, ps, mpps, page_stride, nsplit, split_tokens,   \
                        scale_log2, s);
    APEX_PAGED_GROUP(1)
    APEX_PAGED_GROUP(2)
    APEX_PAGED_GROUP(4)
    APEX_PAGED_GROUP(8)
#undef APEX_PAGED_GROUP
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [slots, h, d] contiguous bf16; k/v pages [pages, kvh, ps, d] bf16
// with rows and heads contiguous (head stride ps * d) and page stride
// `page_stride` elements (a multiple of 8, 16-byte aligned bases);
// page_table [slots, mpps] and lengths [slots] int32; out [slots, h, d]
// bf16.  With nsplit > 1, part_acc [slots * h, nsplit, d] and part_ml
// [slots * h, nsplit, 2] are fp32 scratch; each split covers
// `split_tokens` positions of the window (a multiple of 64).  group = h
// / kvh must be 1, 2, 4 or 8 and d 64 or 128.
extern "C" int apex_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_acc,
    void* part_ml, int slots, int h, int kvh, int ps, int d, int mpps,
    long long page_stride, int nsplit, int split_tokens, float scale_log2,
    void* stream) {
  cudaGetLastError();
  if (slots <= 0) return 0;
  if (kvh <= 0 || h % kvh || slots > 65535 || nsplit < 1 || nsplit > 65535 ||
      split_tokens <= 0 || split_tokens % kChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = h / kvh;
  switch (d) {
    case 64:
      return launch_d<64>(group, q, k_pages, v_pages, page_table, lengths,
                          out, part_acc, part_ml, slots, kvh, ps, mpps,
                          page_stride, nsplit, split_tokens, scale_log2, s);
    case 128:
      return launch_d<128>(group, q, k_pages, v_pages, page_table, lengths,
                           out, part_acc, part_ml, slots, kvh, ps, mpps,
                           page_stride, nsplit, split_tokens, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
