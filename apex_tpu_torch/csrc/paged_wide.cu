// Wide ragged paged decode attention for Hopper (sm_90a): the C entry of
// #7w and its CUDA-core kernel.  The entry launches one of two modes, as
// the wrapper (ops/paged_attention.py :: _wide_paged_tma, the one place
// that decides) asks: the TMA modes, kv_decode.cuh :: paged_decode_kernel's
// wide operand modes (fp16 and bf16 pools on the tensor cores, fp32 pools
// up to head dim 128 on the CUDA cores; instances in paged_wide_tc_*.cu),
// for every pool whose rows, page stride and page size TMA boxes can
// address; and the kernel below, in fp32 on the CUDA cores, for the rest:
// 16-bit rows with d % 8 != 0, fp32 rows with d % 4 != 0 or d past 128,
// rows or a page stride that are not a multiple of 16 bytes or not
// 16-byte aligned, pages that are not a multiple of 8 rows.
//
// Replaces: apex_tpu/ops/paged_attention.py :: _paged_kernel (#7w), for the
// pools the mma instance of csrc/paged_attention.cu does not take. The
// same function: one query token per slot against the slot's live tokens,
// which live in fixed-size pages of a shared pool reached through the
// slot's row of the page table; the `group` query rows of a kv head score
// its k rows once (no broadcast); an fp32 online softmax in base 2 with an
// fp32 accumulator, p rounded to the pool's type for P.V (fp32: not
// rounded), the normalizer from the fp32 p; a slot of length 0 emits
// zeros; a length past the window scores the whole window.  This kernel
// takes the query in fp32 and leaves the output in fp32 (the wrapper
// casts both), so q is never rounded to the pool's type.
//
// What bounds it on the H100: bytes.  Each live token's k and v rows are
// read once per kv head (2 d sizeof(T) bytes) and scored with 4 group d
// flops, far under the CUDA cores' rate for any group.  So this kernel
// reads every page once for all the group's rows and keeps the cores'
// share small (the TMA modes' notes are kv_decode.cuh's):
// - one block per (split, kv head and row chunk, slot): a split is a run
//   of whole pages of the window, planned on the host as paged decode's
//   plan (ops/paged_attention.py :: _plan_splits, never from the
//   lengths); a row chunk is up to 32 query rows of the group (a group
//   past 32 takes several, each reading the pages);
// - the block's 256 threads stage 32 tokens of k and v at a time into
//   shared memory (two stages, cp.async of 16 bytes where the rows are
//   16-byte aligned, else element copies), each token's row found
//   through the page table at any page size and any page stride (one
//   layer's view of the [pages, layers, kv_heads, page_size, d] pool);
// - scores: (row, token) pairs over the threads, a pair's dot product
//   split over up to 8 adjacent lanes (so one query row still fills the
//   block) and summed by xor shuffles; a warp per row then takes the
//   32 tokens' max, p and sum (one token a lane); P.V: each thread owns
//   one column of up to 32 / (256 / D) rows, its accumulators in
//   registers across the window;
// - where a slot's window runs as several splits, each live block writes
//   its partial (m, l, acc) and the last of them to finish (a counter
//   per (slot, kv head, row chunk), which that block resets) merges the
//   partials in split order, so the output repeats bit for bit.
//
// Plain C interface (loaded with ctypes): apex_paged_wide launches on the
// caller's stream and returns cudaGetLastError().

#include "paged_wide_tc.cuh"
#include "wide.cuh"

namespace {

constexpr int kPT = 256;     // threads a block
constexpr int kTC = 32;      // tokens a stage (one a lane in the softmax)
constexpr int kGR = 32;      // query rows a block

struct PagedWide {
  const float* q;              // [slots, h, d] fp32
  const void *k, *v;           // [pages, kvh, ps, d] views, page stride
  const int *pt, *lengths;
  float* out;                  // [slots, h, d] fp32
  float *part_acc, *part_ml;   // [slots * h, nsplit, d], [.., nsplit, 2]
  int* counters;               // [slots * kvh * rchunks]
  long long page_stride;
  int kvh, group, ps, d, mpps, nsplit, pps, rchunks, vec;
  float scale_log2;
};

template <typename T, int D>
__global__ void __launch_bounds__(kPT) paged_wide_kernel(const PagedWide a) {
  constexpr int KS = D + 16 / sizeof(T);  // a row, padded by 16 bytes
  constexpr int RB = kPT / D;             // rows a P.V pass covers
  constexpr int NACC = kGR / RB;          // accumulators a thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);     // [2][kTC][KS]
  T* vs = ks + 2 * kTC * KS;              // [2][kTC][KS]
  float* qs = reinterpret_cast<float*>(vs + 2 * kTC * KS);   // [kGR][D]
  float* ss = qs + kGR * D;               // [kGR][kTC] scores, then p
  float* al = ss + kGR * kTC;             // [kGR] alpha, at the end l
  float* ml = al + kGR;                   // [kGR] m, at the end
  __shared__ int merging;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, slot = blockIdx.z;
  const int kh = blockIdx.y / a.rchunks, rc = blockIdx.y % a.rchunks;
  const int g0 = rc * kGR, gr = min(kGR, a.group - g0);
  const int d = a.d, h = a.kvh * a.group;
  const size_t row0 = (size_t)slot * h + (size_t)kh * a.group + g0;
  const int len = min(a.lengths[slot], a.mpps * a.ps);
  const int per = a.pps * a.ps;           // tokens a split
  const int nlive = len > 0 ? (len + per - 1) / per : 0;
  if (split >= max(nlive, 1)) return;
  if (len <= 0) {                         // an empty slot emits zeros
    for (int i = tid; i < gr * d; i += kPT) a.out[row0 * d + i] = 0.f;
    return;
  }
  const int t0 = split * per, t1 = min(t0 + per, len);
  for (int i = tid; i < kGR * D; i += kPT) {
    const int g = i / D, c = i % D;
    qs[i] = g < gr && c < d ? a.q[(row0 + g) * d + c] * a.scale_log2 : 0.f;
  }
  zero_smem<T, kPT>(ks, 4 * kTC * KS);
  __syncthreads();
  const size_t head = (size_t)kh * a.ps * d;
  const T* kb = static_cast<const T*>(a.k) + head;
  const T* vb = static_cast<const T*>(a.v) + head;
  const int* table = a.pt + (size_t)slot * a.mpps;
  auto stage = [&](int ci, int buf) {
    const int tok0 = t0 + ci * kTC;
    auto row_of = [&](const T* base, int j) -> const T* {
      const int tok = tok0 + j;
      if (tok >= t1) return nullptr;
      return base + (size_t)table[tok / a.ps] * a.page_stride +
             (size_t)(tok % a.ps) * d;
    };
    stage_rows<T, kPT>(ks + buf * kTC * KS, kTC, d, a.vec, KS, kb,
                       [&](int j) { return row_of(kb, j); });
    stage_rows<T, kPT>(vs + buf * kTC * KS, kTC, d, a.vec, KS, vb,
                       [&](int j) { return row_of(vb, j); });
    cp_async_commit();
  };
  // scores: (row, token) pairs, P lanes a pair (a warp's pairs are all
  // live or all dead: pairs = 32 gr)
  const int pairs = gr * kTC;
  const int fit = kPT / pairs;
  const int P = fit >= 8 ? 8 : fit >= 4 ? 4 : fit >= 2 ? 2 : 1;
  const int part = tid % P;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float m_[kGR / 8], l_[kGR / 8];         // the softmax rows of this warp
#pragma unroll
  for (int j = 0; j < kGR / 8; ++j) m_[j] = kNegInf, l_[j] = 0.f;
  const int c = tid % D;                  // this thread's P.V column
  const int chunks = (t1 - t0 + kTC - 1) / kTC;
  stage(0, 0);
  for (int ci = 0; ci < chunks; ++ci) {
    const int buf = ci & 1;
    if (ci + 1 < chunks) {
      stage(ci + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + buf * kTC * KS;
    const T* vt = vs + buf * kTC * KS;
    const int tok0 = t0 + ci * kTC;
    for (int pi = tid / P; pi < pairs; pi += kPT / P) {
      const int g = pi / kTC, t = pi % kTC;
      const float* qg = qs + g * D;
      const T* kr = kt + t * KS;
      float x = 0.f;
      for (int cc = part; cc < d; cc += P) x = fmaf(qg[cc], to_f<T>(kr[cc]), x);
      for (int o = 1; o < P; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (part == 0) ss[g * kTC + t] = tok0 + t < t1 ? x : kNegInf;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kGR / 8; ++j) {
      const int g = warp + 8 * j;
      if (g < gr) {
        const float s = ss[g * kTC + lane];
        float mx = s;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m_[j], mx);
        const float alpha = exp2_ftz(m_[j] - mn);
        const float p = s > kMaskedRowThresh ? exp2_ftz(s - mn) : 0.f;
        float sum = p;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l_[j] = l_[j] * alpha + sum;
        m_[j] = mn;
        ss[g * kTC + lane] = round_to<T>(p);
        if (lane == 0) al[g] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int g = tid / D + i * RB;
      if (g < gr) {
        const float* pg = ss + g * kTC;
        float x = acc[i] * al[g];
#pragma unroll 8
        for (int t = 0; t < kTC; ++t)
          x = fmaf(pg[t], to_f<T>(vt[t * KS + c]), x);
        acc[i] = x;
      }
    }
    __syncthreads();                      // before the next stage lands
  }
#pragma unroll
  for (int j = 0; j < kGR / 8; ++j) {
    const int g = warp + 8 * j;
    if (g < gr && lane == 0) ml[g] = m_[j], al[g] = l_[j];
  }
  __syncthreads();
  if (nlive == 1) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int g = tid / D + i * RB;
      if (g < gr && c < d) a.out[(row0 + g) * d + c] = acc[i] / al[g];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int g = tid / D + i * RB;
    if (g < gr && c < d)
      a.part_acc[((row0 + g) * a.nsplit + split) * d + c] = acc[i];
  }
  if (tid < gr) {
    float* mlp = a.part_ml + ((row0 + tid) * a.nsplit + split) * 2;
    mlp[0] = ml[tid];
    mlp[1] = al[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = a.counters + ((size_t)slot * a.kvh + kh) * a.rchunks + rc;
    merging = atomicAdd(ctr, 1) == nlive - 1;
    if (merging) *ctr = 0;
  }
  __syncthreads();
  if (!merging) return;
  __threadfence();
  for (int i = tid; i < gr * d; i += kPT) {
    const size_t row = row0 + i / d;
    const int cc = i % d;
    const float* mlp = a.part_ml + row * a.nsplit * 2;
    float mx = kNegInf;
    for (int s = 0; s < nlive; ++s) mx = fmaxf(mx, __ldcg(mlp + 2 * s));
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < nlive; ++s) {
      const float w = exp2_ftz(__ldcg(mlp + 2 * s) - mx);
      lsum += __ldcg(mlp + 2 * s + 1) * w;
      o += __ldcg(a.part_acc + (row * a.nsplit + s) * d + cc) * w;
    }
    a.out[row * d + cc] = o / lsum;
  }
}

template <typename T, int D>
int launch(const PagedWide& a, int slots, cudaStream_t stream) {
  constexpr int KS = D + 16 / (int)sizeof(T);
  const size_t bytes = 4 * kTC * KS * sizeof(T) +
                       (kGR * D + kGR * kTC + 2 * kGR) * sizeof(float);
  static std::atomic<unsigned> allowed{0};
  const int e = allow_wide_smem(paged_wide_kernel<T, D>, bytes, allowed);
  if (e) return e;
  const dim3 grid(a.nsplit, a.kvh * a.rchunks, slots);
  paged_wide_kernel<T, D><<<grid, kPT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(PagedWide a, int slots, cudaStream_t stream) {
  a.vec = (size_t)a.d * sizeof(T) % 16 == 0 &&
          (size_t)a.page_stride * sizeof(T) % 16 == 0 &&
          !(((uintptr_t)a.k | (uintptr_t)a.v) % 16);
  if (a.d <= 64) return launch<T, 64>(a, slots, stream);
  if (a.d <= 128) return launch<T, 128>(a, slots, stream);
  return launch<T, 256>(a, slots, stream);
}

}  // namespace

// q [slots, h, d] contiguous; k/v pages [pages, kvh, ps, d] of one type
// (dtype: 0 fp32, 1 bf16, 2 fp16) with rows and heads contiguous (head
// stride ps * d) and any page stride `page_stride` (elements);
// page_table [slots, mpps] and lengths [slots] int32; out [slots, h, d].
// tma 0: the CUDA-core kernel, q and out fp32 (q_dtype 0), any group h /
// kvh, 1 <= d <= 256, any ps, counters a (slot, kv head, 32 query rows).
// tma 1: the TMA modes (paged_wide_tc.cuh's arguments), q and out of
// q_dtype, q in q_planes planes of the pool's type, `rows` query rows a
// block, counters a (slot, kv head, `rows` query rows).  The window runs
// as nsplit splits of `pages_per_split` pages; with nsplit > 1, part_acc
// [slots * h, nsplit, d] and part_ml [slots * h, nsplit, 2] are fp32
// scratch and the counters int32, zero before the launch, are left zero
// by it.
extern "C" int apex_paged_wide(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_acc,
    void* part_ml, void* counters, int slots, int h, int kvh, int ps, int d,
    int mpps, long long pages, long long page_stride, int nsplit,
    int pages_per_split, float scale_log2, int dtype, int tma, int q_dtype,
    int q_planes, int rows, void* stream) {
  cudaGetLastError();
  if (slots <= 0) return 0;
  if (kvh <= 0 || h % kvh || d < 1 || d > 256 || ps < 1 || mpps <= 0 ||
      pages <= 0 || slots > 65535 || pages_per_split <= 0 || nsplit < 1 ||
      (long long)nsplit * pages_per_split < mpps ||
      (long long)(nsplit - 1) * pages_per_split >= mpps ||
      (nsplit > 1 && (!part_acc || !part_ml || !counters)) ||
      q_dtype < kF32 || q_dtype > kF16 || (!tma && q_dtype != kF32))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tma) {
    if (((uintptr_t)k_pages | (uintptr_t)v_pages) % 16 || ps % 8)
      return (int)cudaErrorInvalidValue;
    PagedWideTcArgs t{};
    t.q = q;
    t.k = k_pages;
    t.v = v_pages;
    t.pt = static_cast<const int*>(page_table);
    t.lengths = static_cast<const int*>(lengths);
    t.out = out;
    t.part_acc = static_cast<float*>(part_acc);
    t.part_ml = static_cast<float*>(part_ml);
    t.counters = static_cast<int*>(counters);
    t.pages = pages;
    t.page_stride = page_stride;
    t.slots = slots;
    t.kvh = kvh;
    t.group = h / kvh;
    t.ps = ps;
    t.d = d;
    t.mpps = mpps;
    t.nsplit = nsplit;
    t.pps = pages_per_split;
    t.q_dtype = q_dtype;
    t.q_planes = q_planes;
    t.rows = rows;
    t.scale_log2 = scale_log2;
    switch (dtype) {
      case kF32: return paged_wide_tc_f32(t, s);
      case kBF16: return paged_wide_tc_bf16(t, s);
      case kF16: return paged_wide_tc_f16(t, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  PagedWide a{};
  a.q = static_cast<const float*>(q);
  a.k = k_pages;
  a.v = v_pages;
  a.pt = static_cast<const int*>(page_table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.counters = static_cast<int*>(counters);
  a.page_stride = page_stride;
  a.kvh = kvh;
  a.group = h / kvh;
  a.ps = ps;
  a.d = d;
  a.mpps = mpps;
  a.nsplit = nsplit;
  a.pps = pages_per_split;
  a.rchunks = (a.group + kGR - 1) / kGR;
  a.scale_log2 = scale_log2;
  if ((long long)kvh * a.rchunks > 65535) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return launch_d<float>(a, slots, s);
    case kBF16: return launch_d<bf16>(a, slots, s);
    case kF16: return launch_d<__half>(a, slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
