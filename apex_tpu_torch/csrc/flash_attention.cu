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
// >= valid_k are masked); the masked instance also takes _fwd's boolean
// mask3 operand ([nmask, sq, sk], True = masked; batch-head bh reads
// mask bh / (b*h / nmask): per batch, per head, or one for all).  A
// fully masked row emits 0 and lse -1e30.
// p is rounded to bf16 for the P.V product (the TPU kernel feeds its
// MXU the same way); the row sum keeps the fp32 p.
//
// Translation: the Pallas kernel's sequential k grid axis becomes a
// loop over k tiles inside the block; the grid is (q block, b*h), every
// block independent.  Tiles above the causal diagonal (and past the
// validity window) are never loaded.
//
// What bounds it on the H100: operations.  A causal prefill of s = 2048,
// 32 heads, d = 128 is ~34 GFLOP against ~0.05 GB of q/k/v/o, far above
// the ~295 flops/byte balance point, so the tensor cores are the limit
// (bound 0.0347 ms at 989 TFLOP/s).  The first version ran
// FlashAttention-2's scheme on mma.sync m16n8k16 (four warps of 16 rows,
// every warp re-reading every K/V fragment through ldmatrix, two stages
// with block-wide barriers, exp2f's denormal path) and reached ~15% of
// the bound.  This version is flash_qmajor_kernel<D, false, kFwdBK>
// (flash_qmajor.cuh, one template with the split backward's dq kernel):
// two warpgroups of 64 queries, S = Q K^T and O += P V on wgmma (P from
// registers, V read N-major from its [keys][d] tile), the softmax of one
// key tile running while the previous tile's P V product is on the
// tensor cores, O in fp32 registers written once; a third warpgroup
// issues TMA loads of q and of the k/v tiles into a 3-stage ring guarded
// by mbarriers and hands its registers to the other two (setmaxnreg), so
// no block barrier runs in the loop.  The heaviest causal blocks (the
// last rows) of a group of heads whose k and v fit half the L2 are
// scheduled first.  On the card it reaches ~43% of the bound at 2048
// tokens and ~63% at 8192 (PERF.md).  Measured slower: 64-key tiles;
// the same design with cp.async copies by the product threads and a
// block barrier a step; the two product warpgroups taking turns (named
// barriers) to issue their products; heaviest first over all heads at
// once (at 8192 tokens their k and v overflow the L2).
//
// The masked forward (counter flash_attention_masked) is two launches.
// A pre-pass (mask_tiles_kernel) reads mask3 once, one block a (mask,
// 128-query block, 128-key tile) the kernel would visit, and writes the
// tile's class -- dead (nothing the causal and validity masks leave is
// unmasked), full (nothing they leave is masked) or partial -- and its
// mask bits in the order the product threads hold the scores (a 32-bit
// word a row and quad lane).  Then flash_qmajor_kernel<D, false, kFwdBK,
// true> walks only the tiles that are not dead (its copying thread never
// loads a dead one, so a padding mask's dead keys cost no bytes), takes
// the unmasked fast path on full tiles where the causal and validity
// masks allow, and reads two words a thread on a partial tile.  The
// first version read a mask byte from device memory for every live
// (row, key) of every tile, dead or full, and never took a tile as whole
// (PERF.md).
//
// Decode against the dense slot cache (decode_attention's kernel branch,
// counter flash_attention_masked as well) does not come here: its
// q_len-1 problem is paged decode's kernel template (csrc/kv_decode.cuh)
// with DENSE = true, whose instance and C entry (apex_flash_decode) are
// below.  The group = h / kv_heads query heads of a kv head are the rows
// of one problem against that kv head's cache, which is read in place
// through a 4-d tensor map over one layer's strided [slots, kv_heads, S,
// d] view; the key-only mask is the slot's length.  So no k/v is
// broadcast to the query heads (the TPU path copies 1.07 GB a layer for
// Llama-3-8B at 8192 positions), no mask tensor is built, and only the
// live keys are read.  Only slots x kv heads blocks exist (64 for
// Llama-3-8B at 8 slots), so the window is split over blocks by a plan
// made on the host from the shapes (never the lengths), and the last
// block of a (slot, kv head) merges the splits inside the launch, as
// paged decode does.  Bytes bound it: the live keys' k and v, once.
//
// Plain C interface (loaded with ctypes): apex_flash_attention_fwd,
// apex_flash_attention_fwd_masked and apex_flash_decode launch on the
// caller's stream and return cudaGetLastError().

#include "flash_qmajor.cuh"
#include "kv_decode.cuh"

namespace {

// keys a step (the S tile): PERF.md records the alternatives measured
constexpr int kFwdBK = 128;

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int sq, int sk, int causal, int off, int valid_q,
           int valid_k, float scale_log2, cudaStream_t stream) {
  return launch_qmajor<D, false, kFwdBK>(
      q, k, v, nullptr, nullptr, nullptr, o, lse, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, 0.f, stream);
}

template <int D>
int launch_masked(const void* q, const void* k, const void* v,
                  const void* mask, void* cls, void* bits, void* o,
                  void* lse, int bh, int sq, int sk, int causal, int off,
                  int valid_q, int valid_k, int mask_hper, float scale_log2,
                  cudaStream_t stream) {
  const int e = launch_mask_tiles(mask, cls, bits, bh / mask_hper, sq, sk,
                                  sk, causal, off, valid_q, valid_k, stream);
  if (e) return e;
  return launch_qmajor<D, false, kFwdBK, true>(
      q, k, v, nullptr, nullptr, nullptr, o, lse, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, 0.f, stream, cls, bits, mask_hper);
}

// the dense cache's decode: paged decode's template, DENSE, kDecTile
// positions a ring stage
constexpr int kDecTile = 64;

struct DecodeArgs {
  const void *q, *k, *v, *lengths;
  void *out, *part_acc, *part_ml, *counters;
  int b, kvh, s, nsplit, tps;
  long long head_stride, slot_stride;
  float scale_log2;
  cudaStream_t stream;
};

template <int G, int D>
int launch_decode(const DecodeArgs& a) {
  using S = PagedSmem<D, kDecTile>;
  if (a.nsplit > S::kMaxSplits) return (int)cudaErrorInvalidValue;
  CUtensorMap km, vm;
  int e = cached_kv_map(&km, a.k, D, a.s, a.kvh, a.b, a.head_stride,
                        a.slot_stride, kDecTile);
  if (!e) e = cached_kv_map(&vm, a.v, D, a.s, a.kvh, a.b, a.head_stride,
                            a.slot_stride, kDecTile);
  if (e) return e;
  static std::atomic<unsigned> allowed{0};
  e = allow_smem(paged_decode_kernel<G, D, kDecTile, true>, S::bytes,
                 allowed);
  if (e) return e;
  const dim3 grid(a.nsplit, a.kvh, a.b);
  paged_decode_kernel<G, D, kDecTile, true>
      <<<grid, kThreads, S::bytes, a.stream>>>(
          km, vm, static_cast<const bf16*>(a.q), nullptr,
          static_cast<const int*>(a.lengths), static_cast<bf16*>(a.out),
          static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
          static_cast<int*>(a.counters), a.kvh,
          (a.s + kDecTile - 1) / kDecTile, a.tps, a.s, a.scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_decode_g(int group, const DecodeArgs& a) {
  switch (group) {
    case 1: return launch_decode<1, D>(a);
    case 2: return launch_decode<2, D>(a);
    case 4: return launch_decode<4, D>(a);
    case 8: return launch_decode<8, D>(a);
    default: return (int)cudaErrorInvalidValue;
  }
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

// As apex_flash_attention_fwd, with mask [bh / mask_hper, sq, sk] bytes
// (nonzero = masked), contiguous; mask_hper divides bh.  cls (bytes) and
// bits (uint32) are the pre-pass's scratch: nmask * nqb * nkt entries
// and 512 times as many, nqb = ceil(sq / 128), nkt = ceil(sk / 128).
extern "C" int apex_flash_attention_fwd_masked(
    const void* q, const void* k, const void* v, const void* mask,
    void* cls, void* bits, void* o, void* lse, int bh, int sq, int sk, int d,
    int causal, int off, int valid_q, int valid_k, int mask_hper,
    float scale_log2, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535 || mask_hper < 1 || bh % mask_hper)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_masked<32>(q, k, v, mask, cls, bits, o, lse, bh, sq, sk,
                               causal, off, valid_q, valid_k, mask_hper,
                               scale_log2, s);
    case 64:
      return launch_masked<64>(q, k, v, mask, cls, bits, o, lse, bh, sq, sk,
                               causal, off, valid_q, valid_k, mask_hper,
                               scale_log2, s);
    case 128:
      return launch_masked<128>(q, k, v, mask, cls, bits, o, lse, bh, sq, sk,
                                causal, off, valid_q, valid_k, mask_hper,
                                scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Decode against the dense slot cache: q [b, kvh, group, d] contiguous
// bf16; k/v [b, kvh, s, d] bf16 with contiguous rows, head stride
// `head_stride` and slot stride `slot_stride` elements (multiples of 8,
// 16-byte aligned bases: one layer's view of the cache); lengths [b]
// int32 (a length past s scores the whole cache); out [b, kvh, group, d]
// bf16.  The window runs as nsplit splits of `tiles_per_split` tiles of
// 64 positions (nsplit = ceil(ceil(s / 64) / tiles_per_split)); with
// nsplit > 1, part_acc [b * kvh * group, nsplit, d] and part_ml [...,
// nsplit, 2] are fp32 scratch and counters [b * kvh] int32, zero before
// the launch, is left zero by it; nsplit is at most 256.  group 1, 2, 4
// or 8; d 64 or 128.
extern "C" int apex_flash_decode(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_acc, void* part_ml, void* counters, int b, int kvh,
    int group, int d, int s, long long head_stride, long long slot_stride,
    int nsplit, int tiles_per_split, float scale_log2, void* stream) {
  cudaGetLastError();
  if (b <= 0 || kvh <= 0) return 0;
  const int tiles = (s + kDecTile - 1) / kDecTile;
  if (b > 65535 || kvh > 65535 || s <= 0 || tiles_per_split <= 0 ||
      nsplit < 1 || (long long)nsplit * tiles_per_split < tiles ||
      (long long)(nsplit - 1) * tiles_per_split >= tiles ||
      (nsplit > 1 && (!part_acc || !part_ml || !counters)))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k, v, lengths, out, part_acc, part_ml, counters, b,
                     kvh, s, nsplit, tiles_per_split, head_stride,
                     slot_stride, scale_log2,
                     static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 64: return launch_decode_g<64>(group, a);
    case 128: return launch_decode_g<128>(group, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
