// Flash attention with dropout, and the split backward's dq with a mask
// or dropout, for Hopper (sm_90a): both are the warp-specialized
// persistent kernel of flash_qmajor_ws.cuh (#3d, #3md: the forward; #5md:
// its dq mode).  And the mask pre-pass alone, for the split backward.
//
// Replaces: apex_tpu/ops/attention.py :: _fwd_kernel (launched by _fwd
// through pl.pallas_call) with its dropout operand (rate > 0, the SMEM
// seed [seed, row_off, col_off]), with and without its mask3 operand;
// and _dq_kernel (launched by _bwd_impl past the 2 MiB gate) with
// mask3 and dropout.  The keep mask is _keep_mask's, bit for bit: the
// murmur3 finalizer over the global (batch * head, query row, key
// column), uint32 arithmetic (hopper.cuh, drop_keep), kept where its top
// 24 bits reach round(rate * 2^24).  The forward's row sums take the
// clean p and only the P V product the dropped p scaled by 1 / (1 -
// rate), as _fwd_kernel does; dq takes dS = P (keep ? dP / (1 - rate) :
// 0 - delta), as _dropped_dp does.
//
// Translation: the TPU kernels hash a [bq, bk] block of coordinates a
// grid step; here each product thread hashes the elements of its
// accumulator fragment (rows row and row + 8, keys 8 j + 2 tig + e) in
// registers, about ten integer operations an element, with the row part
// hashed once a row, while the step's S product runs.  The seed operand
// stays in device memory (read by each thread at the start), so a seed
// drawn on the card needs no host sync.  The masked instances take the
// mask pre-pass (mask_tiles_kernel) and walk only live tiles; the dq
// kernel's 64-key steps read half of a 128-key tile's class and bits.
// The forward's masked entry runs the pre-pass itself; the dq entry takes
// the scratch filled (apex_flash_mask_tiles: the split backward runs the
// pre-pass once for its two kernels).
//
// What bounds it on the H100: operations, as the instances without
// dropout (flash_attention.cu, flash_attention_bwd.cu); the hash adds
// integer work on the CUDA cores beside the tensor-core products.  These
// instances are built for head dims 64 and 128 (BERT-large and GPT-3
// 1.3B); the wrapper refuses others.  PERF.md records their times.
//
// Plain C interface (loaded with ctypes): apex_flash_attention_fwd_drop,
// apex_flash_attention_fwd_masked_drop, apex_flash_attention_bwd_dq_md
// and apex_flash_mask_tiles launch on the caller's stream and return
// cudaGetLastError().

#include "flash_qmajor.cuh"
#include "flash_qmajor_ws.cuh"

namespace {

struct MdArgs {
  const void *mask, *cls, *bits, *seed3;
  int mask_hper, mask_ld;
  unsigned threshold;
  float inv_keep;
  void* next_tile;          // the dq kernel's tile counter
};

// the pre-pass, for an instance with the mask
int pre_pass(const MdArgs& a, int bh, int sq, int sk, int causal, int off,
             int valid_q, int valid_k, cudaStream_t s) {
  if (a.mask_hper < 1 || bh % a.mask_hper) return (int)cudaErrorInvalidValue;
  return launch_mask_tiles(a.mask, const_cast<void*>(a.cls),
                           const_cast<void*>(a.bits), bh / a.mask_hper, sq,
                           sk, a.mask_ld, causal, off, valid_q, valid_k, s);
}

template <int D, bool MASK>
int fwd_drop(const void* q, const void* k, const void* v, void* o, void* lse,
             const MdArgs& a, int bh, int sq, int sk, int causal, int off,
             int valid_q, int valid_k, float scale_log2, cudaStream_t s) {
  if (MASK) {
    const int e = pre_pass(a, bh, sq, sk, causal, off, valid_q, valid_k, s);
    if (e) return e;
  }
  return launch_qm_ws<D, MASK, false, true>(
      q, k, v, nullptr, nullptr, nullptr, o, lse, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, 1.f, s, a.cls, a.bits, a.mask_hper,
      a.seed3, a.threshold, a.inv_keep);
}

// the dq kernel (MASK: the pre-pass's scratch filled)
template <int D, bool MASK, bool DROP>
int dq_md(const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, void* dq, const MdArgs& a,
          int bh, int sq, int sk, int causal, int off, int valid_q,
          int valid_k, float scale_log2, float scale, cudaStream_t s) {
  return launch_qm_ws<D, MASK, true, DROP>(
      q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, scale, s, a.cls, a.bits, a.mask_hper,
      a.seed3, a.threshold, a.inv_keep, a.next_tile);
}

template <bool MASK>
int fwd_entry(const void* q, const void* k, const void* v, void* o,
              void* lse, const MdArgs& a, int bh, int sq, int sk, int d,
              int causal, int off, int valid_q, int valid_k,
              float scale_log2, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535 || a.seed3 == nullptr || (MASK != (a.mask != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return fwd_drop<64, MASK>(q, k, v, o, lse, a, bh, sq, sk, causal, off,
                                valid_q, valid_k, scale_log2, s);
    case 128:
      return fwd_drop<128, MASK>(q, k, v, o, lse, a, bh, sq, sk, causal, off,
                                 valid_q, valid_k, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, const MdArgs& a,
             int bh, int sq, int sk, int causal, int off, int valid_q,
             int valid_k, float scale_log2, float scale, cudaStream_t s) {
  const bool mask = a.cls != nullptr, drop = a.seed3 != nullptr;
  if (mask && drop)
    return dq_md<D, true, true>(q, k, v, dout, lse, delta, dq, a, bh, sq, sk,
                                causal, off, valid_q, valid_k, scale_log2,
                                scale, s);
  if (mask)
    return dq_md<D, true, false>(q, k, v, dout, lse, delta, dq, a, bh, sq,
                                 sk, causal, off, valid_q, valid_k,
                                 scale_log2, scale, s);
  if (drop)
    return dq_md<D, false, true>(q, k, v, dout, lse, delta, dq, a, bh, sq,
                                 sk, causal, off, valid_q, valid_k,
                                 scale_log2, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The forward with dropout, no mask: operands as apex_flash_attention_fwd
// (q, k, v, o [bh, s, d] bf16, lse [bh, sq] fp32 or null); mask, cls and
// bits null; seed3 [3] int32 on the card; threshold = round(rate * 2^24),
// inv_keep = 1 / (1 - rate); mask_hper and mask_ld unused.  d 64 or 128.
extern "C" int apex_flash_attention_fwd_drop(
    const void* q, const void* k, const void* v, const void* mask,
    void* cls, void* bits, const void* seed3, void* o, void* lse, int bh,
    int sq, int sk, int d, int causal, int off, int valid_q, int valid_k,
    int mask_hper, int mask_ld, int threshold, float inv_keep,
    float scale_log2, void* stream) {
  const MdArgs a{mask, cls, bits, seed3, mask_hper, mask_ld,
                 (unsigned)threshold, inv_keep, nullptr};
  return fwd_entry<false>(q, k, v, o, lse, a, bh, sq, sk, d, causal, off,
                          valid_q, valid_k, scale_log2, stream);
}

// As apex_flash_attention_fwd_drop with the mask: mask [bh / mask_hper,
// sq, mask_ld] bytes (nonzero = masked, mask_ld >= sk), cls and bits the
// pre-pass's scratch as apex_flash_attention_fwd_masked's.
extern "C" int apex_flash_attention_fwd_masked_drop(
    const void* q, const void* k, const void* v, const void* mask,
    void* cls, void* bits, const void* seed3, void* o, void* lse, int bh,
    int sq, int sk, int d, int causal, int off, int valid_q, int valid_k,
    int mask_hper, int mask_ld, int threshold, float inv_keep,
    float scale_log2, void* stream) {
  const MdArgs a{mask, cls, bits, seed3, mask_hper, mask_ld,
                 (unsigned)threshold, inv_keep, nullptr};
  return fwd_entry<true>(q, k, v, o, lse, a, bh, sq, sk, d, causal, off,
                         valid_q, valid_k, scale_log2, stream);
}

// The split backward's dq with a mask (cls and bits the pre-pass's
// scratch, filled for these operands by apex_flash_mask_tiles) and/or
// dropout (seed3 non-null): operands otherwise as
// apex_flash_attention_bwd_dq's, and next_tile one int32 of scratch (the
// persistent blocks' tile counter).  d 64 or 128.  Runs no pre-pass.
extern "C" int apex_flash_attention_bwd_dq_md(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* cls, void* bits,
    const void* seed3, void* next_tile, void* dq, int bh, int sq, int sk,
    int d, int causal, int off, int valid_q, int valid_k, int mask_hper,
    int threshold, float inv_keep, float scale_log2, float scale,
    void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  const MdArgs a{nullptr, cls, bits, seed3, mask_hper, sk,
                 (unsigned)threshold, inv_keep, next_tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return dq_entry<64>(q, k, v, dout, lse, delta, dq, a, bh, sq, sk,
                          causal, off, valid_q, valid_k, scale_log2, scale, s);
    case 128:
      return dq_entry<128>(q, k, v, dout, lse, delta, dq, a, bh, sq, sk,
                           causal, off, valid_q, valid_k, scale_log2, scale,
                           s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The mask pre-pass alone: mask [nmask, sq, mask_ld] bytes (nonzero =
// masked, mask_ld >= sk) into the tile classes cls [nmask, nqb, nkt] and
// bits [nmask, nqb, nkt, 512] (nqb query blocks and nkt key tiles of 128)
// that the split backward's two kernels read.
extern "C" int apex_flash_mask_tiles(const void* mask, void* cls, void* bits,
                                     int nmask, int sq, int sk, int mask_ld,
                                     int causal, int off, int valid_q,
                                     int valid_k, void* stream) {
  cudaGetLastError();
  if (nmask <= 0 || sq <= 0) return 0;
  if (nmask > 65535) return (int)cudaErrorInvalidValue;
  return launch_mask_tiles(mask, cls, bits, nmask, sq, sk, mask_ld, causal,
                           off, valid_q, valid_k,
                           static_cast<cudaStream_t>(stream));
}
