// Flash-attention backward with a mask or dropout for Hopper (sm_90a):
// the warp-specialized key-major kernel's MASK and DROP instances
// (flash_kmajor_ws.cuh), the one-pass kernel and the split dk/dv kernel.
//
// Replaces: apex_tpu/ops/attention.py :: _bwd_fused_kernel and
// _dkv_kernel (launched by _bwd_impl through pl.pallas_call) with their
// mask3 operand (per batch, per head or shared; True = masked; a fully
// masked row gives 0) and their dropout operand (the SMEM seed [seed,
// row_off, col_off]).  Same function as the instances without them
// (flash_attention_bwd.cu), with _recompute_p's mask and _dropped_dp's
// dropout: dv takes the dropped p scaled by 1 / (1 - rate), ds = p (keep
// ? dp / (1 - rate) : 0 - delta), delta = rowsum(dO * O) unchanged.  The
// keep mask is _keep_mask's bit for bit (hopper.cuh, drop_keep).
//
// Translation: the TPU kernels read a [bq, bk] block of mask3 a grid
// step.  Here the mask runs through the forward's pre-pass
// (mask_tiles_kernel, flash_qmajor.cuh), whose class of each (128-query
// block, 128-key tile) lets the kernel skip a dead 64-query step (and a
// block whose steps are all dead altogether) and take a full one without
// per-element tests; a copying warpgroup brings a partial step's 1 KB of
// the pre-pass's bits with q and dO by TMA.  The one-pass entries run the
// pre-pass themselves; the split dk/dv entry takes the scratch filled
// (the split backward runs the pre-pass once for its two kernels,
// apex_flash_mask_tiles).  The accumulators hold S^T, rows are keys:
// the keep hash takes the query as its row and the key as its column,
// the key's part hashed once a thread, the query's once a step, and the
// step's keep bits are held in one register between the dV and dS
// halves.
//
// What bounds it on the H100: operations, as the instances without them;
// the hash adds integer work beside the tensor-core products.  Built for
// head dims 64 and 128; PERF.md records the times.
//
// Plain C interface (loaded with ctypes): apex_flash_attention_bwd_masked
// (the one-pass kernel with a mask, with or without dropout),
// apex_flash_attention_bwd_drop (the one-pass kernel with dropout, no
// mask) and apex_flash_attention_bwd_dkv_md (the split dk/dv kernel with
// either) launch on the caller's stream and return cudaGetLastError().

#include "flash_kmajor.cuh"
#include "flash_kmajor_ws.cuh"

namespace {

// The one-pass kernel runs the pre-pass (mask: the mask's bytes, its rows
// mask_ld apart) first; the dk/dv kernel takes the scratch filled.
template <int D, bool DQ, bool MASK, bool DROP>
int bwd_md(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* mask,
           int mask_ld, const MdParams& md, const void* bits, void* dq_acc,
           void* dq, void* dk, void* dv, int bh, int sq, int sk, int causal,
           int off, int valid_q, int valid_k, float scale_log2, float scale,
           cudaStream_t s) {
  if constexpr (DQ) {
    if (MASK) {
      if (md.mask_hper < 1 || bh % md.mask_hper)
        return (int)cudaErrorInvalidValue;
      const int e = launch_mask_tiles(
          mask, const_cast<unsigned char*>(md.cls), const_cast<void*>(bits),
          bh / md.mask_hper, sq, sk, mask_ld, causal, off, valid_q, valid_k,
          s);
      if (e) return e;
    }
    return launch_one_pass_ws<D, MASK, DROP>(
        q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, causal,
        off, valid_q, valid_k, scale_log2, scale, s, md, bits);
  } else {
    return launch_dkv_ws<D, MASK, DROP>(q, k, v, dout, lse, delta, dk, dv,
                                        bh, sq, sk, causal, off, valid_q,
                                        valid_k, scale_log2, scale, s, md,
                                        bits);
  }
}

// MASK: the tile classes (cls non-null), DROP: the seed operand.
template <int D, bool DQ>
int by_operands(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* mask, int mask_ld, const MdParams& md,
                const void* bits, void* dq_acc, void* dq, void* dk, void* dv,
                int bh, int sq, int sk, int causal, int off, int valid_q,
                int valid_k, float scale_log2, float scale, cudaStream_t s) {
  const bool masked = md.cls != nullptr, drop = md.seed3 != nullptr;
  if (masked && drop)
    return bwd_md<D, DQ, true, true>(q, k, v, dout, lse, delta, mask,
                                     mask_ld, md, bits, dq_acc, dq, dk, dv,
                                     bh, sq, sk, causal, off, valid_q,
                                     valid_k, scale_log2, scale, s);
  if (masked)
    return bwd_md<D, DQ, true, false>(q, k, v, dout, lse, delta, mask,
                                      mask_ld, md, bits, dq_acc, dq, dk, dv,
                                      bh, sq, sk, causal, off, valid_q,
                                      valid_k, scale_log2, scale, s);
  if (drop)
    return bwd_md<D, DQ, false, true>(q, k, v, dout, lse, delta, mask,
                                      mask_ld, md, bits, dq_acc, dq, dk, dv,
                                      bh, sq, sk, causal, off, valid_q,
                                      valid_k, scale_log2, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <bool DQ>
int entry(const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, const void* mask, void* cls,
          void* bits, const void* seed3, void* dq_acc, void* dq, void* dk,
          void* dv, int bh, int sq, int sk, int d, int causal, int off,
          int valid_q, int valid_k, int mask_hper, int mask_ld,
          int threshold, float inv_keep, float scale_log2, float scale,
          void* stream) {
  cudaGetLastError();
  if (bh <= 0 || (DQ ? sq : sk) <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  const MdParams md{static_cast<const unsigned char*>(cls),
                    static_cast<const int*>(seed3), mask_hper,
                    (unsigned)threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return by_operands<64, DQ>(q, k, v, dout, lse, delta, mask, mask_ld,
                                 md, bits, dq_acc, dq, dk, dv, bh, sq, sk,
                                 causal, off, valid_q, valid_k, scale_log2,
                                 scale, s);
    case 128:
      return by_operands<128, DQ>(q, k, v, dout, lse, delta, mask, mask_ld,
                                  md, bits, dq_acc, dq, dk, dv, bh, sq, sk,
                                  causal, off, valid_q, valid_k, scale_log2,
                                  scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The one-pass backward with a mask: operands as apex_flash_attention_bwd
// plus mask [bh / mask_hper, sq, mask_ld] bytes (nonzero = masked;
// mask_ld >= sk), cls and bits the pre-pass's scratch (as
// apex_flash_attention_fwd_masked's), and, for
// dropout, seed3 [3] int32 on the card, threshold = round(rate * 2^24)
// and inv_keep = 1 / (1 - rate) (seed3 null: no dropout).  d 64 or 128.
extern "C" int apex_flash_attention_bwd_masked(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask, void* cls,
    void* bits, const void* seed3, void* dq_acc, void* dq, void* dk,
    void* dv, int bh, int sq, int sk, int d, int causal, int off,
    int valid_q, int valid_k, int mask_hper, int mask_ld, int threshold,
    float inv_keep, float scale_log2, float scale, void* stream) {
  if (mask == nullptr || cls == nullptr) return (int)cudaErrorInvalidValue;
  return entry<true>(q, k, v, dout, lse, delta, mask, cls, bits, seed3,
                     dq_acc, dq, dk, dv, bh, sq, sk, d, causal, off, valid_q,
                     valid_k, mask_hper, mask_ld, threshold, inv_keep,
                     scale_log2, scale, stream);
}

// The one-pass backward with dropout and no mask (mask, cls, bits null).
extern "C" int apex_flash_attention_bwd_drop(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask, void* cls,
    void* bits, const void* seed3, void* dq_acc, void* dq, void* dk,
    void* dv, int bh, int sq, int sk, int d, int causal, int off,
    int valid_q, int valid_k, int mask_hper, int mask_ld, int threshold,
    float inv_keep, float scale_log2, float scale, void* stream) {
  if (mask != nullptr || cls != nullptr || seed3 == nullptr)
    return (int)cudaErrorInvalidValue;
  return entry<true>(q, k, v, dout, lse, delta, mask, cls, bits, seed3,
                     dq_acc, dq, dk, dv, bh, sq, sk, d, causal, off, valid_q,
                     valid_k, mask_hper, mask_ld, threshold, inv_keep,
                     scale_log2, scale, stream);
}

// The split backward's dk and dv with a mask (cls and bits the pre-pass's
// scratch, filled for these operands by apex_flash_mask_tiles) and/or
// dropout (seed3 non-null): operands otherwise as
// apex_flash_attention_bwd_masked's without the mask, dq_acc and dq.
// Runs no pre-pass.
extern "C" int apex_flash_attention_bwd_dkv_md(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* cls, void* bits,
    const void* seed3, void* dk, void* dv, int bh, int sq, int sk, int d,
    int causal, int off, int valid_q, int valid_k, int mask_hper,
    int threshold, float inv_keep, float scale_log2, float scale,
    void* stream) {
  return entry<false>(q, k, v, dout, lse, delta, nullptr, cls, bits, seed3,
                      nullptr, nullptr, dk, dv, bh, sq, sk, d, causal, off,
                      valid_q, valid_k, mask_hper, sk, threshold, inv_keep,
                      scale_log2, scale, stream);
}
