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
// The masked instance (flash_qmajor_kernel<D, false, kFwdBK, true>) is
// the same kernel with the per-element mask test on every tile: it reads
// one mask byte per live (row, key) from device memory (L2 serves the
// heads that share a mask) and never takes a tile as whole.  Its main
// callers are decode_attention's kernel branch (sq = 1 against a long
// dense cache: 127 of a block's 128 query rows are dead, as in the TPU
// kernel's 128-row block, and the time is the k/v stream, bytes-bound)
// and BERT's padding mask.
//
// Plain C interface (loaded with ctypes): apex_flash_attention_fwd and
// apex_flash_attention_fwd_masked launch on the caller's stream and
// return cudaGetLastError().

#include "flash_qmajor.cuh"

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
                  const void* mask, void* o, void* lse, int bh, int sq,
                  int sk, int causal, int off, int valid_q, int valid_k,
                  int mask_hper, float scale_log2, cudaStream_t stream) {
  return launch_qmajor<D, false, kFwdBK, true>(
      q, k, v, nullptr, nullptr, nullptr, o, lse, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, 0.f, stream, mask, mask_hper);
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
// (nonzero = masked), contiguous; mask_hper divides bh.
extern "C" int apex_flash_attention_fwd_masked(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int bh, int sq, int sk, int d, int causal, int off,
    int valid_q, int valid_k, int mask_hper, float scale_log2,
    void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535 || mask_hper < 1 || bh % mask_hper)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_masked<32>(q, k, v, mask, o, lse, bh, sq, sk, causal,
                               off, valid_q, valid_k, mask_hper, scale_log2,
                               s);
    case 64:
      return launch_masked<64>(q, k, v, mask, o, lse, bh, sq, sk, causal,
                               off, valid_q, valid_k, mask_hper, scale_log2,
                               s);
    case 128:
      return launch_masked<128>(q, k, v, mask, o, lse, bh, sq, sk, causal,
                                off, valid_q, valid_k, mask_hper, scale_log2,
                                s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
