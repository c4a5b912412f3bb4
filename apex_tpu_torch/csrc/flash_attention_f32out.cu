// Flash-attention forward with fp32 outputs for Hopper (sm_90a): bf16
// operands, O written in fp32 from the fp32 accumulators (#3 and #3d's
// fp32-output instances); and the split backward's dq in fp32 (#5 and
// #5md's dropout instance: 5f, 5df), which runs on the forward's
// templates.
//
// Replaces: apex_tpu/ops/attention.py :: _fwd_kernel (launched by _fwd
// through pl.pallas_call) with out_dtype=jnp.float32, as ring attention
// calls it (apex_tpu/ops/ring_attention.py :: _local_flash): each shard
// pair's partial stays fp32, so the cp-step merge never rounds through
// bf16.  Same function as the bf16 instances (flash_attention.cu: the
// query-major kernel; flash_attention_md.cu: the warp-specialized one
// with dropout, its seed operand [seed, row_off, col_off] giving the
// pair's global row and column offsets); only the output's type differs.
//
// Translation: the output type is a template parameter of the shared
// templates (flash_qmajor.cuh's F32, flash_qmajor_ws.cuh's F32), off in
// every other instance, whose code is unchanged.  With it O leaves
// straight from the accumulators as fp32 pairs (the warp-specialized
// kernel then keeps no O staging buffer for a TMA store: an fp32 tile
// would double it).
//
// What bounds it on the H100: operations, as the bf16 instances; O's
// bytes double (4 of 4 + 4 + 4 + 2 bytes a row element), still far
// under the products' time.  PERF.md records the times.
//
// The split dq (5f, 5df) replaces apex_tpu/ops/attention.py :: _dq_kernel
// (launched by _bwd_impl through pl.pallas_call past the one-pass gate)
// with out_dtype=jnp.float32: ring attention's backward at a shard of
// more than 4096 tokens at head dim 128 (sq * d * 4 > 2 MiB).  dq leaves
// from the accumulator times the softmax scale as fp32 pairs, written
// once (no atomics, as the bf16 instances: the pair repeats bit for
// bit); the bf16 instances (flash_attention_bwd.cu's
// apex_flash_attention_bwd_dq, flash_attention_md.cu's
// apex_flash_attention_bwd_dq_md) are unchanged.
//
// Plain C interface (loaded with ctypes): apex_flash_attention_fwd_f32out,
// apex_flash_attention_fwd_drop_f32out, apex_flash_attention_bwd_dq_f32out
// and apex_flash_attention_bwd_dq_drop_f32out launch on the caller's
// stream and return cudaGetLastError().

#include "flash_qmajor.cuh"
#include "flash_qmajor_ws.cuh"

namespace {

constexpr int kF32BK = 128;     // keys a step, as the bf16 forward's
constexpr int kF32DqBK = 64;    // keys a step, as the bf16 split dq's

template <int D>
int fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
            int bh, int sq, int sk, int causal, int off, int valid_q,
            int valid_k, float scale_log2, cudaStream_t s) {
  return launch_qmajor<D, false, kF32BK, false, true>(
      q, k, v, nullptr, nullptr, nullptr, o, lse, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, 0.f, s);
}

template <int D>
int fwd_drop_f32(const void* q, const void* k, const void* v,
                 const void* seed3, void* o, void* lse, int bh, int sq,
                 int sk, int causal, int off, int valid_q, int valid_k,
                 unsigned threshold, float inv_keep, float scale_log2,
                 cudaStream_t s) {
  return launch_qm_ws<D, false, false, true, true>(
      q, k, v, nullptr, nullptr, nullptr, o, lse, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, 1.f, s, nullptr, nullptr, 1, seed3,
      threshold, inv_keep);
}

template <int D>
int dq_f32(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, int sq,
           int sk, int causal, int off, int valid_q, int valid_k,
           float scale_log2, float scale, cudaStream_t s) {
  return launch_qmajor<D, true, kF32DqBK, false, true>(
      q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, scale, s);
}

template <int D>
int dq_drop_f32(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* seed3, void* next_tile, void* dq, int bh, int sq,
                int sk, int causal, int off, int valid_q, int valid_k,
                unsigned threshold, float inv_keep, float scale_log2,
                float scale, cudaStream_t s) {
  return launch_qm_ws<D, false, true, true, true>(
      q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, scale, s, nullptr, nullptr, 1, seed3,
      threshold, inv_keep, next_tile);
}

}  // namespace

// q [bh, sq, d], k/v [bh, sk, d] contiguous, 16-byte aligned bf16; o
// [bh, sq, d] fp32; lse [bh, sq] fp32 or null.  d 32, 64 or 128.
extern "C" int apex_flash_attention_fwd_f32out(
    const void* q, const void* k, const void* v, void* o, void* lse, int bh,
    int sq, int sk, int d, int causal, int off, int valid_q, int valid_k,
    float scale_log2, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return fwd_f32<32>(q, k, v, o, lse, bh, sq, sk, causal, off, valid_q,
                         valid_k, scale_log2, s);
    case 64:
      return fwd_f32<64>(q, k, v, o, lse, bh, sq, sk, causal, off, valid_q,
                         valid_k, scale_log2, s);
    case 128:
      return fwd_f32<128>(q, k, v, o, lse, bh, sq, sk, causal, off, valid_q,
                          valid_k, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The forward with dropout, no mask: operands as
// apex_flash_attention_fwd_f32out's; seed3 [3] int32 on the card
// ([seed, row_off, col_off]), threshold = round(rate * 2^24), inv_keep =
// 1 / (1 - rate).  d 64 or 128.
extern "C" int apex_flash_attention_fwd_drop_f32out(
    const void* q, const void* k, const void* v, const void* seed3, void* o,
    void* lse, int bh, int sq, int sk, int d, int causal, int off,
    int valid_q, int valid_k, int threshold, float inv_keep,
    float scale_log2, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535 || seed3 == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return fwd_drop_f32<64>(q, k, v, seed3, o, lse, bh, sq, sk, causal,
                              off, valid_q, valid_k, (unsigned)threshold,
                              inv_keep, scale_log2, s);
    case 128:
      return fwd_drop_f32<128>(q, k, v, seed3, o, lse, bh, sq, sk, causal,
                               off, valid_q, valid_k, (unsigned)threshold,
                               inv_keep, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The split backward's dq with fp32 output (5f): operands as
// apex_flash_attention_bwd_dq's (q, dout [bh, sq, d], k, v [bh, sk, d]
// bf16; lse in base 2 and delta [bh, sq] fp32); dq [bh, sq, d] fp32,
// written once.  d 32, 64 or 128.
extern "C" int apex_flash_attention_bwd_dq_f32out(
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
      return dq_f32<32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal,
                        off, valid_q, valid_k, scale_log2, scale, s);
    case 64:
      return dq_f32<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal,
                        off, valid_q, valid_k, scale_log2, scale, s);
    case 128:
      return dq_f32<128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, causal,
                         off, valid_q, valid_k, scale_log2, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The split backward's dq with dropout and fp32 output (5df): operands as
// apex_flash_attention_bwd_dq_f32out's; seed3 [3] int32 on the card,
// next_tile one int32 of scratch (the persistent blocks' tile counter,
// zeroed here), threshold = round(rate * 2^24), inv_keep = 1 / (1 -
// rate).  d 64 or 128.
extern "C" int apex_flash_attention_bwd_dq_drop_f32out(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seed3, void* next_tile,
    void* dq, int bh, int sq, int sk, int d, int causal, int off,
    int valid_q, int valid_k, int threshold, float inv_keep,
    float scale_log2, float scale, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535 || seed3 == nullptr || next_tile == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return dq_drop_f32<64>(q, k, v, dout, lse, delta, seed3, next_tile, dq,
                             bh, sq, sk, causal, off, valid_q, valid_k,
                             (unsigned)threshold, inv_keep, scale_log2,
                             scale, s);
    case 128:
      return dq_drop_f32<128>(q, k, v, dout, lse, delta, seed3, next_tile,
                              dq, bh, sq, sk, causal, off, valid_q, valid_k,
                              (unsigned)threshold, inv_keep, scale_log2,
                              scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
