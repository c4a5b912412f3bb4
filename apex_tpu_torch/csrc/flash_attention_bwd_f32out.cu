// Flash-attention one-pass backward with fp32 outputs for Hopper
// (sm_90a): bf16 operands, dq, dk and dv written in fp32 (#4 and #4d's
// fp32-output instances); and the split backward's dk and dv in fp32
// (#6 and #6md's dropout instance: 6f, 6df), which run on the same
// templates.
//
// Replaces: apex_tpu/ops/attention.py :: _bwd_fused_kernel (launched by
// _bwd_impl through pl.pallas_call) with out_dtype=jnp.float32, as ring
// attention's backward calls it (apex_tpu/ops/ring_attention.py ::
// run_bwd): each shard pair's dq, dk and dv stay fp32, so the ring's
// accumulators (dk and dv travel with their K/V for cp hops) never round
// through bf16.  Same function as the bf16 instances
// (flash_attention_bwd.cu's one-pass kernel; flash_attention_bwd_md.cu's
// with dropout, its seed operand giving the pair's global offsets).
//
// Translation: the output type is a template parameter of the shared
// templates (flash_kmajor.cuh's F32, flash_kmajor_ws.cuh's F32), off in
// every other instance, whose code is unchanged.  The one-pass kernels
// add dq's fp32 partials into an accumulator by bulk tensor reductions;
// with fp32 outputs that accumulator is dq itself, so no cast follows
// (the warp-specialized kernel, whose bf16 instances leave the softmax
// scale to the cast, scales its partials before the reduction).  dk and
// dv leave from the accumulators as fp32 pairs.
//
// What bounds it on the H100: operations, as the bf16 instances.
// PERF.md records the times.
//
// The split dk/dv (6f, 6df) replaces apex_tpu/ops/attention.py ::
// _dkv_kernel (launched by _bwd_impl through pl.pallas_call past the
// one-pass gate) with out_dtype=jnp.float32: ring attention's backward at
// a shard of more than 4096 tokens at head dim 128.  The one-pass
// kernels without their dq half (flash_kmajor.cuh's, and
// flash_kmajor_ws.cuh's with dropout), dk and dv stored from the
// accumulators as fp32 pairs, each written once (the pair repeats bit
// for bit); the bf16 instances (apex_flash_attention_bwd_dkv,
// apex_flash_attention_bwd_dkv_md) are unchanged.
//
// Plain C interface (loaded with ctypes): apex_flash_attention_bwd_f32out,
// apex_flash_attention_bwd_drop_f32out, apex_flash_attention_bwd_dkv_f32out
// and apex_flash_attention_bwd_dkv_drop_f32out launch on the caller's
// stream and return cudaGetLastError().

#include "flash_kmajor.cuh"
#include "flash_kmajor_ws.cuh"

namespace {

template <int D>
int bwd_f32(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, void* dk, void* dv,
            int bh, int sq, int sk, int causal, int off, int valid_q,
            int valid_k, float scale_log2, float scale, cudaStream_t s) {
  return launch_one_pass<D, true>(q, k, v, dout, lse, delta, nullptr, dq, dk,
                                  dv, bh, sq, sk, causal, off, valid_q,
                                  valid_k, scale_log2, scale, s);
}

template <int D>
int bwd_drop_f32(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const MdParams& md, void* dq, void* dk, void* dv, int bh,
                 int sq, int sk, int causal, int off, int valid_q,
                 int valid_k, float scale_log2, float scale,
                 cudaStream_t s) {
  return launch_one_pass_ws<D, false, true, true>(
      q, k, v, dout, lse, delta, nullptr, dq, dk, dv, bh, sq, sk, causal,
      off, valid_q, valid_k, scale_log2, scale, s, md, nullptr);
}

template <int D>
int dkv_f32(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int bh,
            int sq, int sk, int causal, int off, int valid_q, int valid_k,
            float scale_log2, float scale, cudaStream_t s) {
  CUtensorMap unused{};
  return launch_bwd<D, false, true>(q, k, v, dout, lse, delta, unused, dk,
                                    dv, bh, sq, sk, causal, off, valid_q,
                                    valid_k, scale_log2, scale, s);
}

template <int D>
int dkv_drop_f32(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const MdParams& md, void* dk, void* dv, int bh, int sq,
                 int sk, int causal, int off, int valid_q, int valid_k,
                 float scale_log2, float scale, cudaStream_t s) {
  return launch_dkv_ws<D, false, true, true>(
      q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, off, valid_q,
      valid_k, scale_log2, scale, s, md, nullptr);
}

}  // namespace

// q, dout [bh, sq, d], k, v [bh, sk, d] contiguous, 16-byte aligned bf16;
// lse, delta [bh, sq] fp32 (lse in base 2); dq [bh, sq, d], dk, dv [bh,
// sk, d] fp32 outputs.  d 32, 64 or 128.
extern "C" int apex_flash_attention_bwd_f32out(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int bh,
    int sq, int sk, int d, int causal, int off, int valid_q, int valid_k,
    float scale_log2, float scale, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return bwd_f32<32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk,
                         causal, off, valid_q, valid_k, scale_log2, scale, s);
    case 64:
      return bwd_f32<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk,
                         causal, off, valid_q, valid_k, scale_log2, scale, s);
    case 128:
      return bwd_f32<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk,
                          causal, off, valid_q, valid_k, scale_log2, scale,
                          s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The one-pass backward with dropout, no mask: operands as
// apex_flash_attention_bwd_f32out's; seed3 [3] int32 on the card,
// threshold = round(rate * 2^24), inv_keep = 1 / (1 - rate).  d 64 or
// 128.
extern "C" int apex_flash_attention_bwd_drop_f32out(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seed3, void* dq,
    void* dk, void* dv, int bh, int sq, int sk, int d, int causal, int off,
    int valid_q, int valid_k, int threshold, float inv_keep,
    float scale_log2, float scale, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sq <= 0) return 0;
  if (bh > 65535 || seed3 == nullptr) return (int)cudaErrorInvalidValue;
  const MdParams md{nullptr, static_cast<const int*>(seed3), 1,
                    (unsigned)threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return bwd_drop_f32<64>(q, k, v, dout, lse, delta, md, dq, dk, dv, bh,
                              sq, sk, causal, off, valid_q, valid_k,
                              scale_log2, scale, s);
    case 128:
      return bwd_drop_f32<128>(q, k, v, dout, lse, delta, md, dq, dk, dv, bh,
                               sq, sk, causal, off, valid_q, valid_k,
                               scale_log2, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The split backward's dk and dv with fp32 outputs (6f): operands as
// apex_flash_attention_bwd_dkv's (bf16 q, k, v, dout; fp32 lse in base 2
// and delta); dk, dv [bh, sk, d] fp32.  d 32, 64 or 128.
extern "C" int apex_flash_attention_bwd_dkv_f32out(
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
      return dkv_f32<32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                         causal, off, valid_q, valid_k, scale_log2, scale, s);
    case 64:
      return dkv_f32<64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                         causal, off, valid_q, valid_k, scale_log2, scale, s);
    case 128:
      return dkv_f32<128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                          causal, off, valid_q, valid_k, scale_log2, scale,
                          s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The split backward's dk and dv with dropout and fp32 outputs (6df):
// operands as apex_flash_attention_bwd_dkv_f32out's; seed3 [3] int32 on
// the card, threshold = round(rate * 2^24), inv_keep = 1 / (1 - rate).
// d 64 or 128.
extern "C" int apex_flash_attention_bwd_dkv_drop_f32out(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seed3, void* dk,
    void* dv, int bh, int sq, int sk, int d, int causal, int off,
    int valid_q, int valid_k, int threshold, float inv_keep,
    float scale_log2, float scale, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || sk <= 0) return 0;
  if (bh > 65535 || seed3 == nullptr) return (int)cudaErrorInvalidValue;
  const MdParams md{nullptr, static_cast<const int*>(seed3), 1,
                    (unsigned)threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return dkv_drop_f32<64>(q, k, v, dout, lse, delta, md, dk, dv, bh, sq,
                              sk, causal, off, valid_q, valid_k, scale_log2,
                              scale, s);
    case 128:
      return dkv_drop_f32<128>(q, k, v, dout, lse, delta, md, dk, dv, bh, sq,
                               sk, causal, off, valid_q, valid_k, scale_log2,
                               scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
