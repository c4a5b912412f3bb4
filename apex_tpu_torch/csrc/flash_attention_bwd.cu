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
// which limits it to sq * d * 4 <= 2 MB.  Here the grid is (key block,
// b*h), every block independent and the heaviest (first) key blocks of
// the causal mask launched first: a block keeps its 128 keys' k and v in
// shared memory and its dk and dv accumulators in registers, loops over
// the 64-query steps that can see those keys (k-major), and adds its dq
// contributions into an fp32 [b*h, sq, d] buffer (zeroed first; a last
// small kernel casts it to bf16).  So every sequence length the forward
// takes is taken; dq's last bits depend on the order the blocks add in.
//
// The one-pass kernel and the split dk/dv kernel are one template,
// flash_bwd_kernel<D, DQ>: the dk/dv kernel is DQ = false, the same
// blocks, loops and products without the dq half, so split and one-pass
// dk and dv are the same bits and repeat from run to run.
//
// What bounds it on the H100: operations.  A causal backward at s = 2048,
// 32 heads, d = 128 is 2.5x the forward's flops (five products per tile
// pair instead of two) over ~0.1 GB of q/k/v/o/dO/dq/dk/dv; the one-pass
// kernel also moves its fp32 dq partials through L2 (64 x d x 4 bytes
// per key block and query step: 0.29 GB at that shape).  The first
// version ran FlashAttention-2's scheme on mma.sync m16n8k16 with four
// warps of 16 keys and 32-query steps and added dq with per-thread fp32
// atomics; it reached 10-15% of the bound (latency: small steps with
// barriers, every B fragment re-read by each warp through ldmatrix, lse
// and delta read from global memory inside the loop, twice the dq
// traffic as per-thread reductions).  This design:
// - all five products run on wgmma (the only path to the card's bf16
//   rate): two warpgroups of 64 keys each, 64-query steps.  S^T = K Q^T
//   and dP^T = V dO^T read both operands from shared memory (K-major);
//   the bf16 P^T and dS^T fragments of those accumulators are the
//   REGISTER A operand of dV += P^T dO and dK += dS^T Q (Q and dO read
//   N-major from the same tiles); dk and dv stay in registers and are
//   written once;
// - q, dO and the step's lse and delta rows are copied with cp.async
//   into a 2-stage ring, prefetched one step ahead; tiles are held in
//   the 128-byte-swizzle layout wgmma reads (64-column chunks, the
//   16-byte units of row r XORed by r mod 8), which the copies write;
// - the softmax recompute is short: one ex2 instruction an element, and
//   without the dq half S^T and dP^T are two commit groups, so P^T and
//   the dV product run while dP^T is still on the tensor cores;
// - dq: dS^T is staged once in shared memory (bf16, swizzled) and each
//   warpgroup takes 64 of dq's d columns of dQ = dS K with one more
//   wgmma (dS read M-major, K N-major); the scaled 64 x d fp32 partial
//   goes to the accumulator as d / 32 bulk tensor reductions
//   (cp.reduce.async.bulk.tensor .add, 64 x 32 boxes of a tensor map in
//   the 128-byte swizzle, rows past sq clipped by the map) issued by one
//   thread, in place of per-thread atomics.
// Head dims 32, 64 and 128 share the template; a head dim under 64 is
// held zero-padded to one 64-column chunk (the swizzle's row).  Not yet
// used by this kernel (#4): TMA loads, a producer warp, setmaxnreg,
// overlap of one step's softmax with the next step's S^T (no registers
// left: dk, dv, S^T and dP^T hold 192 a thread).  The mask and dropout
// instances of the one-pass kernel (flash_attention_bwd_md.cu) took the
// first three (flash_kmajor_ws.cuh: a TMA copying warpgroup, an mbarrier
// ring, dq reductions off the product threads) and ran ~1.4x faster than
// this template's instances of them; the same redesign is open for #4.  PERF.md records the times.
//
// The split dq kernel is query-major: the forward's template with its
// dq half, flash_qmajor_kernel<D, true, kDqBK> (flash_qmajor.cuh).  A
// block keeps 128 queries' q and dO in shared memory (TMA loads by a
// copying warpgroup) and their lse and delta in registers, streams the
// key tiles they can see (64 keys a step, a 3-stage ring guarded by
// mbarriers), runs S = Q K^T and dP = dO V^T on wgmma as two commit
// groups (P's exp2 overlaps dP), and dQ += dS K with dS from registers
// and K read N-major from the tile that was S's B; it writes its
// queries' dq once (no atomics: the same bits from run to run).  Bound
// at causal [1, 32, 8192, 128]: operations, three products, 0.834 ms.
// The first version ran mma.sync m16n8k16 with four warps of 16
// queries, lse and delta read from global memory, and each K tile
// fetched twice through ldmatrix (plain and transposed): 3.51 ms there.
// Measured slower or refused (PERF.md): 128-key steps (ptxas spills at
// d = 128), the dQ product left in flight into the next step, the two
// product warpgroups taking turns to issue their products.
//
// Plain C interface (loaded with ctypes): apex_flash_attention_bwd,
// apex_flash_attention_bwd_dq and apex_flash_attention_bwd_dkv launch on
// the caller's stream and return cudaGetLastError().

#include "flash_kmajor.cuh"
#include "flash_qmajor.cuh"

namespace {

// The split pair: dq from the query-major kernel (flash_qmajor.cuh, the
// forward's template with its dq half), dk and dv from the one-pass
// kernel without its dq half.
constexpr int kDqBK = 64;    // keys a step of the dq kernel

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq,
              int sk, int causal, int off, int valid_q, int valid_k,
              float scale_log2, float scale, cudaStream_t stream) {
  return launch_qmajor<D, true, kDqBK>(
      q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, scale, stream);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int sq, int sk, int causal, int off, int valid_q, int valid_k,
               float scale_log2, float scale, cudaStream_t stream) {
  CUtensorMap unused{};
  return launch_bwd<D, false>(
      q, k, v, dout, lse, delta, unused, dk, dv, bh, sq, sk, causal, off,
      valid_q, valid_k, scale_log2, scale, stream);
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
      return launch_one_pass<32>(q, k, v, dout, lse, delta, dq_acc, dq, dk,
                                 dv, bh, sq, sk, causal, off, valid_q,
                                 valid_k, scale_log2, scale, s);
    case 64:
      return launch_one_pass<64>(q, k, v, dout, lse, delta, dq_acc, dq, dk,
                                 dv, bh, sq, sk, causal, off, valid_q,
                                 valid_k, scale_log2, scale, s);
    case 128:
      return launch_one_pass<128>(q, k, v, dout, lse, delta, dq_acc, dq, dk,
                                 dv, bh, sq, sk, causal, off, valid_q,
                                 valid_k, scale_log2, scale, s);
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
