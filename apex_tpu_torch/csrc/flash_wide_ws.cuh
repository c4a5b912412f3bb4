// The wide family's tensor-core route: #3w (the forward) and #5w (dq) as
// the wide operand modes of the persistent warp-specialized kernel
// (flash_qmajor_ws.cuh :: flash_fwd_ws_kernel<D, false, DQ, DROP, OP,
// NWG>), #6w (dk, dv) as those of the key-major warp-specialized kernel
// (flash_kmajor_ws.cuh :: flash_bwd_ws_kernel<D, false, false, DROP,
// OP>).  flash_wide.cu holds the C entries, which take this route for
// 16-bit operands and for fp32 as planes; the instances live in sources
// of their own (flash_wide_tc_*.cu), which nvcc compiles beside one
// another, and meet flash_wide.cu through the functions declared below.
//
// Instances: fp16 at the buckets D = 64, 128, 256; bf16 at 256 (bf16 up
// to 128 takes the bf16 instances of flash_attention*.cu, padded); both
// again for rows TMA cannot read (d % 8 != 0 or an operand not 16-byte
// aligned: the row-copying modes); fp32 as three bf16 planes at 64 and
// 128, the dq mode at 128 with one product warpgroup on 64-query tiles,
// the dk/dv mode at 128 on 32-query steps.  Each with and without
// dropout (DROP).
#pragma once

#include "flash_kmajor_ws.cuh"
#include "flash_qmajor_ws.cuh"

// One launch of the route.  q, k, v (and dout) are [bh, s, dp] 16-bit
// values (dp = d) or, for fp32, [3, bh, s, dp] bf16 planes (dp = d rounded
// up to 8, the padding columns zero: flash_wide.cu's split kernel);
// 16-byte aligned.
struct WideTcArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;       // dq: the forward's base-2 lse, delta
  const unsigned char* mask;      // [bh / mask_hper, sq, sk] or null
  const int* seed3;               // [seed, row_off, col_off] or null
  void* out;                      // O or dq [bh, sq, d] (dk [bh, sk, d]),
                                  // fp32 for planes
  void* dv;                       // dk/dv: dv [bh, sk, d]
  float* lse_out;                 // the forward's lse [bh, sq]
  int bh, sq, sk, d, dp, causal, off, valid_q, valid_k, mask_hper;
  unsigned threshold;
  float inv_keep, scale_log2, scale;
};

// the instance sources' launches, each picking its bucket (by dp) and
// whether it drops (seed3)
int wide_tc_f16_fwd(const WideTcArgs& a, cudaStream_t s);
int wide_tc_f16_dq(const WideTcArgs& a, cudaStream_t s);
int wide_tc_bf16(const WideTcArgs& a, bool dq, cudaStream_t s);
int wide_tc_f32_fwd(const WideTcArgs& a, cudaStream_t s);
int wide_tc_f32_dq(const WideTcArgs& a, cudaStream_t s);
int wide_tc_rows_fwd(const WideTcArgs& a, bool f16, cudaStream_t s);
int wide_tc_rows_dq(const WideTcArgs& a, bool f16, cudaStream_t s);
int wide_tc_dkv_f16(const WideTcArgs& a, cudaStream_t s);
int wide_tc_dkv_bf16(const WideTcArgs& a, cudaStream_t s);
int wide_tc_dkv_f32(const WideTcArgs& a, cudaStream_t s);
int wide_tc_dkv_rows(const WideTcArgs& a, bool f16, cudaStream_t s);

namespace {

// flash_fwd_ws_kernel's wide mode OP over a.bh batch-heads: the tensor
// maps (planes stacked as batch-heads bh + pl nbh; a row-copying mode's
// operand addresses in their place), the groups of heads and the
// persistent grid, as launch_qm_ws's without a mask.
template <int D, bool DQ, bool DROP, int OP, int NWG>
int launch_wide_ws(const WideTcArgs& a, cudaStream_t stream) {
  using T = FwTiles<D, false, DQ, OP, NWG>;
  constexpr int BQ = T::BQ;
  if (DROP && a.seed3 == nullptr) return (int)cudaErrorInvalidValue;
  if (DQ && (a.dout == nullptr || a.lse == nullptr || a.delta == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rows = T::NPL * a.bh;
  CUtensorMap tq, tk, tv, tdo;
  if constexpr (kOpRows<OP>) {
    tq = address_map(a.q);
    tk = address_map(a.k);
    tv = address_map(a.v);
    tdo = address_map(DQ ? a.dout : a.q);
  } else {
    int e = bf16_tile_map(&tq, a.q, rows, a.sq, a.dp, BQ);
    // no keys: no tile loads k or v, whose maps then describe q
    if (!e) e = a.sk > 0 ? bf16_tile_map(&tk, a.k, rows, a.sk, a.dp, T::BK)
                         : bf16_tile_map(&tk, a.q, rows, a.sq, a.dp, T::BK);
    if (!e) e = a.sk > 0 ? bf16_tile_map(&tv, a.v, rows, a.sk, a.dp, T::BK)
                         : bf16_tile_map(&tv, a.q, rows, a.sq, a.dp, T::BK);
    if (!e) e = bf16_tile_map(&tdo, DQ ? a.dout : a.q, rows, a.sq, a.dp, BQ);
    if (e) return e;
  }
  FwParams p{};
  p.nbh = a.bh;
  p.sq = a.sq;
  p.sk = a.sk;
  p.causal = a.causal;
  p.off = a.off;
  p.valid_q = a.valid_q;
  p.valid_k = a.valid_k;
  p.scale_log2 = a.scale_log2;
  p.scale = a.scale;
  p.lse_in = a.lse;
  p.delta = a.delta;
  p.nqb = (a.sq + BQ - 1) / BQ;
  p.seed3 = a.seed3;
  p.threshold = a.threshold;
  p.inv_keep = a.inv_keep;
  p.out = a.out;
  p.d = a.d;
  p.mask3 = a.mask;
  p.mhper = a.mask_hper;
  // heads in groups of near-equal size whose k and v fit half the L2
  const long long kv_bytes =
      4LL * T::NPL * (a.sk > 0 ? a.sk : 1) * T::DP * a.bh;
  const long long ng = (kv_bytes + kL2Half - 1) / kL2Half;
  p.gm = (int)((a.bh + ng - 1) / ng);
  p.hper = 1;
  p.nmask = a.bh;
  p.hc = 1;
  p.nch = 1;
  const long long tiles = (long long)a.bh * p.nqb;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_ws_kernel<D, false, DQ, DROP, OP, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::bytes);
  if (err != cudaSuccess) return (int)err;
  // one block an SM of the current device
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  flash_fwd_ws_kernel<D, false, DQ, DROP, OP, NWG>
      <<<grid, kFwThreads, T::bytes, stream>>>(tq, tk, tv, tq, tdo,
                                                a.lse_out, p);
  return (int)cudaGetLastError();
}

// bucket D of mode OP, with or without dropout; fp32's dq mode at 128 on
// 64-query tiles (its six planes of Q and dO for 128 queries and two
// stages do not fit)
template <int OP, bool DQ, int D>
int launch_wide_d(const WideTcArgs& a, cudaStream_t s) {
  constexpr int NWG = OP == kOpWideF32 && DQ && D == 128 ? 1 : 2;
  return a.seed3 != nullptr ? launch_wide_ws<D, DQ, true, OP, NWG>(a, s)
                            : launch_wide_ws<D, DQ, false, OP, NWG>(a, s);
}

// #6w: flash_bwd_ws_kernel's wide mode OP over a.bh batch-heads, dk into
// a.out and dv into a.dv: the tensor maps (planes stacked as batch-heads
// bh + pl nbh; a row-copying mode's operand addresses in their place),
// the head dim in the dq map's place and mask3 in the pre-pass bits',
// one block a (64-key block, batch-head), the longest key blocks first
// within groups of heads whose q and dO fit half the L2, as
// launch_dkv_ws's.
template <int D, bool DROP, int OP>
int launch_wide_dkv_ws(const WideTcArgs& a, cudaStream_t stream) {
  using T = WsWideTiles<D, OP>;
  if (DROP && a.seed3 == nullptr) return (int)cudaErrorInvalidValue;
  if (a.dout == nullptr || a.lse == nullptr || a.delta == nullptr ||
      a.dv == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a.sk <= 0 || a.sq <= 0) return 0;
  const int rows = T::NPL * a.bh;
  CUtensorMap tq, tk, tv, tdo;
  if constexpr (kOpRows<OP>) {
    tq = address_map(a.q);
    tk = address_map(a.k);
    tv = address_map(a.v);
    tdo = address_map(a.dout);
  } else {
    int e = bf16_tile_map(&tq, a.q, rows, a.sq, a.dp, T::BQ);
    if (!e) e = bf16_tile_map(&tdo, a.dout, rows, a.sq, a.dp, T::BQ);
    if (!e) e = bf16_tile_map(&tk, a.k, rows, a.sk, a.dp, kWideBK);
    if (!e) e = bf16_tile_map(&tv, a.v, rows, a.sk, a.dp, kWideBK);
    if (e) return e;
  }
  MdParams md{};
  md.seed3 = a.seed3;
  md.mask_hper = a.mask_hper;
  md.threshold = a.threshold;
  md.inv_keep = a.inv_keep;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_ws_kernel<D, false, false, DROP, OP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::bytes);
  if (err != cudaSuccess) return (int)err;
  const long long qdo_bytes = 4LL * T::NPL * a.sq * T::DP * a.bh;
  const long long ngroups = (qdo_bytes + kL2Half - 1) / kL2Half;
  const int group = (int)((a.bh + ngroups - 1) / ngroups);
  const long long blocks =
      (long long)a.bh * ((a.sk + kWideBK - 1) / kWideBK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_ws_kernel<D, false, false, DROP, OP>
      <<<(unsigned)blocks, kWsThreads, T::bytes, stream>>>(
      tq, tk, tv, tdo, int_map(a.d), a.lse, a.delta,
      static_cast<bf16*>(a.out), static_cast<bf16*>(a.dv), a.sq, a.sk,
      a.causal, a.off, a.valid_q, a.valid_k, a.scale_log2, a.scale,
      reinterpret_cast<const unsigned*>(a.mask), md, a.bh, group);
  return (int)cudaGetLastError();
}

// #6w's bucket D of mode OP, with or without dropout
template <int OP, int D>
int launch_wide_dkv_d(const WideTcArgs& a, cudaStream_t s) {
  return a.seed3 != nullptr ? launch_wide_dkv_ws<D, true, OP>(a, s)
                            : launch_wide_dkv_ws<D, false, OP>(a, s);
}

}  // namespace
