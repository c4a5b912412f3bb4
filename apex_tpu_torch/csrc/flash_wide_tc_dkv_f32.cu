// #6w's fp32 instances on the tensor cores (flash_wide_ws.cuh): the
// operands as three bf16 planes, every product as six bf16 products;
// head dims up to 128 (at 128 on 32-query steps).
//
// Replaces: apex_tpu/ops/attention.py :: _dkv_kernel (#6w), for these operands;
// flash_wide.cu says what bounds it.
#include "flash_wide_ws.cuh"

int wide_tc_dkv_f32(const WideTcArgs& a, cudaStream_t s) {
  // no block of three planes fits past 128
  if (a.dp > 128) return (int)cudaErrorInvalidValue;
  if (a.dp <= 64) return launch_wide_dkv_d<kOpWideF32, 64>(a, s);
  return launch_wide_dkv_d<kOpWideF32, 128>(a, s);
}
