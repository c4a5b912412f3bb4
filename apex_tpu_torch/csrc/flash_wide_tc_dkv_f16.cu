// #6w's fp16 instances on the tensor cores (flash_wide_ws.cuh), in a
// source of their own so that nvcc builds them beside the others.
//
// Replaces: apex_tpu/ops/attention.py :: _dkv_kernel (#6w), for these operands;
// flash_wide.cu says what bounds it.
#include "flash_wide_ws.cuh"

int wide_tc_dkv_f16(const WideTcArgs& a, cudaStream_t s) {
  if (a.dp <= 64) return launch_wide_dkv_d<kOpWideF16, 64>(a, s);
  if (a.dp <= 128) return launch_wide_dkv_d<kOpWideF16, 128>(a, s);
  return launch_wide_dkv_d<kOpWideF16, 256>(a, s);
}
