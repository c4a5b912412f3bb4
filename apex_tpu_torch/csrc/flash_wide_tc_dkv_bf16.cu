// #6w's bf16 instances on the tensor cores (flash_wide_ws.cuh): the
// bucket 256, any head dim that is a multiple of 8 up to it (the bf16
// calls at 128 and under take flash_attention_bwd*.cu's instances,
// padded).
//
// Replaces: apex_tpu/ops/attention.py :: _dkv_kernel (#6w), for these operands;
// flash_wide.cu says what bounds it.
#include "flash_wide_ws.cuh"

int wide_tc_dkv_bf16(const WideTcArgs& a, cudaStream_t s) {
  return launch_wide_dkv_d<kOpWideBf16, 256>(a, s);
}
