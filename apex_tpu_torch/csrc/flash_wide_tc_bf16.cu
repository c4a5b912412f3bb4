// #3w's and #5w's bf16 instances on the tensor cores (flash_wide_ws.cuh):
// the bucket 256, any head dim that is a multiple of 8 up to it (the bf16
// calls at 128 and under take flash_attention*.cu's instances, padded).
//
// Replaces: apex_tpu/ops/attention.py :: _fwd_kernel (#3w) and _dq_kernel (#5w), for these operands;
// flash_wide.cu says what bounds it.
#include "flash_wide_ws.cuh"

int wide_tc_bf16(const WideTcArgs& a, bool dq, cudaStream_t s) {
  return dq ? launch_wide_d<kOpWideBf16, true, 256>(a, s)
            : launch_wide_d<kOpWideBf16, false, 256>(a, s);
}
