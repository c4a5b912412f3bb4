// #6w's 16-bit instances on the tensor cores for rows TMA cannot read (d
// % 8 != 0, or operands not 16-byte aligned): the row-copying modes of
// flash_wide_ws.cuh, in a source of their own so that nvcc builds them
// beside the others.
//
// Replaces: apex_tpu/ops/attention.py :: _dkv_kernel (#6w), for these operands;
// flash_wide.cu says what bounds it.
#include "flash_wide_ws.cuh"

int wide_tc_dkv_rows(const WideTcArgs& a, bool f16, cudaStream_t s) {
  if (!f16) return launch_wide_dkv_d<kOpWideBf16Rows, 256>(a, s);
  if (a.dp <= 64) return launch_wide_dkv_d<kOpWideF16Rows, 64>(a, s);
  if (a.dp <= 128) return launch_wide_dkv_d<kOpWideF16Rows, 128>(a, s);
  return launch_wide_dkv_d<kOpWideF16Rows, 256>(a, s);
}
