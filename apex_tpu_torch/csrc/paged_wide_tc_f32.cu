// #7w's TMA mode for fp32 pools up to head dim 128: the instances of
// kv_decode.cuh :: paged_decode_kernel's wide operand mode kDecWideF32
// (that header says what bounds it and what the design does about it),
// in a source of their own so that nvcc builds them beside the others;
// the C entry apex_paged_wide (paged_wide.cu) launches them.
//
// Replaces: apex_tpu/ops/paged_attention.py :: _paged_kernel (#7w), for
// these pools.
#include "kv_decode.cuh"

int paged_wide_tc_f32(const PagedWideTcArgs& a, cudaStream_t s) {
  return launch_paged_wide_d<kDecWideF32>(a, s);
}
