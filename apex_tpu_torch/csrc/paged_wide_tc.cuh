// The wide paged decode's (#7w's) TMA modes: the launch arguments and the
// instance sources' launches, shared by csrc/paged_wide.cu (the C entry,
// which takes these modes where the wrapper asks for them) and the
// instance sources csrc/paged_wide_tc_{bf16,f16,f32}.cu, which launch
// kv_decode.cuh :: paged_decode_kernel's wide operand modes and meet
// paged_wide.cu through the functions declared below (nvcc builds them
// beside one another).

#pragma once

#include <cuda_runtime.h>

// One launch: q [slots, h, d] and out of q's type (q_dtype: 0 fp32, 1
// bf16, 2 fp16); k/v pages [pages, kvh, ps, d] of the pool's type with
// rows and heads contiguous and page stride `page_stride` elements (the
// rows and the page stride multiples of 16 bytes, the bases 16-byte
// aligned); ps a multiple of 8; `rows` query rows a block (an instance's
// bucket), the group run as ceil(group / rows) row chunks; q_planes 1
// (q of the pool's type) or 2 (q as hi + lo of it); the splits and the
// scratch as apex_paged_wide's.
struct PagedWideTcArgs {
  const void *q, *k, *v;
  const int *pt, *lengths;
  void* out;
  float *part_acc, *part_ml;
  int* counters;
  long long pages, page_stride;
  int slots, kvh, group, ps, d, mpps, nsplit, pps, q_dtype, q_planes, rows;
  float scale_log2;
};

// the instance sources' launches, each picking its head-dim bucket and
// row bucket (rows); cudaErrorInvalidValue for a shape none takes
int paged_wide_tc_bf16(const PagedWideTcArgs& a, cudaStream_t s);
int paged_wide_tc_f16(const PagedWideTcArgs& a, cudaStream_t s);
int paged_wide_tc_f32(const PagedWideTcArgs& a, cudaStream_t s);
