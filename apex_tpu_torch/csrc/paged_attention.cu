// Ragged paged decode attention for Hopper (sm_90a), bf16 in, fp32 math.
//
// Replaces: apex_tpu/ops/paged_attention.py :: _paged_kernel (launched
// by _paged_kernel_call through pl.pallas_call).  Same function: one
// query token per slot attends to the slot's live tokens, which live in
// fixed-size pages of a shared pool reached through the slot's row of
// the page table; grouped-query scoring per kv head (the `group = h /
// kvh` query rows of a kv head score its k rows once, no broadcast); an
// fp32 online softmax in base 2 with an fp32 accumulator, p rounded to
// bf16 for the P.V product as the TPU kernel feeds its MXU, the
// normalizer summed from the fp32 p; a slot of length 0 emits zeros; a
// length past the window scores the whole window.
//
// Translation: the TPU kernel gets the page table and lengths as scalar
// prefetch and walks a sequential (slots, pages) grid carrying the
// softmax state in VMEM.  Blocks here run in parallel, so the work is
// split flash-decoding style: one block per (split, kv head, slot), a
// split being a fixed run of whole pages of the slot's window (sized on
// the host from the window, the slot and head counts and the SM count;
// never from the lengths, which live on the device).  A block reads the
// slot's length itself; a split with no live token returns at once.
// With one live split the block writes the output; otherwise every live
// block writes its partial (m, l, acc) and the last of them to finish
// (a device counter per (slot, kv head), which that block resets)
// merges the partials in split order, so the output repeats bit for
// bit.  The k/v operands are one layer's STRIDED view of the [pages,
// layers, kv_heads, page_size, head_dim] pool, read in place through
// 4-d tensor maps (columns, rows, kv heads, pages) with the page stride.
//
// What bounds it on the H100: bytes.  Each live token's k and v rows
// are read once (2 * head_dim * 2 bytes per kv head per layer) and
// scored with ~4 * group * head_dim flops.  So the design keeps whole
// pages in flight and spends as few instructions per byte as it can:
// - one thread of a producer warp issues one TMA box per 64 columns of
//   a page of k and of v (one page-table read per page) into a ring of
//   stages guarded by full/empty mbarriers; the boxes land in the
//   128-byte swizzle, so the fragment loads below hit every bank once;
// - eight consumer warps share each page (a 16-token tile each, or a
//   page each where a page is one tile), groups of them taking pages in
//   turn; each warp keeps its own online-softmax state: no block
//   barrier until the end;
// - the products run on the tensor cores with the tokens on the M side
//   and the kv head's <= 8 query rows as an n = 8 operand (zero rows
//   past the group): S^T = K Q^T (k from ldmatrix, q in registers for
//   the whole block), then O^T = V^T P^T (v from ldmatrix.trans, p from
//   the scores' accumulator by one movmatrix.trans per 8 x 8 block);
// - the warps' states merge once, through shared memory.
//
// The kernel template, its shared-memory layout and the tensor-map cache
// live in csrc/kv_decode.cuh, shared with the dense cache's decode.
//
// Plain C interface (loaded with ctypes): apex_paged_decode_attention
// launches on the caller's stream and returns cudaGetLastError().

#include "kv_decode.cuh"

namespace {

struct Args {
  const void *q, *k, *v, *pt, *lengths;
  void *out, *part_acc, *part_ml, *counters;
  int slots, kvh, mpps, nsplit, pps;
  long long pages, page_stride;
  float scale_log2;
  cudaStream_t stream;
};

template <int G, int D, int PS>
int launch(const Args& a) {
  using S = PagedSmem<D, PS>;
  if (a.nsplit > S::kMaxSplits) return (int)cudaErrorInvalidValue;
  CUtensorMap km, vm;
  int e = cached_kv_map(&km, a.k, D, PS, a.kvh, a.pages, (long long)PS * D,
                        a.page_stride, PS);
  if (!e) e = cached_kv_map(&vm, a.v, D, PS, a.kvh, a.pages,
                            (long long)PS * D, a.page_stride, PS);
  if (e) return e;
  static std::atomic<unsigned> allowed{0};
  e = allow_smem(paged_decode_kernel<G, D, PS>, S::bytes, allowed);
  if (e) return e;
  const dim3 grid(a.nsplit, a.kvh, a.slots);
  paged_decode_kernel<G, D, PS><<<grid, kThreads, S::bytes, a.stream>>>(
      km, vm, static_cast<const bf16*>(a.q), static_cast<const int*>(a.pt),
      static_cast<const int*>(a.lengths), static_cast<bf16*>(a.out),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
      static_cast<int*>(a.counters), a.kvh, a.mpps, a.pps, a.mpps * PS,
      a.scale_log2);
  return (int)cudaGetLastError();
}

template <int D, int PS>
int launch_g(int group, const Args& a) {
  switch (group) {
    case 1: return launch<1, D, PS>(a);
    case 2: return launch<2, D, PS>(a);
    case 4: return launch<4, D, PS>(a);
    case 8: return launch<8, D, PS>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_ps(int group, int ps, const Args& a) {
  switch (ps) {
    case 16: return launch_g<D, 16>(group, a);
    case 32: return launch_g<D, 32>(group, a);
    case 64: return launch_g<D, 64>(group, a);
    case 128: return launch_g<D, 128>(group, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [slots, h, d] contiguous bf16; k/v pages [pages, kvh, ps, d] bf16
// with rows and heads contiguous (head stride ps * d) and page stride
// `page_stride` elements (a multiple of 8, 16-byte aligned bases);
// page_table [slots, mpps] and lengths [slots] int32; out [slots, h, d]
// bf16.  The window runs as nsplit splits of `pages_per_split` pages
// (nsplit = ceil(mpps / pages_per_split)); with nsplit > 1, part_acc
// [slots * h, nsplit, d] and part_ml [slots * h, nsplit, 2] are fp32
// scratch and counters [slots * kvh] int32, zero before the launch, is
// left zero by it; nsplit is at most 256.  group = h / kvh must be 1,
// 2, 4 or 8, d 64 or 128, ps 16, 32, 64 or 128.
extern "C" int apex_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_acc,
    void* part_ml, void* counters, int slots, int h, int kvh, int ps, int d,
    int mpps, long long pages, long long page_stride, int nsplit,
    int pages_per_split, float scale_log2, void* stream) {
  cudaGetLastError();
  if (slots <= 0) return 0;
  if (kvh <= 0 || h % kvh || slots > 65535 || kvh > 65535 || mpps <= 0 ||
      pages <= 0 || pages_per_split <= 0 || nsplit < 1 ||
      (long long)nsplit * pages_per_split < mpps ||
      (long long)(nsplit - 1) * pages_per_split >= mpps ||
      (nsplit > 1 && (!part_acc || !part_ml || !counters)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, page_table, lengths, out, part_acc,
               part_ml, counters, slots, kvh, mpps, nsplit, pages_per_split,
               pages, page_stride, scale_log2,
               static_cast<cudaStream_t>(stream)};
  const int group = h / kvh;
  switch (d) {
    case 64: return launch_ps<64>(group, ps, a);
    case 128: return launch_ps<128>(group, ps, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
