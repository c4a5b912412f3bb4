// Device and host pieces shared by the fused decode block's two kernels:
// fused_block_kernel (csrc/fused_block_decode.cu, the whole layer, #8 and
// #8g) and fused_block_partial_kernel (csrc/fused_block_partial.cu, a
// tensor-parallel rank's attention half, V6): warp reductions, bf16
// unpacking, the GEMV's normalised activations (BuildNorm), the
// transposed fragment load and the m16n8k16 product the GEMV runs on,
// the global timer of the phase clocks and the weights' tensor-map cache.

#pragma once

#include <mutex>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h2[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// the box at (column c, row r) of a 2-d tensor map into shared memory at
// dst, completing `bar`'s transactions
__device__ __forceinline__ void tma_load2(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// The GEMV's activations, four consecutive inputs k .. k + 3 of one slot
// at a time (k a multiple of 4; K is a multiple of 8).

__device__ __forceinline__ float4 bf16x4(uint2 raw) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// A = bf16(v * r[slot] * w[k]) with v from the bf16 x or the fp32 x2:
// the normalised activations the q/k/v and gate/up products read.  GPT:
// A = bf16((v - mu[slot]) * r[slot] * w[k] + b[k]), w and b fp32.
template <bool GPT>
struct BuildNorm {
  const bf16* xb;
  const float* xf;
  const float* r;
  const void* w;
  int ln_fp32, hidden, slots;
  const float* mu;
  const float* b;
  __device__ void prepare(int, int, int) const {}
  __device__ float4 operator()(int slot, int k) const {
    const size_t i = (size_t)slot * hidden + k;
    const float4 v =
        xb ? bf16x4(__ldg(reinterpret_cast<const uint2*>(xb + i)))
           : __ldcg(reinterpret_cast<const float4*>(xf + i));
    if constexpr (GPT) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(w) + k / 4);
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(b) + k / 4);
      const float rs = r[slot], m = mu[slot];
      return make_float4(bf16_round((v.x - m) * rs * w4.x + b4.x),
                         bf16_round((v.y - m) * rs * w4.y + b4.y),
                         bf16_round((v.z - m) * rs * w4.z + b4.z),
                         bf16_round((v.w - m) * rs * w4.w + b4.w));
    }
    const float4 w4 =
        ln_fp32 ? __ldg(reinterpret_cast<const float4*>(w) + k / 4)
                : bf16x4(__ldg(reinterpret_cast<const uint2*>(
                      static_cast<const bf16*>(w) + k)));
    const float rs = r[slot];
    return make_float4(bf16_round(v.x * rs * w4.x), bf16_round(v.y * rs * w4.y),
                       bf16_round(v.z * rs * w4.z), bf16_round(v.w * rs * w4.w));
  }
};

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 sums (tensor cores)
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The tensor map of a bf16 [K, n] row-major weight for TMA boxes of
// `rows` rows x 64 columns in the 128-byte swizzle, encoded once per
// (address, shape, box): a decode step asks for the same maps of every
// layer on every step, and the step is bound by host time.
struct WeightKey {
  const void* w;
  int K, n, rows;
};
constexpr int kWeightMaps = 1024;
std::mutex g_wmap_mu;
WeightKey g_wmap_key[kWeightMaps];
CUtensorMap g_wmap[kWeightMaps];
int g_wmap_used = 0, g_wmap_next = 0;

int weight_map(CUtensorMap* map, const void* w, int K, int n, int rows) {
  std::lock_guard<std::mutex> lock(g_wmap_mu);
  for (int i = 0; i < g_wmap_used; ++i)
    if (g_wmap_key[i].w == w && g_wmap_key[i].K == K && g_wmap_key[i].n == n &&
        g_wmap_key[i].rows == rows) {
      *map = g_wmap[i];
      return 0;
    }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<void*>(w), dims, strides, box, one,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  g_wmap_key[g_wmap_next] = WeightKey{w, K, n, rows};
  g_wmap[g_wmap_next] = *map;
  g_wmap_next = (g_wmap_next + 1) % kWeightMaps;
  if (g_wmap_used < kWeightMaps) ++g_wmap_used;
  return 0;
}

}  // namespace
