// Wide flash attention for Hopper (sm_90a): fp32, bf16 and fp16 operands
// at any head dim up to 256 -- the calls the bf16 instances do not take.
//
// Replaces: apex_tpu/ops/attention.py :: _fwd_kernel (#3w, the forward),
// _dq_kernel (#5w, the split dq) and _dkv_kernel (#6w, the split dk, dv), for
// the calls the bf16 wgmma instances do not take (fp32 and fp16 operands,
// and bf16 past head dim 128).  #5w and #6w also take the one-pass
// _bwd_fused_kernel's calls: the two JAX routes compute one function.  The
// same function as those kernels: the scores in base 2 (q k^T scale
// log2(e)), the causal triangle at offset `off`, the validity window (rows
// < valid_q, columns < valid_k), the boolean mask3 (batch-head i reads mask
// i / mask_hper; True = masked), a masked score -1e30 and a fully masked
// row 0 (lse -1e30), an fp32 online softmax returning the base-2
// log-sum-exp, and dropout with the JAX package's keep mask (hopper.cuh ::
// drop_keep, the global row and column, bit for bit), survivors scaled by 1
// / (1 - rate); the row sums take the clean p.  For 16-bit operands p
// rounds to the value type before P.V and ds to the operand type before dq
// and dk, as the plain versions (ops/attention.py) round them; fp32 rounds
// nothing.
//
// Two designs, chosen by the caller through the operand code (dtype):
//
// - On the tensor cores (bf16, fp16, and fp32 handed over as planes):
//   #3w and #5w as the wide operand modes of the persistent
//   warp-specialized kernel that #3d and #5md run (flash_qmajor_ws.cuh;
//   TMA rings, ping-pong product warpgroups, the keep hash under the S
//   product), #6w as those of the key-major warp-specialized kernel that
//   #6md runs (flash_kmajor_ws.cuh; k and v resident, a TMA ring of q and
//   dO, setmaxnreg, the longest key blocks first; in the wide modes a
//   block of 64 keys whose first product warpgroup accumulates dV and
//   second dK, P^T handed from the first to the second through shared
//   memory), both launched through flash_wide_ws.cuh.  fp16 runs its
//   .f16 wgmma products at the buckets 64, 128 and 256; bf16 the bucket
//   256.  16-bit rows that TMA cannot read (d % 8 != 0, or an operand not
//   16-byte aligned) are copied into the same swizzled tiles by three
//   warps of the copying warpgroup (the operands are not padded).  fp32
//   runs as three bf16 planes an operand (x ~ x0 + x1 + x2, made by
//   wide_split_kernel below), each product as six bf16 products that keep
//   every term down to ~2^-16 of the product and drop those near 2^-24
//   and below (a0b0 + a0b1 + a1b0 + a0b2 + a1b1 + a2b0, the small ones
//   first); p and ds are split into planes in registers.  Why planes and
//   not TF32: a single TF32 product keeps ~3 decimal digits, so it would
//   not compute the fp32 function; 3xTF32 reaches about the rate of six
//   bf16 products (494 / 3 against 989 / 6 TFLOP/s) but needs 8 bytes an
//   element against 6, and .tf32 wgmma takes only K-major B operands, so
//   V (in P.V) and K (in dS.K) would need transposed copies.  What bounds
//   them: the tensor-core products (six times the 16-bit ones at fp32),
//   then the hash and the softmax on the CUDA cores beside them.
// - The CUDA-core kernels (fp32 FMAs): wide_fwd_kernel, wide_dq_kernel
//   and wide_dkv_kernel take fp32 as it is (dtype 0), which
//   ops/attention.py hands over only past head dim 128, where no tile of
//   three planes of Q (and dO) and two stages of K and V fits in shared
//   memory; they are built at the bucket 256 alone.  A block is 256
//   threads; each row of the block's tile (a query for #3w/#5w, a key for
//   #6w) is split along d over 8 adjacent lanes, 32 columns each (column
//   u + 8 i), so a d = 256 row of q, dO and the fp32 accumulators fits in
//   registers; the partial dot products meet by xor shuffles, which give
//   every lane of the row the same bits.  The other side's rows (k and v,
//   or q and dO) stream through shared memory in 32-row stages,
//   double-buffered with cp.async (element copies where a row is not
//   16-byte aligned); all rows of the block read each staged element at
//   once (a broadcast).  What bounds them: the fp32 FMA rate (67 TFLOP/s
//   on an H100 SXM), then the shared-memory reads that feed it.  The real
//   d is a run-time argument; shared-memory columns past d stay zero.
//   Causal blocks skip the tiles past their last live key (#3w, #5w) or
//   before their first live query (#6w), and run heaviest first.
//
// No atomics: #5w and #6w each write every output once, so the pair
// repeats bit for bit.
//
// Plain C interface (loaded with ctypes): each entry launches on the
// caller's stream and returns cudaGetLastError().

#include "flash_wide_ws.cuh"
#include "wide.cuh"

namespace {

constexpr int kNT = 256;     // threads a block
constexpr int kRows = 32;     // rows a shared-memory stage
constexpr int kKC = 8;       // rows a register chunk

struct FlashWide {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const unsigned char* mask;   // mask3 [nmask, sq, sk] or null
  const int* seed3;            // [seed, row_off, col_off] or null
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int bh, sq, sk, d, causal, off, vq, vk, mask_hper, threshold, vec;
  float inv_keep, scale_log2, scale;
};

// Which (row, column) elements are scored, for one batch-head.
struct Live {
  int sq, sk, vq, vk, causal, off;
  const unsigned char* mask;   // this batch-head's [sq, sk], or null
  __device__ bool row(int r) const { return r < sq && r < vq; }
  __device__ bool col(int c) const { return c < sk && c < vk; }
  __device__ bool operator()(int r, int c) const {
    return row(r) && col(c) && (!causal || r + off >= c) &&
           (!mask || !mask[(size_t)r * sk + c]);
  }
};

__device__ __forceinline__ Live make_live(const FlashWide& a, int bh) {
  return Live{a.sq, a.sk, a.vq, a.vk, a.causal, a.off,
              a.mask ? a.mask + (size_t)(bh / a.mask_hper) * a.sq * a.sk
                     : nullptr};
}

// Dropout's keep bits for one batch-head (off: every element kept).
struct Drop {
  bool on;
  uint32_t seed, roff, coff, threshold, bh;
  __device__ uint32_t row(int r) const {
    return drop_row(seed, bh, roff + (uint32_t)r);
  }
  __device__ bool keep(uint32_t row_h, int c) const {
    return drop_keep(row_h, drop_col(coff + (uint32_t)c), threshold);
  }
};

__device__ __forceinline__ Drop make_drop(const FlashWide& a, int bh) {
  if (!a.seed3) return Drop{false, 0, 0, 0, 0, 0};
  return Drop{true, (uint32_t)a.seed3[0], (uint32_t)a.seed3[1],
              (uint32_t)a.seed3[2], (uint32_t)a.threshold, (uint32_t)bh};
}

// One past the last key any row of [r0, r0 + rows) scores.
__device__ __forceinline__ int key_end(const FlashWide& a, int r0, int rows) {
  const int r1 = min(r0 + rows, min(a.sq, a.vq));
  if (r1 <= r0) return 0;
  int end = min(a.sk, a.vk);
  if (a.causal) end = min(end, r1 - 1 + a.off + 1);
  return max(end, 0);
}

// The dot product of a thread's 32 register columns with the same
// columns of a shared-memory row (`sm` at the thread's first column),
// summed over the row's TPR lanes.
template <typename T, int TPR>
__device__ __forceinline__ float row_dot(const float (&x)[32], const T* sm) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc = fmaf(x[i], to_f<T>(sm[TPR * i]), acc);
  return group_sum<TPR>(acc);
}

template <typename T, int TPR>
__device__ __forceinline__ void axpy(float (&y)[32], float a, const T* sm) {
#pragma unroll
  for (int i = 0; i < 32; ++i) y[i] = fmaf(a, to_f<T>(sm[TPR * i]), y[i]);
}

// A thread's 32 columns of global row `row` (zero past n rows or d
// columns), times `mul`.
template <typename T, int TPR>
__device__ __forceinline__ void load_cols(float (&x)[32], const T* base,
                                          int row, int n, int d, int u,
                                          float mul) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = u + TPR * i;
    x[i] = row < n && c < d ? to_f<T>(base[(size_t)row * d + c]) * mul : 0.f;
  }
}

template <typename T, int TPR>
__device__ __forceinline__ void store_cols(const float (&x)[32], T* base,
                                           int row, int n, int d, int u,
                                           float mul) {
  if (row >= n) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = u + TPR * i;
    if (c < d) base[(size_t)row * d + c] = from_f<T>(x[i] * mul);
  }
}

// the kept forward's and dq's head-dim bucket (fp32 past 128)
constexpr int kF32D = 256;

// Stage rows [j0, j0 + kRows) of two [n, d] matrices (rows >= end dead).
template <typename T, int D>
__device__ __forceinline__ void stage2(T* xs, T* ys, const T* x, const T* y,
                                       int j0, int end, int d, bool vec) {
  stage_rows<T, kNT>(xs, kRows, d, vec, D, x, [&](int j) -> const T* {
    return j0 + j < end ? x + (size_t)(j0 + j) * d : nullptr;
  });
  stage_rows<T, kNT>(ys, kRows, d, vec, D, y, [&](int j) -> const T* {
    return j0 + j < end ? y + (size_t)(j0 + j) * d : nullptr;
  });
}

// #3w at fp32 past head dim 128: one block per (batch-head, ROWS-query
// tile), tiles heaviest first.
__global__ void __launch_bounds__(kNT) wide_fwd_kernel(const FlashWide a) {
  using T = float;
  constexpr int D = kF32D, TPR = D / 32, ROWS = kNT / TPR;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);     // [2][kRows][D]
  T* vs = ks + 2 * kRows * D;               // [2][kRows][D]
  const int bh = blockIdx.y, d = a.d;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int u = threadIdx.x % TPR, row = r0 + threadIdx.x / TPR;
  const size_t qoff = (size_t)bh * a.sq * d, koff = (size_t)bh * a.sk * d;
  const T* k = static_cast<const T*>(a.k) + koff;
  const T* v = static_cast<const T*>(a.v) + koff;
  const Live live = make_live(a, bh);
  const Drop drop = make_drop(a, bh);
  zero_smem<T, kNT>(ks, 4 * kRows * D);
  float qr[32], acc[32];
  load_cols<T, TPR>(qr, static_cast<const T*>(a.q) + qoff, row, a.sq, d, u,
                    a.scale_log2);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const bool rlive = live.row(row);
  const uint32_t rh = drop.on ? drop.row(row) : 0u;
  const int kend = key_end(a, r0, ROWS);
  const int tiles = (kend + kRows - 1) / kRows;
  float m = kNegInf, l = 0.f;
  __syncthreads();                        // zeros before the copies
  if (tiles > 0) {
    stage2<T, D>(ks, vs, k, v, 0, kend, d, a.vec);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage2<T, D>(ks + (buf ^ 1) * kRows * D, vs + (buf ^ 1) * kRows * D, k, v,
                   (t + 1) * kRows, kend, d, a.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + buf * kRows * D + u;
    const T* vt = vs + buf * kRows * D + u;
#pragma unroll 1
    for (int jc = 0; jc < kRows; jc += kKC) {
      const int c0 = t * kRows + jc;
      float s[kKC];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        s[jj] = row_dot<T, TPR>(qr, kt + (jc + jj) * D);
        if (!(rlive && live(row, c0 + jj))) s[jj] = kNegInf;
        mx = fmaxf(mx, s[jj]);
      }
      const float alpha = exp2_ftz(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        const float p =
            s[jj] > kMaskedRowThresh ? exp2_ftz(s[jj] - mx) : 0.f;
        l += p;
        float pv = p;
        if (drop.on) pv = drop.keep(rh, c0 + jj) ? p * a.inv_keep : 0.f;
        axpy<T, TPR>(acc, pv, vt + (jc + jj) * D);
      }
      m = mx;
    }
    __syncthreads();                      // before the next stage lands
  }
  const float l1 = l == 0.f ? 1.f : l;
  store_cols<T, TPR>(acc, static_cast<T*>(a.o) + qoff, row, a.sq, d, u,
                     1.f / l1);
  if (row < a.sq && u == 0)
    a.lse_out[(size_t)bh * a.sq + row] = m + log2f(l1);
}

// #5w at fp32 past head dim 128: one block per (batch-head, ROWS-query
// tile); dq from the base-2 lse and delta = rowsum(o * dO), written once.
__global__ void __launch_bounds__(kNT) wide_dq_kernel(const FlashWide a) {
  using T = float;
  constexpr int D = kF32D, TPR = D / 32, ROWS = kNT / TPR;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);     // [2][kRows][D]
  T* vs = ks + 2 * kRows * D;               // [2][kRows][D]
  const int bh = blockIdx.y, d = a.d;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int u = threadIdx.x % TPR, row = r0 + threadIdx.x / TPR;
  const size_t qoff = (size_t)bh * a.sq * d, koff = (size_t)bh * a.sk * d;
  const T* k = static_cast<const T*>(a.k) + koff;
  const T* v = static_cast<const T*>(a.v) + koff;
  const Live live = make_live(a, bh);
  const Drop drop = make_drop(a, bh);
  zero_smem<T, kNT>(ks, 4 * kRows * D);
  float qr[32], dor[32], dqa[32];
  load_cols<T, TPR>(qr, static_cast<const T*>(a.q) + qoff, row, a.sq, d, u,
                    a.scale_log2);
  load_cols<T, TPR>(dor, static_cast<const T*>(a.dout) + qoff, row, a.sq, d,
                    u, 1.f);
#pragma unroll
  for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
  const float lse = row < a.sq ? a.lse[(size_t)bh * a.sq + row] : kNegInf;
  const float delta = row < a.sq ? a.delta[(size_t)bh * a.sq + row] : 0.f;
  const bool rlive = live.row(row) && lse > kMaskedRowThresh;
  const uint32_t rh = drop.on ? drop.row(row) : 0u;
  const int kend = key_end(a, r0, ROWS);
  const int tiles = (kend + kRows - 1) / kRows;
  __syncthreads();
  if (tiles > 0) {
    stage2<T, D>(ks, vs, k, v, 0, kend, d, a.vec);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage2<T, D>(ks + (buf ^ 1) * kRows * D, vs + (buf ^ 1) * kRows * D, k, v,
                   (t + 1) * kRows, kend, d, a.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + buf * kRows * D + u;
    const T* vt = vs + buf * kRows * D + u;
#pragma unroll 1
    for (int jc = 0; jc < kRows; jc += kKC) {
      const int c0 = t * kRows + jc;
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        const float s = row_dot<T, TPR>(qr, kt + (jc + jj) * D);
        float g = row_dot<T, TPR>(dor, vt + (jc + jj) * D);
        const int c = c0 + jj;
        const float p = rlive && live(row, c) ? exp2_ftz(s - lse) : 0.f;
        if (drop.on) g = drop.keep(rh, c) ? g * a.inv_keep : 0.f;
        const float ds = p * (g - delta);
        axpy<T, TPR>(dqa, ds, kt + (jc + jj) * D);
      }
    }
    __syncthreads();
  }
  store_cols<T, TPR>(dqa, static_cast<T*>(a.dq) + qoff, row, a.sq, d, u,
                     a.scale);
}

// #6w at fp32 past head dim 128: one block per (batch-head, ROWS-key
// tile), key tiles with the most live queries first; dk and dv written
// once.
__global__ void __launch_bounds__(kNT) wide_dkv_kernel(const FlashWide a) {
  using T = float;
  constexpr int D = kF32D, TPR = D / 32, ROWS = kNT / TPR;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);     // [2][kRows][D]
  T* dos = qs + 2 * kRows * D;              // [2][kRows][D]
  float* ls = reinterpret_cast<float*>(dos + 2 * kRows * D);   // [2][kRows]
  float* des = ls + 2 * kRows;                                  // [2][kRows]
  const int bh = blockIdx.y, d = a.d;
  const int k0 = blockIdx.x * ROWS;
  const int u = threadIdx.x % TPR, key = k0 + threadIdx.x / TPR;
  const size_t qoff = (size_t)bh * a.sq * d, koff = (size_t)bh * a.sk * d;
  const T* q = static_cast<const T*>(a.q) + qoff;
  const T* dout = static_cast<const T*>(a.dout) + qoff;
  const float* lse = a.lse + (size_t)bh * a.sq;
  const float* delta = a.delta + (size_t)bh * a.sq;
  const Live live = make_live(a, bh);
  const Drop drop = make_drop(a, bh);
  zero_smem<T, kNT>(qs, 4 * kRows * D);
  float kr[32], vr[32], dka[32], dva[32];
  load_cols<T, TPR>(kr, static_cast<const T*>(a.k) + koff, key, a.sk, d, u,
                    a.scale_log2);
  load_cols<T, TPR>(vr, static_cast<const T*>(a.v) + koff, key, a.sk, d, u,
                    1.f);
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  const bool klive = live.col(key);
  // the live queries of the block's keys: [rbeg, rend)
  const int rend = k0 < min(a.sk, a.vk) ? min(a.sq, a.vq) : 0;
  const int rbeg = a.causal ? min(max(k0 - a.off, 0), rend) : 0;
  const int tiles = (rend - rbeg + kRows - 1) / kRows;
  __syncthreads();
  auto stage = [&](int t, int buf) {
    const int j0 = rbeg + t * kRows;
    stage2<T, D>(qs + buf * kRows * D, dos + buf * kRows * D, q, dout, j0, rend,
                 d, a.vec);
    if (threadIdx.x < 2 * kRows) {
      const int j = threadIdx.x % kRows;
      const float* src = threadIdx.x < kRows ? lse : delta;
      float* dst = (threadIdx.x < kRows ? ls : des) + buf * kRows + j;
      const bool in = j0 + j < rend;
      cp_async4z(smem_addr(dst), in ? src + j0 + j : src, in);
    }
    cp_async_commit();
  };
  if (tiles > 0) stage(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qt = qs + buf * kRows * D + u;
    const T* dot = dos + buf * kRows * D + u;
    const int j0 = rbeg + t * kRows;
#pragma unroll 1
    for (int jc = 0; jc < kRows; jc += kKC) {
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        const int j = jc + jj, r = j0 + j;
        const float s = row_dot<T, TPR>(kr, qt + j * D);
        float g = row_dot<T, TPR>(vr, dot + j * D);
        const float lr = ls[buf * kRows + j];
        const bool lv = klive && r < rend && lr > kMaskedRowThresh &&
                        live(r, key);
        const float p = lv ? exp2_ftz(s - lr) : 0.f;
        float pv = p;
        if (drop.on) {
          const bool kept = drop.keep(drop.row(r), key);
          pv = kept ? p * a.inv_keep : 0.f;
          g = kept ? g * a.inv_keep : 0.f;
        }
        const float ds = p * (g - des[buf * kRows + j]);
        axpy<T, TPR>(dva, pv, dot + j * D);
        axpy<T, TPR>(dka, ds, qt + j * D);
      }
    }
    __syncthreads();
  }
  store_cols<T, TPR>(dka, static_cast<T*>(a.dk) + koff, key, a.sk, d, u,
                     a.scale);
  store_cols<T, TPR>(dva, static_cast<T*>(a.dv) + koff, key, a.sk, d, u, 1.f);
}

enum Kind { kFwd, kDq, kDkv };

// whether cp.async may copy the operands' rows 16 bytes at a time
bool vec_rows(const FlashWide& a) {
  return (size_t)a.d * sizeof(float) % 16 == 0 &&
         !(((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
            (uintptr_t)a.dout) % 16);
}

// #3w, #5w or #6w on fp32 operands as they are (the CUDA-core kernels)
int launch_f32(Kind kind, FlashWide a, cudaStream_t stream) {
  constexpr int ROWS = kNT / (kF32D / 32);
  const size_t bytes = 4 * kRows * kF32D * sizeof(float) +
                       (kind == kDkv ? 4 * kRows * sizeof(float) : 0);
  const dim3 grid(((kind == kDkv ? a.sk : a.sq) + ROWS - 1) / ROWS, a.bh);
  a.vec = vec_rows(a);
  static std::atomic<unsigned> fwd_allowed{0}, dq_allowed{0},
      dkv_allowed{0};
  int e;
  if (kind == kFwd) {
    e = allow_wide_smem(wide_fwd_kernel, bytes, fwd_allowed);
    if (!e) wide_fwd_kernel<<<grid, kNT, bytes, stream>>>(a);
  } else if (kind == kDq) {
    e = allow_wide_smem(wide_dq_kernel, bytes, dq_allowed);
    if (!e) wide_dq_kernel<<<grid, kNT, bytes, stream>>>(a);
  } else {
    e = allow_wide_smem(wide_dkv_kernel, bytes, dkv_allowed);
    if (!e) wide_dkv_kernel<<<grid, kNT, bytes, stream>>>(a);
  }
  return e ? e : (int)cudaGetLastError();
}

// The operand code of fp32 operands handed over as three bf16 planes each
// ([3, bh, s, dp], dp = d rounded up to 8: apex_flash_wide_split).
constexpr int kF32Planes = 3;

// #3w, #5w or #6w on the tensor cores: 16-bit operands, or fp32 as
// planes.
int tensor_cores(Kind kind, const FlashWide& a, int dtype, cudaStream_t s) {
  WideTcArgs t{};
  t.q = a.q; t.k = a.k; t.v = a.v; t.dout = a.dout;
  t.lse = a.lse; t.delta = a.delta;
  t.mask = a.mask; t.seed3 = a.seed3;
  t.out = kind == kFwd ? a.o : kind == kDq ? a.dq : a.dk;
  t.dv = a.dv;
  t.lse_out = a.lse_out;
  t.bh = a.bh; t.sq = a.sq; t.sk = a.sk; t.d = a.d;
  t.dp = dtype == kF32Planes ? (a.d + 7) / 8 * 8 : a.d;
  t.causal = a.causal; t.off = a.off; t.valid_q = a.vq; t.valid_k = a.vk;
  t.mask_hper = a.mask ? a.mask_hper : 1;
  t.threshold = (unsigned)a.threshold; t.inv_keep = a.inv_keep;
  t.scale_log2 = a.scale_log2; t.scale = a.scale;
  const bool dq = kind == kDq, dkv = kind == kDkv;
  // TMA reads rows that are 16-byte multiples from 16-byte aligned
  // operands (the forward's dout is q)
  const bool tma = t.dp % 8 == 0 &&
                   !(((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                      (uintptr_t)a.dout) % 16);
  switch (dtype) {
    case kF32Planes:
      if (!tma) return (int)cudaErrorInvalidValue;
      if (dkv) return wide_tc_dkv_f32(t, s);
      return dq ? wide_tc_f32_dq(t, s) : wide_tc_f32_fwd(t, s);
    case kBF16:
      if (dkv)
        return tma ? wide_tc_dkv_bf16(t, s) : wide_tc_dkv_rows(t, false, s);
      if (tma) return wide_tc_bf16(t, dq, s);
      return dq ? wide_tc_rows_dq(t, false, s) : wide_tc_rows_fwd(t, false, s);
    default:
      if (dkv)
        return tma ? wide_tc_dkv_f16(t, s) : wide_tc_dkv_rows(t, true, s);
      if (tma) return dq ? wide_tc_f16_dq(t, s) : wide_tc_f16_fwd(t, s);
      return dq ? wide_tc_rows_dq(t, true, s) : wide_tc_rows_fwd(t, true, s);
  }
}

int run(Kind kind, FlashWide a, int dtype, void* stream) {
  cudaGetLastError();
  if (a.bh <= 0 || a.sq <= 0 || a.sk <= 0) return 0;
  if (a.d < 1 || a.d > 256 || a.bh > 65535 || (a.mask && a.mask_hper < 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_f32(kind, a, s);
    case kBF16: case kF16: case kF32Planes:
      return tensor_cores(kind, a, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x [rows, d] fp32 into its bf16 planes [3, rows, dp] (hopper.cuh split3;
// columns d..dp zero), eight columns a thread: the fp32 operands of the
// tensor-core route.  Bound by bytes: 4 read and 6 written an element.
__global__ void __launch_bounds__(256) wide_split_kernel(
    const float* __restrict__ x, bf16* __restrict__ planes, long long rows,
    int d, int dp) {
  const int groups = dp / 8;
  const long long n = rows * groups, plane = rows * dp;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const long long r = i / groups;
    const int c0 = (int)(i - r * groups) * 8;
    unsigned w[3][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};
      const int c = c0 + 2 * k;
      if (c < d) split3(x[r * d + c], lo);
      if (c + 1 < d) split3(x[r * d + c + 1], hi);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) w[pl][k] = pack_bf16(lo[pl], hi[pl]);
    }
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      *reinterpret_cast<uint4*>(planes + pl * plane + r * dp + c0) =
          make_uint4(w[pl][0], w[pl][1], w[pl][2], w[pl][3]);
  }
}

}  // namespace

// q [bh, sq, d], k/v [bh, sk, d] contiguous, all of one type (dtype: 0
// fp32, run on the CUDA cores; 1 bf16, 2 fp16; 3 fp32 as three bf16
// planes, each operand [3, bh, s, dp] from apex_flash_wide_split, 16-byte
// aligned, d <= 128: the tensor cores), 1 <= d <= 256; mask3 [bh /
// mask_hper, sq, sk] bool or null; seed3 [seed, row_off, col_off] int32 on the device or
// null (no dropout; else threshold = round(rate 2^24), inv_keep = 1 /
// (1 - rate)); o [bh, sq, d] of the operands' type, lse [bh, sq] fp32
// (base 2).
extern "C" int apex_flash_wide_fwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* seed3, void* o, void* lse, int bh, int sq, int sk, int d,
    int causal, int off, int valid_q, int valid_k, int mask_hper,
    int threshold, float inv_keep, float scale_log2, int dtype,
    void* stream) {
  FlashWide a{};
  a.q = q; a.k = k; a.v = v; a.dout = q;
  a.mask = static_cast<const unsigned char*>(mask);
  a.seed3 = static_cast<const int*>(seed3);
  a.o = o; a.lse_out = static_cast<float*>(lse);
  a.bh = bh; a.sq = sq; a.sk = sk; a.d = d; a.causal = causal; a.off = off;
  a.vq = valid_q; a.vk = valid_k; a.mask_hper = mask_hper;
  a.threshold = threshold; a.inv_keep = inv_keep; a.scale_log2 = scale_log2;
  return run(kFwd, a, dtype, stream);
}

// The backward's two kernels over the forward's operands, dout [bh, sq, d]
// (the operands' type), the base-2 lse and delta = rowsum(o * dout), both
// [bh, sq] fp32; dq [bh, sq, d] (apex_flash_wide_dq), dk and dv [bh, sk, d]
// (apex_flash_wide_dkv), of the operands' type.  scale is the softmax
// scale, scale_log2 = scale log2(e).  dtype as apex_flash_wide_fwd's.
extern "C" int apex_flash_wide_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask, const void* seed3,
    void* dq, int bh, int sq, int sk, int d, int causal, int off,
    int valid_q, int valid_k, int mask_hper, int threshold, float inv_keep,
    float scale_log2, float scale, int dtype, void* stream) {
  FlashWide a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.mask = static_cast<const unsigned char*>(mask);
  a.seed3 = static_cast<const int*>(seed3);
  a.dq = dq;
  a.bh = bh; a.sq = sq; a.sk = sk; a.d = d; a.causal = causal; a.off = off;
  a.vq = valid_q; a.vk = valid_k; a.mask_hper = mask_hper;
  a.threshold = threshold; a.inv_keep = inv_keep; a.scale_log2 = scale_log2;
  a.scale = scale;
  return run(kDq, a, dtype, stream);
}

extern "C" int apex_flash_wide_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask, const void* seed3,
    void* dk, void* dv, int bh, int sq, int sk, int d, int causal, int off,
    int valid_q, int valid_k, int mask_hper, int threshold, float inv_keep,
    float scale_log2, float scale, int dtype, void* stream) {
  FlashWide a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.mask = static_cast<const unsigned char*>(mask);
  a.seed3 = static_cast<const int*>(seed3);
  a.dk = dk; a.dv = dv;
  a.bh = bh; a.sq = sq; a.sk = sk; a.d = d; a.causal = causal; a.off = off;
  a.vq = valid_q; a.vk = valid_k; a.mask_hper = mask_hper;
  a.threshold = threshold; a.inv_keep = inv_keep; a.scale_log2 = scale_log2;
  a.scale = scale;
  return run(kDkv, a, dtype, stream);
}

// x [rows, d] fp32 contiguous into planes [3, rows, dp] bf16 (dp = d
// rounded up to 8, 16-byte aligned): the three bf16 planes of every
// element, the padding columns zero.
extern "C" int apex_flash_wide_split(const void* x, void* planes,
                                     long long rows, int d, void* stream) {
  cudaGetLastError();
  if (rows <= 0) return 0;
  if (d < 1 || d > 256 || (uintptr_t)planes % 16)
    return (int)cudaErrorInvalidValue;
  const int dp = (d + 7) / 8 * 8;
  const long long n = rows * (dp / 8);
  const long long blocks = (n + 255) / 256;
  wide_split_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<bf16*>(planes), rows, d, dp);
  return (int)cudaGetLastError();
}
