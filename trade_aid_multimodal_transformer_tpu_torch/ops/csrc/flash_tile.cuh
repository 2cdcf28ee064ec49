// Shared pieces of the blockwise (flash) causal attention kernels for long T
// (T % 128 == 0, T >= 256, hs <= 256): tile layouts in shared memory, tile
// loads, block-wide products over tiles held there, warp reductions, and the
// dropout hash keyed on the JAX kernels' block grid.
//
// A tile is R rows (64, 32 or 16: the largest whose layout fits the shared
// memory of a block) of a (T, hs) row. Operands live in shared memory in the
// input type, products accumulate in f32: for bf16 on the tensor cores (WMMA
// 16x16x16), with hs padded with zeros to a multiple of 16; for f32 on FMAs,
// with odd row strides so that a product reading by column finds no bank
// conflict. R divides the JAX block (a multiple of 128), so a tile never
// straddles two of its dropout blocks.
#pragma once

#include <initializer_list>
#include <type_traits>

#include "attention_tile.cuh"

namespace tat {
namespace flash {

constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block may use (227 KB)

__host__ __device__ inline size_t up128(size_t b) { return (b + 127) & ~(size_t)127; }

template <typename T>
struct Lay;

template <>
struct Lay<__nv_bfloat16> {
  static __host__ __device__ int hsp(int hs) { return (hs + 15) / 16 * 16; }
  static __host__ __device__ int ldh(int hs) { return hsp(hs) + 8; }
  static __host__ __device__ int ldp(int R) { return R + 8; }
};

template <>
struct Lay<float> {
  static __host__ __device__ int hsp(int hs) { return hs; }
  static __host__ __device__ int ldh(int hs) { return hs | 1; }
  static __host__ __device__ int ldp(int R) { return R + 4; }
};

// Strides of the f32 score tiles (R x R) and accumulators (R x hsp).
__host__ __device__ inline int lds_of(int R) { return R + 4; }
__host__ __device__ inline int lda_of(int hsp) { return hsp + 4; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Dropout keep bit of score (row, col) of collapsed row n, as the JAX flash
// kernels draw it in interpret mode (pallas_attention.py _keep_mask ->
// hash_keep_mask): keyed by (seed, n, iq, jk) with iq = row / blk and
// jk = col / blk on the JAX block grid, and (r, c) = (row % blk, col % blk)
// inside the block. u32 arithmetic wraps as there.
__device__ __forceinline__ bool keep(uint32_t seed, uint32_t n, uint32_t blk, uint32_t row,
                                     uint32_t col, uint32_t thresh) {
  const uint32_t iq = row / blk, jk = col / blk;
  const uint32_t x = (seed * 2654435761u) ^ (n * 40503u) ^ (iq * 1000003u) ^ (jk * 97u);
  uint32_t h = (row - iq * blk) * 2246822519u + (col - jk * blk) * 3266489917u + x;
  h ^= h >> 13;
  h *= 2654435761u;
  h ^= h >> 16;
  return h >= thresh;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// R rows of hs elements from src (the tile's first row) into dst (stride ld),
// columns hs..hsp-1 zeroed. ``vec``: bf16 rows of a multiple of 8 elements on
// 16-byte boundaries, copied 16 bytes a thread. The caller synchronises.
template <typename T>
__device__ void load_tile(const T* __restrict__ src, int R, int hs, int hsp, T* dst, int ld,
                          bool vec) {
  if (sizeof(T) == 2 && vec) {
    const int per_row = hs >> 3;
    for (int idx = threadIdx.x; idx < R * per_row; idx += kThreads) {
      const int i = idx / per_row, c = idx - i * per_row;
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(src + (size_t)i * hs) + c);
      *reinterpret_cast<uint4*>(dst + i * ld + c * 8) = w;
    }
  } else {
    for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
      const int i = idx / hs;
      dst[i * ld + idx - i * hs] = src[idx];
    }
  }
  if (hsp > hs) {
    const int pad = hsp - hs;
    for (int idx = threadIdx.x; idx < R * pad; idx += kThreads) {
      const int i = idx / pad;
      dst[i * ld + hs + idx - i * pad] = from_f32<T>(0.f);
    }
  }
}

// C (M x N, f32, stride ldc) = [C +] op(A) (M x K) . op(B) (K x N). op(A) is
// A, stored row-major (stride lda), or with AT its transpose stored row-major;
// op(B) likewise with BT. M, N, K are multiples of 16. Ends with a barrier.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  template <bool AT, bool BT>
  static __device__ void run(const __nv_bfloat16* a, int lda, const __nv_bfloat16* b, int ldb,
                             float* c, int ldc, int M, int N, int K, bool accumulate) {
    using namespace nvcuda;
    using LA = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
    const int tn = N / 16, tiles = (M / 16) * tn, warp = threadIdx.x / 32;
    for (int tile = warp; tile < tiles; tile += kWarps) {
      const int tr = tile / tn, tc = tile - tr * tn;
      float* cp = c + tr * 16 * ldc + tc * 16;
      Frag acc;
      if (accumulate)
        wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb;
        wmma::load_matrix_sync(fa, AT ? a + kk * lda + tr * 16 : a + tr * 16 * lda + kk, lda);
        wmma::load_matrix_sync(fb, BT ? b + tc * 16 * ldb + kk : b + kk * ldb + tc * 16, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
    }
    __syncthreads();
  }
};

template <>
struct Mma<float> {
  // Each thread sums kG rows of one output column per pass, over k in order.
  static constexpr int kG = 8;

  template <bool AT, bool BT>
  static __device__ void run(const float* a, int lda, const float* b, int ldb, float* c,
                             int ldc, int M, int N, int K, bool accumulate) {
    for (int o = threadIdx.x; o < (M / kG) * N; o += kThreads) {
      const int g = o / N, j = o - g * N;
      float acc[kG];
#pragma unroll
      for (int u = 0; u < kG; ++u) acc[u] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const float bv = BT ? b[j * ldb + kk] : b[kk * ldb + j];
#pragma unroll
        for (int u = 0; u < kG; ++u) {
          const int i = g * kG + u;
          acc[u] = fmaf(AT ? a[kk * lda + i] : a[i * lda + kk], bv, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        float* cp = c + (g * kG + u) * ldc + j;
        *cp = accumulate ? *cp + acc[u] : acc[u];
      }
    }
    __syncthreads();
  }
};

// Whether every pointer lies on a 16-byte boundary (the vectorised loads).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The largest tile height in {64, 32, 16} whose layout fits a block, or 0.
template <typename Layout>
inline int pick_rows(int hs) {
  for (int R = 64; R >= 16; R /= 2)
    if (Layout(R, hs).bytes <= kSmemMax) return R;
  return 0;
}

}  // namespace flash
}  // namespace tat
