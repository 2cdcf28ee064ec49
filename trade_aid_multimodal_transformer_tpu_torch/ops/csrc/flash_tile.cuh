// Shared pieces of the blockwise (flash) causal attention kernels for long T
// (T % 128 == 0, T >= 256, hs <= 256): the f32 bodies' tile layouts in
// shared memory, tile loads and block-wide products on FMAs, warp
// reductions, and the dropout hash keyed on the JAX kernels' block grid.
//
// A tile of the f32 bodies is R rows (64, 32 or 16: the largest whose
// layout fits the shared memory of a block) of a (T, hs) row, with odd row
// strides so that a product reading by column finds no bank conflict. R
// divides the JAX block (a multiple of 128), so a tile never straddles two
// of its dropout blocks. The bf16 bodies (flash_fwd.cuh, flash_attention.cu)
// run on mma.sync through flash_mma.cuh.
#pragma once

#include <initializer_list>

#include "attention_tile.cuh"

namespace tat {
namespace flash {

constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block may use (227 KB)

__host__ __device__ inline size_t up128(size_t b) { return (b + 127) & ~(size_t)127; }

// Row strides of the f32 tiles: operands (R x hs), the rounded-score tiles
// (R x R), the score tiles (R x R) and the accumulators (R x hs).
__host__ __device__ inline int ldh_of(int hs) { return hs | 1; }
__host__ __device__ inline int ldp_of(int R) { return R + 4; }
__host__ __device__ inline int lds_of(int R) { return R + 4; }
__host__ __device__ inline int lda_of(int hs) { return hs + 4; }

// Dropout keep bit of score (row, col) of collapsed row n, as the JAX flash
// kernels draw it in interpret mode (pallas_attention.py _keep_mask ->
// hash_keep_mask): keyed by (seed, n, iq, jk) with iq = row / bq and
// jk = col / bk on the JAX block grid (query block bq, key block bk), and
// (r, c) = (row % bq, col % bk) inside the block. u32 arithmetic wraps as
// there.
__device__ __forceinline__ bool keep(uint32_t seed, uint32_t n, uint32_t bq, uint32_t bk,
                                     uint32_t row, uint32_t col, uint32_t thresh) {
  const uint32_t iq = row / bq, jk = col / bk;
  const uint32_t x = (seed * 2654435761u) ^ (n * 40503u) ^ (iq * 1000003u) ^ (jk * 97u);
  uint32_t h = (row - iq * bq) * 2246822519u + (col - jk * bk) * 3266489917u + x;
  h ^= h >> 13;
  h *= 2654435761u;
  h ^= h >> 16;
  return h >= thresh;
}

// keep() for the columns col0 .. col0 + R - 1 of one row, R dividing bk: the
// key block jk and everything but the column's term of the hash are fixed,
// so they are computed once (the u32 sum wraps as keep()'s), and only where
// dropout is on.
struct KeepRow {
  uint32_t base = 0, thresh;
  __device__ __forceinline__ KeepRow(bool on, uint32_t seed, uint32_t n, uint32_t bq,
                                     uint32_t bk, uint32_t row, uint32_t col0, uint32_t thresh_)
      : thresh(thresh_) {
    if (!on) return;
    const uint32_t iq = row / bq, jk = col0 / bk;
    const uint32_t x = (seed * 2654435761u) ^ (n * 40503u) ^ (iq * 1000003u) ^ (jk * 97u);
    base = (row - iq * bq) * 2246822519u + (col0 - jk * bk) * 3266489917u + x;
  }
  __device__ __forceinline__ bool operator()(uint32_t c) const {
    uint32_t h = base + c * 3266489917u;
    h ^= h >> 13;
    h *= 2654435761u;
    h ^= h >> 16;
    return h >= thresh;
  }
};

// keep() for the rows row0 .. row0 + R - 1 of one column, R dividing bq: the
// key-major twin of KeepRow, for kernels that hold a key's scores against a
// run of query rows. Everything but the row's term is fixed per (query tile,
// column) pair.
struct KeepCol {
  uint32_t base = 0, thresh;
  __device__ __forceinline__ KeepCol(bool on, uint32_t seed, uint32_t n, uint32_t bq,
                                     uint32_t bk, uint32_t row0, uint32_t col, uint32_t thresh_)
      : thresh(thresh_) {
    if (!on) return;
    const uint32_t iq = row0 / bq, jk = col / bk;
    const uint32_t x = (seed * 2654435761u) ^ (n * 40503u) ^ (iq * 1000003u) ^ (jk * 97u);
    base = (row0 - iq * bq) * 2246822519u + (col - jk * bk) * 3266489917u + x;
  }
  __device__ __forceinline__ bool operator()(uint32_t r) const {
    uint32_t h = base + r * 2246822519u;
    h ^= h >> 13;
    h *= 2654435761u;
    h ^= h >> 16;
    return h >= thresh;
  }
};

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

// R rows of hs floats from src (the tile's first row) into dst (stride ld).
// The caller synchronises.
__device__ inline void load_tile(const float* __restrict__ src, int R, int hs, float* dst,
                                 int ld) {
  for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
    const int i = idx / hs;
    dst[i * ld + idx - i * hs] = src[idx];
  }
}

// C (M x N, f32, stride ldc) = [C +] op(A) (M x K) . op(B) (K x N) on FMAs.
// op(A) is A, stored row-major (stride lda), or with AT its transpose stored
// row-major; op(B) likewise with BT. M is a multiple of kMmaRows. Each thread
// sums kMmaRows rows of one output column per pass, over k in order. Ends
// with a barrier.
constexpr int kMmaRows = 8;

template <bool AT, bool BT>
__device__ void mma_f32(const float* a, int lda, const float* b, int ldb, float* c, int ldc,
                        int M, int N, int K, bool accumulate) {
  for (int o = threadIdx.x; o < (M / kMmaRows) * N; o += kThreads) {
    const int g = o / N, j = o - g * N;
    float acc[kMmaRows];
#pragma unroll
    for (int u = 0; u < kMmaRows; ++u) acc[u] = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const float bv = BT ? b[j * ldb + kk] : b[kk * ldb + j];
#pragma unroll
      for (int u = 0; u < kMmaRows; ++u) {
        const int i = g * kMmaRows + u;
        acc[u] = fmaf(AT ? a[kk * lda + i] : a[i * lda + kk], bv, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kMmaRows; ++u) {
      float* cp = c + (g * kMmaRows + u) * ldc + j;
      *cp = accumulate ? *cp + acc[u] : acc[u];
    }
  }
  __syncthreads();
}

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
