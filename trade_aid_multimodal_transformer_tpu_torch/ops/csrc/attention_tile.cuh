// Shared pieces of the whole-row causal attention kernels: element I/O with the
// rounding points of the JAX kernels, the tile size rule, and the block-wide
// score / softmax / P.V steps over one (query tile, key tile) pair held in
// shared memory as f32.
//
// Every kernel here runs 256 threads per block. A block-wide product with an
// R x N result gives each thread one column and at most kMaxPerThread rows, so
// its sums stay in registers; the tile height R is chosen from the head size so
// that this holds for the R x hs products and for the R x R scores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace tat {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 16;

// Rows of one query tile (and of one key tile) for head size hs <= 256.
__host__ __device__ inline int tile_rows(int hs) {
  const int r = kMaxPerThread * (kThreads / hs);
  return r < 64 ? r : 64;
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // Round an f32 value to bf16 (nearest even) and back: the cast points of
  // the JAX kernels, kept so that bf16 results agree with them.
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// Attention dropout, as the JAX kernels draw it in interpret mode
// (pallas_attention.py hash_keep_mask with iq = jk = 0): element (r, c) of
// collapsed row n_idx is kept when the hash of (seed, n_idx, r, c) is at least
// thresh = min(floor(rate * 2^32), 2^32 - 1). u32 arithmetic wraps as there.
struct Dropout {
  uint32_t seed;    // the row's seed (a cross stream's already offset)
  uint32_t n_idx;   // collapsed row index of the JAX kernel's mask
  uint32_t thresh;
  bool on;
};

__device__ __forceinline__ bool keep_bit(uint32_t seed, uint32_t n_idx, uint32_t r,
                                         uint32_t c, uint32_t thresh) {
  const uint32_t x = (seed * 2654435761u) ^ (n_idx * 40503u);
  uint32_t h = r * 2246822519u + c * 3266489917u + x;
  h ^= h >> 13;
  h *= 2654435761u;
  h ^= h >> 16;
  return h >= thresh;
}

// The seed of cross stream j: seed + (j + 1) * 1000003 in int32 (wrapping).
__host__ __device__ inline uint32_t stream_seed(uint32_t seed, int j) {
  return seed + (uint32_t)(j + 1) * 1000003u;
}

// Zero the dropped entries of an R x R tile of probabilities p (stride ld)
// whose rows start at query q0 and columns at key k0.
template <typename P>
__device__ void drop_tile(P* p, int ld, int R, int q0, int k0, const Dropout& d) {
  if (!d.on) return;
  for (int idx = threadIdx.x; idx < R * R; idx += blockDim.x) {
    const int i = idx / R, j = idx % R;
    if (!keep_bit(d.seed, d.n_idx, (uint32_t)(q0 + i), (uint32_t)(k0 + j), d.thresh))
      p[i * ld + j] = P(0.f);
  }
  __syncthreads();
}

// One query tile and one key tile in shared memory, all f32.
struct Tile {
  float* q;  // R x ld
  float* k;  // R x ld
  float* v;  // R x ld
  float* s;  // R x lds: scores, then probabilities
  float* m;  // R: row max over every key of the row
  float* l;  // R: row sum of exp(s - m)
  int ld;    // hs + 1 (odd: the score product reads k by column)
  int lds;   // R + 1
  int R;
  int hs;
};

__host__ __device__ inline size_t tile_floats(int R, int hs) {
  return (size_t)3 * R * (hs + 1) + (size_t)R * (R + 1) + 2 * (size_t)R;
}

__device__ inline Tile carve_tile(float* base, int R, int hs) {
  Tile t;
  t.R = R;
  t.hs = hs;
  t.ld = hs + 1;
  t.lds = R + 1;
  t.q = base;
  t.k = t.q + R * t.ld;
  t.v = t.k + R * t.ld;
  t.s = t.v + R * t.ld;
  t.m = t.s + R * t.lds;
  t.l = t.m + R;
  return t;
}

// Loads per thread issued together before their results are used: a loop
// that loads, converts and stores one element per iteration waits a full
// device-memory latency per element.
constexpr int kBatch = 8;

// Copy rows [row0, row0 + R) of a (rows, hs) array into dst (stride ld),
// zero past the last row so that padded rows stay finite.
template <typename T>
__device__ void load_rows(const T* __restrict__ src, int rows, int row0, int R,
                          int hs, float* dst, int ld) {
  const int n = R * hs;
  const int valid = max(0, min(R, rows - row0)) * hs;
  const T* base = src + (size_t)row0 * hs;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      v[u] = idx < valid ? Io<T>::load(base + idx) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx < n) dst[(idx / hs) * ld + idx % hs] = v[u];
    }
  }
  __syncthreads();
}

__device__ inline void reset_rows(const Tile& t) {
  for (int i = threadIdx.x; i < t.R; i += kThreads) {
    t.m[i] = -INFINITY;
    t.l[i] = 0.f;
  }
  __syncthreads();
}

// s[i][j] = (q_i . k_j) * scale where key k0 + j <= query q0 + i, else -inf.
// The feature loop is outermost so that a thread's rows are independent FMA
// chains (instruction-level parallelism) over one k value.
__device__ inline void scores(const Tile& t, int q0, int k0, float scale) {
  const int R = t.R, step = kThreads / R, j = threadIdx.x % R, i0 = threadIdx.x / R;
  if (threadIdx.x < step * R) {
    const float* kj = t.k + j * t.ld;
    float acc[kMaxPerThread];
#pragma unroll
    for (int u = 0; u < kMaxPerThread; ++u) acc[u] = 0.f;
    for (int e = 0; e < t.hs; ++e) {
      const float kv = kj[e];
#pragma unroll
      for (int u = 0; u < kMaxPerThread; ++u) {
        const int i = i0 + u * step;
        if (i < R) acc[u] = fmaf(t.q[i * t.ld + e], kv, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxPerThread; ++u) {
      const int i = i0 + u * step;
      if (i < R) t.s[i * t.lds + j] = (k0 + j <= q0 + i) ? acc[u] * scale : -INFINITY;
    }
  }
  __syncthreads();
}

// First pass: fold this key tile into each row's max.
__device__ inline void fold_row_max(const Tile& t) {
  const int i = threadIdx.x;
  if (i < t.R) {
    float mx = t.m[i];
    for (int j = 0; j < t.R; ++j) mx = fmaxf(mx, t.s[i * t.lds + j]);
    t.m[i] = mx;
  }
  __syncthreads();
}

// Second pass: p = exp(s - m) with the row's final max, l += sum(p) in f32,
// then p is rounded in place to the value type for the P.V product.
template <typename T>
__device__ void probabilities(const Tile& t) {
  const int R = t.R;
  for (int idx = threadIdx.x; idx < R * R; idx += kThreads) {
    const int i = idx / R, j = idx % R;
    t.s[i * t.lds + j] = expf(t.s[i * t.lds + j] - t.m[i]);
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int i = threadIdx.x;
    float sum = 0.f;
    for (int j = 0; j < R; ++j) sum += t.s[i * t.lds + j];
    t.l[i] += sum;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * R; idx += kThreads) {
    const int i = idx / R, j = idx % R;
    t.s[i * t.lds + j] = Io<T>::round(t.s[i * t.lds + j]);
  }
  __syncthreads();
}

// o[u] += sum_j p[i][j] * v[j][e] for this thread's rows i and column e,
// the key loop outermost as in scores().
__device__ inline void accumulate_pv(const Tile& t, float (&o)[kMaxPerThread]) {
  const int step = kThreads / t.hs, e = threadIdx.x % t.hs, i0 = threadIdx.x / t.hs;
  if (threadIdx.x < step * t.hs) {
    for (int j = 0; j < t.R; ++j) {
      const float vv = t.v[j * t.ld + e];
#pragma unroll
      for (int u = 0; u < kMaxPerThread; ++u) {
        const int i = i0 + u * step;
        if (i < t.R) o[u] = fmaf(t.s[i * t.lds + j], vv, o[u]);
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Tensor-core variant for bf16 with hs a multiple of 16: q/k/v and p live in
// shared memory as bf16 (the values the f32 variant holds are bf16-exact
// anyway), QK^T and P.V run as WMMA 16x16x16 products with f32 accumulation,
// and the softmax steps stay in f32. Rows are padded by 8 (bf16) or 4 (f32)
// elements, which keeps every 16-row tile 32-byte aligned as WMMA needs.

using Frag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
constexpr int kWarps = kThreads / 32;
constexpr int kOutFrags = 2;  // (R/16) x (hs/16) <= 16 output tiles over 8 warps

struct TileTc {
  float* s;            // R x lds scores, then exp(s - m)
  float* o;            // R x ldo staging for WMMA results
  float* a;            // R x ldo running sum over streams (cross kernel only)
  float* m;            // R
  float* l;            // R
  __nv_bfloat16* q;    // R x ldh
  __nv_bfloat16* k;    // R x ldh
  __nv_bfloat16* v;    // R x ldh
  __nv_bfloat16* p;    // R x ldp
  int R, hs, lds, ldo, ldh, ldp;
};

__host__ __device__ inline size_t tile_tc_bytes(int R, int hs, bool stream_sum) {
  const size_t floats = (size_t)R * (R + 4) + (size_t)(stream_sum ? 2 : 1) * R * (hs + 4) + 2 * (size_t)R;
  const size_t halves = (size_t)3 * R * (hs + 8) + (size_t)R * (R + 8);
  return floats * sizeof(float) + halves * sizeof(__nv_bfloat16);
}

__device__ inline TileTc carve_tile_tc(char* base, int R, int hs, bool stream_sum) {
  TileTc t;
  t.R = R;
  t.hs = hs;
  t.lds = R + 4;
  t.ldo = hs + 4;
  t.ldh = hs + 8;
  t.ldp = R + 8;
  t.s = reinterpret_cast<float*>(base);
  t.o = t.s + R * t.lds;
  t.a = stream_sum ? t.o + R * t.ldo : nullptr;
  t.m = t.o + (stream_sum ? 2 : 1) * R * t.ldo;
  t.l = t.m + R;
  t.q = reinterpret_cast<__nv_bfloat16*>(t.l + R);
  t.k = t.q + R * t.ldh;
  t.v = t.k + R * t.ldh;
  t.p = t.v + R * t.ldh;
  return t;
}

// Rows [row0, row0 + R) of a (rows, hs) bf16 array into dst (stride ld),
// zero past the last row.
__device__ inline void load_rows_bf16(const __nv_bfloat16* __restrict__ src, int rows,
                                      int row0, int R, int hs, __nv_bfloat16* dst,
                                      int ld) {
  const int n = R * hs;
  const int valid = max(0, min(R, rows - row0)) * hs;
  const __nv_bfloat16* base = src + (size_t)row0 * hs;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    __nv_bfloat16 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      v[u] = idx < valid ? base[idx] : zero;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx < n) dst[(idx / hs) * ld + idx % hs] = v[u];
    }
  }
  __syncthreads();
}

__device__ inline void reset_rows_tc(const TileTc& t) {
  for (int i = threadIdx.x; i < t.R; i += kThreads) {
    t.m[i] = -INFINITY;
    t.l[i] = 0.f;
  }
  __syncthreads();
}

// s = q k^T on the tensor cores, then scaled and causally masked in f32.
__device__ inline void scores_tc(const TileTc& t, int q0, int k0, float scale) {
  using namespace nvcuda;
  const int tr_n = t.R / 16, warp = threadIdx.x / 32;
  for (int tile = warp; tile < tr_n * tr_n; tile += kWarps) {
    const int tr = tile / tr_n, tc = tile % tr_n;
    Frag acc;
    wmma::fill_fragment(acc, 0.f);
    for (int e = 0; e < t.hs; e += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, t.q + tr * 16 * t.ldh + e, t.ldh);
      wmma::load_matrix_sync(b, t.k + tc * 16 * t.ldh + e, t.ldh);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(t.s + tr * 16 * t.lds + tc * 16, acc, t.lds, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < t.R * t.R; idx += kThreads) {
    const int i = idx / t.R, j = idx % t.R;
    float* sp = t.s + i * t.lds + j;
    *sp = (k0 + j <= q0 + i) ? *sp * scale : -INFINITY;
  }
  __syncthreads();
}

__device__ inline void fold_row_max_tc(const TileTc& t) {
  const int i = threadIdx.x;
  if (i < t.R) {
    float mx = t.m[i];
    for (int j = 0; j < t.R; ++j) mx = fmaxf(mx, t.s[i * t.lds + j]);
    t.m[i] = mx;
  }
  __syncthreads();
}

// p = exp(s - m): the f32 values feed l, their bf16 roundings feed P.V.
__device__ inline void probabilities_tc(const TileTc& t) {
  const int R = t.R;
  for (int idx = threadIdx.x; idx < R * R; idx += kThreads) {
    const int i = idx / R, j = idx % R;
    const float e = expf(t.s[i * t.lds + j] - t.m[i]);
    t.s[i * t.lds + j] = e;
    t.p[i * t.ldp + j] = __float2bfloat16_rn(e);
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int i = threadIdx.x;
    float sum = 0.f;
    for (int j = 0; j < R; ++j) sum += t.s[i * t.lds + j];
    t.l[i] += sum;
  }
  __syncthreads();
}

// o += p v on the tensor cores; warp w owns output tiles w and w + 8.
__device__ inline void accumulate_pv_tc(const TileTc& t, Frag (&o)[kOutFrags]) {
  using namespace nvcuda;
  const int tc_n = t.hs / 16, n_tiles = (t.R / 16) * tc_n, warp = threadIdx.x / 32;
#pragma unroll
  for (int f = 0; f < kOutFrags; ++f) {
    const int tile = warp + f * kWarps;
    if (tile < n_tiles) {
      const int tr = tile / tc_n, tc = tile % tc_n;
      for (int j = 0; j < t.R; j += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, t.p + tr * 16 * t.ldp + j, t.ldp);
        wmma::load_matrix_sync(b, t.v + j * t.ldh + tc * 16, t.ldh);
        wmma::mma_sync(o[f], a, b, o[f]);
      }
    }
  }
  __syncthreads();
}

__device__ inline void zero_frags(Frag (&o)[kOutFrags]) {
#pragma unroll
  for (int f = 0; f < kOutFrags; ++f) nvcuda::wmma::fill_fragment(o[f], 0.f);
}

// o -> t.o (R x hs, f32)
__device__ inline void store_frags(const TileTc& t, Frag (&o)[kOutFrags]) {
  using namespace nvcuda;
  const int tc_n = t.hs / 16, n_tiles = (t.R / 16) * tc_n, warp = threadIdx.x / 32;
#pragma unroll
  for (int f = 0; f < kOutFrags; ++f) {
    const int tile = warp + f * kWarps;
    if (tile < n_tiles) {
      const int tr = tile / tc_n, tc = tile % tc_n;
      wmma::store_matrix_sync(t.o + tr * 16 * t.ldo + tc * 16, o[f], t.ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();
}

}  // namespace tat
