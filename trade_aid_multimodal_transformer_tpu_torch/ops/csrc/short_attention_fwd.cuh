// Forward of whole-row causal attention for 8 <= T <= 512, shared by the cross
// kernel (one query stream against J key/value streams, summed) and the
// self-attention kernel (J = 1):
//
//   out[r] = sum_j softmax_causal(q[r] k_j[r]^T * hs^-0.5) . v_j[r]
//
// Rounding points of the JAX kernels (_short_fwd_kernel, _short_cross_fwd_kernel):
// scores, max, exp and row sum in f32, p rounded to v's type before P.V, each
// stream divided by its own row sum (times 1 - rate with dropout), the streams
// summed in f32 and the sum rounded once. Dropout keeps p's element (r, c) of
// stream j of collapsed row i by the hash of (seed_j, i, r, c): seed_j is
// seed + (j + 1) * 1000003 for the cross kernel and the seed itself for the
// self-attention kernel, as the JAX kernels key them in interpret mode.
//
// One block per (row r, query tile of R rows) holds q in shared memory and
// walks the streams and the key tiles in two passes (row max, then exp / row
// sum / P.V); with a single key tile (T <= R) k_j and v_j are loaded once and
// held, and the stream sum stays on chip so the output is written once. For
// bf16 with hs % 16 == 0, QK^T and P.V run on the tensor cores (WMMA);
// otherwise they are f32 FMAs.
//
// The kernels are templated on the row addressing (where row r's q, k_j and
// v_j planes lie): ``SeparateRows`` for q (n, T, hs) and k, v (J, n, T, hs),
// ``PackedRows`` for one packed (nb, 3H, T, hs) q|k|v operand (J = 1, the
// packed self-attention kernel). The output of row r is always plane r.
#pragma once

#include "attention_tile.cuh"

namespace tat {

// q (n, T, hs), k and v (J, n, T, hs): element offsets of row r's planes.
struct SeparateRows {
  int n;
  __device__ __forceinline__ size_t q(int r, size_t plane) const { return (size_t)r * plane; }
  __device__ __forceinline__ size_t k(int j, int r, size_t plane) const {
    return ((size_t)j * n + r) * plane;
  }
  __device__ __forceinline__ size_t v(int j, int r, size_t plane) const { return k(j, r, plane); }
};

// One packed (nb, 3H, T, hs) operand, J = 1: row r = b * H + h takes q at
// [b, h], k at [b, H + h] and v at [b, 2H + h].
struct PackedRows {
  int H;
  __device__ __forceinline__ size_t q(int r, size_t plane) const {
    return ((size_t)(r / H) * 3 * H + r % H) * plane;
  }
  __device__ __forceinline__ size_t k(int, int r, size_t plane) const {
    return q(r, plane) + (size_t)H * plane;
  }
  __device__ __forceinline__ size_t v(int, int r, size_t plane) const {
    return q(r, plane) + (size_t)2 * H * plane;
  }
};

// Dropout of stream j: the cross kernels offset the seed per stream, the
// self-attention kernel does not.
__device__ __forceinline__ uint32_t fwd_stream_seed(uint32_t seed, int j, int stream_seeds) {
  return stream_seeds ? stream_seed(seed, j) : seed;
}

template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
    short_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int J, Rows rows,
                     int Tn, int hs, int R, int n_qt, float scale, uint32_t seed,
                     uint32_t thresh, int rate_on, float keepf, int stream_seeds) {
  extern __shared__ float smem[];
  const long long bid = blockIdx.x;
  const int qt = (int)(bid % n_qt);
  const int r = (int)(bid / n_qt);
  const int q0 = qt * R;
  Tile t = carve_tile(smem, R, hs);

  const size_t plane = (size_t)Tn * hs;
  load_rows<T>(q + rows.q(r, plane), Tn, q0, R, hs, t.q, t.ld);

  const int n_kt = qt + 1;  // causal: keys up to the end of this query tile
  const bool held = n_kt == 1;
  float acc[kMaxPerThread];
#pragma unroll
  for (int u = 0; u < kMaxPerThread; ++u) acc[u] = 0.f;
  const int step = kThreads / hs, e = threadIdx.x % hs, i0 = threadIdx.x / hs;
  const bool active = threadIdx.x < step * hs;

  for (int jj = 0; jj < J; ++jj) {
    const T* kj = k + rows.k(jj, r, plane);
    const T* vj = v + rows.v(jj, r, plane);
    const Dropout d{fwd_stream_seed(seed, jj, stream_seeds), (uint32_t)r, thresh, rate_on != 0};
    reset_rows(t);
    float o[kMaxPerThread];
#pragma unroll
    for (int u = 0; u < kMaxPerThread; ++u) o[u] = 0.f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * R;
        if (pass == 0 || !held) {
          load_rows<T>(kj, Tn, k0, R, hs, t.k, t.ld);
          if (pass == 1 || held) load_rows<T>(vj, Tn, k0, R, hs, t.v, t.ld);
        }
        // a held tile keeps its scores from the first pass
        if (pass == 0 || !held) scores(t, q0, k0, scale);
        if (pass == 0) {
          fold_row_max(t);
        } else {
          probabilities<T>(t);
          drop_tile(t.s, t.lds, R, q0, k0, d);
          accumulate_pv(t, o);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int u = 0; u < kMaxPerThread; ++u) {
        const int i = i0 + u * step;
        if (i < R) acc[u] += o[u] / (t.l[i] * keepf);
      }
    }
    __syncthreads();
  }

  T* ob = out + r * plane;
  if (active) {
#pragma unroll
    for (int u = 0; u < kMaxPerThread; ++u) {
      const int i = i0 + u * step, row = q0 + i;
      if (i < R && row < Tn) Io<T>::store(ob + (size_t)row * hs + e, acc[u]);
    }
  }
}

// The same function for bf16 and hs a multiple of 16, QK^T and P.V on the
// tensor cores.
template <typename Rows>
__global__ void __launch_bounds__(kThreads)
    short_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out, int J, Rows rows, int Tn, int hs,
                        int R, int n_qt, float scale, uint32_t seed, uint32_t thresh,
                        int rate_on, float keepf, int stream_seeds) {
  extern __shared__ __align__(128) char smem_tc[];
  const long long bid = blockIdx.x;
  const int qt = (int)(bid % n_qt);
  const int r = (int)(bid / n_qt);
  const int q0 = qt * R;
  const TileTc t = carve_tile_tc(smem_tc, R, hs, true);

  const size_t plane = (size_t)Tn * hs;
  load_rows_bf16(q + rows.q(r, plane), Tn, q0, R, hs, t.q, t.ldh);
  for (int idx = threadIdx.x; idx < R * t.ldo; idx += kThreads) t.a[idx] = 0.f;

  const int n_kt = qt + 1;  // causal: keys up to the end of this query tile
  const bool held = n_kt == 1;
  for (int jj = 0; jj < J; ++jj) {
    const __nv_bfloat16* kj = k + rows.k(jj, r, plane);
    const __nv_bfloat16* vj = v + rows.v(jj, r, plane);
    const Dropout d{fwd_stream_seed(seed, jj, stream_seeds), (uint32_t)r, thresh, rate_on != 0};
    reset_rows_tc(t);
    Frag o[kOutFrags];
    zero_frags(o);
    for (int pass = 0; pass < 2; ++pass) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * R;
        if (pass == 0 || !held) {
          load_rows_bf16(kj, Tn, k0, R, hs, t.k, t.ldh);
          if (pass == 1 || held) load_rows_bf16(vj, Tn, k0, R, hs, t.v, t.ldh);
          scores_tc(t, q0, k0, scale);  // a held tile keeps its first-pass scores
        }
        if (pass == 0) {
          fold_row_max_tc(t);
        } else {
          probabilities_tc(t);
          drop_tile(t.p, t.ldp, R, q0, k0, d);
          accumulate_pv_tc(t, o);
        }
      }
    }
    store_frags(t, o);
    for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
      const int i = idx / hs, e = idx % hs;
      t.a[i * t.ldo + e] += t.o[i * t.ldo + e] / (t.l[i] * keepf);
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = out + r * plane + (size_t)q0 * hs;
  const int valid = max(0, min(R, Tn - q0)) * hs;
  for (int idx = threadIdx.x; idx < valid; idx += kThreads) {
    ob[idx] = __float2bfloat16_rn(t.a[(idx / hs) * t.ldo + idx % hs]);
  }
}

// Dropout arguments of a forward launch: the base seed (s0 ^ s1 of the site's
// salts), the keep threshold, whether dropout is on, and 1 - rate as f32.
struct FwdDrop {
  uint32_t seed, thresh;
  int on;
  float keepf;
};

template <typename Rows>
int launch_short_fwd_tc(const void* q, const void* k, const void* v, void* out, int J,
                        int n, Rows rows, int Tn, int hs, float scale, FwdDrop dr,
                        int stream_seeds, cudaStream_t stream) {
  const int R = tile_rows(hs);
  const int n_qt = (Tn + R - 1) / R;
  const long long blocks = (long long)n * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = tile_tc_bytes(R, hs, true);
  cudaError_t err = cudaFuncSetAttribute(
      short_fwd_tc_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  short_fwd_tc_kernel<Rows><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), J, rows,
      Tn, hs, R, n_qt, scale, dr.seed, dr.thresh, dr.on, dr.keepf, stream_seeds);
  return (int)cudaGetLastError();
}

template <typename T, typename Rows>
int launch_short_fwd(const void* q, const void* k, const void* v, void* out, int J, int n,
                     Rows rows, int Tn, int hs, float scale, FwdDrop dr, int stream_seeds,
                     cudaStream_t stream) {
  const int R = tile_rows(hs);
  const int n_qt = (Tn + R - 1) / R;
  const long long blocks = (long long)n * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = tile_floats(R, hs) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      short_fwd_kernel<T, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  short_fwd_kernel<T, Rows><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), J, rows, Tn, hs, R, n_qt, scale, dr.seed, dr.thresh, dr.on,
      dr.keepf, stream_seeds);
  return (int)cudaGetLastError();
}

// Dispatch of one forward launch over n rows addressed by ``rows``: bf16 with
// hs a multiple of 16 (production: hs 64) takes the tensor cores, other
// shapes and f32 the FMA body.
template <typename Rows>
int launch_short_forward(const void* q, const void* k, const void* v, void* out, int J,
                         int n, Rows rows, int Tn, int hs, int is_bf16, float scale,
                         FwdDrop dr, int stream_seeds, cudaStream_t s) {
  if (is_bf16 && hs % 16 == 0)
    return launch_short_fwd_tc(q, k, v, out, J, n, rows, Tn, hs, scale, dr, stream_seeds, s);
  if (is_bf16)
    return launch_short_fwd<__nv_bfloat16>(q, k, v, out, J, n, rows, Tn, hs, scale, dr,
                                           stream_seeds, s);
  return launch_short_fwd<float>(q, k, v, out, J, n, rows, Tn, hs, scale, dr, stream_seeds, s);
}

}  // namespace tat
