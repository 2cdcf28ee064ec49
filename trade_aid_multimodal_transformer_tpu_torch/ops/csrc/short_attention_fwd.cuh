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
// self-attention kernel, as the JAX kernels key them in interpret mode. Under
// data parallelism i is the row's row in the global batch (SeparateRows'
// RowMap, attention_tile.cuh).
//
// Three bodies, by type and head size:
// - bf16 with hs % 16 == 0 and hs <= 128 (every model path):
//   short_fwd_mma_kernel on mma.sync (whole_row_mma.cuh). Warps own 16
//   query rows each; S, p and the stream sum stay in registers (see the
//   note above the kernel).
// - bf16 with hs % 16 == 0 above 128: short_fwd_tc_kernel, QK^T and P.V on
//   WMMA through f32 tiles in shared memory.
// - f32, and bf16 with hs % 16 != 0: short_fwd_kernel on f32 FMAs.
// The last two hold one block per (row r, query tile of R rows), q in
// shared memory, and walk the streams and the key tiles in two passes (row
// max, then exp / row sum / P.V); with a single key tile (T <= R) k_j and
// v_j are loaded once and held, and the stream sum stays on chip so the
// output is written once.
//
// The kernels are templated on the row addressing (where row r's q, k_j and
// v_j planes lie): ``SeparateRows`` for q (n, T, hs) and k, v (J, n, T, hs),
// ``PackedRows`` for one packed (nb, 3H, T, hs) q|k|v operand (J = 1, the
// packed self-attention kernel). The output of row r is always plane r.
#pragma once

#include "whole_row_mma.cuh"

namespace tat {

// q (n, T, hs), k and v (J, n, T, hs): element offsets of row r's planes.
struct SeparateRows {
  int n;
  RowMap rm;  // the rows' mask rows (data parallelism)
  __device__ __forceinline__ uint32_t mask_row(int r) const { return rm(r); }
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
  __device__ __forceinline__ uint32_t mask_row(int r) const { return (uint32_t)r; }
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
    const Dropout d{fwd_stream_seed(seed, jj, stream_seeds), rows.mask_row(r), thresh,
                    rate_on != 0};
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
    const Dropout d{fwd_stream_seed(seed, jj, stream_seeds), rows.mask_row(r), thresh,
                    rate_on != 0};
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

// ------------------------------------------------------------- bf16 mma body

namespace wr {

// The forward on mma.sync m16n8k16, bf16 with hs % 16 == 0 and hs <= 128
// (D = 64 or 128, the padded head size). One block of kFwdWarps warps per
// (row r, chunk of kFwdRows query rows), the chunks that see the most keys
// first; warp w owns query rows 16w..16w+15 of the chunk and, at D = 64,
// holds q's A fragments in registers for the whole launch (at D = 128 it
// reads them from shared memory per key tile: held, they would spill).
// Per stream j:
// - The chunk's keys (up to its last row) come in key tiles of kFwdKeys rows
//   through a ring of kFwdStages shared-memory stages filled by 16-byte
//   cp.async: the next two steps' k_j (and v_j) tiles are in flight while
//   this one is computed, so at T <= 64 all three streams of the cross
//   layout load at once. Rows past T are zeros, which add nothing.
// - Where the chunk's keys fit one tile (T <= 64), one pass: S = q k^T for
//   the key slabs up to the warp's last row in C fragments (16 x up to 64),
//   scaled by scale * log2(e) and masked in place, the exact row max by
//   quad shuffles, p = exp2(s - m) with l = sum p of the f32 values, the
//   dropout bit per element (p dropped after l is summed), p rounded and
//   packed to bf16 as P.V's A fragments without leaving registers, V's B
//   fragments through ldmatrix.trans, o += P V in f32.
// - Above 64, two passes over the key tiles: the first forms S for the row
//   max only, the second forms S again and p at the whole row's max, then
//   l and P.V as above. p is rounded at the whole row's max, as the JAX
//   kernels round it (an online softmax would round it at running maxima).
// o_j / (l_j (1 - rate)) is added to an f32 register accumulator in stream
// order j = 0..J-1, and the sum is rounded once and written through the
// warp's own rows of q (16-byte stores). The division is o_j times the
// reciprocal of l_j (1 - rate) rounded once, as the backward forms 1 / l
// (within two f32 ulps of the quotient; 32 divisions a thread cost a K2f
// block ~1 us a stream). exp2 of the log2-scaled scores is the backward's
// form (attention_bwd.cuh), so both directions form the same p. No
// atomics: two runs give the same bits.
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdRows = 16 * kFwdWarps;  // query rows of a block
constexpr int kFwdKeys = 64;              // keys of a tile
constexpr int kFwdStages = 3;             // the ring's depth: steps in flight + 1

// Shared memory of a launch: the chunk's q, then `stages` stages of one key
// tile and one value tile, rows D + 8 apart.
template <int D>
constexpr size_t fwd_smem_bytes(int stages) {
  return ((size_t)kFwdRows + 2 * (size_t)stages * kFwdKeys) * (D + 8) * 2;
}

struct FwdMmaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  int J, n, Tn, hs;
  float sl2;      // scale * log2(e)
  uint32_t seed, thresh;
  int on;         // dropout
  float keepf;    // 1 - rate as f32
  int stream_seeds;
  int vec;        // 16-byte copies (every pointer 16-byte aligned)
};

template <int D, typename Rows>
__global__ void __launch_bounds__(kFwdThreads) short_fwd_mma_kernel(const FwdMmaArgs a,
                                                                    const Rows rows) {
  constexpr int kLd = D + 8, kSn = kFwdKeys / 8;
  extern __shared__ __align__(128) char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* stages = sq + kFwdRows * kLd;  // stage s: k at stages + 2 s kFwdKeys kLd, v after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Tn = a.Tn, hs = a.hs, n_qc = (Tn + kFwdRows - 1) / kFwdRows;
  const int qc = n_qc - 1 - (int)(blockIdx.x / a.n), r = (int)(blockIdx.x % a.n);
  const int q0 = qc * kFwdRows, valid_q = min(kFwdRows, Tn - q0);
  const int keys = q0 + valid_q;  // the keys the chunk's last row sees
  const int n_kt = (keys + kFwdKeys - 1) / kFwdKeys;
  const bool one = n_kt == 1;  // one pass a stream
  const int per_stream = one ? 1 : 2 * n_kt, steps = a.J * per_stream;
  const bool vec = a.vec != 0;
  const size_t plane = (size_t)Tn * hs;
  const int w0 = 16 * warp;
  const bool active = w0 < valid_q;
  const int qrow[2] = {q0 + w0 + (lane >> 2), q0 + w0 + (lane >> 2) + 8};  // this thread's rows

  // step st: stream st / per_stream; pass 0 (the max: k only) or 1 (k and v)
  auto load_step = [&](int st) {
    if (st < steps) {
      const int j = st / per_stream, at = st % per_stream;
      const int kt = one ? 0 : at % n_kt;
      const bool with_v = one || at >= n_kt;
      bf16* dst = stages + (st % kFwdStages) * 2 * kFwdKeys * kLd;
      const int k0 = kt * kFwdKeys, valid = min(kFwdKeys, keys - k0);
      const int slab_rows = (valid + 15) & ~15;  // rows of the slabs a warp reads
      const size_t off = (size_t)k0 * hs;
      load_tile<D, kFwdKeys, kFwdThreads>(dst, a.k + rows.k(j, r, plane) + off, hs, valid, vec,
                                          slab_rows);
      if (with_v)
        load_tile<D, kFwdKeys, kFwdThreads>(dst + kFwdKeys * kLd, a.v + rows.v(j, r, plane) + off,
                                            hs, valid, vec, slab_rows);
    }
    mma::cp_async_commit();
  };
  load_tile<D, kFwdRows, kFwdThreads>(sq, a.q + rows.q(r, plane) + (size_t)q0 * hs, hs, valid_q,
                                      vec);
  for (int st = 0; st < kFwdStages - 1; ++st) load_step(st);

  const bool on = a.on != 0;
  uint32_t qa[kHoldQ<D> ? D / 16 : 1][4];
  float acc[D / 8][4], o[D / 8][4], m2[2], l[2];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;

  for (int st = 0; st < steps; ++st) {
    mma::cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // step st landed; every warp is done with step st - 1's stage
    load_step(st + kFwdStages - 1);
    if (!active) continue;
    const int j = st / per_stream, at = st % per_stream;
    const int kt = one ? 0 : at % n_kt, k0 = kt * kFwdKeys;
    const bool p_pass = one || at >= n_kt;
    if constexpr (kHoldQ<D>) {
      if (st == 0)
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd)
          mma::ldsm_x4(qa[kd], mma::a_frag_addr(sq + w0 * kLd, kLd, 0, 16 * kd, lane));
    }
    if (at == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m2[h] = -INFINITY;
        l[h] = 0.f;
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
    }
    const bf16* sk = stages + (st % kFwdStages) * 2 * kFwdKeys * kLd;
    const int reach = q0 + w0 + 15 - k0;  // key slabs of this tile the warp's rows see
    const int ns = reach < 0 ? 0 : min(kSn / 2, reach / 16 + 1);
    if (ns > 0) {
      float s[kSn][4];
      qk_scores<D, kSn>(s, qa, sq + w0 * kLd, sk, ns, lane);
      float mt[2] = {-INFINITY, -INFINITY};
      mask_scale<kSn>(s, ns, k0, qrow, a.sl2, mt, lane);
      if (!p_pass || one)
#pragma unroll
        for (int h = 0; h < 2; ++h) m2[h] = fmaxf(m2[h], mt[h]);
      if (p_pass) {
        if (kt == 0)  // the row's max is complete: reduce it over the quad
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            m2[h] = quad_max(m2[h]);
            if (m2[h] == -INFINITY) m2[h] = 0.f;
          }
        const uint32_t seed = a.stream_seeds ? stream_seed(a.seed, j) : a.seed;
        const uint32_t n_idx = rows.mask_row(r);
        const KeepRowW kr[2] = {KeepRowW(on, seed, n_idx, (uint32_t)qrow[0], a.thresh),
                                KeepRowW(on, seed, n_idx, (uint32_t)qrow[1], a.thresh)};
        softmax_pv<D, kSn>(o, l, s, m2, kr, on, k0, sk + kFwdKeys * kLd, ns, lane);
      }
    }
    if (at == per_stream - 1) {  // the stream's end: o_j / (l_j (1 - rate)) into the sum
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = __frcp_rn(quad_sum(l[h]) * a.keepf);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[dt][i] += o[dt][i] * l[i >> 1];
    }
  }

  if (active) {  // the sum through the warp's own rows of q (only this warp read them)
    uint32_t out[D / 8][2];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int h = 0; h < 2; ++h) out[dt][h] = mma::pack_bf16(acc[dt][2 * h], acc[dt][2 * h + 1]);
    store_warp_rows<kLd, D / 8>(a.out + (size_t)r * plane + (size_t)(q0 + w0) * hs, sq + w0 * kLd,
                                out, hs, Tn - q0 - w0, vec, lane, 0);
  }
}

template <int D, typename Rows>
int launch_fwd_mma(const FwdMmaArgs& a, Rows rows, cudaStream_t stream) {
  const long long blocks = (long long)a.n * ((a.Tn + kFwdRows - 1) / kFwdRows);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // as many stages as the most steps a block runs, at most kFwdStages
  const int n_kt = (a.Tn + kFwdKeys - 1) / kFwdKeys;
  const long long steps = (long long)a.J * (n_kt == 1 ? 1 : 2 * n_kt);
  const size_t smem = fwd_smem_bytes<D>((int)(steps < kFwdStages ? steps : kFwdStages));
  const cudaError_t err = cudaFuncSetAttribute(
      short_fwd_mma_kernel<D, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  short_fwd_mma_kernel<D, Rows><<<(unsigned)blocks, kFwdThreads, smem, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

}  // namespace wr

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

// bf16 with hs % 16 == 0 and hs <= 128 on the mma.sync body.
template <typename Rows>
int launch_short_fwd_mma(const void* q, const void* k, const void* v, void* out, int J, int n,
                         Rows rows, int Tn, int hs, float scale, FwdDrop dr, int stream_seeds,
                         cudaStream_t stream) {
  wr::FwdMmaArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.J = J; a.n = n; a.Tn = Tn; a.hs = hs;
  a.sl2 = scale * wr::kLog2e;
  a.seed = dr.seed; a.thresh = dr.thresh; a.on = dr.on; a.keepf = dr.keepf;
  a.stream_seeds = stream_seeds;
  a.vec = flash::aligned16({q, k, v, out});
  return hs <= 64 ? wr::launch_fwd_mma<64>(a, rows, stream)
                  : wr::launch_fwd_mma<128>(a, rows, stream);
}

// Dispatch of one forward launch over n rows addressed by ``rows``: bf16
// with hs a multiple of 16 up to 128 (every model path: hs 64) takes the
// mma.sync body, above 128 the WMMA body; other shapes and f32 the FMA body.
template <typename Rows>
int launch_short_forward(const void* q, const void* k, const void* v, void* out, int J,
                         int n, Rows rows, int Tn, int hs, int is_bf16, float scale,
                         FwdDrop dr, int stream_seeds, cudaStream_t s) {
  if (is_bf16 && hs % 16 == 0 && hs <= 128)
    return launch_short_fwd_mma(q, k, v, out, J, n, rows, Tn, hs, scale, dr, stream_seeds, s);
  if (is_bf16 && hs % 16 == 0)
    return launch_short_fwd_tc(q, k, v, out, J, n, rows, Tn, hs, scale, dr, stream_seeds, s);
  if (is_bf16)
    return launch_short_fwd<__nv_bfloat16>(q, k, v, out, J, n, rows, Tn, hs, scale, dr,
                                           stream_seeds, s);
  return launch_short_fwd<float>(q, k, v, out, J, n, rows, Tn, hs, scale, dr, stream_seeds, s);
}

}  // namespace tat
