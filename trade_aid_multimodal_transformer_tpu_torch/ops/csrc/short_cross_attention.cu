// Cross attention of one query stream against J key/value streams:
// out[r] = sum_j softmax_causal(q[r] k_j[r]^T * hs^-0.5) . v_j[r], and its
// backward (dq summed over the streams, every dk_j and dv_j).
//
// Replaces: trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py,
// _short_cross_fwd_kernel (entries short_cross_attention and
// short_cross_attention_t) and _short_cross_bwd_kernel. Rounding points as
// there: scores, max, exp and row sum in f32, p rounded to v's type before
// P.V, each stream divided by its own row sum (times 1 - rate with dropout),
// the streams summed in f32, and the sum rounded once. Dropout keeps p's
// element (r, c) of stream j by the hash of (seed + (j + 1) * 1000003, row
// index, r, c), the JAX kernels' interpret-mode stream. The JAX kernel's
// transposed key/value layout was a TPU relayout workaround; these kernels
// take k and v as (J, n, T, hs).
//
// What bounds the forward on the H100: at the production shape (q 6x32x64x64
// bf16, J=3) it moves ~12.6 MB (q once, every k_j and v_j once, out once) for
// ~0.3 GFLOP (causal half), so memory bounds it (~25 FLOP/byte, far under
// the ~295 ridge). The design reads each input once per pass: one block per
// (row r, query tile of R rows) holds q in shared memory and walks the
// streams and the key tiles in two passes (row max, then exp / row sum /
// P.V); with a single key tile (T <= R, production) k_j and v_j are loaded
// once and held, and the stream sum stays on chip so the output is written
// once. For bf16 with hs % 16 == 0 (production) QK^T and P.V run on the
// tensor cores (WMMA); otherwise they are f32 FMAs. With only n blocks (192 at
// production, 6 at B=1) and the streams walked in turn, a block's latency,
// not bandwidth, sets the time. The backward is attention_bwd.cuh's kernel
// (one block per row, FMAs).
#include "attention_bwd.cuh"

namespace tat {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    short_cross_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int J,
                           int n, int Tn, int hs, int R, int n_qt, float scale,
                           uint32_t seed, uint32_t thresh, int rate_on, float keepf) {
  extern __shared__ float smem[];
  const long long bid = blockIdx.x;
  const int qt = (int)(bid % n_qt);
  const int r = (int)(bid / n_qt);
  const int q0 = qt * R;
  Tile t = carve_tile(smem, R, hs);

  const size_t plane = (size_t)Tn * hs;
  load_rows<T>(q + r * plane, Tn, q0, R, hs, t.q, t.ld);

  const int n_kt = qt + 1;  // causal: keys up to the end of this query tile
  const bool held = n_kt == 1;
  float acc[kMaxPerThread];
#pragma unroll
  for (int u = 0; u < kMaxPerThread; ++u) acc[u] = 0.f;
  const int step = kThreads / hs, e = threadIdx.x % hs, i0 = threadIdx.x / hs;
  const bool active = threadIdx.x < step * hs;

  for (int jj = 0; jj < J; ++jj) {
    const T* kj = k + ((size_t)jj * n + r) * plane;
    const T* vj = v + ((size_t)jj * n + r) * plane;
    const Dropout d{stream_seed(seed, jj), (uint32_t)r, thresh, rate_on != 0};
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
__global__ void __launch_bounds__(kThreads)
    short_cross_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ out, int J, int n, int Tn,
                              int hs, int R, int n_qt, float scale, uint32_t seed,
                              uint32_t thresh, int rate_on, float keepf) {
  extern __shared__ __align__(128) char smem_tc[];
  const long long bid = blockIdx.x;
  const int qt = (int)(bid % n_qt);
  const int r = (int)(bid / n_qt);
  const int q0 = qt * R;
  const TileTc t = carve_tile_tc(smem_tc, R, hs, true);

  const size_t plane = (size_t)Tn * hs;
  load_rows_bf16(q + r * plane, Tn, q0, R, hs, t.q, t.ldh);
  for (int idx = threadIdx.x; idx < R * t.ldo; idx += kThreads) t.a[idx] = 0.f;

  const int n_kt = qt + 1;  // causal: keys up to the end of this query tile
  const bool held = n_kt == 1;
  for (int jj = 0; jj < J; ++jj) {
    const __nv_bfloat16* kj = k + ((size_t)jj * n + r) * plane;
    const __nv_bfloat16* vj = v + ((size_t)jj * n + r) * plane;
    const Dropout d{stream_seed(seed, jj), (uint32_t)r, thresh, rate_on != 0};
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

int launch_tc(const void* q, const void* k, const void* v, void* out, int J, int n,
              int Tn, int hs, float scale, FwdDrop dr, cudaStream_t stream) {
  const int R = tile_rows(hs);
  const int n_qt = (Tn + R - 1) / R;
  const long long blocks = (long long)n * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = tile_tc_bytes(R, hs, true);
  cudaError_t err = cudaFuncSetAttribute(
      short_cross_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  short_cross_fwd_tc_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), J, n,
      Tn, hs, R, n_qt, scale, dr.seed, dr.thresh, dr.on, dr.keepf);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int J, int n,
           int Tn, int hs, float scale, FwdDrop dr, cudaStream_t stream) {
  const int R = tile_rows(hs);
  const int n_qt = (Tn + R - 1) / R;
  const long long blocks = (long long)n * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = tile_floats(R, hs) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      short_cross_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  short_cross_fwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), J, n, Tn, hs, R, n_qt,
      scale, dr.seed, dr.thresh, dr.on, dr.keepf);
  return (int)cudaGetLastError();
}

}  // namespace tat

// q (n, T, hs); k, v (J, n, T, hs); out (n, T, hs); one type for all, bf16 or
// f32, contiguous. Dropout (rate_on) keeps element (r, c) of stream j of row i
// by the hash of (seed + (j + 1) * 1000003, i, r, c) against thresh and
// divides each stream by l * keepf. Returns the cudaError_t of the launch.
extern "C" int tat_short_cross_attention_fwd(const void* q, const void* k,
                                             const void* v, void* out, int J,
                                             int n, int T, int hs, int is_bf16,
                                             float scale, unsigned seed,
                                             unsigned thresh, int rate_on,
                                             float keepf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tat::FwdDrop dr{seed, thresh, rate_on, keepf};
  // bf16 with hs a multiple of 16 (production: hs 64) takes the tensor cores
  if (is_bf16 && hs % 16 == 0)
    return tat::launch_tc(q, k, v, out, J, n, T, hs, scale, dr, s);
  if (is_bf16)
    return tat::launch<__nv_bfloat16>(q, k, v, out, J, n, T, hs, scale, dr, s);
  return tat::launch<float>(q, k, v, out, J, n, T, hs, scale, dr, s);
}

// Backward of the above: dq (n, T, hs) summed over the streams, dk and dv
// (J, n, T, hs) per stream, in the inputs' type; dq_ws is an (n, T, hs) f32
// workspace. inv is 1 / (1 - rate) as f32. Returns the cudaError_t.
extern "C" int tat_short_cross_attention_bwd(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             void* dq, void* dk, void* dv,
                                             void* dq_ws, int J, int n, int T,
                                             int hs, int is_bf16, float scale,
                                             unsigned seed, unsigned thresh,
                                             int rate_on, float inv, void* stream) {
  tat::BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = nullptr; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.dq_ws = static_cast<float*>(dq_ws);
  a.J = J; a.n = n; a.Tn = T; a.hs = hs; a.scale = scale;
  a.rate_on = rate_on; a.seed = seed; a.thresh = thresh; a.inv = inv;
  a.fused = 0; a.B = a.H = a.gb = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return tat::launch_attn_bwd<__nv_bfloat16>(a, s);
  return tat::launch_attn_bwd<float>(a, s);
}
