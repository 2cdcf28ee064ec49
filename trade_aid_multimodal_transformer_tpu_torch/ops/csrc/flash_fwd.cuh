// Forward of blockwise (flash) causal attention, shared by the self-attention
// kernel (K5f, J = 1, with the logsumexp), the cross kernels (K6f, K6f-r:
// one query stream against J key/value streams, summed) and the ring
// attention chunk kernel (K7f: J = 1, t_q query rows against t_k key rows,
// with the causal mask of the diagonal chunk or none):
//
//   out_j[r] = softmax_mask(q[r] k_j[r]^T * hs^-0.5) . v_j[r],
//   lse_j[r] = logsumexp of the row's scores,  out[r] = sum_j out_j[r],
//
// the mask the top-left causal one (key column c visible from query row i
// iff c <= i, also where t_q != t_k) or, for the chunks of earlier ring
// ranks, every key visible (kCausal = false).
//
// Arithmetic of the JAX kernels (_flash_fwd_kernel, _flash_cross_kernel,
// _flash_cross_kernel_res): scores in f32 from products in the input type
// with f32 accumulation; per key tile an online max m and row sum l of the
// unmasked p = exp(s - m); the dropout keep-mask applied to p before it is
// rounded to v's type for P.V; out_j = acc / (l * (1 - rate)) rounded to q's
// type; lse_j = m + log l. The streams are summed in q's type in stream order
// (each stream's rounded output added to the rounded running sum), so the sum
// is kept in the output array itself. Dropout of stream j is keyed by seed +
// (j + 1) * 1000003 for the cross kernels and by the seed itself for
// self-attention and the chunks, on the JAX block grid (flash_tile.cuh
// keep(): query blocks bq, key blocks bk, which differ where t_q != t_k). The
// tiles differ from the JAX blocks, so p is rounded relative to another
// running max: agreement with the JAX kernel is to tolerance, not to the bit.
//
// One block per (collapsed row, query tile of R rows), the longest rows of a
// collapsed row first; it holds q in shared memory and walks the streams and
// the key tiles up to the diagonal (every key tile without the mask),
// keeping m, l and the f32 accumulator on chip. Nothing of size t_q * t_k
// reaches device memory.
#pragma once

#include "flash_tile.cuh"

namespace tat {
namespace flash {

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;     // (n, Tq, hs): the output, or the sum over the J streams
  float* lse;    // (n, 1, Tq), or null
  void* outs;    // (J, n, Tq, hs) each stream's output, or null
  float* lses;   // (J, n, 1, Tq) each stream's logsumexp, or null
  int J, n, Tq, Tk, hs, R, bq, bk;  // k, v: (J, n, Tk, hs); bq, bk the JAX blocks
  int causal;
  float scale, keepf;
  uint32_t seed, thresh;
  int on, stream_seeds, vec;
};

template <typename T>
struct FwdLayout {
  int R, hsp, ldh, ldp, lds, lda;
  size_t off_k, off_v, off_p, off_s, off_acc, off_row, bytes;
  __host__ __device__ FwdLayout(int R_, int hs) : R(R_) {
    hsp = Lay<T>::hsp(hs);
    ldh = Lay<T>::ldh(hs);
    ldp = Lay<T>::ldp(R);
    lds = lds_of(R);
    lda = lda_of(hsp);
    const size_t tile = up128((size_t)R * ldh * sizeof(T));
    off_k = tile;  // q at 0
    off_v = off_k + tile;
    off_p = off_v + tile;
    off_s = off_p + up128((size_t)R * ldp * sizeof(T));
    off_acc = off_s + up128((size_t)R * lds * sizeof(float));
    off_row = off_acc + up128((size_t)R * lda * sizeof(float));
    bytes = off_row + 3 * (size_t)R * sizeof(float);
  }
};

// At most 85 registers a thread, so that three blocks of the bf16 hs-64
// layout (~72 KB of shared memory each) stay resident on an SM.
template <typename T, bool kCausal>
__global__ void __launch_bounds__(kThreads, 3) flash_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) char smem[];
  const FwdLayout<T> L(a.R, a.hs);
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + L.off_k);
  T* sv = reinterpret_cast<T*>(smem + L.off_v);
  T* sp = reinterpret_cast<T*>(smem + L.off_p);
  float* ss = reinterpret_cast<float*>(smem + L.off_s);
  float* sacc = reinterpret_cast<float*>(smem + L.off_acc);
  float* sm = reinterpret_cast<float*>(smem + L.off_row);  // running max
  float* sl = sm + a.R;                                     // running row sum
  float* sc = sl + a.R;                                     // this tile's correction

  const int R = a.R, hs = a.hs, hsp = L.hsp;
  const int n_qt = a.Tq / R;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int row = (int)(blockIdx.x / n_qt);
  const int q0 = qt * R;
  // the last key tile: the diagonal one under the causal mask, else all
  const int kt_end = kCausal ? min(qt, a.Tk / R - 1) : a.Tk / R - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qplane = (size_t)a.Tq * hs, kplane = (size_t)a.Tk * hs;
  const T* q = static_cast<const T*>(a.q) + row * qplane;
  T* out = static_cast<T*>(a.out) + row * qplane;

  load_tile<T>(q + (size_t)q0 * hs, R, hs, hsp, sq, L.ldh, a.vec);
  for (int j = 0; j < a.J; ++j) {
    const size_t at = ((size_t)j * a.n + row) * kplane;
    const T* kj = static_cast<const T*>(a.k) + at;
    const T* vj = static_cast<const T*>(a.v) + at;
    const uint32_t seed = a.stream_seeds ? stream_seed(a.seed, j) : a.seed;
    for (int i = threadIdx.x; i < R; i += kThreads) {
      sm[i] = -INFINITY;
      sl[i] = 0.f;
    }
    for (int kt = 0; kt <= kt_end; ++kt) {
      const int k0 = kt * R;
      load_tile<T>(kj + (size_t)k0 * hs, R, hs, hsp, sk, L.ldh, a.vec);
      load_tile<T>(vj + (size_t)k0 * hs, R, hs, hsp, sv, L.ldh, a.vec);
      __syncthreads();
      Mma<T>::template run<false, true>(sq, L.ldh, sk, L.ldh, ss, L.lds, R, R, hsp, false);
      // online softmax, one warp per query row
      for (int i = warp; i < R; i += kWarps) {
        const int r = q0 + i;
        float* srow = ss + i * L.lds;
        float mx = -INFINITY;
        for (int c = lane; c < R; c += 32) {
          const float x = (!kCausal || k0 + c <= r) ? srow[c] * a.scale : -INFINITY;
          srow[c] = x;
          mx = fmaxf(mx, x);
        }
        const float m_old = sm[i], m_new = fmaxf(m_old, warp_max(mx));
        float sum = 0.f;
        const KeepRow kr(a.on, seed, (uint32_t)row, (uint32_t)a.bq, (uint32_t)a.bk,
                         (uint32_t)r, (uint32_t)k0, a.thresh);
        for (int c = lane; c < R; c += 32) {
          const float p = expf(srow[c] - m_new);
          sum += p;
          const bool kept = !a.on || kr((uint32_t)c);
          sp[i * L.ldp + c] = from_f32<T>(kept ? p : 0.f);
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          sl[i] = sl[i] * corr + sum;
          sm[i] = m_new;
          sc[i] = corr;
        }
      }
      __syncthreads();
      if (kt > 0) {
        for (int idx = threadIdx.x; idx < R * hsp; idx += kThreads) {
          const int i = idx / hsp;
          sacc[i * L.lda + idx - i * hsp] *= sc[i];
        }
        __syncthreads();
      }
      Mma<T>::template run<false, false>(sp, L.ldp, sv, L.ldh, sacc, L.lda, R, hsp, R, kt > 0);
    }
    // stream j's output, rounded to q's type, and its logsumexp
    T* outs = a.outs ? static_cast<T*>(a.outs) + ((size_t)j * a.n + row) * qplane : nullptr;
    for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
      const int i = idx / hs, e = idx - i * hs;
      const float o = Io<T>::round(sacc[i * L.lda + e] / (sl[i] * a.keepf));
      const size_t off = (size_t)(q0 + i) * hs + e;
      if (outs) Io<T>::store(outs + off, o);
      Io<T>::store(out + off, j == 0 ? o : Io<T>::load(out + off) + o);
    }
    for (int i = threadIdx.x; i < R; i += kThreads) {
      const float lse = sm[i] + logf(sl[i]);
      if (a.lse) a.lse[(size_t)row * a.Tq + q0 + i] = lse;
      if (a.lses) a.lses[((size_t)j * a.n + row) * a.Tq + q0 + i] = lse;
    }
    __syncthreads();
  }
}

template <typename T, bool kCausal>
int launch_flash_fwd_t(FwdArgs a, cudaStream_t stream) {
  a.R = pick_rows<FwdLayout<T>>(a.hs);
  if (a.R == 0 || a.Tq % a.R != 0 || a.Tk % a.R != 0 || a.bq % a.R != 0 || a.bk % a.R != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)a.n * (a.Tq / a.R);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = FwdLayout<T>(a.R, a.hs).bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, kCausal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T, kCausal><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores, f32 on FMAs; the causal mask or none.
inline int launch_flash_fwd(FwdArgs a, int is_bf16, cudaStream_t stream) {
  a.vec = is_bf16 && a.hs % 8 == 0 && aligned16({a.q, a.k, a.v});
  if (is_bf16)
    return a.causal ? launch_flash_fwd_t<__nv_bfloat16, true>(a, stream)
                    : launch_flash_fwd_t<__nv_bfloat16, false>(a, stream);
  return a.causal ? launch_flash_fwd_t<float, true>(a, stream)
                  : launch_flash_fwd_t<float, false>(a, stream);
}

}  // namespace flash
}  // namespace tat
