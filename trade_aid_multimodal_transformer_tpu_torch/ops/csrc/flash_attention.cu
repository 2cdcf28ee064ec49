// Blockwise (flash) causal self-attention for long T, forward with its
// logsumexp (K5f) and backward (K5b), and the same for one chunk pair of ring
// (context-parallel) attention (K7f, K7b):
//
//   out[r] = softmax_mask(q[r] k[r]^T * hs^-0.5) . v[r],  lse[r] = logsumexp(s[r])
//   dq, dk, dv from q, k, v, lse, dout and delta = rowsum(dout * out).
//
// K7 takes t_q query rows against t_k key rows (both multiples of 128) with
// the top-left causal mask (the diagonal chunk) or none (a chunk of an
// earlier rank), and its backward takes the logsumexp and the output merged
// over the whole ring: p = exp(s - lse) then splits the global softmax per
// chunk exactly. Its dropout is keyed on JAX's query blocks bq = pick(t_q)
// and key blocks bk = pick(t_k) with the chunk pair's seed.
//
// Replaces: trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py,
// _flash_forward / _flash_forward_streamed (_flash_fwd_kernel and its
// KV-streamed twin) for K5f, and _flash_backward_fused, _flash_backward and
// _flash_backward_streamed (_flash_bwd_fused_kernel, _flash_bwd_dq_kernel,
// _flash_bwd_dkv_kernel and their streamed twins) for K5b; flash_chunk_fwd
// and flash_chunk_bwd (the same Pallas kernels with causal=False and t_q !=
// t_k) for K7f and K7b. The TPU's tiers
// exist for its VMEM budget; here every T % 128 == 0 and hs <= 256 runs the
// same two kernels, which hold only tiles on chip. The forward body is
// flash_fwd.cuh's, shared with the cross kernels (flash_cross_attention.cu).
//
// Backward arithmetic as the JAX kernels': per (query tile, key tile) pair
// s = q k^T * scale in f32, p = exp(s - lse) where key <= query (else 0;
// every key without the mask),
// dp = dout v^T; with dropout dp and the dropped p (pd) are masked and
// divided by 1 - rate, the mask regenerated from the salts on the JAX block
// grid; ds = p * (dp - delta) rounded to q's type before the dk and dq
// products, pd rounded to dout's type before the dv product; every gradient
// accumulates in f32 and is rounded once (dq and dk times the scale).
//
// What bounds them on the H100: at the production training shape (n = 192
// rows, T = 1024, hs 64, bf16) the forward moves ~100 MB (q, k, v, out once)
// for ~26 GFLOP of causal products, ~0.030 ms at 3.35 TB/s, and the backward
// does five such products (~64 GFLOP, ~0.065 ms at 989 TFLOP/s). A ring chunk
// pair at context_parallel 2 (n = 192, t_q = t_k = 512, no mask) does 12.9
// GFLOP forward (~0.013 ms, operations) and 32 GFLOP in five products
// backward (~0.033 ms). Both keep every T^2 quantity on chip. The forward's
// bf16 body (flash_fwd.cuh, on mma.sync with S, P and the output in
// registers and the next key/value tile prefetched by cp.async) says there
// what it does about its bound. The backward runs its products on the tensor
// cores (WMMA, bf16; f32 on FMAs) and is two kernels with no atomics, so
// two runs give the same bits: a dq kernel (one block per query tile, walking
// the key tiles up to the diagonal) and a dk/dv kernel (one block per key
// tile, walking the query tiles from the diagonal down); each recomputes p,
// as the JAX package's split tier does. delta is one PyTorch reduction before
// the launch, as the JAX package computes it outside its kernel. The backward
// is a first, simple version: WMMA with accumulators staged through shared
// memory, no TMA, no wgmma, no double buffering.
#include "flash_fwd.cuh"

namespace tat {
namespace flash {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (n, 1, Tq)
  const float* delta;  // (n, Tq)
  void* dq;
  void* dk;
  void* dv;
  int n, Tq, Tk, hs, R, bq, bk;  // q, dout, dq: (n, Tq, hs); k, v, dk, dv: (n, Tk, hs)
  int causal;
  float scale, keepf;
  uint32_t seed, thresh;
  int on, vec;
};

// Shared memory of both backward kernels: four (R, hs) operand tiles, the f32
// scores and dout.v^T, the rounded ds and pd, one or two f32 accumulators and
// two rows of lse / delta.
template <typename T, int kAcc>
struct BwdLayout {
  int R, hsp, ldh, ldp, lds, lda;
  size_t off_t[4], off_s, off_dp, off_ds, off_pd, off_acc[2], off_row, bytes;
  __host__ __device__ BwdLayout(int R_, int hs) : R(R_) {
    hsp = Lay<T>::hsp(hs);
    ldh = Lay<T>::ldh(hs);
    ldp = Lay<T>::ldp(R);
    lds = lds_of(R);
    lda = lda_of(hsp);
    const size_t tile = up128((size_t)R * ldh * sizeof(T));
    const size_t ptile = up128((size_t)R * ldp * sizeof(T));
    const size_t stile = up128((size_t)R * lds * sizeof(float));
    size_t o = 0;
    for (int i = 0; i < 4; ++i, o += tile) off_t[i] = o;
    off_s = o;
    off_dp = off_s + stile;
    off_ds = off_dp + stile;
    off_pd = off_ds + ptile;
    o = off_pd + (kAcc == 2 ? ptile : 0);
    for (int i = 0; i < 2; ++i) {
      off_acc[i] = o;
      if (i < kAcc) o += up128((size_t)R * lda * sizeof(float));
    }
    off_row = o;
    bytes = off_row + 2 * (size_t)R * sizeof(float);
  }
};

// s = q k^T and dp = dout v^T of one tile pair, then p, ds (and with kPd the
// dropped probabilities pd) in place of the rounded tiles.
template <typename T, bool kCausal, bool kPd>
__device__ void tile_grads(const BwdArgs& a, const BwdLayout<T, kPd ? 2 : 1>& L, const T* sq,
                           const T* sdo, const T* sk, const T* sv, float* ss, float* sdp,
                           T* sds, T* spd, const float* slse, const float* sdel, int row,
                           int q0, int k0) {
  const int R = a.R;
  Mma<T>::template run<false, true>(sq, L.ldh, sk, L.ldh, ss, L.lds, R, R, L.hsp, false);
  Mma<T>::template run<false, true>(sdo, L.ldh, sv, L.ldh, sdp, L.lds, R, R, L.hsp, false);
  for (int idx = threadIdx.x; idx < R * R; idx += kThreads) {
    const int i = idx / R, c = idx - i * R;
    const int r = q0 + i, col = k0 + c;
    const float p = (!kCausal || col <= r) ? expf(ss[i * L.lds + c] * a.scale - slse[i]) : 0.f;
    float dp = sdp[i * L.lds + c];
    float pd = p;
    if (a.on) {
      const bool kept = keep(a.seed, (uint32_t)row, (uint32_t)a.bq, (uint32_t)a.bk, (uint32_t)r,
                             (uint32_t)col, a.thresh);
      dp = kept ? dp / a.keepf : 0.f;
      pd = kept ? p / a.keepf : 0.f;
    }
    sds[i * L.ldp + c] = from_f32<T>(p * (dp - sdel[i]));
    if (kPd) spd[i * L.ldp + c] = from_f32<T>(pd);
  }
  __syncthreads();
}

__device__ inline void load_rows_f32(const float* src, int R, float* dst) {
  for (int i = threadIdx.x; i < R; i += kThreads) dst[i] = src[i];
}

// dq of one query tile: key tiles 0..qt under the causal mask (every key tile
// without it), the longest rows first.
template <typename T, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) char smem[];
  const BwdLayout<T, 1> L(a.R, a.hs);
  T* sq = reinterpret_cast<T*>(smem + L.off_t[0]);
  T* sdo = reinterpret_cast<T*>(smem + L.off_t[1]);
  T* sk = reinterpret_cast<T*>(smem + L.off_t[2]);
  T* sv = reinterpret_cast<T*>(smem + L.off_t[3]);
  float* ss = reinterpret_cast<float*>(smem + L.off_s);
  float* sdp = reinterpret_cast<float*>(smem + L.off_dp);
  T* sds = reinterpret_cast<T*>(smem + L.off_ds);
  float* sdq = reinterpret_cast<float*>(smem + L.off_acc[0]);
  float* slse = reinterpret_cast<float*>(smem + L.off_row);
  float* sdel = slse + a.R;

  const int R = a.R, hs = a.hs, hsp = L.hsp;
  const int n_qt = a.Tq / R;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int row = (int)(blockIdx.x / n_qt);
  const int q0 = qt * R;
  const int kt_end = kCausal ? min(qt, a.Tk / R - 1) : a.Tk / R - 1;
  const size_t qbase = row * (size_t)a.Tq * hs, kbase = row * (size_t)a.Tk * hs;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;

  load_tile<T>(static_cast<const T*>(a.q) + qbase + (size_t)q0 * hs, R, hs, hsp, sq, L.ldh,
               a.vec);
  load_tile<T>(static_cast<const T*>(a.dout) + qbase + (size_t)q0 * hs, R, hs, hsp, sdo, L.ldh,
               a.vec);
  load_rows_f32(a.lse + (size_t)row * a.Tq + q0, R, slse);
  load_rows_f32(a.delta + (size_t)row * a.Tq + q0, R, sdel);
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * R;
    load_tile<T>(k + (size_t)k0 * hs, R, hs, hsp, sk, L.ldh, a.vec);
    load_tile<T>(v + (size_t)k0 * hs, R, hs, hsp, sv, L.ldh, a.vec);
    __syncthreads();
    tile_grads<T, kCausal, false>(a, L, sq, sdo, sk, sv, ss, sdp, sds, nullptr, slse, sdel, row,
                                  q0, k0);
    Mma<T>::template run<false, false>(sds, L.ldp, sk, L.ldh, sdq, L.lda, R, hsp, R, kt > 0);
  }
  T* dq = static_cast<T*>(a.dq) + qbase + (size_t)q0 * hs;
  for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
    const int i = idx / hs;
    Io<T>::store(dq + idx, sdq[i * L.lda + idx - i * hs] * a.scale);
  }
}

// dk and dv of one key tile: query tiles kt..n-1 under the causal mask (every
// query tile without it). Under the causal mask a key tile past the last
// query row (t_k > t_q) sees no query: its gradients are zero.
template <typename T, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) char smem[];
  const BwdLayout<T, 2> L(a.R, a.hs);
  T* sk = reinterpret_cast<T*>(smem + L.off_t[0]);
  T* sv = reinterpret_cast<T*>(smem + L.off_t[1]);
  T* sq = reinterpret_cast<T*>(smem + L.off_t[2]);
  T* sdo = reinterpret_cast<T*>(smem + L.off_t[3]);
  float* ss = reinterpret_cast<float*>(smem + L.off_s);
  float* sdp = reinterpret_cast<float*>(smem + L.off_dp);
  T* sds = reinterpret_cast<T*>(smem + L.off_ds);
  T* spd = reinterpret_cast<T*>(smem + L.off_pd);
  float* sdk = reinterpret_cast<float*>(smem + L.off_acc[0]);
  float* sdv = reinterpret_cast<float*>(smem + L.off_acc[1]);
  float* slse = reinterpret_cast<float*>(smem + L.off_row);
  float* sdel = slse + a.R;

  const int R = a.R, hs = a.hs, hsp = L.hsp;
  const int n_kt = a.Tk / R, n_qt = a.Tq / R;
  const int kt = (int)(blockIdx.x % n_kt);  // the longest columns first
  const int row = (int)(blockIdx.x / n_kt);
  const int k0 = kt * R;
  const int qt_begin = kCausal ? kt : 0;
  const size_t qbase = row * (size_t)a.Tq * hs, kbase = row * (size_t)a.Tk * hs;
  const T* q = static_cast<const T*>(a.q) + qbase;
  const T* dout = static_cast<const T*>(a.dout) + qbase;

  load_tile<T>(static_cast<const T*>(a.k) + kbase + (size_t)k0 * hs, R, hs, hsp, sk, L.ldh,
               a.vec);
  load_tile<T>(static_cast<const T*>(a.v) + kbase + (size_t)k0 * hs, R, hs, hsp, sv, L.ldh,
               a.vec);
  if (qt_begin >= n_qt) {
    for (int idx = threadIdx.x; idx < R * hsp; idx += kThreads) {
      const int i = idx / hsp, at = i * L.lda + idx - i * hsp;
      sdk[at] = 0.f;
      sdv[at] = 0.f;
    }
    __syncthreads();
  }
  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * R;
    load_tile<T>(q + (size_t)q0 * hs, R, hs, hsp, sq, L.ldh, a.vec);
    load_tile<T>(dout + (size_t)q0 * hs, R, hs, hsp, sdo, L.ldh, a.vec);
    load_rows_f32(a.lse + (size_t)row * a.Tq + q0, R, slse);
    load_rows_f32(a.delta + (size_t)row * a.Tq + q0, R, sdel);
    __syncthreads();
    tile_grads<T, kCausal, true>(a, L, sq, sdo, sk, sv, ss, sdp, sds, spd, slse, sdel, row, q0,
                                 k0);
    // dv += pd^T dout, dk += ds^T q
    Mma<T>::template run<true, false>(spd, L.ldp, sdo, L.ldh, sdv, L.lda, R, hsp, R,
                                      qt > qt_begin);
    Mma<T>::template run<true, false>(sds, L.ldp, sq, L.ldh, sdk, L.lda, R, hsp, R,
                                      qt > qt_begin);
  }
  T* dk = static_cast<T*>(a.dk) + kbase + (size_t)k0 * hs;
  T* dv = static_cast<T*>(a.dv) + kbase + (size_t)k0 * hs;
  for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
    const int i = idx / hs, at = i * L.lda + idx - i * hs;
    Io<T>::store(dk + idx, sdk[at] * a.scale);
    Io<T>::store(dv + idx, sdv[at]);
  }
}

template <typename Layout, typename Kernel>
int launch_bwd_kernel(Kernel kernel, const BwdArgs& a, long long blocks, cudaStream_t stream) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = Layout(a.R, a.hs).bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool kCausal>
int launch_flash_bwd_t(BwdArgs a, cudaStream_t stream) {
  // one tile height for both kernels: the dk/dv layout is the larger
  a.R = pick_rows<BwdLayout<T, 2>>(a.hs);
  if (a.R == 0 || a.Tq % a.R != 0 || a.Tk % a.R != 0 || a.bq % a.R != 0 || a.bk % a.R != 0)
    return (int)cudaErrorInvalidValue;
  int err = launch_bwd_kernel<BwdLayout<T, 1>>(flash_bwd_dq_kernel<T, kCausal>, a,
                                               (long long)a.n * (a.Tq / a.R), stream);
  if (err != 0) return err;
  return launch_bwd_kernel<BwdLayout<T, 2>>(flash_bwd_dkv_kernel<T, kCausal>, a,
                                            (long long)a.n * (a.Tk / a.R), stream);
}

inline int launch_flash_bwd(BwdArgs a, int is_bf16, cudaStream_t stream) {
  a.vec = is_bf16 && a.hs % 8 == 0 && aligned16({a.q, a.k, a.v, a.dout});
  if (is_bf16)
    return a.causal ? launch_flash_bwd_t<__nv_bfloat16, true>(a, stream)
                    : launch_flash_bwd_t<__nv_bfloat16, false>(a, stream);
  return a.causal ? launch_flash_bwd_t<float, true>(a, stream)
                  : launch_flash_bwd_t<float, false>(a, stream);
}

int chunk_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int n, int Tq,
              int Tk, int hs, int causal, int is_bf16, float scale, unsigned seed,
              unsigned thresh, int rate_on, float keepf, int bq, int bk, void* stream) {
  FwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse = static_cast<float*>(lse);
  a.J = 1; a.n = n; a.Tq = Tq; a.Tk = Tk; a.hs = hs; a.bq = bq; a.bk = bk; a.causal = causal;
  a.scale = scale; a.keepf = keepf; a.seed = seed; a.thresh = thresh; a.on = rate_on;
  a.stream_seeds = 0;
  return launch_flash_fwd(a, is_bf16, static_cast<cudaStream_t>(stream));
}

int chunk_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, void* dk, void* dv, int n, int Tq, int Tk, int hs,
              int causal, int is_bf16, float scale, unsigned seed, unsigned thresh, int rate_on,
              float keepf, int bq, int bk, void* stream) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse); a.delta = static_cast<const float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.n = n; a.Tq = Tq; a.Tk = Tk; a.hs = hs; a.bq = bq; a.bk = bk; a.causal = causal;
  a.scale = scale; a.keepf = keepf; a.seed = seed; a.thresh = thresh; a.on = rate_on;
  return launch_flash_bwd(a, is_bf16, static_cast<cudaStream_t>(stream));
}

}  // namespace flash
}  // namespace tat

// K5f. q, k, v, out (n, T, hs), one type (bf16 or f32), contiguous; lse
// (n, 1, T) f32. Dropout (rate_on) keeps score (row, col) of collapsed row i
// by the hash of (seed, i, row / blk, col / blk, row % blk, col % blk) against
// thresh, blk the JAX kernels' block (flash_pick_block(T)); keepf is 1 - rate.
// Returns the cudaError_t of the launch.
extern "C" int tat_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int n, int T, int hs, int is_bf16,
                                       float scale, unsigned seed, unsigned thresh, int rate_on,
                                       float keepf, int blk, void* stream) {
  return tat::flash::chunk_fwd(q, k, v, out, lse, n, T, T, hs, 1, is_bf16, scale, seed, thresh,
                               rate_on, keepf, blk, blk, stream);
}

// K5b. dq, dk, dv (n, T, hs) in the inputs' type from q, k, v, dout, the
// forward's lse (n, 1, T) and delta = rowsum(dout * out) (n, T), both f32.
// Dropout as the forward's (seed already offset for a cross stream). Two
// launches on the stream; returns the first cudaError_t that is not 0.
extern "C" int tat_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, void* dk, void* dv, int n, int T, int hs,
                                       int is_bf16, float scale, unsigned seed, unsigned thresh,
                                       int rate_on, float keepf, int blk, void* stream) {
  return tat::flash::chunk_bwd(q, k, v, dout, lse, delta, dq, dk, dv, n, T, T, hs, 1, is_bf16,
                               scale, seed, thresh, rate_on, keepf, blk, blk, stream);
}

// K7f. q, out (n, Tq, hs), k, v (n, Tk, hs), one type (bf16 or f32),
// contiguous; lse (n, 1, Tq) f32. causal: the top-left causal mask, else
// none. Dropout keeps score (row, col) of collapsed row i by the hash of
// (seed, i, row / bq, col / bk, row % bq, col % bk), bq and bk the JAX
// blocks of Tq and Tk. Returns the cudaError_t of the launch.
extern "C" int tat_flash_chunk_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int n, int Tq, int Tk, int hs, int causal,
                                   int is_bf16, float scale, unsigned seed, unsigned thresh,
                                   int rate_on, float keepf, int bq, int bk, void* stream) {
  return tat::flash::chunk_fwd(q, k, v, out, lse, n, Tq, Tk, hs, causal, is_bf16, scale, seed,
                               thresh, rate_on, keepf, bq, bk, stream);
}

// K7b. dq (n, Tq, hs), dk, dv (n, Tk, hs) in the inputs' type from q, k, v,
// dout, a logsumexp lse (n, 1, Tq) given by the caller (the ring-merged one)
// and delta = rowsum(dout * out) (n, Tq) of the merged output. Mask and
// dropout as K7f's. Two launches; returns the first cudaError_t that is not 0.
extern "C" int tat_flash_chunk_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int n, int Tq, int Tk, int hs,
                                   int causal, int is_bf16, float scale, unsigned seed,
                                   unsigned thresh, int rate_on, float keepf, int bq, int bk,
                                   void* stream) {
  return tat::flash::chunk_bwd(q, k, v, dout, lse, delta, dq, dk, dv, n, Tq, Tk, hs, causal,
                               is_bf16, scale, seed, thresh, rate_on, keepf, bq, bk, stream);
}
