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
// every key without the mask), dp = dout v^T; with dropout dp and the
// dropped p (pd) are masked and scaled by 1 / (1 - rate), the mask
// regenerated from the salts on the JAX block grid; ds = p * (dp - delta)
// rounded to q's type before the dk and dq products, pd rounded to dout's
// type before the dv product; every gradient accumulates in f32 and is
// rounded once (dq and dk times the scale). delta = rowsum(dout * out) is
// one PyTorch reduction before the launch, as the JAX package computes it
// outside its kernel.
//
// What bounds them on the H100: at the production training shape (n = 192
// rows, T = 1024, hs 64, bf16) the forward moves ~100 MB (q, k, v, out once)
// for ~26 GFLOP of causal products, ~0.030 ms at 3.35 TB/s, and the backward
// does five such products (~64 GFLOP, ~0.065 ms at 989 TFLOP/s). A ring chunk
// pair at context_parallel 2 (n = 192, t_q = t_k = 512, no mask) does 12.9
// GFLOP forward (~0.013 ms, operations) and 32 GFLOP in five products
// backward (~0.033 ms). Both keep every T^2 quantity on chip. The forward's
// bf16 body (flash_fwd.cuh) says there what it does about its bound.
//
// The backward is two kernels with no atomics, so two runs give the same
// bits: FlashAttention-2's deterministic split (the JAX package's split
// tier), a dq kernel over query tiles and a dk/dv kernel over key tiles,
// each recomputing p. It issues seven products where the bound counts five
// (S and dP in both), the price of no atomics. bf16 (every model path) runs
// them on mma.sync m16n8k16 (flash_mma.cuh): a block of 4 warps owns 64
// rows, 16 a warp (its query rows in the dq kernel, its key rows in the
// dk/dv kernel, the transposed problem), copies its own two operands once
// into shared memory (at D = 64 their A fragments then stay in registers),
// and walks tiles of the other two (64 rows; 32 at D = 128 and 256) through
// a ring of two stages filled by cp.async, the next tile in flight while
// this one is computed, one barrier a tile. A warp takes its tile in slabs
// (16 keys in the dq kernel, 32 queries in the dk/dv kernel): the scores
// and dP of the slab, p, the dropout bit of each held element (KeepRow;
// the dk/dv kernel hashes key-major, KeepCol), ds and pd (packed from the C
// fragments into the next product's A fragments) stay in registers, as do
// the f32 gradients; only slabs that cross a warp's diagonal test the mask,
// and a warp skips the slabs wholly past it. The dk/dv kernel reads its
// query tiles' lse and delta rows with the tile. At D = 256 dk and dv would
// take 256 registers a thread, so two groups of 4 warps split D, each
// computing the scores of its 16 rows. Rows are padded to D + 8 elements
// (zeros beyond hs), so ldmatrix finds no bank conflict; hs not a multiple
// of 8 takes element copies and stores. What it leaves: each warp reads
// whole tiles through ldmatrix (wgmma would read them once per 4 warps),
// 8 (dk/dv) or 12 (dq) warps an SM hide the serial S -> p -> dP -> ds
// chain, and the dropout hash is paid in both kernels.
//
// f32 (the correctness gates only) runs the same split on FMAs (flash_tile.cuh
// mma_f32), tiles and accumulators in shared memory.
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

// ------------------------------------------------------------- f32 body

// Shared memory of both f32 backward kernels: four (R, hs) operand tiles,
// the scores and dout.v^T, ds and pd, one or two accumulators and two rows
// of lse / delta.
template <int kAcc>
struct BwdLayout {
  int R, ldh, ldp, lds, lda;
  size_t off_t[4], off_s, off_dp, off_ds, off_pd, off_acc[2], off_row, bytes;
  __host__ __device__ BwdLayout(int R_, int hs) : R(R_) {
    ldh = ldh_of(hs);
    ldp = ldp_of(R);
    lds = lds_of(R);
    lda = lda_of(hs);
    const size_t tile = up128((size_t)R * ldh * sizeof(float));
    const size_t ptile = up128((size_t)R * ldp * sizeof(float));
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
// dropped probabilities pd) in place.
template <bool kCausal, bool kPd>
__device__ void tile_grads(const BwdArgs& a, const BwdLayout<kPd ? 2 : 1>& L, const float* sq,
                           const float* sdo, const float* sk, const float* sv, float* ss,
                           float* sdp, float* sds, float* spd, const float* slse,
                           const float* sdel, uint32_t mrow, int q0, int k0) {
  const int R = a.R;
  mma_f32<false, true>(sq, L.ldh, sk, L.ldh, ss, L.lds, R, R, a.hs, false);
  mma_f32<false, true>(sdo, L.ldh, sv, L.ldh, sdp, L.lds, R, R, a.hs, false);
  for (int idx = threadIdx.x; idx < R * R; idx += kThreads) {
    const int i = idx / R, c = idx - i * R;
    const int r = q0 + i, col = k0 + c;
    const float p = (!kCausal || col <= r) ? expf(ss[i * L.lds + c] * a.scale - slse[i]) : 0.f;
    float dp = sdp[i * L.lds + c];
    float pd = p;
    if (a.on) {
      const bool kept = keep(a.seed, mrow, (uint32_t)a.bq, (uint32_t)a.bk, (uint32_t)r,
                             (uint32_t)col, a.thresh);
      dp = kept ? dp / a.keepf : 0.f;
      pd = kept ? p / a.keepf : 0.f;
    }
    sds[i * L.ldp + c] = p * (dp - sdel[i]);
    if (kPd) spd[i * L.ldp + c] = pd;
  }
  __syncthreads();
}

__device__ inline void load_rows_f32(const float* src, int R, float* dst) {
  for (int i = threadIdx.x; i < R; i += kThreads) dst[i] = src[i];
}

// dq of one query tile: key tiles 0..qt under the causal mask (every key tile
// without it), the longest rows first.
template <bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a,
                                                                   const FlashRows rm) {
  extern __shared__ __align__(128) char smem[];
  const BwdLayout<1> L(a.R, a.hs);
  float* sq = reinterpret_cast<float*>(smem + L.off_t[0]);
  float* sdo = reinterpret_cast<float*>(smem + L.off_t[1]);
  float* sk = reinterpret_cast<float*>(smem + L.off_t[2]);
  float* sv = reinterpret_cast<float*>(smem + L.off_t[3]);
  float* ss = reinterpret_cast<float*>(smem + L.off_s);
  float* sdp = reinterpret_cast<float*>(smem + L.off_dp);
  float* sds = reinterpret_cast<float*>(smem + L.off_ds);
  float* sdq = reinterpret_cast<float*>(smem + L.off_acc[0]);
  float* slse = reinterpret_cast<float*>(smem + L.off_row);
  float* sdel = slse + a.R;

  const int R = a.R, hs = a.hs;
  const int n_qt = a.Tq / R;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int row = (int)(blockIdx.x / n_qt);
  const uint32_t mrow = rm(row);  // the row's mask row
  const int q0 = qt * R;
  const int kt_end = kCausal ? min(qt, a.Tk / R - 1) : a.Tk / R - 1;
  const size_t qbase = row * (size_t)a.Tq * hs, kbase = row * (size_t)a.Tk * hs;
  const float* k = static_cast<const float*>(a.k) + kbase;
  const float* v = static_cast<const float*>(a.v) + kbase;

  load_tile(static_cast<const float*>(a.q) + qbase + (size_t)q0 * hs, R, hs, sq, L.ldh);
  load_tile(static_cast<const float*>(a.dout) + qbase + (size_t)q0 * hs, R, hs, sdo, L.ldh);
  load_rows_f32(a.lse + (size_t)row * a.Tq + q0, R, slse);
  load_rows_f32(a.delta + (size_t)row * a.Tq + q0, R, sdel);
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * R;
    load_tile(k + (size_t)k0 * hs, R, hs, sk, L.ldh);
    load_tile(v + (size_t)k0 * hs, R, hs, sv, L.ldh);
    __syncthreads();
    tile_grads<kCausal, false>(a, L, sq, sdo, sk, sv, ss, sdp, sds, nullptr, slse, sdel, mrow, q0,
                               k0);
    mma_f32<false, false>(sds, L.ldp, sk, L.ldh, sdq, L.lda, R, hs, R, kt > 0);
  }
  float* dq = static_cast<float*>(a.dq) + qbase + (size_t)q0 * hs;
  for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
    const int i = idx / hs;
    dq[idx] = sdq[i * L.lda + idx - i * hs] * a.scale;
  }
}

// dk and dv of one key tile: query tiles kt..n-1 under the causal mask (every
// query tile without it). Under the causal mask a key tile past the last
// query row (t_k > t_q) sees no query: its gradients are zero.
template <bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdArgs a,
                                                                    const FlashRows rm) {
  extern __shared__ __align__(128) char smem[];
  const BwdLayout<2> L(a.R, a.hs);
  float* sk = reinterpret_cast<float*>(smem + L.off_t[0]);
  float* sv = reinterpret_cast<float*>(smem + L.off_t[1]);
  float* sq = reinterpret_cast<float*>(smem + L.off_t[2]);
  float* sdo = reinterpret_cast<float*>(smem + L.off_t[3]);
  float* ss = reinterpret_cast<float*>(smem + L.off_s);
  float* sdp = reinterpret_cast<float*>(smem + L.off_dp);
  float* sds = reinterpret_cast<float*>(smem + L.off_ds);
  float* spd = reinterpret_cast<float*>(smem + L.off_pd);
  float* sdk = reinterpret_cast<float*>(smem + L.off_acc[0]);
  float* sdv = reinterpret_cast<float*>(smem + L.off_acc[1]);
  float* slse = reinterpret_cast<float*>(smem + L.off_row);
  float* sdel = slse + a.R;

  const int R = a.R, hs = a.hs;
  const int n_kt = a.Tk / R, n_qt = a.Tq / R;
  const int kt = (int)(blockIdx.x % n_kt);  // the longest columns first
  const int row = (int)(blockIdx.x / n_kt);
  const uint32_t mrow = rm(row);  // the row's mask row
  const int k0 = kt * R;
  const int qt_begin = kCausal ? kt : 0;
  const size_t qbase = row * (size_t)a.Tq * hs, kbase = row * (size_t)a.Tk * hs;
  const float* q = static_cast<const float*>(a.q) + qbase;
  const float* dout = static_cast<const float*>(a.dout) + qbase;

  load_tile(static_cast<const float*>(a.k) + kbase + (size_t)k0 * hs, R, hs, sk, L.ldh);
  load_tile(static_cast<const float*>(a.v) + kbase + (size_t)k0 * hs, R, hs, sv, L.ldh);
  if (qt_begin >= n_qt) {
    for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
      const int i = idx / hs, at = i * L.lda + idx - i * hs;
      sdk[at] = 0.f;
      sdv[at] = 0.f;
    }
    __syncthreads();
  }
  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * R;
    load_tile(q + (size_t)q0 * hs, R, hs, sq, L.ldh);
    load_tile(dout + (size_t)q0 * hs, R, hs, sdo, L.ldh);
    load_rows_f32(a.lse + (size_t)row * a.Tq + q0, R, slse);
    load_rows_f32(a.delta + (size_t)row * a.Tq + q0, R, sdel);
    __syncthreads();
    tile_grads<kCausal, true>(a, L, sq, sdo, sk, sv, ss, sdp, sds, spd, slse, sdel, mrow, q0, k0);
    // dv += pd^T dout, dk += ds^T q
    mma_f32<true, false>(spd, L.ldp, sdo, L.ldh, sdv, L.lda, R, hs, R, qt > qt_begin);
    mma_f32<true, false>(sds, L.ldp, sq, L.ldh, sdk, L.lda, R, hs, R, qt > qt_begin);
  }
  float* dk = static_cast<float*>(a.dk) + kbase + (size_t)k0 * hs;
  float* dv = static_cast<float*>(a.dv) + kbase + (size_t)k0 * hs;
  for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
    const int i = idx / hs, at = i * L.lda + idx - i * hs;
    dk[idx] = sdk[at] * a.scale;
    dv[idx] = sdv[at];
  }
}

template <typename Kernel>
int launch_bwd(Kernel kernel, int threads, size_t smem, long long blocks, const BwdArgs& a,
               FlashRows rm, cudaStream_t stream) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(a, rm);
  return (int)cudaGetLastError();
}

template <bool kCausal>
int launch_flash_bwd_f32(BwdArgs a, FlashRows rm, cudaStream_t stream) {
  // one tile height for both kernels: the dk/dv layout is the larger
  a.R = pick_rows<BwdLayout<2>>(a.hs);
  if (a.R == 0 || a.Tq % a.R != 0 || a.Tk % a.R != 0 || a.bq % a.R != 0 || a.bk % a.R != 0)
    return (int)cudaErrorInvalidValue;
  const int err = launch_bwd(flash_bwd_dq_kernel<kCausal>, kThreads, BwdLayout<1>(a.R, a.hs).bytes,
                             (long long)a.n * (a.Tq / a.R), a, rm, stream);
  if (err != 0) return err;
  return launch_bwd(flash_bwd_dkv_kernel<kCausal>, kThreads, BwdLayout<2>(a.R, a.hs).bytes,
                    (long long)a.n * (a.Tk / a.R), a, rm, stream);
}

// ------------------------------------------------------------- bf16 body

// Tiles of the bf16 backward kernels for the padded head size D (64, 128,
// 256). A block owns kRows = 64 rows of its own two operands (the query rows
// and their dout rows for dq; the key and value rows for dk and dv), 16 a
// warp of a group of four, and walks tiles of kCols rows of the other two
// through a ring of kStages stages, rows kLd bf16 apart. kSplit groups of
// warps share the block's rows and each holds a D / kSplit slice of the
// gradients (kDs columns): at D = 256 dk and dv alone would take 256
// registers a thread, so two groups split D, each computing the scores of
// its rows in full.
template <int D>
struct MmaBwd {
  static constexpr int kSplit = D == 256 ? 2 : 1;
  static constexpr int kWarps = 4 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 64;
  static constexpr int kCols = D == 64 ? 64 : 32;
  static constexpr int kDs = D / kSplit;
  // queries of a slab of the dk/dv kernel, whose scores it holds at a time
  // (the dq kernel takes slabs of 16 keys)
  static constexpr int kSlab = 32;
  static constexpr int kLd = D + 8;
  // the A fragments of the block's own operands held in registers for the
  // whole block at D = 64 (32 registers), re-read per slab above
  static constexpr bool kOwnRegs = D == 64;
  // resident blocks an SM: at D = 64 three of the dq kernel (168 registers
  // a thread, no spill) and two of the dk/dv kernel (at three it spilled);
  // two at D = 128; one at D = 256 (8 warps, 136 KB)
  static constexpr int kDqBlocks = D == 64 ? 3 : (D == 128 ? 2 : 1);
  static constexpr int kDkvBlocks = D == 256 ? 1 : 2;
  static constexpr int kStages = 2;
  static constexpr size_t kOwnBytes = 2 * (size_t)kRows * kLd * 2;
  static constexpr size_t kTileBytes = (size_t)kCols * kLd * 2;
  // a stage: two operand tiles, then (dk/dv) the query rows' lse and delta
  static constexpr size_t kStageBytes = 2 * kTileBytes + 2 * kCols * sizeof(float);
  static constexpr size_t kBytes = kOwnBytes + kStages * kStageBytes;
};

constexpr float kLog2e = 1.4426950408889634f;

// dq of kRows query rows (see the note at the top): the key tiles up to the
// diagonal, the longest query tiles first over every collapsed row.
template <int D, bool kCausal, bool kMapped>
__global__ void __launch_bounds__(MmaBwd<D>::kThreads, MmaBwd<D>::kDqBlocks)
    flash_bwd_dq_mma_kernel(const BwdArgs a, const FlashRows rm) {
  using C = MmaBwd<D>;
  using bf16 = __nv_bfloat16;
  constexpr int kBr = C::kRows, kBc = C::kCols, kLd = C::kLd;
  constexpr int kGn = C::kDs / 8;  // n8 tiles of a warp's gradient slice
  extern __shared__ __align__(128) char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kBr * kLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp % 4, d0 = (warp / 4) * C::kDs;  // the warp's rows and gradient columns
  const int n_qt = a.Tq / kBr;
  const int qt = n_qt - 1 - (int)(blockIdx.x / a.n);
  const int row = (int)(blockIdx.x % a.n);
  const int q0 = qt * kBr, w0 = q0 + 16 * grp;
  const int n_kt = a.Tk / kBc;
  // the block's key tiles and the warp's last: up to the diagonal under the
  // causal mask (a warp skips the tiles wholly above its rows), else all
  const int tiles = kCausal ? min((q0 + kBr - 1) / kBc, n_kt - 1) + 1 : n_kt;
  const int kt_warp = kCausal ? min((w0 + 15) / kBc, n_kt - 1) : n_kt - 1;
  const int hs = a.hs;
  const size_t qplane = (size_t)a.Tq * hs, kplane = (size_t)a.Tk * hs;
  const int r0 = w0 + mma::frag_row(lane, 0), r1 = r0 + 8;  // this thread's query rows
  const bf16* sw = sq + 16 * grp * kLd;
  const bf16* sdw = sdo + 16 * grp * kLd;
  const bf16* k = static_cast<const bf16*>(a.k) + row * kplane;
  const bf16* v = static_cast<const bf16*>(a.v) + row * kplane;

  auto stage = [&](int kt) {
    return reinterpret_cast<bf16*>(smem + C::kOwnBytes + (kt % C::kStages) * C::kStageBytes);
  };
  // one commit group for each key tile, empty past the last
  auto load_kv = [&](int kt) {
    if (kt < tiles) {
      bf16* st = stage(kt);
      const size_t at = (size_t)kt * kBc * hs;
      load_rows_async<D, kBc, C::kThreads>(st, k + at, hs, a.vec);
      load_rows_async<D, kBc, C::kThreads>(st + kBc * kLd, v + at, hs, a.vec);
    }
    mma::cp_async_commit();
  };
  const size_t at_q = row * qplane + (size_t)q0 * hs;
  load_rows_async<D, kBr, C::kThreads>(sq, static_cast<const bf16*>(a.q) + at_q, hs, a.vec);
  load_rows_async<D, kBr, C::kThreads>(sdo, static_cast<const bf16*>(a.dout) + at_q, hs, a.vec);
  load_kv(0);

  const float sl2 = a.scale * kLog2e;  // exp(s scale - lse) = exp2(s sl2 - lse log2 e)
  const float inv_keep = 1.f / a.keepf;
  float lse2[2], del[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = (size_t)row * a.Tq + (h ? r1 : r0);
    lse2[h] = a.lse[at] * kLog2e;
    del[h] = a.delta[at];
  }
  uint32_t qf[C::kOwnRegs ? D / 16 : 1][4], df[C::kOwnRegs ? D / 16 : 1][4];
  float dq[kGn][4];
#pragma unroll
  for (int dt = 0; dt < kGn; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[dt][i] = 0.f;

  for (int kt = 0; kt < tiles; ++kt) {
    mma::cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1's stage
    load_kv(kt + C::kStages - 1);
    if constexpr (C::kOwnRegs) {
      if (kt == 0)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          mma::ldsm_x4(qf[kk], mma::a_frag_addr(sw, kLd, 0, 16 * kk, lane));
          mma::ldsm_x4(df[kk], mma::a_frag_addr(sdw, kLd, 0, 16 * kk, lane));
        }
    }
    if (kt > kt_warp) continue;
    const bf16* sk = stage(kt);
    const bf16* sv = sk + kBc * kLd;
    const int k0 = kt * kBc;
    // slab by slab of 16 keys (k0 + 16 kk ..): S = q k^T and dP = dout v^T
    // (16 rows x 16 keys), ds, dQ += dS K
    const KeepRow kr0(a.on, a.seed, mask_row<kMapped>(rm, row), (uint32_t)a.bq,
                      (uint32_t)a.bk, (uint32_t)r0, (uint32_t)k0, a.thresh);
    const KeepRow kr1(a.on, a.seed, mask_row<kMapped>(rm, row), (uint32_t)a.bq,
                      (uint32_t)a.bk, (uint32_t)r1, (uint32_t)k0, a.thresh);
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      const int c16 = k0 + 16 * kk;
      if (kCausal && c16 > w0 + 15) break;  // this slab and the rest are past the warp's rows
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t af[4], bf[4], b[4];
        if constexpr (C::kOwnRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            af[i] = qf[kd][i];
            bf[i] = df[kd][i];
          }
        } else {
          mma::ldsm_x4(af, mma::a_frag_addr(sw, kLd, 0, 16 * kd, lane));
          mma::ldsm_x4(bf, mma::a_frag_addr(sdw, kLd, 0, 16 * kd, lane));
        }
        mma::ldsm_x4(b, mma::bt_frag_addr(sk, kLd, 16 * kk, 16 * kd, lane));
        mma::mma_bf16(s[0], af, b[0], b[1]);
        mma::mma_bf16(s[1], af, b[2], b[3]);
        mma::ldsm_x4(b, mma::bt_frag_addr(sv, kLd, 16 * kk, 16 * kd, lane));
        mma::mma_bf16(dp[0], bf, b[0], b[1]);
        mma::mma_bf16(dp[1], bf, b[2], b[3]);
      }
      // element i of n8 tile u (row r0 or r1, key k0 + c): p = exp(s - lse),
      // zero above the diagonal (only the slabs that cross the warp's
      // diagonal test it); ds = p (dp dropped and scaled by the kept share,
      // - delta), rounded to bf16 and packed as dQ's A fragment
      const bool diag = kCausal && c16 + 15 > w0;
      uint32_t af[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const uint32_t c = 16 * kk + 8 * u + mma::frag_col(lane, i);
          float p = mma::exp2_approx(fmaf(s[u][i], sl2, -lse2[h]));
          if (diag && k0 + (int)c > (h ? r1 : r0)) p = 0.f;
          float g = dp[u][i];
          if (a.on) g = (h ? kr1(c) : kr0(c)) ? g * inv_keep : 0.f;
          d[i] = p * (g - del[h]);
        }
        af[2 * u] = mma::pack_bf16(d[0], d[1]);
        af[2 * u + 1] = mma::pack_bf16(d[2], d[3]);
      }
#pragma unroll
      for (int dt = 0; dt < kGn; dt += 2) {
        uint32_t b[4];
        mma::ldsm_x4_trans(b, mma::a_frag_addr(sk, kLd, 16 * kk, d0 + 8 * dt, lane));
        mma::mma_bf16(dq[dt], af, b[0], b[1]);
        mma::mma_bf16(dq[dt + 1], af, b[2], b[3]);
      }
    }
  }

  // dq times the scale, rounded once, stored through the warp's rows of q
  // (the other group of a split block reads them until this barrier)
  if constexpr (C::kSplit > 1) __syncthreads();
  uint32_t out[kGn][2];
#pragma unroll
  for (int dt = 0; dt < kGn; ++dt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      out[dt][h] = mma::pack_bf16(dq[dt][2 * h] * a.scale, dq[dt][2 * h + 1] * a.scale);
  store_rows<D, C::kDs>(static_cast<bf16*>(a.dq) + row * qplane + (size_t)w0 * hs,
                        sq + 16 * grp * kLd, out, hs, a.vec, lane, d0);
}

// dk and dv of kRows key rows (see the note at the top): the query tiles
// from the diagonal on under the causal mask (a key tile past the last
// query row sees none, and stores zeros), every query tile without it; the
// longest key columns first over every collapsed row.
template <int D, bool kCausal, bool kMapped>
__global__ void __launch_bounds__(MmaBwd<D>::kThreads, MmaBwd<D>::kDkvBlocks)
    flash_bwd_dkv_mma_kernel(const BwdArgs a, const FlashRows rm) {
  using C = MmaBwd<D>;
  using bf16 = __nv_bfloat16;
  constexpr int kBk = C::kRows, kBq = C::kCols, kLd = C::kLd;
  constexpr int kSlab = C::kSlab, kSn = kSlab / 8;  // queries a slab, its n8 tiles
  constexpr int kGn = C::kDs / 8;  // n8 tiles of a warp's gradient slice
  extern __shared__ __align__(128) char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kBk * kLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp % 4, d0 = (warp / 4) * C::kDs;
  const int kt = (int)(blockIdx.x / a.n);  // the longest columns first
  const int row = (int)(blockIdx.x % a.n);
  const int k0 = kt * kBk, wk0 = k0 + 16 * grp;  // the block's and the warp's first key
  const int n_qt = a.Tq / kBq;
  // the block's first query tile and the warp's: the one holding the query
  // of the same index as the first key under the causal mask (the tiles
  // before it are wholly above the diagonal), else 0
  const int qt0 = kCausal ? min(k0 / kBq, n_qt) : 0;
  const int qt_warp = kCausal ? wk0 / kBq : 0;
  const int tiles = n_qt - qt0;
  const int hs = a.hs;
  const size_t qplane = (size_t)a.Tq * hs, kplane = (size_t)a.Tk * hs;
  const int kr0 = wk0 + mma::frag_row(lane, 0), kr1 = kr0 + 8;  // this thread's keys
  const int c0 = mma::frag_col(lane, 0);
  const bf16* skw = sk + 16 * grp * kLd;
  const bf16* svw = sv + 16 * grp * kLd;
  const bf16* q = static_cast<const bf16*>(a.q) + row * qplane;
  const bf16* dout = static_cast<const bf16*>(a.dout) + row * qplane;
  const float* lse = a.lse + (size_t)row * a.Tq;
  const float* delta = a.delta + (size_t)row * a.Tq;

  auto stage = [&](int it) {
    return reinterpret_cast<bf16*>(smem + C::kOwnBytes + (it % C::kStages) * C::kStageBytes);
  };
  // one commit group for each query tile (q, dout, lse and delta rows),
  // empty past the last
  auto load_q = [&](int it) {
    if (it < tiles) {
      bf16* st = stage(it);
      const int q0 = (qt0 + it) * kBq;
      load_rows_async<D, kBq, C::kThreads>(st, q + (size_t)q0 * hs, hs, a.vec);
      load_rows_async<D, kBq, C::kThreads>(st + kBq * kLd, dout + (size_t)q0 * hs, hs, a.vec);
      float* rows = reinterpret_cast<float*>(st + 2 * kBq * kLd);
      for (int i = threadIdx.x; i < 2 * kBq; i += C::kThreads)
        mma::cp_async4(rows + i, (i < kBq ? lse : delta) + q0 + i % kBq);
    }
    mma::cp_async_commit();
  };
  const size_t at_k = row * kplane + (size_t)k0 * hs;
  load_rows_async<D, kBk, C::kThreads>(sk, static_cast<const bf16*>(a.k) + at_k, hs, a.vec);
  load_rows_async<D, kBk, C::kThreads>(sv, static_cast<const bf16*>(a.v) + at_k, hs, a.vec);
  load_q(0);

  const float sl2 = a.scale * kLog2e;
  const float inv_keep = 1.f / a.keepf;
  uint32_t kf[C::kOwnRegs ? D / 16 : 1][4], vf[C::kOwnRegs ? D / 16 : 1][4];
  float dk[kGn][4], dv[kGn][4];
#pragma unroll
  for (int dt = 0; dt < kGn; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[dt][i] = dv[dt][i] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    mma::cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1's stage
    load_q(it + C::kStages - 1);
    if constexpr (C::kOwnRegs) {
      if (it == 0)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          mma::ldsm_x4(kf[kk], mma::a_frag_addr(skw, kLd, 0, 16 * kk, lane));
          mma::ldsm_x4(vf[kk], mma::a_frag_addr(svw, kLd, 0, 16 * kk, lane));
        }
    }
    const int qt = qt0 + it;
    if (qt < qt_warp) continue;  // every query of the tile is above the warp's keys
    const bf16* sq = stage(it);
    const bf16* sdo = sq + kBq * kLd;
    const float* slse = reinterpret_cast<const float*>(sq + 2 * kBq * kLd);
    const float* sdel = slse + kBq;
    const int q0 = qt * kBq;
    // slab by slab of kSlab queries (q0 + kSlab kk ..): S^T = k q^T, p, pd,
    // dV += pd^T dout, dP^T = v dout^T, ds, dK += dS^T q
    const KeepCol kc0(a.on, a.seed, mask_row<kMapped>(rm, row), (uint32_t)a.bq, (uint32_t)a.bk,
                      (uint32_t)q0, (uint32_t)kr0, a.thresh);
    const KeepCol kc1(a.on, a.seed, mask_row<kMapped>(rm, row), (uint32_t)a.bq, (uint32_t)a.bk,
                      (uint32_t)q0, (uint32_t)kr1, a.thresh);
#pragma unroll
    for (int kk = 0; kk < kBq / kSlab; ++kk) {
      const int js = kSlab * kk, j0 = q0 + js;  // the slab's first query, in the tile and in all
      if (kCausal && j0 + kSlab - 1 < wk0) continue;  // every query of the slab is before the keys
      float s[kSn][4] = {}, dp[kSn][4] = {};
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t af[4];
        if constexpr (C::kOwnRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) af[i] = kf[kd][i];
        } else {
          mma::ldsm_x4(af, mma::a_frag_addr(skw, kLd, 0, 16 * kd, lane));
        }
#pragma unroll
        for (int nt = 0; nt < kSn; nt += 2) {
          uint32_t b[4];
          mma::ldsm_x4(b, mma::bt_frag_addr(sq, kLd, js + 8 * nt, 16 * kd, lane));
          mma::mma_bf16(s[nt], af, b[0], b[1]);
          mma::mma_bf16(s[nt + 1], af, b[2], b[3]);
        }
      }
      // element i of n8 tile nt (key kr0 or kr1, query q0 + j): p = exp(s -
      // lse[j]) in place, zero where the key is past the query (only the
      // slabs that cross the warp's diagonal test it), and its dropout bit
      const bool diag = kCausal && wk0 + 15 > j0;
      bool kept[kSn][4];
#pragma unroll
      for (int nt = 0; nt < kSn; ++nt) {
        const int j = js + 8 * nt + c0;
        const float2 l = *reinterpret_cast<const float2*>(slse + j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1, e = i & 1;
          const float p = mma::exp2_approx(fmaf(s[nt][i], sl2, -(e ? l.y : l.x) * kLog2e));
          s[nt][i] = diag && (h ? kr1 : kr0) > q0 + j + e ? 0.f : p;
          kept[nt][i] = !a.on || (h ? kc1((uint32_t)(j + e)) : kc0((uint32_t)(j + e)));
        }
      }
      // dV += pd^T dout over the warp's gradient columns, 16 queries at a
      // time: pd = p scaled by the kept share or 0, rounded to bf16 and
      // packed from the C fragments as the A fragment
#pragma unroll
      for (int m = 0; m < kSn / 2; ++m) {
        uint32_t af[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nt = 2 * m + u;
          float pd[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pd[i] = kept[nt][i] ? s[nt][i] * inv_keep : 0.f;
          af[2 * u] = mma::pack_bf16(pd[0], pd[1]);
          af[2 * u + 1] = mma::pack_bf16(pd[2], pd[3]);
        }
#pragma unroll
        for (int dt = 0; dt < kGn; dt += 2) {
          uint32_t b[4];
          mma::ldsm_x4_trans(b, mma::a_frag_addr(sdo, kLd, js + 16 * m, d0 + 8 * dt, lane));
          mma::mma_bf16(dv[dt], af, b[0], b[1]);
          mma::mma_bf16(dv[dt + 1], af, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t af[4];
        if constexpr (C::kOwnRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) af[i] = vf[kd][i];
        } else {
          mma::ldsm_x4(af, mma::a_frag_addr(svw, kLd, 0, 16 * kd, lane));
        }
#pragma unroll
        for (int nt = 0; nt < kSn; nt += 2) {
          uint32_t b[4];
          mma::ldsm_x4(b, mma::bt_frag_addr(sdo, kLd, js + 8 * nt, 16 * kd, lane));
          mma::mma_bf16(dp[nt], af, b[0], b[1]);
          mma::mma_bf16(dp[nt + 1], af, b[2], b[3]);
        }
      }
      // dK += dS^T q likewise: ds = p (dp scaled by the kept share or 0, -
      // delta[j])
#pragma unroll
      for (int m = 0; m < kSn / 2; ++m) {
        uint32_t af[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nt = 2 * m + u;
          const float2 dl = *reinterpret_cast<const float2*>(sdel + js + 8 * nt + c0);
          float d[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float g = kept[nt][i] ? dp[nt][i] * inv_keep : 0.f;
            d[i] = s[nt][i] * (g - (i & 1 ? dl.y : dl.x));
          }
          af[2 * u] = mma::pack_bf16(d[0], d[1]);
          af[2 * u + 1] = mma::pack_bf16(d[2], d[3]);
        }
#pragma unroll
        for (int dt = 0; dt < kGn; dt += 2) {
          uint32_t b[4];
          mma::ldsm_x4_trans(b, mma::a_frag_addr(sq, kLd, js + 16 * m, d0 + 8 * dt, lane));
          mma::mma_bf16(dk[dt], af, b[0], b[1]);
          mma::mma_bf16(dk[dt + 1], af, b[2], b[3]);
        }
      }
    }
  }

  // dk times the scale and dv, rounded once, stored through the warp's rows
  // of k and v (a block that walked no tile may still be copying them in,
  // and the other group of a split block reads them until this barrier)
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t ok[kGn][2], ov[kGn][2];
#pragma unroll
  for (int dt = 0; dt < kGn; ++dt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ok[dt][h] = mma::pack_bf16(dk[dt][2 * h] * a.scale, dk[dt][2 * h + 1] * a.scale);
      ov[dt][h] = mma::pack_bf16(dv[dt][2 * h], dv[dt][2 * h + 1]);
    }
  const size_t at_w = row * kplane + (size_t)wk0 * hs;
  store_rows<D, C::kDs>(static_cast<bf16*>(a.dk) + at_w, sk + 16 * grp * kLd, ok, hs, a.vec,
                        lane, d0);
  store_rows<D, C::kDs>(static_cast<bf16*>(a.dv) + at_w, sv + 16 * grp * kLd, ov, hs, a.vec,
                        lane, d0);
}

// The dq kernel, then the dk/dv kernel. Every tile lies in one JAX block
// (the dropout keys): kRows and kCols divide bq and bk.
template <int D, bool kCausal, bool kMapped>
int launch_flash_bwd_mma(const BwdArgs& a, FlashRows rm, cudaStream_t stream) {
  using C = MmaBwd<D>;
  if (a.Tq % C::kRows != 0 || a.Tk % C::kRows != 0 || a.bq % C::kRows != 0 ||
      a.bk % C::kRows != 0)
    return (int)cudaErrorInvalidValue;
  const int err = launch_bwd(flash_bwd_dq_mma_kernel<D, kCausal, kMapped>, C::kThreads, C::kBytes,
                             (long long)a.n * (a.Tq / C::kRows), a, rm, stream);
  if (err != 0) return err;
  return launch_bwd(flash_bwd_dkv_mma_kernel<D, kCausal, kMapped>, C::kThreads, C::kBytes,
                    (long long)a.n * (a.Tk / C::kRows), a, rm, stream);
}

template <int D>
int launch_flash_bwd_d(const BwdArgs& a, FlashRows rm, cudaStream_t stream) {
  // mapped mask rows in instances of their own (flash_fwd_mma_kernel's
  // note): the causal mask (K5b, K7b) and none (K7b: a ring's modality rows
  // from a base)
  const bool mapped = rm.mapped();
  if (!a.causal)
    return mapped ? launch_flash_bwd_mma<D, false, true>(a, rm, stream)
                  : launch_flash_bwd_mma<D, false, false>(a, rm, stream);
  return mapped ? launch_flash_bwd_mma<D, true, true>(a, rm, stream)
                : launch_flash_bwd_mma<D, true, false>(a, rm, stream);
}

// bf16 on the tensor cores (mma.sync, hs padded to D = 64, 128 or 256), f32
// on FMAs; the causal mask or none.
inline int launch_flash_bwd(BwdArgs a, FlashRows rm, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    a.vec = a.hs % 8 == 0 && aligned16({a.q, a.k, a.v, a.dout, a.dq, a.dk, a.dv});
    if (a.hs <= 0 || a.hs > 256) return (int)cudaErrorInvalidValue;
    return a.hs <= 64    ? launch_flash_bwd_d<64>(a, rm, stream)
           : a.hs <= 128 ? launch_flash_bwd_d<128>(a, rm, stream)
                         : launch_flash_bwd_d<256>(a, rm, stream);
  }
  a.vec = 0;
  return a.causal ? launch_flash_bwd_f32<true>(a, rm, stream)
                  : launch_flash_bwd_f32<false>(a, rm, stream);
}

int chunk_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int n, int Tq,
              int Tk, int hs, int causal, int is_bf16, float scale, unsigned seed,
              unsigned thresh, int rate_on, float keepf, int bq, int bk, FlashRows rm,
              void* stream) {
  FwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse = static_cast<float*>(lse);
  a.J = 1; a.n = n; a.Tq = Tq; a.Tk = Tk; a.hs = hs; a.bq = bq; a.bk = bk; a.causal = causal;
  a.scale = scale; a.keepf = keepf; a.seed = seed; a.thresh = thresh; a.on = rate_on;
  a.stream_seeds = 0;
  return launch_flash_fwd<false>(a, rm, is_bf16, static_cast<cudaStream_t>(stream));
}

int chunk_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, void* dk, void* dv, int n, int Tq, int Tk, int hs,
              int causal, int is_bf16, float scale, unsigned seed, unsigned thresh, int rate_on,
              float keepf, int bq, int bk, FlashRows rm, void* stream) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse); a.delta = static_cast<const float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.n = n; a.Tq = Tq; a.Tk = Tk; a.hs = hs; a.bq = bq; a.bk = bk; a.causal = causal;
  a.scale = scale; a.keepf = keepf; a.seed = seed; a.thresh = thresh; a.on = rate_on;
  return launch_flash_bwd(a, rm, is_bf16, static_cast<cudaStream_t>(stream));
}

}  // namespace flash
}  // namespace tat

// K5f. q, k, v, out (n, T, hs), one type (bf16 or f32), contiguous; lse
// (n, 1, T) f32. Dropout (rate_on) keeps score (row, col) of collapsed row i
// by the hash of (seed, g(i), row / blk, col / blk, row % blk, col % blk)
// against thresh, blk the JAX kernels' block (flash_pick_block(T)); keepf is
// 1 - rate; g(i) is the row's row in the global call under data and tensor
// parallelism (tat::FlashRows{span, skip, base, ispan, iskip}; span 1, skip
// 0, base 0, ispan 1, iskip 0 on one rank). Returns the cudaError_t of the
// launch.
extern "C" int tat_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int n, int T, int hs, int is_bf16,
                                       float scale, unsigned seed, unsigned thresh, int rate_on,
                                       float keepf, int blk, int span, int skip, int base,
                                       int ispan, int iskip, void* stream) {
  return tat::flash::chunk_fwd(q, k, v, out, lse, n, T, T, hs, 1, is_bf16, scale, seed, thresh,
                               rate_on, keepf, blk, blk,
                               tat::FlashRows{span, skip, base, ispan, iskip}, stream);
}

// K5b. dq, dk, dv (n, T, hs) in the inputs' type from q, k, v, dout, the
// forward's lse (n, 1, T) and delta = rowsum(dout * out) (n, T), both f32.
// Dropout and mask rows as the forward's (seed already offset for a cross
// stream). Two launches on the stream; returns the first cudaError_t that is
// not 0.
extern "C" int tat_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, void* dk, void* dv, int n, int T, int hs,
                                       int is_bf16, float scale, unsigned seed, unsigned thresh,
                                       int rate_on, float keepf, int blk, int span, int skip,
                                       int base, int ispan, int iskip, void* stream) {
  return tat::flash::chunk_bwd(q, k, v, dout, lse, delta, dq, dk, dv, n, T, T, hs, 1, is_bf16,
                               scale, seed, thresh, rate_on, keepf, blk, blk,
                               tat::FlashRows{span, skip, base, ispan, iskip}, stream);
}

// K7f. q, out (n, Tq, hs), k, v (n, Tk, hs), one type (bf16 or f32),
// contiguous; lse (n, 1, Tq) f32. causal: the top-left causal mask, else
// none. Dropout keeps score (row, col) of collapsed row i by the hash of
// (seed, base + i, row / bq, col / bk, row % bq, col % bk), bq and bk the
// JAX blocks of Tq and Tk (base != 0: the mapped instance, a
// modality-parallel rank's rows in the whole M). Returns the cudaError_t of
// the launch.
extern "C" int tat_flash_chunk_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int n, int Tq, int Tk, int hs, int causal,
                                   int is_bf16, float scale, unsigned seed, unsigned thresh,
                                   int rate_on, float keepf, int bq, int bk, int base,
                                   void* stream) {
  return tat::flash::chunk_fwd(q, k, v, out, lse, n, Tq, Tk, hs, causal, is_bf16, scale, seed,
                               thresh, rate_on, keepf, bq, bk, tat::FlashRows{1, 0, base, 1, 0},
                               stream);
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
                                   int base, void* stream) {
  return tat::flash::chunk_bwd(q, k, v, dout, lse, delta, dq, dk, dv, n, Tq, Tk, hs, causal,
                               is_bf16, scale, seed, thresh, rate_on, keepf, bq, bk,
                               tat::FlashRows{1, 0, base, 1, 0}, stream);
}
