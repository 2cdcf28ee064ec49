// Backward of the fused factored-QKV projection + whole-row causal attention.
//
// Replaces: trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py,
// _fqkv_bwd_kernel (custom VJP of fused_qkv_attention). For x (M, B, T, C),
// w1 (M, C, 3D), b1 (M, 3D), w2 (M, 3H, hs/2, hs), the forward output o and
// its cotangent do (M, H, B, T, hs), it recomputes the projection and computes
//   dqkv  attention backward per (m, h, b)            rounded to x's type
//   dt3   = dqkv . w2^T per virtual head             f32, rounded (dt2)
//   dpre  = dt2 * (1 - t2^2), t2 the f32 tanh output  f32, rounded (dprec)
//   db1   = sum over rows of dpre                     f32
//   dw2   = t3^T . dqkv per virtual head, summed over B   f32
//   dx    = dprec . w1^T                              f32, rounded once
//   dw1   = x^T . dprec, summed over B                f32
// with the JAX kernel's rounding points: weights cast to x's type, products
// summed in f32, the weight gradients f32.
//
// Design: the TPU kernel does all of this in one program per (m, batch group),
// with t and qkv in VMEM and the weight gradients summed across the
// sequential grid. Here it is a run of launches on one stream, each a simple
// kernel, the intermediates (t2, t3, qkv, dqkv, dprec: ~57 MB at the
// production shape) through device memory. Every sum runs in a fixed order
// (no atomics), so two runs give the same bits.
//
// What bounds it on the H100: ~12.6 GFLOP of projection products at the
// production shape (x 4x32x64x384 bf16, H=6, hs=64), most of it the four
// C x 3D products (~0.013 ms at 989 TFLOP/s), and the intermediates' bytes
// (~0.02 ms at 3.35 TB/s). bf16 (every model path) runs the six products
// on the tensor cores: gemm_mma_kernel, mma.sync m16n8k16 with f32
// accumulators over 128 x 64 output tiles of 8 warps of 32 x 32 (64 x 64
// of 4 warps where a product has at most 64 rows, as dw2's hs / 2), k-steps
// of 32 through a ring of three (four) stages filled by 16-byte cp.async
// (element copies where an operand's rows are not 16-byte aligned),
// operands read straight or transposed through ldmatrix as their strides
// lie. The f32
// weights are rounded to bf16 once a call (the JAX kernel's cast) into the
// end of the dq workspace. tanh and b1 run in the epilogue of the pre
// product (t2 f32 and t3 bf16 written once); dpre and dprec in that of the
// dt3 product, which also sums dpre's columns over each tile's rows in a
// fixed order, so that db1 is a column sum of B T / 128 partial rows. The
// weight gradients (B T-row reductions) cut K into runs of ~16 k-steps,
// each run's f32 sums in a spent workspace (f32a, f32b), added in run
// order by one last kernel. Ten launches a call at the production shape
// (weights, pre, qkv, attention, dt3, db1, dw2, dx, dw1, the runs' sum;
// nine at B = 1, whose 64 rows need no runs; one more at T > 64, whose
// attention backward is two kernels).
// f32 (the correctness gates) keeps the FMA path: the batched tiled
// gemm_kernel (any strides), elementwise tanh and dpre kernels, and the
// column sum for db1 over every row.
#include "attention_bwd.cuh"
#include "round_weights.cuh"

namespace tat {

// C[z](i, j) = sum_k A[z](i, k) * B[z](k, j), z = z1 * Z2 + z2; every operand
// addressed by its own strides. The epilogue (epi) stores C in f32 or bf16,
// or applies one of the fused elementwise steps (GemmEpi).
enum GemmEpi {
  kEpiF32 = 0,   // C (f32) = acc
  kEpiBf16 = 1,  // C (bf16) = acc
  kEpiTanh = 2,  // t = tanh(acc + bias[z1][j]): C (f32) = t, C2 (bf16) = t
  kEpiDpre = 3,  // d = round(acc) (1 - E^2), E (f32, C's strides): C2 (bf16) = d, and the
                 // column sums of d over the tile's rows to part
};

struct Gemm {
  const void* A;
  const void* B;
  void* C;
  int Mr, N, K, Z1, Z2;
  long long sA1, sA2, sai, sak;
  long long sB1, sB2, sbk, sbj;
  long long sC1, sC2, sci, scj;
  int epi;
  void* C2;          // kEpiTanh, kEpiDpre: the bf16 output (C's strides)
  const void* E;     // kEpiDpre: t2 (C's strides)
  const float* bias; // kEpiTanh: b1, bias + z1 * sbias1 + j
  long long sbias1;
  int a_vec, b_vec;  // gemm_mma_kernel: 16-byte cp.async of an operand
  int pair;          // gemm_mma_kernel: column pairs stored together
  float* part;       // kEpiDpre: part[z1 sp1 + row tile spr + z2 sC2 + j scj]
  long long sp1, spr;
  int splits;        // gemm_mma_kernel: K cut in `splits` runs of k_chunk, run s
  long long k_chunk, ssplit;  // writing its sums at C + s ssplit
};

// ------------------------------------------------------------- f32: FMAs
// (every operand and result f32)

constexpr int kGM = 64, kGN = 64, kGK = 16;  // GEMM tile

__global__ void __launch_bounds__(kThreads) gemm_kernel(Gemm g) {
  __shared__ float As[kGK][kGM + 4];
  __shared__ float Bs[kGK][kGN + 4];
  const int z = blockIdx.z, z1 = z / g.Z2, z2 = z % g.Z2;
  const float* A = static_cast<const float*>(g.A) + z1 * g.sA1 + z2 * g.sA2;
  const float* Bm = static_cast<const float*>(g.B) + z1 * g.sB1 + z2 * g.sB2;
  float* C = static_cast<float*>(g.C) + z1 * g.sC1 + z2 * g.sC2;
  const int i0 = blockIdx.y * kGM, j0 = blockIdx.x * kGN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  // neighbouring threads on neighbouring addresses where a stride is 1
  const bool a_k_fast = g.sak == 1, b_j_fast = g.sbj == 1;
  for (int k0 = 0; k0 < g.K; k0 += kGK) {
#pragma unroll
    for (int u = 0; u < kGK * kGM / kThreads; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int kk = a_k_fast ? idx % kGK : idx / kGM, ii = a_k_fast ? idx / kGK : idx % kGM;
      const int i = i0 + ii, k = k0 + kk;
      As[kk][ii] = (i < g.Mr && k < g.K) ? A[i * g.sai + k * g.sak] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGK * kGN / kThreads; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int kk = b_j_fast ? idx / kGN : idx % kGK, jj = b_j_fast ? idx % kGN : idx / kGK;
      const int j = j0 + jj, k = k0 + kk;
      Bs[kk][jj] = (j < g.N && k < g.K) ? Bm[k * g.sbk + j * g.sbj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + ty + 16 * a, j = j0 + tx + 16 * b;
      if (i < g.Mr && j < g.N) C[i * g.sci + j * g.scj] = acc[a][b];
    }
}

int gemm(const Gemm& g, cudaStream_t stream) {
  const dim3 grid((g.N + kGN - 1) / kGN, (g.Mr + kGM - 1) / kGM, g.Z1 * g.Z2);
  gemm_kernel<<<grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// t2 = tanh(pre + b1) in place (f32), t3 = t2 (f32).
__global__ void tanh_kernel(float* pre, float* t3, const float* __restrict__ b1, long long n,
                            int rows, int d3) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const int col = (int)(idx % d3);
    const long long m = idx / ((long long)rows * d3);
    const float t = tanhf(pre[idx] + b1[m * d3 + col]);
    pre[idx] = t;
    t3[idx] = t;
  }
}

// dpre = dt3 * (1 - t2^2) in place of dt3, dprec = dpre (f32).
__global__ void dpre_kernel(float* dt3, const float* __restrict__ t2, float* dprec, long long n) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const float t = t2[idx];
    const float dp = dt3[idx] * (1.f - t * t);
    dt3[idx] = dp;
    dprec[idx] = dp;
  }
}

// out[m][c] = sum over rows of x[m][row][c]: one block per (m, 32 columns);
// 8 lanes per column sum every 8th row, then the lanes add in a fixed order.
__global__ void colsum_kernel(const float* __restrict__ x, float* out, int rows, int cols) {
  __shared__ float part[8][33];
  const int m = blockIdx.y, c = blockIdx.x * 32 + threadIdx.x % 32, lane = threadIdx.x / 32;
  const float* xm = x + (size_t)m * rows * cols;
  float acc = 0.f;
  if (c < cols)
    for (int r = lane; r < rows; r += 8) acc += xm[(size_t)r * cols + c];
  part[lane][threadIdx.x % 32] = acc;
  __syncthreads();
  if (lane == 0 && c < cols) {
    float s = 0.f;
    for (int l = 0; l < 8; ++l) s += part[l][threadIdx.x % 32];
    out[(size_t)m * cols + c] = s;
  }
}

inline unsigned grid_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 4096 ? b : 4096);
}

// ------------------------------------------------------------- bf16: mma.sync

namespace gm {

using bf16 = __nv_bfloat16;
constexpr int kBN = 64, kBK = 32;

// A block's tile: kBM rows (64 or 128) x kBN columns, 2 x kBM / 32 warps
// of 32 x 32, and the stages of its ring (static shared memory under 48 KB).
template <int kBM>
struct TileCfg {
  static constexpr int kThreads = 2 * kBM, kStages = kBM == 64 ? 4 : 3;
};

// One operand tile of kR rows x kC contiguous elements in shared memory
// (rows kC + 8 apart): with vec 16-byte cp.async (the caller commits and
// waits), else element copies. Elements outside (er, ec) are zeros.
template <int kR, int kC, int kThreadsG>
struct Loader {
  static constexpr int kLd = kC + 8, kPer = kR * kC / 8 / kThreadsG;
  static_assert(kR * kC % (8 * kThreadsG) == 0, "a whole number of chunks a thread");
  const bf16* p;
  long long sr, sc;  // strides of the tile's rows and of its contiguous axis
  int er, ec;        // extents of both axes
  bool vec;

  __device__ __forceinline__ void load(bf16* dst, int r0, int c0) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int idx = (int)threadIdx.x + u * kThreadsG;
      const int r = idx / (kC / 8), c = (idx % (kC / 8)) * 8, gr = r0 + r, gc = c0 + c;
      if (vec) {
        const bool in = gr < er && gc < ec;
        mma::cp_async16(dst + r * kLd + c, in ? p + gr * sr + gc : p, in);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[r * kLd + c + e] =
              gr < er && gc + e < ec ? p[gr * sr + (gc + e) * sc] : __float2bfloat16_rn(0.f);
      }
    }
  }
};

// The products of K1b on the tensor cores (see the note at the top): A is
// (Mr x K) with K contiguous, or with kAT its transpose stored (M
// contiguous); B is (K x N) with N contiguous, or with kBT K contiguous;
// both bf16. A block computes a kBM x 64 tile of C, each warp 32 x 32,
// k-steps of 32 through a ring of kStages.
template <int kBM, bool kAT, bool kBT>
__global__ void __launch_bounds__(TileCfg<kBM>::kThreads) gemm_mma_kernel(const Gemm g) {
  constexpr int kThreadsG = TileCfg<kBM>::kThreads, kStages = TileCfg<kBM>::kStages;
  using ALd = Loader<kAT ? kBK : kBM, kAT ? kBM : kBK, kThreadsG>;
  using BLd = Loader<kBT ? kBN : kBK, kBT ? kBK : kBN, kThreadsG>;
  constexpr int kASz = (kAT ? kBK : kBM) * ALd::kLd, kBSz = (kBT ? kBN : kBK) * BLd::kLd;
  __shared__ __align__(128) bf16 sa[kStages][kASz];
  __shared__ __align__(128) bf16 sb[kStages][kBSz];
  const int z = blockIdx.z / g.splits, split = blockIdx.z % g.splits;
  const int z1 = z / g.Z2, z2 = z % g.Z2;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = 32 * (warp >> 1), wn = 32 * (warp & 1);
  const ALd la{static_cast<const bf16*>(g.A) + z1 * g.sA1 + z2 * g.sA2, kAT ? g.sak : g.sai,
               kAT ? g.sai : g.sak, kAT ? g.K : g.Mr, kAT ? g.Mr : g.K, g.a_vec != 0};
  const BLd lb{static_cast<const bf16*>(g.B) + z1 * g.sB1 + z2 * g.sB2, kBT ? g.sbj : g.sbk,
               kBT ? g.sbk : g.sbj, kBT ? g.N : g.K, kBT ? g.K : g.N, g.b_vec != 0};
  const long long k_begin = split * g.k_chunk;
  const int nk = (int)((min((long long)g.K, k_begin + g.k_chunk) - k_begin + kBK - 1) / kBK);
  // one commit group a k-step, empty past the last
  auto load_step = [&](int kt) {
    if (kt < nk) {
      const int k0 = (int)k_begin + kt * kBK;
      la.load(sa[kt % kStages], kAT ? k0 : i0, kAT ? i0 : k0);
      lb.load(sb[kt % kStages], kBT ? j0 : k0, kBT ? k0 : j0);
    }
    mma::cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) load_step(kt);
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // step kt landed; every warp is done with step kt - 1's stage
    load_step(kt + kStages - 1);
    const bf16* a = sa[kt % kStages];
    const bf16* b = sb[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (kAT)
          mma::ldsm_x4_trans(af[mi], mma::bt_frag_addr(a, ALd::kLd, kk, wm + 16 * mi, lane));
        else
          mma::ldsm_x4(af[mi], mma::a_frag_addr(a, ALd::kLd, wm + 16 * mi, kk, lane));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        if (kBT)
          mma::ldsm_x4(r, mma::bt_frag_addr(b, BLd::kLd, wn + 16 * nj, kk, lane));
        else
          mma::ldsm_x4_trans(r, mma::a_frag_addr(b, BLd::kLd, kk, wn + 16 * nj, lane));
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma::mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  mma::cp_async_wait<0>();

  // each thread's two adjacent columns (2t, 2t + 1) of rows g and g + 8,
  // stored as one pair where C's rows allow (pair: scj = 1, even strides)
  const long long c_off = z1 * g.sC1 + z2 * g.sC2 + split * g.ssplit;
  const bool to_f32 = g.epi == kEpiF32 || g.epi == kEpiTanh, to_bf16 = g.epi != kEpiF32;
  float csum[4][2] = {};  // kEpiDpre: this thread's column sums
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i0 + wm + 16 * mi + mma::frag_row(lane, 2 * h);
        const int col = j0 + wn + 8 * ni + mma::frag_col(lane, 0);
        if (row >= g.Mr) continue;
        const long long at = c_off + row * g.sci + col * g.scj;
        float v[2] = {acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]};
        if (g.epi == kEpiTanh) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < g.N) v[e] = tanhf(v[e] + g.bias[z1 * g.sbias1 + col + e]);
        } else if (g.epi == kEpiDpre) {
          const float* t2 = static_cast<const float*>(g.E);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < g.N) {
              const float t = t2[at + e * g.scj];
              v[e] = Io<bf16>::round(v[e]) * (1.f - t * t);
              csum[ni][e] += v[e];
            }
        }
        float* cf = static_cast<float*>(g.C);
        bf16* cb = static_cast<bf16*>(g.epi == kEpiBf16 ? g.C : g.C2);
        if (g.pair && col + 1 < g.N) {
          if (to_f32) *reinterpret_cast<float2*>(cf + at) = make_float2(v[0], v[1]);
          if (to_bf16) *reinterpret_cast<uint32_t*>(cb + at) = mma::pack_bf16(v[0], v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < g.N) {
              if (to_f32) cf[at + e * g.scj] = v[e];
              if (to_bf16) cb[at + e * g.scj] = __float2bfloat16_rn(v[e]);
            }
        }
      }
  if (g.epi == kEpiDpre) {
    // db1's partial sums over the tile's rows in a fixed order: each
    // warp's 8 row groups by shuffles, then the warps' rows in order
    __shared__ float red[kBM / 32][kBN];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = csum[ni][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) red[warp >> 1][wn + 8 * ni + 2 * lane + e] = v;
      }
    __syncthreads();
    const int col = j0 + (int)threadIdx.x;
    if (threadIdx.x < kBN && col < g.N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kBM / 32; ++w) sum += red[w][threadIdx.x];
      g.part[z1 * g.sp1 + blockIdx.y * g.spr + z2 * g.sC2 + col * g.scj] = sum;
    }
  }
}

// 16-byte copies of an operand: its contiguous stride 1, the extent along
// it, its other strides and its address all multiples of 8 elements.
inline bool vec_ok(const void* p, long long s_contig, int extent,
                   std::initializer_list<long long> strides) {
  if (s_contig != 1 || extent % 8 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (long long s : strides)
    if (s % 8 != 0) return false;
  return true;
}

// splits > 1: K cut into that many runs of whole k-steps (the last may be
// shorter), run s writing its f32 sums at C + s ssplit.
// Rows of a block's tile for a product of Mr rows: 128 (8 warps), or 64
// (4 warps) where Mr is at most 64 (dw2's hs / 2 rows).
inline int tile_m(int Mr) { return Mr <= 64 ? 64 : 128; }

template <int kBM, bool kAT, bool kBT>
int launch_gemm(const Gemm& g, int splits, cudaStream_t stream) {
  const dim3 grid((g.N + kBN - 1) / kBN, (g.Mr + kBM - 1) / kBM, g.Z1 * g.Z2 * splits);
  gemm_mma_kernel<kBM, kAT, kBT><<<grid, TileCfg<kBM>::kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// splits > 1: K cut into that many runs of whole k-steps (the last may be
// shorter), run s writing its f32 sums at C + s ssplit.
template <bool kAT, bool kBT>
int gemm_mma(Gemm g, cudaStream_t stream, int splits = 1, long long ssplit = 0) {
  g.splits = splits;
  g.k_chunk = ((long long)g.K + splits - 1) / splits;
  g.k_chunk = (g.k_chunk + kBK - 1) / kBK * kBK;
  g.ssplit = ssplit;
  g.a_vec = vec_ok(g.A, kAT ? g.sai : g.sak, kAT ? g.Mr : g.K,
                   {kAT ? g.sak : g.sai, g.sA1, g.sA2});
  g.b_vec = vec_ok(g.B, kBT ? g.sbk : g.sbj, kBT ? g.K : g.N, {kBT ? g.sbj : g.sbk, g.sB1, g.sB2});
  // pairs of columns: 8-byte f32 and 4-byte bf16 stores at even offsets
  g.pair = g.scj == 1 && g.sci % 2 == 0 && g.sC1 % 2 == 0 && g.sC2 % 2 == 0 &&
           reinterpret_cast<uintptr_t>(g.C) % 8 == 0 &&
           (g.C2 == nullptr || reinterpret_cast<uintptr_t>(g.C2) % 4 == 0);
  return tile_m(g.Mr) == 64 ? launch_gemm<64, kAT, kBT>(g, splits, stream)
                            : launch_gemm<128, kAT, kBT>(g, splits, stream);
}

// Runs of k-steps for a weight gradient's K (B T rows): about 16 steps of
// kBK a run, at most 8 runs and at most `room` (the partial sums' space).
inline int k_splits(int K, long long room) {
  long long s = K / (16 * kBK);
  s = s < 8 ? s : 8;
  s = s < room ? s : room;
  return s > 1 ? (int)s : 1;
}

// out_a[i] = sum over s < sa of part_a[s na + i] in order, and likewise b.
__global__ void sum_splits_kernel(const float* __restrict__ part_a, float* out_a, long long na,
                                  int sa, const float* __restrict__ part_b, float* out_b,
                                  long long nb, int sb) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < na + nb;
       idx += (long long)gridDim.x * blockDim.x) {
    const bool in_a = idx < na;
    const float* p = in_a ? part_a + idx : part_b + (idx - na);
    const long long n = in_a ? na : nb;
    float acc = 0.f;
    for (int s = 0; s < (in_a ? sa : sb); ++s) acc += p[s * n];
    (in_a ? out_a[idx] : out_b[idx - na]) = acc;
  }
}

}  // namespace gm

#define TAT_TRY(expr)             \
  do {                            \
    const int e_ = (expr);        \
    if (e_ != 0) return e_;       \
  } while (0)

template <typename T>
int fqkv_bwd(const void* x, const void* w1, const void* b1, const void* w2, const void* o,
             const void* dout, void* dx, void* dw1, void* db1, void* dw2, void* ws_f32a,
             void* ws_f32b, void* ws_t3, void* ws_qkv, void* ws_dqkv, void* ws_dprec,
             void* ws_dq, int M, int B, int Tn, int C, int H, int hs, float scale,
             uint32_t seed, uint32_t thresh, int rate_on, float inv, int gb, int Bg,
             int b0, int Hg, int h0, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int hs2 = hs / 2, d3 = 3 * H * hs2, H3 = 3 * H;
  const long long BT = (long long)B * Tn, vhead = BT * hs;
  float* pre = static_cast<float*>(ws_f32a);  // pre, then t2
  float* dt3 = static_cast<float*>(ws_f32b);  // dt3, then dpre
  T* qkv = static_cast<T*>(ws_qkv);
  T* dqkv = static_cast<T*>(ws_dqkv);
  const long long n_pre = (long long)M * BT * d3;
  // bf16: the weights rounded to bf16 once (the JAX kernel's cast), after
  // the attention workspace in ws_dq (bwd_ws_floats)
  const long long n_w1 = (long long)M * C * d3, n_w2 = (long long)M * H3 * hs2 * hs;
  __nv_bfloat16* w1b = nullptr;
  __nv_bfloat16* w2b = nullptr;
  if constexpr (kBf16) {
    w1b = reinterpret_cast<__nv_bfloat16*>(static_cast<float*>(ws_dq) +
                                           bwd_ws_floats((long long)M * H * B, Tn, hs));
    w2b = w1b + (n_w1 + 7) / 8 * 8;
    TAT_TRY(gm::round_weights(static_cast<const float*>(w1), n_w1, static_cast<const float*>(w2),
                              n_w2, w1b, w2b, s));
  }
  const void* w1_op = kBf16 ? static_cast<const void*>(w1b) : w1;
  const void* w2_op = kBf16 ? static_cast<const void*>(w2b) : w2;

  // pre[m] (BT x d3) = x[m] (BT x C) . w1[m] (C x d3); t2 = tanh(pre + b1),
  // t3 = t2 rounded
  Gemm g{x, w1_op, pre, (int)BT, d3, C, M, 1, BT * C, 0, C, 1, (long long)C * d3, 0, d3, 1,
         BT * d3, 0, d3, 1};
  if constexpr (kBf16) {
    g.epi = kEpiTanh;
    g.C2 = ws_t3;
    g.bias = static_cast<const float*>(b1);
    g.sbias1 = d3;
    TAT_TRY((gm::gemm_mma<false, false>(g, s)));
  } else {
    TAT_TRY(gemm(g, s));
    tanh_kernel<<<grid_for(n_pre), kThreads, 0, s>>>(
        pre, static_cast<float*>(ws_t3), static_cast<const float*>(b1), n_pre, (int)BT, d3);
    TAT_TRY((int)cudaGetLastError());
  }
  // qkv[m, vh] (BT x hs) = t3[m][:, vh] (BT x hs2) . w2[m, vh] (hs2 x hs)
  g = Gemm{ws_t3, w2_op, qkv, (int)BT, hs, hs2, M, H3, BT * d3, hs2, d3, 1,
           (long long)H3 * hs2 * hs, (long long)hs2 * hs, hs, 1, H3 * vhead, vhead, hs, 1};
  if constexpr (kBf16) {
    g.epi = kEpiBf16;
    TAT_TRY((gm::gemm_mma<false, false>(g, s)));
  } else {
    TAT_TRY(gemm(g, s));
  }
  // dqkv: attention backward per (m, h, b)
  BwdArgs a{};
  a.q = a.k = a.v = qkv;
  a.o = o;
  a.dout = dout;
  a.dq = dqkv;
  a.dk = a.dv = dqkv;
  a.dq_ws = static_cast<float*>(ws_dq);
  a.J = 1;
  a.n = M * H * B;
  a.Tn = Tn;
  a.hs = hs;
  a.scale = scale;
  a.rate_on = rate_on;
  a.seed = seed;
  a.thresh = thresh;
  a.inv = inv;
  a.layout = kFusedRows;
  a.B = B;
  a.H = H;
  a.gb = gb;
  a.Bg = Bg;
  a.b0 = b0;
  a.rm.span = Hg;
  a.rm.base = h0;
  TAT_TRY(launch_attn_bwd<T>(a, s));
  // dt3[m][:, vh] (BT x hs2) = dqkv[m, vh] (BT x hs) . w2[m, vh]^T (hs x hs2);
  // dpre = round(dt3) * (1 - t2^2), dprec = dpre rounded; db1 = the column
  // sums of dpre (bf16: of the product tiles' partial sums in f32b)
  g = Gemm{dqkv, w2_op, dt3, (int)BT, hs2, hs, M, H3, H3 * vhead, vhead, hs, 1,
           (long long)H3 * hs2 * hs, (long long)hs2 * hs, 1, hs, BT * d3, hs2, d3, 1};
  int sum_rows = (int)BT;
  if constexpr (kBf16) {
    const int rows = gm::tile_m((int)BT);  // of the dt3 product's tiles
    sum_rows = (int)((BT + rows - 1) / rows);
    g.epi = kEpiDpre;
    g.E = pre;
    g.C2 = ws_dprec;
    g.part = dt3;
    g.sp1 = (long long)sum_rows * d3;
    g.spr = d3;
    TAT_TRY((gm::gemm_mma<false, true>(g, s)));
  } else {
    TAT_TRY(gemm(g, s));
    dpre_kernel<<<grid_for(n_pre), kThreads, 0, s>>>(dt3, pre, static_cast<float*>(ws_dprec),
                                                     n_pre);
    TAT_TRY((int)cudaGetLastError());
  }
  colsum_kernel<<<dim3((d3 + 31) / 32, M), kThreads, 0, s>>>(dt3, static_cast<float*>(db1),
                                                             sum_rows, d3);
  TAT_TRY((int)cudaGetLastError());
  // dw2[m, vh] (hs2 x hs) = t3[m][:, vh]^T (hs2 x BT) . dqkv[m, vh] (BT x hs);
  // bf16: K split into runs whose partial sums go to f32b, then added in order
  const long long n_dw2 = n_w2, n_dw1 = n_w1, room = M * BT * d3;
  const int s2 = kBf16 ? gm::k_splits((int)BT, room / n_dw2) : 1;
  g = Gemm{ws_t3, dqkv, s2 > 1 ? dt3 : dw2, hs2, hs, (int)BT, M, H3, BT * d3, hs2, 1, d3,
           H3 * vhead, vhead, hs, 1, (long long)H3 * hs2 * hs, (long long)hs2 * hs, hs, 1};
  if constexpr (kBf16) {
    TAT_TRY((gm::gemm_mma<true, false>(g, s, s2, n_dw2)));
  } else {
    TAT_TRY(gemm(g, s));
  }
  // dx[m] (BT x C) = dprec[m] (BT x d3) . w1[m]^T (d3 x C)
  g = Gemm{ws_dprec, w1_op, dx, (int)BT, C, d3, M, 1, BT * d3, 0, d3, 1, (long long)C * d3, 0, 1,
           d3, BT * C, 0, C, 1};
  if constexpr (kBf16) {
    g.epi = kEpiBf16;
    TAT_TRY((gm::gemm_mma<false, true>(g, s)));
  } else {
    TAT_TRY(gemm(g, s));
  }
  // dw1[m] (C x d3) = x[m]^T (C x BT) . dprec[m] (BT x d3); bf16: split as
  // dw2, the partial sums in f32a (t2 is spent)
  const int s1 = kBf16 ? gm::k_splits((int)BT, room / n_dw1) : 1;
  g = Gemm{x, ws_dprec, s1 > 1 ? pre : dw1, C, d3, (int)BT, M, 1, BT * C, 0, 1, C, BT * d3, 0,
           d3, 1, (long long)C * d3, 0, d3, 1};
  if constexpr (kBf16) {
    TAT_TRY((gm::gemm_mma<true, false>(g, s, s1, n_dw1)));
    if (s1 > 1 || s2 > 1) {
      const long long na = s1 > 1 ? n_dw1 : 0, nb = s2 > 1 ? n_dw2 : 0;
      gm::sum_splits_kernel<<<grid_for(na + nb), kThreads, 0, s>>>(
          pre, static_cast<float*>(dw1), na, s1, dt3, static_cast<float*>(dw2), nb, s2);
      TAT_TRY((int)cudaGetLastError());
    }
  } else {
    TAT_TRY(gemm(g, s));
  }
  return 0;
}

}  // namespace tat

// x (M, B, T, C), o and dout (M, H, B, T, hs), dx (M, B, T, C): x's type;
// w1, b1, w2 and dw1 (M, C, 3D), db1 (M, 3D), dw2 (M, 3H, hs/2, hs): f32.
// Workspaces: f32a and f32b (M, B*T, 3D) f32; t3 and dprec (M, B*T, 3D) and
// qkv and dqkv (M, 3H, B, T, hs) in x's type; dq f32 of
// bwd_ws_floats(M*H*B, T, hs) (launch_attn_bwd's dq_ws), then for bf16 the
// weights rounded to bf16: w1 (padded to a multiple of 8) and w2.
// inv = 1 / (1 - rate) as f32; gb = _fqkv_pick_gb's batch group of the
// global batch of Bg rows, of which x holds rows [b0, b0 + B) (Bg = B, b0 = 0
// on one rank), and of the model's Hg heads, of which w1 and w2 hold heads
// [h0, h0 + H) (Hg = H, h0 = 0 on one rank); b0 carries a modality offset
// m0 as m0 Bg, as the forward's. All contiguous. Returns the
// first failing cudaError_t, or 0.
extern "C" int tat_fused_qkv_attention_bwd(
    const void* x, const void* w1, const void* b1, const void* w2, const void* o,
    const void* dout, void* dx, void* dw1, void* db1, void* dw2, void* ws_f32a,
    void* ws_f32b, void* ws_t3, void* ws_qkv, void* ws_dqkv, void* ws_dprec, void* ws_dq,
    int M, int B, int T, int C, int H, int hs, int is_bf16, float scale, unsigned seed,
    unsigned thresh, int rate_on, float inv, int gb, int Bg, int b0, int Hg, int h0,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tat::fqkv_bwd<__nv_bfloat16>(x, w1, b1, w2, o, dout, dx, dw1, db1, dw2, ws_f32a,
                                        ws_f32b, ws_t3, ws_qkv, ws_dqkv, ws_dprec, ws_dq, M, B,
                                        T, C, H, hs, scale, seed, thresh, rate_on, inv, gb, Bg,
                                        b0, Hg, h0, s);
  return tat::fqkv_bwd<float>(x, w1, b1, w2, o, dout, dx, dw1, db1, dw2, ws_f32a, ws_f32b,
                              ws_t3, ws_qkv, ws_dqkv, ws_dprec, ws_dq, M, B, T, C, H, hs,
                              scale, seed, thresh, rate_on, inv, gb, Bg, b0, Hg, h0, s);
}
