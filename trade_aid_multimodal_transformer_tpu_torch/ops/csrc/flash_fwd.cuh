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
// (each stream's rounded output added to the rounded running sum). Dropout
// of stream j is keyed by seed + (j + 1) * 1000003 for the cross kernels and
// by the seed itself for self-attention and the chunks, on the JAX block
// grid (flash_tile.cuh keep(): query blocks bq, key blocks bk, which differ
// where t_q != t_k), at each row's global row under data parallelism (the
// kernels' FlashRows parameter). The tiles differ from the JAX blocks, so p is rounded
// relative to another running max: agreement with the JAX kernel is to
// tolerance, not to the bit.
//
// bf16 (every model path) runs flash_fwd_mma_kernel, FlashAttention-2's
// shape on mma.sync: a block of 4 warps owns 64 query rows, 16 a warp, and
// the grid takes the longest causal query tiles first over every collapsed
// row, so its tail is short tiles (4 warps of 16 rows beat 8 at B = 1 and
// lost little at the training shape). q is copied once into shared memory;
// at D = 64 its A fragments are then held in registers, at D = 128 and 256
// re-read per key tile. The K and V tiles of Bc = 64 rows (32 at D = 256)
// run through a ring of two stages filled by 16-byte cp.async, the next
// tile in flight while this one is computed, one barrier a tile. Rows are
// padded to D + 8 elements (D = hs rounded up to 64, 128 or 256, zeros
// beyond hs), so ldmatrix finds no bank conflict. S = q k^T, the online
// softmax (quad shuffles, exp2 with the scale folded in, per-thread partial
// row sums reduced once), the dropout bit at each held element and P,
// packed from S's fragments into P.V's A fragments, and the f32 output all
// stay in registers; only tiles that cross the diagonal test the mask, and
// a warp skips the key tiles wholly above its rows. The epilogue keeps the
// J-stream sum in registers and stores each warp's rows with 16-byte writes
// staged in its own rows of q's shared memory. Nothing of size t_q * t_k
// reaches device memory. At the production training shape (n = 192 rows,
// T = 1024, hs 64) the call moves ~100 MB (q, k, v, out once) for ~26
// GFLOP of causal products: bytes bound it at ~0.030 ms on the H100 (3.35
// TB/s; 0.026 ms at 989 TFLOP/s). Against that the design keeps every
// operand of the two products on chip and in registers and overlaps the
// next tile's load with this tile's products. What it leaves: every warp
// reads the whole K and V tile through ldmatrix (wgmma would read them once
// per 4 warps), and 12 warps an SM (168 registers a thread at D = 64) hide
// the serial S -> softmax -> P.V chain.
//
// f32 (the correctness gates only) runs flash_fwd_kernel: one block per
// (collapsed row, query tile of R rows) holds q in shared memory and walks
// the streams and the key tiles up to the diagonal with block-wide products
// on FMAs (flash_tile.cuh mma_f32), keeping m, l and the f32 accumulator
// in shared memory and the J-stream sum in the output array.
#pragma once

#include "flash_mma.cuh"
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

struct FwdLayout {
  int R, ldh, ldp, lds, lda;
  size_t off_k, off_v, off_p, off_s, off_acc, off_row, bytes;
  __host__ __device__ FwdLayout(int R_, int hs) : R(R_) {
    ldh = ldh_of(hs);
    ldp = ldp_of(R);
    lds = lds_of(R);
    lda = lda_of(hs);
    const size_t tile = up128((size_t)R * ldh * sizeof(float));
    off_k = tile;  // q at 0
    off_v = off_k + tile;
    off_p = off_v + tile;
    off_s = off_p + up128((size_t)R * ldp * sizeof(float));
    off_acc = off_s + up128((size_t)R * lds * sizeof(float));
    off_row = off_acc + up128((size_t)R * lda * sizeof(float));
    bytes = off_row + 3 * (size_t)R * sizeof(float);
  }
};

// The f32 body. At most 85 registers a thread.
template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 3) flash_fwd_kernel(const FwdArgs a,
                                                                      const FlashRows rm) {
  extern __shared__ __align__(128) char smem[];
  const FwdLayout L(a.R, a.hs);
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = reinterpret_cast<float*>(smem + L.off_k);
  float* sv = reinterpret_cast<float*>(smem + L.off_v);
  float* sp = reinterpret_cast<float*>(smem + L.off_p);
  float* ss = reinterpret_cast<float*>(smem + L.off_s);
  float* sacc = reinterpret_cast<float*>(smem + L.off_acc);
  float* sm = reinterpret_cast<float*>(smem + L.off_row);  // running max
  float* sl = sm + a.R;                                     // running row sum
  float* sc = sl + a.R;                                     // this tile's correction

  const int R = a.R, hs = a.hs;
  const int n_qt = a.Tq / R;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int row = (int)(blockIdx.x / n_qt);
  const uint32_t mrow = rm(row);  // the row's mask row
  const int q0 = qt * R;
  // the last key tile: the diagonal one under the causal mask, else all
  const int kt_end = kCausal ? min(qt, a.Tk / R - 1) : a.Tk / R - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qplane = (size_t)a.Tq * hs, kplane = (size_t)a.Tk * hs;
  const float* q = static_cast<const float*>(a.q) + row * qplane;
  float* out = static_cast<float*>(a.out) + row * qplane;

  load_tile(q + (size_t)q0 * hs, R, hs, sq, L.ldh);
  for (int j = 0; j < a.J; ++j) {
    const size_t at = ((size_t)j * a.n + row) * kplane;
    const float* kj = static_cast<const float*>(a.k) + at;
    const float* vj = static_cast<const float*>(a.v) + at;
    const uint32_t seed = a.stream_seeds ? stream_seed(a.seed, j) : a.seed;
    for (int i = threadIdx.x; i < R; i += kThreads) {
      sm[i] = -INFINITY;
      sl[i] = 0.f;
    }
    for (int kt = 0; kt <= kt_end; ++kt) {
      const int k0 = kt * R;
      load_tile(kj + (size_t)k0 * hs, R, hs, sk, L.ldh);
      load_tile(vj + (size_t)k0 * hs, R, hs, sv, L.ldh);
      __syncthreads();
      mma_f32<false, true>(sq, L.ldh, sk, L.ldh, ss, L.lds, R, R, hs, false);
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
        const KeepRow kr(a.on, seed, mrow, (uint32_t)a.bq, (uint32_t)a.bk,
                         (uint32_t)r, (uint32_t)k0, a.thresh);
        for (int c = lane; c < R; c += 32) {
          const float p = expf(srow[c] - m_new);
          sum += p;
          const bool kept = !a.on || kr((uint32_t)c);
          sp[i * L.ldp + c] = kept ? p : 0.f;
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
        for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
          const int i = idx / hs;
          sacc[i * L.lda + idx - i * hs] *= sc[i];
        }
        __syncthreads();
      }
      mma_f32<false, false>(sp, L.ldp, sv, L.ldh, sacc, L.lda, R, hs, R, kt > 0);
    }
    // stream j's output and its logsumexp
    float* outs = a.outs ? static_cast<float*>(a.outs) + ((size_t)j * a.n + row) * qplane
                         : nullptr;
    for (int idx = threadIdx.x; idx < R * hs; idx += kThreads) {
      const int i = idx / hs, e = idx - i * hs;
      const float o = sacc[i * L.lda + e] / (sl[i] * a.keepf);
      const size_t off = (size_t)(q0 + i) * hs + e;
      if (outs) outs[off] = o;
      out[off] = j == 0 ? o : out[off] + o;
    }
    for (int i = threadIdx.x; i < R; i += kThreads) {
      const float lse = sm[i] + logf(sl[i]);
      if (a.lse) a.lse[(size_t)row * a.Tq + q0 + i] = lse;
      if (a.lses) a.lses[((size_t)j * a.n + row) * a.Tq + q0 + i] = lse;
    }
    __syncthreads();
  }
}

template <bool kCausal>
int launch_flash_fwd_f32(FwdArgs a, FlashRows rm, cudaStream_t stream) {
  a.R = pick_rows<FwdLayout>(a.hs);
  if (a.R == 0 || a.Tq % a.R != 0 || a.Tk % a.R != 0 || a.bq % a.R != 0 || a.bk % a.R != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)a.n * (a.Tq / a.R);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = FwdLayout(a.R, a.hs).bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<kCausal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<kCausal><<<(unsigned)blocks, kThreads, smem, stream>>>(a, rm);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- bf16 body

// Tiles of flash_fwd_mma_kernel for the padded head size D (64, 128, 256):
// kWarps warps of 16 query rows each (kBr rows a block), key tiles of kBc
// rows, rows kLd bf16 apart in shared memory: the query tile, then a ring
// of kStages stages of a key and a value tile.
template <int D>
struct MmaFwd {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBr = 16 * kWarps;
  static constexpr int kBc = D == 256 ? 32 : 64;
  static constexpr int kLd = D + 8;
  // q's A fragments held in registers for the whole block at D = 64 (16
  // registers), re-read from shared memory per key tile at D = 128 and 256,
  // where they would take 32 or 64 registers beside 64 or 128 of the output
  static constexpr bool kQRegs = D == 64;
  // resident blocks an SM: at D = 64 three (168 registers a thread, 46 KB
  // of shared memory; four would hold a thread to 128 registers, which
  // spilled and ran slower), else two (87 KB, 101 KB)
  static constexpr int kMinBlocks = D == 64 ? 3 : 2;
  static constexpr int kStages = 2;
  static constexpr size_t kQBytes = (size_t)kBr * kLd * 2;
  static constexpr size_t kTileBytes = (size_t)kBc * kLd * 2;
  static constexpr size_t kBytes = kQBytes + 2 * kStages * kTileBytes;
};

// kRows rows of hs bf16 from src (the first row; rows hs apart) into dst
// (rows D + 8 apart), columns hs..D-1 zeroed. vec: 16-byte cp.async (hs a
// multiple of 8, 16-byte aligned rows), which the caller commits and waits
// for; else plain element copies, which a barrier publishes.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int hs, bool vec) {
  constexpr int kLd = D + 8;
  if (vec) {
    constexpr int kChunks = D / 8;
    static_assert(kRows * kChunks % kThreads == 0, "a whole number of chunks a thread");
#pragma unroll
    for (int u = 0; u < kRows * kChunks / kThreads; ++u) {
      const int idx = (int)threadIdx.x + u * kThreads;
      const int r = idx / kChunks, c = idx % kChunks;
      const bool in = c * 8 < hs;
      mma::cp_async16(dst + r * kLd + c * 8, src + (size_t)r * hs + (in ? c * 8 : 0), in);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      dst[r * kLd + c] = c < hs ? src[(size_t)r * hs + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// 16 output rows (rows of a (T, hs) plane from dst on), columns c0 ..
// c0 + kN - 1 of the padded D: each thread's elements of fragment rows g and
// g + 8 packed in v[dt][0], v[dt][1] for columns c0 + 8 dt + 2 (lane % 4) +
// {0, 1}, written through 16 rows of shared memory (stage, rows kLd apart)
// whose columns c0 .. c0 + kN - 1 only this warp uses, so that device memory
// sees 16-byte stores (vec), else element stores. Columns from hs on are
// not stored.
template <int D, int kN = D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, __nv_bfloat16* stage,
                                           const uint32_t (&v)[kN / 8][2], int hs, bool vec,
                                           int lane, int c0 = 0) {
  constexpr int kLd = D + 8;
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < kN / 8; ++dt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stage + mma::frag_row(lane, 2 * h) * kLd + c0 + 8 * dt +
                                   mma::frag_col(lane, 0)) = v[dt][h];
  __syncwarp();
  // columns to store: hs for a whole row (the forward's stores, whose
  // registers the general form below would disturb)
  const int w = kN == D ? hs : min(c0 + kN, hs) - c0;
  if (vec) {
    const int chunks = w / 8;
    for (int idx = lane; idx < 16 * chunks; idx += 32) {
      const int r = idx / chunks, c = c0 + 8 * (idx - r * chunks);
      *reinterpret_cast<uint4*>(dst + (size_t)r * hs + c) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + c);
    }
  } else {
    for (int idx = lane; idx < 16 * w; idx += 32) {
      const int r = idx / w, c = c0 + idx - r * w;
      dst[r * hs + c] = stage[r * kLd + c];
    }
  }
  __syncwarp();
}

// The bf16 body (see the note at the top). One block per (collapsed row,
// query tile of kBr rows); kMulti: J > 1 streams summed; kMapped: the rows'
// mask rows are mapped (rm, data parallelism; mask_row).
template <int D, bool kCausal, bool kMulti, bool kMapped>
__global__ void __launch_bounds__(MmaFwd<D>::kThreads, MmaFwd<D>::kMinBlocks)
    flash_fwd_mma_kernel(const FwdArgs a, const FlashRows rm) {
  using C = MmaFwd<D>;
  using bf16 = __nv_bfloat16;
  constexpr int kBr = C::kBr, kBc = C::kBc, kLd = C::kLd;
  constexpr int kSn = kBc / 8;  // n8 tiles of a warp's scores
  constexpr int kOn = D / 8;    // n8 tiles of a warp's output
  extern __shared__ __align__(128) char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the longest causal query tiles first, over every collapsed row
  const int n_qt = a.Tq / kBr;
  const int qt = n_qt - 1 - (int)(blockIdx.x / a.n);
  const int row = (int)(blockIdx.x % a.n);
  const int q0 = qt * kBr, w0 = q0 + 16 * warp;  // the block's and the warp's first query row
  const int n_kt = a.Tk / kBc;
  // the last key tile of the block and of the warp: the diagonal one under
  // the causal mask (a warp skips the tiles wholly above its rows), else all
  const int tiles = (kCausal ? min((q0 + kBr - 1) / kBc, n_kt - 1) : n_kt - 1) + 1;
  const int kt_warp = kCausal ? min((w0 + 15) / kBc, n_kt - 1) : n_kt - 1;
  const int hs = a.hs;
  const size_t qplane = (size_t)a.Tq * hs, kplane = (size_t)a.Tk * hs;
  const int r0 = w0 + mma::frag_row(lane, 0), r1 = r0 + 8;  // this thread's query rows
  const int c0 = mma::frag_col(lane, 0);                    // and first column of an n8 tile
  bf16* sw = sq + 16 * warp * kLd;                          // the warp's rows of q

  const int n_it = a.J * tiles;
  // the key tile of iteration it (stream it / tiles, tile it % tiles) in
  // stage it % kStages of the ring, its value tile after it
  auto stage = [&](int it) {
    return reinterpret_cast<bf16*>(smem + C::kQBytes + (it % C::kStages) * 2 * C::kTileBytes);
  };
  // one commit group for each iteration, empty past the last
  auto load_kv = [&](int it) {
    if (it < n_it) {
      const int j = it / tiles, kt = it - j * tiles;
      const size_t at = ((size_t)j * a.n + row) * kplane + (size_t)kt * kBc * hs;
      bf16* st = stage(it);
      load_rows_async<D, kBc, C::kThreads>(st, static_cast<const bf16*>(a.k) + at, hs, a.vec);
      load_rows_async<D, kBc, C::kThreads>(st + kBc * kLd, static_cast<const bf16*>(a.v) + at,
                                           hs, a.vec);
    }
    mma::cp_async_commit();
  };
  load_rows_async<D, kBr, C::kThreads>(
      sq, static_cast<const bf16*>(a.q) + row * qplane + (size_t)q0 * hs, hs, a.vec);
#pragma unroll
  for (int it = 0; it < C::kStages - 1; ++it) load_kv(it);

  const float sl2 = a.scale * 1.4426950408889634f;  // exp(x scale) = exp2(x sl2)
  uint32_t qf[C::kQRegs ? D / 16 : 1][4];
  float o[kOn][4];
  float m[2], l[2];  // running max of the raw scores, this thread's part of the row sum
  uint32_t sum[kMulti ? kOn : 1][2];

  for (int it = 0; it < n_it; ++it) {
    const int j = it / tiles, kt = it - j * tiles;
    mma::cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile it landed; every warp is done with iteration it - 1's stage
    load_kv(it + C::kStages - 1);
    if constexpr (C::kQRegs) {
      if (it == 0)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma::ldsm_x4(qf[kk], mma::a_frag_addr(sw, kLd, 0, 16 * kk, lane));
    }
    if (kt == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = -INFINITY;
        l[h] = 0.f;
      }
#pragma unroll
      for (int dt = 0; dt < kOn; ++dt)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
    }
    if (kt <= kt_warp) {
      const bf16* sk = stage(it);
      const bf16* sv = sk + kBc * kLd;
      const int k0 = kt * kBc;
      // S = q k^T, 16 x kBc a warp
      float s[kSn][4];
#pragma unroll
      for (int nt = 0; nt < kSn; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) af[i] = qf[kk][i];
        } else {
          mma::ldsm_x4(af, mma::a_frag_addr(sw, kLd, 0, 16 * kk, lane));
        }
#pragma unroll
        for (int nt = 0; nt < kSn; nt += 2) {
          uint32_t b[4];
          mma::ldsm_x4(b, mma::bt_frag_addr(sk, kLd, 8 * nt, 16 * kk, lane));
          mma::mma_bf16(s[nt], af, b[0], b[1]);
          mma::mma_bf16(s[nt + 1], af, b[2], b[3]);
        }
      }
      // the causal mask, on the tiles that cross the warp's diagonal
      if (kCausal && k0 + kBc - 1 > w0) {
#pragma unroll
        for (int nt = 0; nt < kSn; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + 8 * nt + mma::frag_col(lane, i) > (i < 2 ? r0 : r1)) s[nt][i] = -INFINITY;
      }
      // online softmax: the row max over the quad holding the row, the old
      // sums and outputs rescaled
      float base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int nt = 0; nt < kSn; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row with every key so far masked keeps p = 0, and no NaN
        base[h] = mx == -INFINITY ? 0.f : mx * sl2;
        const float corr = mma::exp2_approx(m[h] * sl2 - base[h]);
        m[h] = mx;
        l[h] *= corr;
#pragma unroll
        for (int dt = 0; dt < kOn; ++dt) {
          o[dt][2 * h] *= corr;
          o[dt][2 * h + 1] *= corr;
        }
      }
      // p = exp(s - m) into the row sums, the dropped p zeroed, rounded to
      // bf16 and packed as P.V's A fragments
      const uint32_t seed = a.stream_seeds ? stream_seed(a.seed, j) : a.seed;
      const KeepRow kr0(a.on, seed, mask_row<kMapped>(rm, row), (uint32_t)a.bq,
                        (uint32_t)a.bk, (uint32_t)r0, (uint32_t)k0, a.thresh);
      const KeepRow kr1(a.on, seed, mask_row<kMapped>(rm, row), (uint32_t)a.bq,
                        (uint32_t)a.bk, (uint32_t)r1, (uint32_t)k0, a.thresh);
      uint32_t pf[kBc / 16][4];
#pragma unroll
      for (int nt = 0; nt < kSn; ++nt) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = mma::exp2_approx(fmaf(s[nt][i], sl2, -base[i >> 1]));
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        if (a.on) {
          const uint32_t c = 8 * nt + c0;
          if (!kr0(c)) p[0] = 0.f;
          if (!kr0(c + 1)) p[1] = 0.f;
          if (!kr1(c)) p[2] = 0.f;
          if (!kr1(c + 1)) p[3] = 0.f;
        }
        pf[nt / 2][2 * (nt & 1)] = mma::pack_bf16(p[0], p[1]);
        pf[nt / 2][2 * (nt & 1) + 1] = mma::pack_bf16(p[2], p[3]);
      }
      // O += P V
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk)
#pragma unroll
        for (int dt = 0; dt < kOn; dt += 2) {
          uint32_t b[4];
          mma::ldsm_x4_trans(b, mma::a_frag_addr(sv, kLd, 16 * kk, 8 * dt, lane));
          mma::mma_bf16(o[dt], pf[kk], b[0], b[1]);
          mma::mma_bf16(o[dt + 1], pf[kk], b[2], b[3]);
        }
    }
    if (kt != tiles - 1) continue;

    // stream j's output rounded to bf16, and its logsumexp
    float den[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      den[h] = lt * a.keepf;
      const float lse = m[h] * a.scale + logf(lt);
      const size_t at = (size_t)row * a.Tq + (h ? r1 : r0);
      if (c0 == 0) {
        if (a.lse) a.lse[at] = lse;
        if (a.lses) a.lses[(size_t)j * a.n * a.Tq + at] = lse;
      }
    }
    uint32_t ob[kOn][2];
#pragma unroll
    for (int dt = 0; dt < kOn; ++dt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ob[dt][h] = mma::pack_bf16(o[dt][2 * h] / den[h], o[dt][2 * h + 1] / den[h]);
    if (a.outs) {
      bf16* dst = static_cast<bf16*>(a.outs) + ((size_t)j * a.n + row) * qplane;
#pragma unroll
      for (int dt = 0; dt < kOn; ++dt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * dt + c0;
          bf16* p = dst + (size_t)(h ? r1 : r0) * hs + c;
          if (a.vec) {
            if (c < hs) *reinterpret_cast<uint32_t*>(p) = ob[dt][h];
          } else {
            const float2 f = mma::unpack_bf16(ob[dt][h]);
            if (c < hs) p[0] = __float2bfloat16_rn(f.x);
            if (c + 1 < hs) p[1] = __float2bfloat16_rn(f.y);
          }
        }
    }
    bf16* out = static_cast<bf16*>(a.out) + row * qplane + (size_t)w0 * hs;
    if constexpr (kMulti) {
      // the rounded running sum plus this stream's rounded output, rounded
#pragma unroll
      for (int dt = 0; dt < kOn; ++dt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (j == 0) {
            sum[dt][h] = ob[dt][h];
          } else {
            const float2 x = mma::unpack_bf16(sum[dt][h]), y = mma::unpack_bf16(ob[dt][h]);
            sum[dt][h] = mma::pack_bf16(x.x + y.x, x.y + y.y);
          }
        }
      if (j == a.J - 1) store_rows<D>(out, sw, sum, hs, a.vec, lane);
    } else {
      store_rows<D>(out, sw, ob, hs, a.vec, lane);
    }
  }
}

template <int D, bool kCausal, bool kMulti, bool kMapped>
int launch_flash_fwd_mma(const FwdArgs& a, FlashRows rm, cudaStream_t stream) {
  using C = MmaFwd<D>;
  if (a.Tq % C::kBr != 0 || a.Tk % C::kBc != 0 || a.bq % C::kBr != 0 || a.bk % C::kBc != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)a.n * (a.Tq / C::kBr);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D, kCausal, kMulti, kMapped>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kBytes);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_mma_kernel<D, kCausal, kMulti, kMapped>
      <<<(unsigned)blocks, C::kThreads, C::kBytes, stream>>>(a, rm);
  return (int)cudaGetLastError();
}

// kCross: J streams summed under the causal mask (the cross kernels, K6f
// and K6f-r); else one stream with the causal mask or none (K5f, K7f). Each
// source compiles only the instances its kernels launch. Mapped mask rows
// (a rank's rows of the global call) in instances of their own.
template <int D, bool kCross>
int launch_flash_fwd_d(const FwdArgs& a, FlashRows rm, cudaStream_t stream) {
  const bool mapped = rm.mapped();
  if constexpr (kCross) {
    if (!a.causal) return (int)cudaErrorInvalidValue;
    if (a.J > 1)
      return mapped ? launch_flash_fwd_mma<D, true, true, true>(a, rm, stream)
                    : launch_flash_fwd_mma<D, true, true, false>(a, rm, stream);
  } else {
    if (a.J > 1) return (int)cudaErrorInvalidValue;
    if (!a.causal)
      return mapped ? launch_flash_fwd_mma<D, false, false, true>(a, rm, stream)
                    : launch_flash_fwd_mma<D, false, false, false>(a, rm, stream);
  }
  return mapped ? launch_flash_fwd_mma<D, true, false, true>(a, rm, stream)
                : launch_flash_fwd_mma<D, true, false, false>(a, rm, stream);
}

// bf16 on the tensor cores (mma.sync, hs padded to D = 64, 128 or 256), f32
// on FMAs; the causal mask or none.
template <bool kCross>
inline int launch_flash_fwd(FwdArgs a, FlashRows rm, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    a.vec = a.hs % 8 == 0 && aligned16({a.q, a.k, a.v, a.out, a.outs});
    if (a.hs <= 0 || a.hs > 256) return (int)cudaErrorInvalidValue;
    return a.hs <= 64    ? launch_flash_fwd_d<64, kCross>(a, rm, stream)
           : a.hs <= 128 ? launch_flash_fwd_d<128, kCross>(a, rm, stream)
                         : launch_flash_fwd_d<256, kCross>(a, rm, stream);
  }
  a.vec = 0;
  return a.causal ? launch_flash_fwd_f32<true>(a, rm, stream)
                  : launch_flash_fwd_f32<false>(a, rm, stream);
}

}  // namespace flash
}  // namespace tat
