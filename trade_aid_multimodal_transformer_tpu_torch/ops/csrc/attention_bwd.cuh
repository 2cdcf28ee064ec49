// Backward of whole-row causal attention, shared by the cross-attention
// backward (short_cross_attention.cu, K2b), the fused QKV attention backward
// (fused_qkv_attention_bwd.cu, K1b's attention launch) and the self-attention
// backwards over separate and packed q, k, v (short_causal_attention.cu, K3b
// and K4b). Per collapsed row r and stream j it recomputes, with the JAX
// kernels' math (pallas_attention.py _short_cross_bwd_kernel /
// _fqkv_bwd_kernel):
//   p  = exp(s - m) with s = q k^T * scale causally masked, m its row max,
//   l  = rowsum(p)                                    (f32, unmasked)
//   w  = keep ? p * (inv / l) : 0   (p / l without dropout), rounded to T
//   dp = keep ? (do v^T) * inv : 0  (do v^T without dropout)
//   D  = rowsum(w * do v^T) (cross) or rowsum(do * o) (every self layout)
//   ds = ((p / l) * (dp - D)) rounded to T
//   dv_j = w^T do, dk_j = scale * ds^T q, dq = sum_j scale * ds k_j
// with every product summed in f32 and each gradient rounded once.
//
// The row layout (``BwdArgs::layout``) says where row r's q, k_j and v_j
// planes lie and which mask row keys it; every layout but the cross one
// takes the unoffset seed and D = rowsum(do * o). Each gradient lands at its
// input's offset in its own buffer (the fused and packed layouts pass one
// d(qkv) buffer as dq, dk and dv); dout and the output o of row r are plane
// r. The layout is a run-time argument read once, in the prologue.
//
// What bounds it on the H100: at the production shapes (K2b: 192 rows, J =
// 3; K1b: 768 rows; T = 64, hs = 64, bf16) every (row, stream) is one 64 x 64
// tile pair of five products, ~17 FLOP a byte moved, so memory bounds it
// (K2b 22.5 MB, 0.0070 ms at 3.35 TB/s). What the bf16 body (every model
// path, hs <= 128) does about it, on mma.sync m16n8k16 (flash_mma.cuh; the
// pieces it shares with the forward in whole_row_mma.cuh):
// - T <= 64 (attn_bwd_row_kernel): one block of 4 warps per collapsed row
//   holds the whole row on chip and reads every input once. q and dout are
//   copied once into shared memory as bf16 by cp.async, each stream's k_j and
//   v_j through a ring of two stages (stream j + 1 loads while j is
//   computed). In the query-major phase warp w owns query rows 16w..16w+15
//   and every key of them: S = q k^T and dP = dout v^T once each into
//   registers, the row max and sum exact over the whole row (quad
//   shuffles), the dropout bit per held element, D, ds, and dQ += dS K_j
//   with dq held in registers across the streams (summed in stream order,
//   scaled and rounded once); w and ds go to shared memory as bf16. After
//   one barrier, in the key-major phase warp w owns keys 16w..16w+15: dV_j
//   = w^T dout and dK_j = ds^T q read w, ds, dout and q transposed through
//   ldmatrix and are stored once, staged for 16-byte writes. Two barriers a
//   tile pair; nothing but the inputs and the gradients touches device
//   memory.
// - 64 < T <= 512: two kernels over the same fragments, without atomics.
//   attn_bwd_dq_kernel (one block per (row, 64-row query tile), the longest
//   tiles first) walks its key tiles three times a stream (row max and sum
//   online, then D for the cross layout, then ds and dQ += dS K), keeps dq
//   in registers across the streams and writes each query row's max, 1 / l
//   and D to an f32 workspace; attn_bwd_dkv_kernel (one block per (row,
//   stream, key tile)) walks the query tiles with them through the ring,
//   forms w and ds query-major from the stored statistics and accumulates
//   dk and dv key-major in registers. Key tiles are 64 rows at hs <= 64, 32
//   at hs <= 128, so dk and dv take 64 registers a thread either way.
// Rows are padded to D + 8 elements (D = 64 or 128, zeros beyond hs), rows
// past T are zeros and are neither stored nor seen by a real row. f32 (the
// correctness gates) and bf16 above hs 128 run the FMA body below: one
// block of 256 threads per row, tiles of R rows in f32 shared memory, dq
// gathered in the row's f32 workspace. No body uses atomics: two runs give
// the same bits.
#pragma once

#include "whole_row_mma.cuh"

namespace tat {

// Row layouts of the backward:
//   kCrossRows   q (n, T, hs), k and v (J, n, T, hs); stream j keyed by
//                seed + (j + 1) * 1000003, mask row rm(r); D = rowsum(w * do v^T)
//   kFusedRows   q, k, v in one (M, 3H, B, T, hs) buffer, r = (m H + h) B + b;
//                mask row of the JAX fused kernel's batch groups (gb) over the
//                global batch of Bg rows, whose row b0 + b this b is
//   kSelfRows    q, k, v (n, T, hs); mask row rm(r)
//   kPackedRows  one (nb, 3H, T, hs) operand, r = b H + h: q at [b, h], k at
//                [b, H + h], v at [b, 2H + h]; mask row r
// Every layout but kCrossRows has J = 1, the unoffset seed and D = rowsum(do * o).
enum BwdLayout { kCrossRows = 0, kFusedRows = 1, kSelfRows = 2, kPackedRows = 3 };

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // the forward output (for D); unused by kCrossRows
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* dq_ws;      // f32 workspace: (n, T, hs) dq of the FMA body; 3 J n T
                     // row statistics of the bf16 body at T > 64
  int J, n, Tn, hs, R, n_t;
  float scale;
  int rate_on;
  uint32_t seed, thresh;
  float inv;         // 1 / (1 - rate) as f32
  int layout;        // a BwdLayout
  int B, H, gb;      // kFusedRows: B, H, gb; kPackedRows: H
  int Bg, b0;        // kFusedRows: the global batch and this launch's first row of it
  RowMap rm;         // kSelfRows, kCrossRows: the rows' mask rows (data parallelism);
                     // kFusedRows: span the model's head count Hg, base the global
                     // head h0 of head 0 (tensor parallelism), skip unused
  int vec;           // bf16 body: 16-byte copies (hs % 8 == 0, aligned)
};

// Where row r's planes lie: q at q_off; k and v at k_off, v_off (every
// layout but the cross one; the cross layout's stream j at (j n + r) plane);
// n_idx the mask row.
struct RowPlanes {
  size_t q_off, k_off, v_off;
  uint32_t n_idx;
  bool self;
  __device__ RowPlanes(const BwdArgs& a, int r) {
    const size_t plane = (size_t)a.Tn * a.hs;
    self = a.layout != kCrossRows;
    if (a.layout == kFusedRows) {
      const int b = r % a.B, h = (r / a.B) % a.H, m = r / (a.B * a.H);
      const size_t head = (size_t)a.B * plane;  // one virtual head of (M, 3H, B, T, hs)
      q_off = ((size_t)m * 3 * a.H + h) * head + b * plane;
      k_off = q_off + (size_t)a.H * head;
      v_off = k_off + (size_t)a.H * head;
      // the global batch's row bg and the model's head rm.base + h of its rm.span
      const int bg = a.b0 + b, pid = m * (a.Bg / a.gb) + bg / a.gb;
      n_idx = (uint32_t)(pid * a.gb * a.rm.span + (a.rm.base + h) * a.gb + bg % a.gb);
    } else if (a.layout == kPackedRows) {
      q_off = ((size_t)(r / a.H) * 3 * a.H + r % a.H) * plane;
      k_off = q_off + (size_t)a.H * plane;
      v_off = k_off + (size_t)a.H * plane;
      n_idx = (uint32_t)r;
    } else {
      q_off = (size_t)r * plane;
      k_off = v_off = a.layout == kSelfRows ? q_off : 0;
      n_idx = a.rm(r);
    }
  }
  // offsets of stream j's k and v planes (and of their gradients)
  __device__ size_t k_of(const BwdArgs& a, int r, int j) const {
    return self ? k_off : ((size_t)j * a.n + r) * a.Tn * a.hs;
  }
  __device__ size_t v_of(const BwdArgs& a, int r, int j) const {
    return self ? v_off : ((size_t)j * a.n + r) * a.Tn * a.hs;
  }
};

// ------------------------------------------------------------- FMA body

__host__ __device__ inline size_t attn_bwd_smem_floats(int R, int hs, int n_t) {
  return (size_t)4 * R * (hs + 1) + (size_t)3 * R * (R + 1) + (size_t)3 * n_t * R;
}

// out[i][j] = sum_e A[i][e] * Bm[j][e] for i, j < R (row strides ld, lds).
__device__ inline void prod_abt(const float* A, const float* Bm, float* out, int R,
                                int hs, int ld, int lds) {
  const int step = kThreads / R, j = threadIdx.x % R, i0 = threadIdx.x / R;
  if (threadIdx.x < step * R) {
    float acc[kMaxPerThread];
#pragma unroll
    for (int u = 0; u < kMaxPerThread; ++u) acc[u] = 0.f;
    for (int e = 0; e < hs; ++e) {
      const float bv = Bm[j * ld + e];
#pragma unroll
      for (int u = 0; u < kMaxPerThread; ++u) {
        const int i = i0 + u * step;
        if (i < R) acc[u] = fmaf(A[i * ld + e], bv, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxPerThread; ++u) {
      const int i = i0 + u * step;
      if (i < R) out[i * lds + j] = acc[u];
    }
  }
  __syncthreads();
}

// acc[u] (row c = i0 + u * step, column e) += sum_i P[i][c] * Bm[i][e]
__device__ inline void prod_ptb(const float* P, int lds, const float* Bm, int ld, int R,
                                int hs, float (&acc)[kMaxPerThread]) {
  const int step = kThreads / hs, e = threadIdx.x % hs, i0 = threadIdx.x / hs;
  if (threadIdx.x < step * hs) {
    for (int i = 0; i < R; ++i) {
      const float bv = Bm[i * ld + e];
#pragma unroll
      for (int u = 0; u < kMaxPerThread; ++u) {
        const int c = i0 + u * step;
        if (c < R) acc[u] = fmaf(P[i * lds + c], bv, acc[u]);
      }
    }
  }
}

// acc[u] (row i = i0 + u * step, column e) = sum_c P[i][c] * Bm[c][e]
__device__ inline void prod_pb(const float* P, int lds, const float* Bm, int ld, int R,
                               int hs, float (&acc)[kMaxPerThread]) {
  const int step = kThreads / hs, e = threadIdx.x % hs, i0 = threadIdx.x / hs;
#pragma unroll
  for (int u = 0; u < kMaxPerThread; ++u) acc[u] = 0.f;
  if (threadIdx.x < step * hs) {
    for (int c = 0; c < R; ++c) {
      const float bv = Bm[c * ld + e];
#pragma unroll
      for (int u = 0; u < kMaxPerThread; ++u) {
        const int i = i0 + u * step;
        if (i < R) acc[u] = fmaf(P[i * lds + c], bv, acc[u]);
      }
    }
  }
}

// One block of 256 threads per collapsed row r walks every stream j and
// every (query tile, key tile) pair with tiles of R rows, all in f32 shared
// memory with the products on FMAs. Row statistics (m, l, D) take two or
// three passes over the key tiles of a query tile; the gradient pass walks
// key tiles outermost so that dk_j and dv_j stay in registers, and dq
// gathers in the f32 workspace rows that only this block touches.
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem_bwd[];
  const int R = a.R, hs = a.hs, ld = hs + 1, lds = R + 1, Tn = a.Tn, n_t = a.n_t;
  float* sQ = smem_bwd;
  float* sK = sQ + R * ld;
  float* sV = sK + R * ld;
  float* sDo = sV + R * ld;
  float* sP = sDo + R * ld;  // scores, then p = exp(s - m)
  float* sW = sP + R * lds;  // w
  float* sS = sW + R * lds;  // do v^T, then ds
  float* mrow = sS + R * lds;
  float* lrow = mrow + n_t * R;
  float* drow = lrow + n_t * R;
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const size_t plane = (size_t)Tn * hs;

  const RowPlanes pl(a, r);
  const T* Q = static_cast<const T*>(a.q) + pl.q_off;
  const T* Do = static_cast<const T*>(a.dout) + (size_t)r * plane;
  float* ws = a.dq_ws + (size_t)r * plane;
  for (size_t idx = tid; idx < plane; idx += kThreads) ws[idx] = 0.f;
  __syncthreads();

  const bool held = n_t == 1;
  const int stepH = kThreads / hs, eH = tid % hs, iH = tid / hs;
  const bool actH = tid < stepH * hs;

  // scores of the loaded q tile (q0) against the loaded k tile (k0) into sP,
  // scaled and causally masked
  auto scores_to_p = [&](int q0, int k0) {
    prod_abt(sQ, sK, sP, R, hs, ld, lds);
    for (int idx = tid; idx < R * R; idx += kThreads) {
      const int i = idx / R, j = idx % R;
      float* sp = sP + i * lds + j;
      *sp = (k0 + j <= q0 + i) ? *sp * a.scale : -INFINITY;
    }
    __syncthreads();
  };
  // sP <- exp(sP - m) with the rows' final max
  auto exp_rows = [&](int q0) {
    for (int idx = tid; idx < R * R; idx += kThreads) {
      const int i = idx / R, j = idx % R;
      sP[i * lds + j] = expf(sP[i * lds + j] - mrow[q0 + i]);
    }
    __syncthreads();
  };
  // sW <- w (rounded to T) and sS <- dp = masked, scaled do v^T, from sP = p and
  // sS = do v^T; keeps do v^T for D where asked
  auto weights = [&](int q0, int k0, const Dropout& d, bool fold_d) {
    for (int idx = tid; idx < R * R; idx += kThreads) {
      const int i = idx / R, j = idx % R;
      const float p = sP[i * lds + j], l = lrow[q0 + i];
      bool keep = true;
      if (d.on) keep = keep_bit(d.seed, d.n_idx, (uint32_t)(q0 + i), (uint32_t)(k0 + j), d.thresh);
      const float w = d.on ? (keep ? p * (a.inv / l) : 0.f) : p / l;
      sW[i * lds + j] = Io<T>::round(w);
      if (!fold_d) {
        const float dpr = sS[i * lds + j];
        sS[i * lds + j] = d.on ? (keep ? dpr * a.inv : 0.f) : dpr;
      }
    }
    __syncthreads();
  };

  for (int jj = 0; jj < a.J; ++jj) {
    const T* Kj = static_cast<const T*>(a.k) + pl.k_of(a, r, jj);
    const T* Vj = static_cast<const T*>(a.v) + pl.v_of(a, r, jj);
    const Dropout d{pl.self ? a.seed : stream_seed(a.seed, jj), pl.n_idx, a.thresh,
                    a.rate_on != 0};

    // ---- row statistics: m, l and D of every query row
    for (int qt = 0; qt < n_t; ++qt) {
      const int q0 = qt * R;
      load_rows<T>(Q, Tn, q0, R, hs, sQ, ld);
      for (int i = tid; i < R; i += kThreads) {
        mrow[q0 + i] = -INFINITY;
        lrow[q0 + i] = 0.f;
        drow[q0 + i] = 0.f;
      }
      __syncthreads();
      for (int kt = 0; kt <= qt; ++kt) {  // max
        load_rows<T>(Kj, Tn, kt * R, R, hs, sK, ld);
        scores_to_p(q0, kt * R);
        if (tid < R) {
          float mx = mrow[q0 + tid];
          for (int j = 0; j < R; ++j) mx = fmaxf(mx, sP[tid * lds + j]);
          mrow[q0 + tid] = mx;
        }
        __syncthreads();
      }
      for (int kt = 0; kt <= qt; ++kt) {  // row sum (a held tile keeps its scores)
        if (!held) {
          load_rows<T>(Kj, Tn, kt * R, R, hs, sK, ld);
          scores_to_p(q0, kt * R);
        }
        exp_rows(q0);
        if (tid < R) {
          float sum = 0.f;
          for (int j = 0; j < R; ++j) sum += sP[tid * lds + j];
          lrow[q0 + tid] += sum;
        }
        __syncthreads();
      }
      load_rows<T>(Do, Tn, q0, R, hs, sDo, ld);
      if (pl.self) {  // D = rowsum(do * o)
        const T* O = static_cast<const T*>(a.o) + (size_t)r * plane;
        if (tid < R && q0 + tid < Tn) {
          float acc = 0.f;
          for (int e = 0; e < hs; ++e)
            acc += Io<T>::load(O + (size_t)(q0 + tid) * hs + e) * sDo[tid * ld + e];
          drow[q0 + tid] = acc;
        }
        __syncthreads();
      } else {  // D = rowsum(w * do v^T)
        for (int kt = 0; kt <= qt; ++kt) {
          if (!held) {
            load_rows<T>(Kj, Tn, kt * R, R, hs, sK, ld);
            scores_to_p(q0, kt * R);
            exp_rows(q0);
          }
          load_rows<T>(Vj, Tn, kt * R, R, hs, sV, ld);
          prod_abt(sDo, sV, sS, R, hs, ld, lds);
          weights(q0, kt * R, d, true);
          if (tid < R) {
            float acc = 0.f;
            for (int j = 0; j < R; ++j) acc += sW[tid * lds + j] * sS[tid * lds + j];
            drow[q0 + tid] += acc;
          }
          __syncthreads();
        }
      }
    }

    // ---- gradients, key tiles outermost
    for (int kt = 0; kt < n_t; ++kt) {
      const int k0 = kt * R;
      load_rows<T>(Kj, Tn, k0, R, hs, sK, ld);
      load_rows<T>(Vj, Tn, k0, R, hs, sV, ld);
      float dk[kMaxPerThread], dv[kMaxPerThread];
#pragma unroll
      for (int u = 0; u < kMaxPerThread; ++u) dk[u] = dv[u] = 0.f;
      for (int qt = kt; qt < n_t; ++qt) {
        const int q0 = qt * R;
        if (!held) {
          load_rows<T>(Q, Tn, q0, R, hs, sQ, ld);
          load_rows<T>(Do, Tn, q0, R, hs, sDo, ld);
        }
        scores_to_p(q0, k0);
        exp_rows(q0);
        prod_abt(sDo, sV, sS, R, hs, ld, lds);
        weights(q0, k0, d, false);
        // ds = round((p / l) * (dp - D)) in place of dp
        for (int idx = tid; idx < R * R; idx += kThreads) {
          const int i = idx / R, j = idx % R;
          const float pl_ = sP[i * lds + j] / lrow[q0 + i];
          sS[i * lds + j] = Io<T>::round(pl_ * (sS[i * lds + j] - drow[q0 + i]));
        }
        __syncthreads();
        prod_ptb(sW, lds, sDo, ld, R, hs, dv);
        prod_ptb(sS, lds, sQ, ld, R, hs, dk);
        float dq[kMaxPerThread];
        prod_pb(sS, lds, sK, ld, R, hs, dq);
        if (actH) {
#pragma unroll
          for (int u = 0; u < kMaxPerThread; ++u) {
            const int i = iH + u * stepH, row = q0 + i;
            if (i < R && row < Tn) ws[(size_t)row * hs + eH] += a.scale * dq[u];
          }
        }
        __syncthreads();
      }
      T* dK = static_cast<T*>(a.dk) + pl.k_of(a, r, jj);
      T* dV = static_cast<T*>(a.dv) + pl.v_of(a, r, jj);
      if (actH) {
#pragma unroll
        for (int u = 0; u < kMaxPerThread; ++u) {
          const int c = iH + u * stepH, row = k0 + c;
          if (c < R && row < Tn) {
            Io<T>::store(dK + (size_t)row * hs + eH, a.scale * dk[u]);
            Io<T>::store(dV + (size_t)row * hs + eH, dv[u]);
          }
        }
      }
      __syncthreads();
    }
  }

  T* dQ = static_cast<T*>(a.dq) + pl.q_off;
  for (size_t idx = tid; idx < plane; idx += kThreads) Io<T>::store(dQ + idx, ws[idx]);
}

// ------------------------------------------------------------- bf16 body

namespace wr {

// Tiles for the padded head size D (64 or 128): operand rows kLd bf16
// apart; the split kernels' key tiles of kBc rows (64 at D = 64, 32 at
// D = 128: dk and dv of 16 keys x 64 columns a warp); the w and ds tiles
// (query-major, kRows x keys) kLw apart.
template <int D>
struct Cfg {
  static constexpr int kLd = D + 8;
  static constexpr int kBc = 4096 / D;
  static constexpr size_t kOp = (size_t)kRows * kLd * 2;  // bytes of a 64-row operand tile
  static constexpr size_t kKv = (size_t)kBc * kLd * 2;    // bytes of a key tile
  // T <= 64: q, dout, two stages of (k, v), w and ds
  static constexpr int kLwRow = kRows + 8;
  static constexpr size_t kRowBytes = 6 * kOp + 2 * (size_t)kRows * kLwRow * 2;
  // T > 64, dq kernel: q, dout, two stages of (k, v)
  static constexpr size_t kDqBytes = 2 * kOp + 4 * kKv;
  // T > 64, dk/dv kernel: k, v, two stages of (q, dout, three rows of
  // statistics), w and ds
  static constexpr int kLwKv = kBc + 8;
  static constexpr size_t kStage = 2 * kOp + 3 * kRows * sizeof(float);
  static constexpr size_t kDkvBytes = 2 * kKv + 2 * kStage + 2 * (size_t)kRows * kLwKv * 2;
};

// S = q k^T (and with kDp dP = dout v^T) of a warp's 16 query rows (sq,
// sdo: their first row) against key slabs 0 .. ns - 1 of 16 rows (sk, sv:
// the key tile's first row), in C fragments: n8 tile nt holds keys 8nt ..
// 8nt + 7 of the tile. Slabs from ns on are left at zero.
template <int D, int kSn, bool kDp>
__device__ __forceinline__ void scores(float (&s)[kSn][4], float (&dp)[kSn][4], const bf16* sq,
                                       const bf16* sdo, const bf16* sk, const bf16* sv, int ns,
                                       int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int nt = 0; nt < kSn; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t qa[4], da[4];
    mma::ldsm_x4(qa, mma::a_frag_addr(sq, kLd, 0, 16 * kd, lane));
    if (kDp) mma::ldsm_x4(da, mma::a_frag_addr(sdo, kLd, 0, 16 * kd, lane));
#pragma unroll
    for (int kk = 0; kk < kSn / 2; ++kk) {
      if (kk < ns) {
        uint32_t b[4];
        mma::ldsm_x4(b, mma::bt_frag_addr(sk, kLd, 16 * kk, 16 * kd, lane));
        mma::mma_bf16(s[2 * kk], qa, b[0], b[1]);
        mma::mma_bf16(s[2 * kk + 1], qa, b[2], b[3]);
        if (kDp) {
          mma::ldsm_x4(b, mma::bt_frag_addr(sv, kLd, 16 * kk, 16 * kd, lane));
          mma::mma_bf16(dp[2 * kk], da, b[0], b[1]);
          mma::mma_bf16(dp[2 * kk + 1], da, b[2], b[3]);
        }
      }
    }
  }
}

// From s (scaled, masked scores; with kHaveP already p = exp(s - m)), the
// rows' max m2 and 1 / l: s <- p / l, dp <- the dropped, scaled dP; w
// (rounded) to sw unless it is null (the warp's first row, ldw apart, key
// columns from 0) and, with fold_d, each row's part of rowsum(w * dP) into
// dsum.
template <int kSn, bool kHaveP>
__device__ __forceinline__ void weights(float (&s)[kSn][4], float (&dp)[kSn][4], int ns, int k0,
                                        const float (&m2)[2], const float (&rl)[2],
                                        const KeepRowW (&kr)[2], bool on, float inv, bool fold_d,
                                        float (&dsum)[2], bf16* sw, int ldw, int lane) {
#pragma unroll
  for (int nt = 0; nt < kSn; ++nt) {
    if (nt < 2 * ns) {
      float wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const uint32_t c = (uint32_t)(k0 + 8 * nt + mma::frag_col(lane, i));
        const float pl = (kHaveP ? s[nt][i] : mma::exp2_approx(s[nt][i] - m2[h])) * rl[h];
        const bool keep = !on || kr[h](c);
        wv[i] = round_bf16(on ? (keep ? pl * inv : 0.f) : pl);
        const float dpr = dp[nt][i];
        if (fold_d) dsum[h] = fmaf(wv[i], dpr, dsum[h]);
        dp[nt][i] = on ? (keep ? dpr * inv : 0.f) : dpr;
        s[nt][i] = pl;
      }
      if (sw != nullptr) {
        const int c = 8 * nt + mma::frag_col(lane, 0), g = lane >> 2;
        *reinterpret_cast<uint32_t*>(sw + g * ldw + c) = mma::pack_bf16(wv[0], wv[1]);
        *reinterpret_cast<uint32_t*>(sw + (g + 8) * ldw + c) = mma::pack_bf16(wv[2], wv[3]);
      }
    }
  }
}

// ds = round((p / l) (dp - D)) from s = p / l and the dropped dP: packed as
// dQ's A fragments (da[kk], key slab kk) and, unless sds is null, stored to
// sds (the warp's first row, ldw apart).
template <int kSn>
__device__ __forceinline__ void dscores(const float (&s)[kSn][4], const float (&dp)[kSn][4],
                                        int ns, const float (&dc)[2], uint32_t (&da)[kSn / 2][4],
                                        bf16* sds, int ldw, int lane) {
#pragma unroll
  for (int kk = 0; kk < kSn / 2; ++kk) {
    if (kk < ns) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nt = 2 * kk + u;
        float d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = s[nt][i] * (dp[nt][i] - dc[i >> 1]);
        da[kk][2 * u] = mma::pack_bf16(d[0], d[1]);
        da[kk][2 * u + 1] = mma::pack_bf16(d[2], d[3]);
        if (sds != nullptr) {
          const int c = 8 * nt + mma::frag_col(lane, 0), g = lane >> 2;
          *reinterpret_cast<uint32_t*>(sds + g * ldw + c) = da[kk][2 * u];
          *reinterpret_cast<uint32_t*>(sds + (g + 8) * ldw + c) = da[kk][2 * u + 1];
        }
      }
    }
  }
}

// Key-major products of one query slab qs (16 rows): for the 16 keys from
// key column kc of the w and ds tiles (query-major, ldw apart),
// dv (16 keys x 64 columns from c0) += w^T dout and dk += ds^T q, the A
// operands read transposed from w and ds, the B operands from dout and q
// (rows of the query tile, kLd apart).
template <int kLd>
__device__ __forceinline__ void kv_product(float (&dk)[8][4], float (&dv)[8][4], const bf16* sw,
                                           const bf16* sds, int ldw, const bf16* sq,
                                           const bf16* sdo, int qs, int kc, int c0, int lane) {
  uint32_t aw[4], ad[4];
  mma::ldsm_x4_trans(aw, mma::bt_frag_addr(sw, ldw, 16 * qs, kc, lane));
  mma::ldsm_x4_trans(ad, mma::bt_frag_addr(sds, ldw, 16 * qs, kc, lane));
#pragma unroll
  for (int dt = 0; dt < 8; dt += 2) {
    uint32_t b[4];
    mma::ldsm_x4_trans(b, mma::a_frag_addr(sdo, kLd, 16 * qs, c0 + 8 * dt, lane));
    mma::mma_bf16(dv[dt], aw, b[0], b[1]);
    mma::mma_bf16(dv[dt + 1], aw, b[2], b[3]);
    mma::ldsm_x4_trans(b, mma::a_frag_addr(sq, kLd, 16 * qs, c0 + 8 * dt, lane));
    mma::mma_bf16(dk[dt], ad, b[0], b[1]);
    mma::mma_bf16(dk[dt + 1], ad, b[2], b[3]);
  }
}

// dk (times scale) and dv of 16 keys x 64 columns from c0, rounded, to rows
// [0, valid) of dk_dst / dv_dst, staged through the warp's rows of sk / sv.
template <int kLd>
__device__ __forceinline__ void store_kv(const float (&dk)[8][4], const float (&dv)[8][4],
                                         bf16* dk_dst, bf16* dv_dst, bf16* sk, bf16* sv,
                                         float scale, int hs, int valid, bool vec, int lane,
                                         int c0) {
  uint32_t ok[8][2], ov[8][2];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ok[dt][h] = mma::pack_bf16(dk[dt][2 * h] * scale, dk[dt][2 * h + 1] * scale);
      ov[dt][h] = mma::pack_bf16(dv[dt][2 * h], dv[dt][2 * h + 1]);
    }
  store_warp_rows<kLd, 8>(dk_dst, sk, ok, hs, valid, vec, lane, c0);
  store_warp_rows<kLd, 8>(dv_dst, sv, ov, hs, valid, vec, lane, c0);
}

// rowsum(do * o) of this thread's two rows (rows[h] of the plane; do from
// shared memory rows sdo_rows[h]), over the quad.
template <int kLd>
__device__ __forceinline__ void rowsum_do_o(float (&dc)[2], const bf16* O, const bf16* sdo,
                                            const int (&rows)[2], const int (&local)[2], int Tn,
                                            int hs, bool vec, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float acc = 0.f;
    if (rows[h] < Tn) {
      const bf16* o = O + (size_t)rows[h] * hs;
      const bf16* d = sdo + local[h] * kLd;
      if (vec) {
        for (int c = 8 * t; c < hs; c += 32) {
          const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(d + c);
          const uint32_t* op = reinterpret_cast<const uint32_t*>(&ov);
          const uint32_t* dp = reinterpret_cast<const uint32_t*>(&dv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 a = mma::unpack_bf16(op[u]), b = mma::unpack_bf16(dp[u]);
            acc = fmaf(a.x, b.x, acc);
            acc = fmaf(a.y, b.y, acc);
          }
        }
      } else {
        for (int c = t; c < hs; c += 4)
          acc = fmaf(__bfloat162float(o[c]), __bfloat162float(d[c]), acc);
      }
    }
    dc[h] = quad_sum(acc);
  }
}

// T <= 64: one block per collapsed row (see the note at the top).
template <int D>
__global__ void __launch_bounds__(kThreadsW) attn_bwd_row_kernel(const BwdArgs a) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, kLw = C::kLwRow, kSn = kRows / 8;
  extern __shared__ __align__(128) char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kRows * kLd;
  bf16* stages = sdo + kRows * kLd;  // stage s: k at stages + 2 s kRows kLd, v after it
  bf16* sw = stages + 4 * kRows * kLd;
  bf16* sds = sw + kRows * kLw;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x, Tn = a.Tn, hs = a.hs;
  const bool vec = a.vec != 0;
  const size_t plane = (size_t)Tn * hs;
  const RowPlanes pl(a, r);
  const int nq = (Tn + 15) / 16;  // query (and key) slabs
  const int w0 = 16 * warp;
  const bool active = warp < nq;
  const int rows[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};  // this thread's query rows
  const bf16* K = static_cast<const bf16*>(a.k);
  const bf16* V = static_cast<const bf16*>(a.v);

  auto load_kv = [&](int j) {
    if (j < a.J) {
      bf16* st = stages + (j & 1) * 2 * kRows * kLd;
      load_tile<D, kRows>(st, K + pl.k_of(a, r, j), hs, Tn, vec);
      load_tile<D, kRows>(st + kRows * kLd, V + pl.v_of(a, r, j), hs, Tn, vec);
    }
    mma::cp_async_commit();
  };
  load_tile<D, kRows>(sq, static_cast<const bf16*>(a.q) + pl.q_off, hs, Tn, vec);
  load_tile<D, kRows>(sdo, static_cast<const bf16*>(a.dout) + r * plane, hs, Tn, vec);
  load_kv(0);

  const float sl2 = a.scale * kLog2e;
  const bool on = a.rate_on != 0;
  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[dt][i] = 0.f;
  float dself[2] = {0.f, 0.f};

  for (int j = 0; j < a.J; ++j) {
    mma::cp_async_wait<0>();
    __syncthreads();  // stream j landed; every warp is done with stream j - 1's stage
    load_kv(j + 1);
    bf16* sk = stages + (j & 1) * 2 * kRows * kLd;
    bf16* sv = sk + kRows * kLd;
    if (j == 0 && pl.self && active) {
      const int local[2] = {rows[0], rows[1]};
      rowsum_do_o<kLd>(dself, static_cast<const bf16*>(a.o) + r * plane, sdo, rows, local, Tn,
                       hs, vec, lane);
    }

    // ---- query-major: warp rows w0.., every key up to the diagonal
    if (active) {
      const int ns = warp + 1;
      float s[kSn][4], dp[kSn][4];
      scores<D, kSn, true>(s, dp, sq + w0 * kLd, sdo + w0 * kLd, sk, sv, ns, lane);
      float m[2] = {-INFINITY, -INFINITY};
      mask_scale<kSn>(s, ns, 0, rows, sl2, m, lane);
      float m2[2], l[2] = {0.f, 0.f}, rl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m2[h] = quad_max(m[h]);
        if (m2[h] == -INFINITY) m2[h] = 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < kSn; ++nt)
        if (nt < 2 * ns)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[nt][i] = mma::exp2_approx(s[nt][i] - m2[i >> 1]);
            l[i >> 1] += s[nt][i];
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) rl[h] = 1.f / quad_sum(l[h]);
      const uint32_t seed = pl.self ? a.seed : stream_seed(a.seed, j);
      const KeepRowW kr[2] = {KeepRowW(on, seed, pl.n_idx, (uint32_t)rows[0], a.thresh),
                              KeepRowW(on, seed, pl.n_idx, (uint32_t)rows[1], a.thresh)};
      float dsum[2] = {0.f, 0.f};
      weights<kSn, true>(s, dp, ns, 0, m2, rl, kr, on, a.inv, !pl.self, dsum, sw + w0 * kLw, kLw,
                   lane);
      float dc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) dc[h] = pl.self ? dself[h] : quad_sum(dsum[h]);
      uint32_t da[kSn / 2][4];
      dscores<kSn>(s, dp, ns, dc, da, sds + w0 * kLw, kLw, lane);
      tile_product<D, kSn>(dq, da, sk, ns, lane);
    }
    __syncthreads();  // w and ds of every row are in shared memory

    // ---- key-major: warp keys w0.., every query from the diagonal on
    if (active) {
      bf16* dK = static_cast<bf16*>(a.dk) + pl.k_of(a, r, j) + (size_t)w0 * hs;
      bf16* dV = static_cast<bf16*>(a.dv) + pl.v_of(a, r, j) + (size_t)w0 * hs;
      for (int c0 = 0; c0 < D && c0 < hs; c0 += 64) {
        float dk[8][4], dv[8][4];
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
#pragma unroll
          for (int i = 0; i < 4; ++i) dk[dt][i] = dv[dt][i] = 0.f;
        for (int qs = warp; qs < nq; ++qs)
          kv_product<kLd>(dk, dv, sw, sds, kLw, sq, sdo, qs, w0, c0, lane);
        store_kv<kLd>(dk, dv, dK, dV, sk + w0 * kLd, sv + w0 * kLd, a.scale, hs, Tn - w0, vec,
                      lane, c0);
      }
    }
  }

  __syncthreads();  // the last key-major phase read every row of q
  if (active) {
    uint32_t out[D / 8][2];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        out[dt][h] = mma::pack_bf16(dq[dt][2 * h] * a.scale, dq[dt][2 * h + 1] * a.scale);
    store_warp_rows<kLd, D / 8>(static_cast<bf16*>(a.dq) + pl.q_off + (size_t)w0 * hs,
                                sq + w0 * kLd, out, hs, Tn - w0, vec, lane, 0);
  }
}

// Row statistics of the split kernels: three planes (the rows' max in the
// scaled log2 domain, 1 / l, D) of J n T floats.
__device__ __forceinline__ size_t stat_at(const BwdArgs& a, int which, int j, int r, int row) {
  return ((size_t)which * a.J * a.n + (size_t)j * a.n + r) * a.Tn + row;
}

// T > 64, dq and the row statistics of one (row, query tile): per stream
// three walks over the key tiles up to the diagonal (the cross layout; the
// self layouts skip the second), one key tile a step through the ring.
template <int D>
__global__ void __launch_bounds__(kThreadsW) attn_bwd_dq_kernel(const BwdArgs a) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, kBc = C::kBc, kSn = kBc / 8;
  extern __shared__ __align__(128) char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kRows * kLd;
  bf16* stages = sdo + kRows * kLd;  // stage s: k at stages + 2 s kBc kLd, v after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Tn = a.Tn, hs = a.hs, n_qt = (Tn + kRows - 1) / kRows;
  const int qt = n_qt - 1 - (int)(blockIdx.x / a.n), r = (int)(blockIdx.x % a.n);
  const int q0 = qt * kRows, valid_q = min(kRows, Tn - q0);
  const bool vec = a.vec != 0;
  const size_t plane = (size_t)Tn * hs;
  const RowPlanes pl(a, r);
  const int w0 = 16 * warp;  // the warp's first row in the tile
  const bool active = w0 < valid_q;
  const int rows[2] = {q0 + w0 + (lane >> 2), q0 + w0 + (lane >> 2) + 8};
  const int n_kt = (q0 + valid_q - 1) / kBc + 1;  // key tiles up to the last row's diagonal
  const int passes = pl.self ? 2 : 3;
  const int per_stream = passes * n_kt, steps = a.J * per_stream;
  const bf16* K = static_cast<const bf16*>(a.k);
  const bf16* V = static_cast<const bf16*>(a.v);

  auto load_step = [&](int st) {
    if (st < steps) {
      const int j = st / per_stream, pass = (st % per_stream) / n_kt, kt = st % n_kt;
      bf16* dst = stages + (st & 1) * 2 * kBc * kLd;
      const size_t at = (size_t)kt * kBc * hs;
      const int valid = Tn - kt * kBc;
      load_tile<D, kBc>(dst, K + pl.k_of(a, r, j) + at, hs, valid, vec);
      if (pass > 0) load_tile<D, kBc>(dst + kBc * kLd, V + pl.v_of(a, r, j) + at, hs, valid, vec);
    }
    mma::cp_async_commit();
  };
  const size_t at_q = (size_t)q0 * hs;
  load_tile<D, kRows>(sq, static_cast<const bf16*>(a.q) + pl.q_off + at_q, hs, valid_q, vec);
  load_tile<D, kRows>(sdo, static_cast<const bf16*>(a.dout) + r * plane + at_q, hs, valid_q, vec);
  load_step(0);

  const float sl2 = a.scale * kLog2e;
  const bool on = a.rate_on != 0;
  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[dt][i] = 0.f;
  float dself[2] = {0.f, 0.f}, m2[2], l[2], rl[2], dsum[2];

  for (int st = 0; st < steps; ++st) {
    mma::cp_async_wait<0>();
    __syncthreads();  // step st landed; every warp is done with step st - 1's stage
    load_step(st + 1);
    const int j = st / per_stream, pass = (st % per_stream) / n_kt, kt = st % n_kt;
    const int k0 = kt * kBc;
    if (!active) continue;
    if (st == 0 && pl.self) {
      const int local[2] = {rows[0] - q0, rows[1] - q0};
      rowsum_do_o<kLd>(dself, static_cast<const bf16*>(a.o) + r * plane, sdo, rows, local, Tn,
                       hs, vec, lane);
    }
    if (st % per_stream == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m2[h] = -INFINITY;
        l[h] = dsum[h] = 0.f;
      }
    const bf16* sk = stages + (st & 1) * 2 * kBc * kLd;
    const bf16* sv = sk + kBc * kLd;
    const int reach = q0 + w0 + 15 - k0;  // slabs of this tile the warp's rows see
    const int ns = reach < 0 ? 0 : min(kBc / 16, reach / 16 + 1);
    float s[kSn][4], dp[kSn][4];
    if (pass == 0) {  // online row max and sum
      scores<D, kSn, false>(s, dp, sq + w0 * kLd, sdo + w0 * kLd, sk, sv, ns, lane);
      float mt[2] = {-INFINITY, -INFINITY};
      mask_scale<kSn>(s, ns, k0, rows, sl2, mt, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m2[h], quad_max(mt[h]));
        const float base = mn == -INFINITY ? 0.f : mn;
        l[h] *= mma::exp2_approx(m2[h] - base);
        m2[h] = mn;
      }
#pragma unroll
      for (int nt = 0; nt < kSn; ++nt)
        if (nt < 2 * ns)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float mb = m2[i >> 1] == -INFINITY ? 0.f : m2[i >> 1];
            l[i >> 1] += mma::exp2_approx(s[nt][i] - mb);
          }
      if (kt == n_kt - 1)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rl[h] = 1.f / quad_sum(l[h]);
          if (m2[h] == -INFINITY) m2[h] = 0.f;
        }
    } else {
      scores<D, kSn, true>(s, dp, sq + w0 * kLd, sdo + w0 * kLd, sk, sv, ns, lane);
      float unused[2] = {-INFINITY, -INFINITY};
      mask_scale<kSn>(s, ns, k0, rows, sl2, unused, lane);
      const uint32_t seed = pl.self ? a.seed : stream_seed(a.seed, j);
      const KeepRowW kr[2] = {KeepRowW(on, seed, pl.n_idx, (uint32_t)rows[0], a.thresh),
                              KeepRowW(on, seed, pl.n_idx, (uint32_t)rows[1], a.thresh)};
      const bool d_pass = pass == 1 && !pl.self;
      weights<kSn, false>(s, dp, ns, k0, m2, rl, kr, on, a.inv, d_pass, dsum, nullptr, 0, lane);
      if (d_pass) {
        if (kt == n_kt - 1)
#pragma unroll
          for (int h = 0; h < 2; ++h) dsum[h] = quad_sum(dsum[h]);
      } else {
        float dc[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) dc[h] = pl.self ? dself[h] : dsum[h];
        uint32_t da[kSn / 2][4];
        dscores<kSn>(s, dp, ns, dc, da, nullptr, 0, lane);
        tile_product<D, kSn>(dq, da, sk, ns, lane);
      }
    }
    if (st % per_stream == per_stream - 1 && (lane & 3) == 0) {  // the stream's statistics
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (rows[h] < Tn) {
          a.dq_ws[stat_at(a, 0, j, r, rows[h])] = m2[h];
          a.dq_ws[stat_at(a, 1, j, r, rows[h])] = rl[h];
          a.dq_ws[stat_at(a, 2, j, r, rows[h])] = pl.self ? dself[h] : dsum[h];
        }
    }
  }

  if (active) {  // dq through the warp's own rows of q (only this warp reads them)
    uint32_t out[D / 8][2];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        out[dt][h] = mma::pack_bf16(dq[dt][2 * h] * a.scale, dq[dt][2 * h + 1] * a.scale);
    store_warp_rows<kLd, D / 8>(static_cast<bf16*>(a.dq) + pl.q_off + (q0 + w0) * (size_t)hs,
                                sq + w0 * kLd, out, hs, valid_q - w0, vec, lane, 0);
  }
}

// T > 64, dk and dv of one (row, stream, key tile of kBc rows): the query
// tiles from the diagonal on through the ring with their rows' statistics;
// per tile, w and ds query-major to shared memory (warp w: query rows
// 16w..), then dK and dV key-major (warp w: key slab w % slabs, columns
// 64 (w / slabs)..), accumulated in registers over the tiles.
template <int D>
__global__ void __launch_bounds__(kThreadsW) attn_bwd_dkv_kernel(const BwdArgs a) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, kBc = C::kBc, kSn = kBc / 8, kLw = C::kLwKv;
  constexpr int kSlabs = kBc / 16;  // key slabs of the tile; 4 / kSlabs column blocks of 64
  extern __shared__ __align__(128) char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kBc * kLd;
  char* stages = smem + 2 * C::kKv;  // stage s: q, dout, then m2, 1 / l and D of its 64 rows
  bf16* sw = reinterpret_cast<bf16*>(stages + 2 * C::kStage);
  bf16* sds = sw + kRows * kLw;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Tn = a.Tn, hs = a.hs, n_qt = (Tn + kRows - 1) / kRows;
  const int per_kt = a.n * a.J;
  const int kt = (int)(blockIdx.x / per_kt), j = (int)(blockIdx.x % per_kt) / a.n,
            r = (int)(blockIdx.x % a.n);
  const int k0 = kt * kBc, valid_k = min(kBc, Tn - k0);
  const bool vec = a.vec != 0;
  const size_t plane = (size_t)Tn * hs;
  const RowPlanes pl(a, r);
  const int qt0 = k0 / kRows, steps = n_qt - qt0;
  const int w0 = 16 * warp;
  const int ks = warp % kSlabs, c0 = 64 * (warp / kSlabs);  // key-major: slab and columns
  const bool active_k = 16 * ks < valid_k && c0 < hs;
  const bf16* Q = static_cast<const bf16*>(a.q) + pl.q_off;
  const bf16* Do = static_cast<const bf16*>(a.dout) + r * plane;

  auto stage = [&](int i) { return stages + (i & 1) * C::kStage; };
  auto load_step = [&](int i) {
    if (i < steps) {
      const int q0 = (qt0 + i) * kRows, valid = min(kRows, Tn - q0);
      bf16* sq = reinterpret_cast<bf16*>(stage(i));
      load_tile<D, kRows>(sq, Q + (size_t)q0 * hs, hs, valid, vec);
      load_tile<D, kRows>(sq + kRows * kLd, Do + (size_t)q0 * hs, hs, valid, vec);
      float* st = reinterpret_cast<float*>(stage(i) + 2 * C::kOp);
      for (int idx = threadIdx.x; idx < 3 * kRows; idx += kThreadsW) {
        const int which = idx / kRows, row = idx % kRows;
        if (row < valid) mma::cp_async4(st + idx, a.dq_ws + stat_at(a, which, j, r, q0 + row));
      }
    }
    mma::cp_async_commit();
  };
  const size_t at_k = (size_t)k0 * hs;
  load_tile<D, kBc>(sk, static_cast<const bf16*>(a.k) + pl.k_of(a, r, j) + at_k, hs, valid_k, vec);
  load_tile<D, kBc>(sv, static_cast<const bf16*>(a.v) + pl.v_of(a, r, j) + at_k, hs, valid_k, vec);
  load_step(0);

  const float sl2 = a.scale * kLog2e;
  const bool on = a.rate_on != 0;
  const uint32_t seed = pl.self ? a.seed : stream_seed(a.seed, j);
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[dt][i] = dv[dt][i] = 0.f;

  for (int i = 0; i < steps; ++i) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1's w and ds
    load_step(i + 1);
    const int q0 = (qt0 + i) * kRows, valid_q = min(kRows, Tn - q0);
    const bf16* sq = reinterpret_cast<const bf16*>(stage(i));
    const bf16* sdo = sq + kRows * kLd;
    const float* st = reinterpret_cast<const float*>(stage(i) + 2 * C::kOp);

    // ---- query-major: w and ds of the warp's 16 rows against the key tile
    const int reach = q0 + w0 + 15 - k0;
    const int ns = reach < 0 ? 0 : min(kSlabs, reach / 16 + 1);
    if (w0 < valid_q && ns > 0) {
      const int rows[2] = {q0 + w0 + (lane >> 2), q0 + w0 + (lane >> 2) + 8};
      float m2[2], rl[2], dc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = rows[h] - q0;
        const bool in = rows[h] < Tn;
        m2[h] = in ? st[lr] : 0.f;
        rl[h] = in ? st[kRows + lr] : 1.f;
        dc[h] = in ? st[2 * kRows + lr] : 0.f;
      }
      float s[kSn][4], dp[kSn][4];
      scores<D, kSn, true>(s, dp, sq + w0 * kLd, sdo + w0 * kLd, sk, sv, ns, lane);
      float unused[2] = {-INFINITY, -INFINITY};
      mask_scale<kSn>(s, ns, k0, rows, sl2, unused, lane);
      const KeepRowW kr[2] = {KeepRowW(on, seed, pl.n_idx, (uint32_t)rows[0], a.thresh),
                              KeepRowW(on, seed, pl.n_idx, (uint32_t)rows[1], a.thresh)};
      float dsum[2] = {0.f, 0.f};
      weights<kSn, false>(s, dp, ns, k0, m2, rl, kr, on, a.inv, false, dsum, sw + w0 * kLw, kLw,
                          lane);
      uint32_t da[kSn / 2][4];
      dscores<kSn>(s, dp, ns, dc, da, sds + w0 * kLw, kLw, lane);
    }
    __syncthreads();  // w and ds of the tile are in shared memory

    // ---- key-major: the query slabs at or past the slab's diagonal
    if (active_k) {
      const int nqs = (valid_q + 15) / 16;
      for (int qs = 0; qs < nqs; ++qs)
        if (q0 + 16 * qs + 15 >= k0 + 16 * ks)
          kv_product<kLd>(dk, dv, sw, sds, kLw, sq, sdo, qs, 16 * ks, c0, lane);
    }
  }

  // the last tile's query-major phase was the last to read k and v
  if (active_k) {
    const size_t at = at_k + (size_t)16 * ks * hs;
    store_kv<kLd>(dk, dv, static_cast<bf16*>(a.dk) + pl.k_of(a, r, j) + at,
                  static_cast<bf16*>(a.dv) + pl.v_of(a, r, j) + at, sk + 16 * ks * kLd,
                  sv + 16 * ks * kLd, a.scale, hs, valid_k - 16 * ks, vec, lane, c0);
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, long long blocks, const BwdArgs& a, cudaStream_t stream) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreadsW, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const BwdArgs& a, cudaStream_t stream) {
  using C = Cfg<D>;
  if (a.Tn <= kRows) return launch(attn_bwd_row_kernel<D>, C::kRowBytes, a.n, a, stream);
  const long long n_qt = (a.Tn + kRows - 1) / kRows, n_kt = (a.Tn + C::kBc - 1) / C::kBc;
  const int err = launch(attn_bwd_dq_kernel<D>, C::kDqBytes, (long long)a.n * n_qt, a, stream);
  if (err != 0) return err;
  return launch(attn_bwd_dkv_kernel<D>, C::kDkvBytes, (long long)a.n * a.J * n_kt, a, stream);
}

}  // namespace wr

// Floats of launch_attn_bwd's f32 workspace dq_ws: the FMA body's dq (n, T,
// hs) or the bf16 body's row statistics at T > 64 (3 J n T), rounded up to
// a multiple of 8.
inline long long bwd_ws_floats(long long n, int T, int hs, int J = 1) {
  const long long f = n * T * (hs > 3 * J ? hs : 3 * J);
  return (f + 7) / 8 * 8;
}

// bf16 with hs <= 128: the mma.sync body; f32, and bf16 above hs 128, the
// FMA body.
template <typename T>
int launch_attn_bwd(BwdArgs a, cudaStream_t stream) {
  if (a.n <= 0 || a.n > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (sizeof(T) == 2 && a.hs <= 128) {
    a.vec = a.hs % 8 == 0 &&
            flash::aligned16({a.q, a.k, a.v, a.dout, a.dq, a.dk, a.dv,
                              a.layout == kCrossRows ? nullptr : a.o});
    return a.hs <= 64 ? wr::launch_mma<64>(a, stream) : wr::launch_mma<128>(a, stream);
  }
  a.R = tile_rows(a.hs);
  a.n_t = (a.Tn + a.R - 1) / a.R;
  const size_t smem = attn_bwd_smem_floats(a.R, a.hs, a.n_t) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_kernel<T><<<(unsigned)a.n, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tat
