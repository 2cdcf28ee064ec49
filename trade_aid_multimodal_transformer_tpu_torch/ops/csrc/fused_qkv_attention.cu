// Fused factored-QKV projection + whole-row causal attention, forward (the
// backward is fused_qkv_attention_bwd.cu).
//
// Replaces: trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py,
// _fqkv_fwd_kernel (entry fused_qkv_attention). For every (modality m, batch
// row b, head h):
//   t   = tanh(x[m, b] . w1[m][:, cols of (g, h)] + b1)   g in {q, k, v}
//   q/k/v = t . w2[m, g*H + h]
//   out[m, h, b] = softmax_causal(q k^T * hs^-0.5) . v
// with the JAX kernel's rounding points: weights cast to x's type, the first
// product summed in f32 plus b1 and tanh in f32, t rounded to x's type, q/k/v
// rounded to x's type, scores / max / exp / row sum in f32, p rounded to v's
// type before P.V, and out = o / (l * (1 - rate)) rounded once. Dropout
// zeroes p's dropped entries before P.V, keyed as the JAX kernel's
// interpret-mode mask: row pid * gb * H + h * gb + b % gb of its (m, batch
// group) programs (FwdDrop, fqkv_dropout). Under data parallelism b is the
// row's row b0 + b of the global batch of Bg rows, and gb is the global
// batch's group; under tensor parallelism the launch holds heads [h0, h0 +
// H) of the model's Hg, and h and H in the row are the global h0 + h and Hg.
//
// What bounds it on the H100: at the production shape (x 4x32x64x384 bf16,
// H=6, hs=64) the work is ~4.4 GFLOP, most of it the C=384 -> 3*hs/2
// projection, against ~16.7 MB of traffic: bytes bound it by a hair
// (0.0050 ms) and operations nearly as much. Every body keeps what the TPU
// kernel kept out of device memory: t and q/k/v never reach it, x is read
// from L2 per (row chunk, head), and out is written once. Keys are walked in
// two passes where the causal row spans more than one key chunk, the first
// for each row's exact max and the second for exp / row sum / P.V, so that
// p is rounded at the whole-row max as in the JAX kernel.
//
// Three bodies:
// - bf16 with hs % 16 == 0 and hs <= 128 (every model path):
//   qkv::fqkv_fwd_mma_kernel on mma.sync (see the note above it). The
//   weights are rounded to bf16 once a call into a workspace
//   (round_weights.cuh, shared with the backward); both products and the
//   attention keep their sums in registers, the contraction over C streams
//   through a cp.async ring, and the attention runs on whole_row_mma.cuh's
//   pieces, as the whole-row forwards do.
// - bf16 above hs 128 with hs % 32 == 0 and C % 8 == 0:
//   fqkv_fwd_tc_kernel, both products and the attention on WMMA 16x16x16
//   through f32 tiles in shared memory, one block of 256 threads per (m, b,
//   h, query tile of R rows); q, k and v are projected in one pass over C
//   where the row spans one key tile, else K and V again per pass.
// - f32 (the correctness gates) and the other bf16 head sizes:
//   fqkv_fwd_kernel, the same walk with f32 FMAs on the CUDA cores.
#include "attention_tile.cuh"
#include "round_weights.cuh"
#include "whole_row_mma.cuh"

namespace tat {

constexpr int kChunk = 32;  // contraction chunk of the first product

// Dropout arguments of a launch: seed (s0 ^ s1 of the site's salts), keep
// threshold, on/off, 1 - rate as f32, the JAX kernel's batch group gb of the
// global batch of Bg rows, b0, the global row of the launch's first, the
// model's head count Hg and h0, the global head of the launch's first.
struct FwdDrop {
  uint32_t seed, thresh;
  int on;
  float keepf;
  int gb, Bg, b0, Hg, h0;
};

// The mask row of (m, b, h) in the JAX kernel on the global batch and all
// Hg heads: program pid = m * (Bg / gb) + bg / gb holds gb batch rows of
// every head, collapsed head-major, where bg = b0 + b and hg = h0 + h.
__device__ inline uint32_t fqkv_mask_row(int gb, int Bg, int b0, int Hg, int h0, int m, int b,
                                         int h) {
  const int bg = b0 + b, pid = m * (Bg / gb) + bg / gb;
  return (uint32_t)(pid * gb * Hg + (h0 + h) * gb + bg % gb);
}

__device__ inline Dropout fqkv_dropout(const FwdDrop& dr, int m, int b, int h) {
  return Dropout{dr.seed, fqkv_mask_row(dr.gb, dr.Bg, dr.b0, dr.Hg, dr.h0, m, b, h), dr.thresh,
                 dr.on != 0};
}

__host__ __device__ inline size_t fqkv_smem_floats(int R, int hs) {
  const int hs2 = hs / 2;
  return tile_floats(R, hs) + (size_t)R * (hs2 + 1) + (size_t)R * (kChunk + 1) +
         (size_t)kChunk * hs2;
}

// dst[r][e] (stride ld) = round(round(tanh(x[row0 + r] . w1c + b1c)) . w2v)
// for one virtual head: w1c are its hs2 columns of w1 (row stride d3, first
// column col0), b1c the same columns of b1, w2v its (hs2, hs) block of w2.
template <typename T>
__device__ void project_rows(const T* __restrict__ xb, int rows, int C, int row0,
                             int R, const float* __restrict__ w1, int d3,
                             int col0, const float* __restrict__ b1,
                             const float* __restrict__ w2v, int hs2, int hs,
                             float* sX, float* sW, float* sT, float* dst, int ld) {
  const int tid = threadIdx.x;
  {
    const int N = hs2, step = kThreads / N, n = tid % N, i0 = tid / N;
    const bool active = tid < step * N;
    float acc[kMaxPerThread];
#pragma unroll
    for (int u = 0; u < kMaxPerThread; ++u) acc[u] = 0.f;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      const int kc = min(kChunk, C - c0);
      for (int base = tid; base < R * kChunk; base += kThreads * kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = base + u * kThreads, r = idx / kChunk, c = idx % kChunk;
          v[u] = (idx < R * kChunk && row0 + r < rows && c < kc)
                     ? Io<T>::load(xb + (size_t)(row0 + r) * C + c0 + c) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = base + u * kThreads;
          if (idx < R * kChunk) sX[(idx / kChunk) * (kChunk + 1) + idx % kChunk] = v[u];
        }
      }
      for (int base = tid; base < kChunk * N; base += kThreads * kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = base + u * kThreads, c = idx / N, d = idx % N;
          v[u] = (idx < kChunk * N && c < kc)
                     ? Io<T>::round(w1[(size_t)(c0 + c) * d3 + col0 + d]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = base + u * kThreads;
          if (idx < kChunk * N) sW[idx] = v[u];
        }
      }
      __syncthreads();
      if (active) {
        for (int c = 0; c < kc; ++c) {
          const float w = sW[c * N + n];
#pragma unroll
          for (int u = 0; u < kMaxPerThread; ++u) {
            const int i = i0 + u * step;
            if (i < R) acc[u] = fmaf(sX[i * (kChunk + 1) + c], w, acc[u]);
          }
        }
      }
      __syncthreads();
    }
    if (active) {
      const float bias = b1[col0 + n];
#pragma unroll
      for (int u = 0; u < kMaxPerThread; ++u) {
        const int i = i0 + u * step;
        if (i < R) sT[i * (hs2 + 1) + n] = Io<T>::round(tanhf(acc[u] + bias));
      }
    }
    __syncthreads();
  }
  {
    const int N = hs, step = kThreads / N, e = tid % N, i0 = tid / N;
    if (tid < step * N) {
      float acc[kMaxPerThread];
#pragma unroll
      for (int u = 0; u < kMaxPerThread; ++u) acc[u] = 0.f;
#pragma unroll 4
      for (int d = 0; d < hs2; ++d) {
        const float w = Io<T>::round(__ldg(w2v + (size_t)d * hs + e));
#pragma unroll
        for (int u = 0; u < kMaxPerThread; ++u) {
          const int i = i0 + u * step;
          if (i < R) acc[u] = fmaf(sT[i * (hs2 + 1) + d], w, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kMaxPerThread; ++u) {
        const int i = i0 + u * step;
        if (i < R) dst[i * ld + e] = Io<T>::round(acc[u]);
      }
    }
    __syncthreads();
  }
}

constexpr int kTcChunk = 64;  // contraction chunk of the tensor-core first product
constexpr int kProjFrags = 3;  // (R/16) x (3*hs2/16) <= 24 tiles of pre over 8 warps

// Shared memory of the tensor-core kernel, in order: stage (R x (3*hs2 + 4)
// f32: the products' sums, then P.V's), m and l, q/k/v (bf16), and one region
// used by the projection (x chunk, w1 chunk, t, one w2 block; all bf16) and
// by the attention steps (scores f32, p bf16) in turn.
struct LayoutTc {
  size_t stage, ml, qkv, proj, attn, total;
};

__host__ __device__ inline LayoutTc layout_tc(int R, int hs) {
  const int hs2 = hs / 2;
  LayoutTc L;
  L.stage = (size_t)R * (3 * hs2 + 4) * sizeof(float);
  L.ml = 2 * (size_t)R * sizeof(float);
  L.qkv = 3 * (size_t)R * (hs + 8) * sizeof(__nv_bfloat16);
  L.proj = ((size_t)R * (kTcChunk + 8) + (size_t)kTcChunk * (3 * hs2 + 8) +
            (size_t)R * (3 * hs2 + 8) + (size_t)hs2 * (hs + 8)) *
           sizeof(__nv_bfloat16);
  L.attn = (size_t)R * (R + 4) * sizeof(float) + (size_t)R * (R + 8) * sizeof(__nv_bfloat16);
  L.total = L.stage + L.ml + L.qkv + (L.proj > L.attn ? L.proj : L.attn);
  return L;
}

struct ProjTc {
  __nv_bfloat16* x;   // R x (kTcChunk + 8)
  __nv_bfloat16* w1;  // kTcChunk x (3*hs2 + 8)
  __nv_bfloat16* t;   // R x (3*hs2 + 8)
  __nv_bfloat16* w2;  // hs2 x (hs + 8)
};

// The virtual heads projected together for the same rows: g[i] in {0 q, 1 k,
// 2 v}, written to dst[i] (bf16, stride ldh).
struct Groups {
  int n;
  int g[3];
  __nv_bfloat16* dst[3];
};

// Rows [row0, row0 + R) of x through the factored projection of every group,
// both products on the tensor cores (WMMA 16x16x16, bf16 operands, f32
// accumulation), with the rounding points of the FMA path. One pass over C
// serves all groups; each pass issues its loads as 16-byte vectors together
// (x needs C % 8 == 0).
__device__ void project_groups_tc(const __nv_bfloat16* __restrict__ xb, int rows,
                                  int C, int row0, int R,
                                  const float* __restrict__ w1, int d3, int D,
                                  int h, const float* __restrict__ b1,
                                  const float* __restrict__ w2m, int H, int hs2,
                                  int hs, const Groups& G, const ProjTc& sb,
                                  float* stage, int ldh) {
  using namespace nvcuda;
  const int tid = threadIdx.x, warp = tid / 32;
  const int tiles_r = R / 16;
  const int ldx = kTcChunk + 8, ldw = 3 * hs2 + 8, lds = 3 * hs2 + 4, ldw2 = hs + 8;
  const int n1 = G.n * hs2;  // columns of pre
  const int tiles_c = n1 / 16, n_tiles = tiles_r * tiles_c;
  Frag acc[kProjFrags];
#pragma unroll
  for (int f = 0; f < kProjFrags; ++f) wmma::fill_fragment(acc[f], 0.f);
  const int nx = R * (kTcChunk / 8);   // 16-byte vectors of the x chunk
  const int nw = kTcChunk * (n1 / 4);  // 16-byte vectors of the w1 chunk
  for (int c0 = 0; c0 < C; c0 += kTcChunk) {
    for (int base = tid; base < nx + nw; base += kThreads * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads;
        v[u] = make_uint4(0, 0, 0, 0);
        if (idx < nx) {
          const int r = idx / (kTcChunk / 8), c = 8 * (idx % (kTcChunk / 8));
          if (row0 + r < rows && c0 + c < C)
            v[u] = *reinterpret_cast<const uint4*>(xb + (size_t)(row0 + r) * C + c0 + c);
        } else if (idx < nx + nw) {
          const int j = idx - nx, c = j / (n1 / 4), col = 4 * (j % (n1 / 4));
          const int gi = col / hs2, d = col % hs2;
          if (c0 + c < C)
            v[u] = *reinterpret_cast<const uint4*>(
                w1 + (size_t)(c0 + c) * d3 + G.g[gi] * D + h * hs2 + d);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads;
        if (idx < nx) {
          const int r = idx / (kTcChunk / 8), c = 8 * (idx % (kTcChunk / 8));
          *reinterpret_cast<uint4*>(sb.x + r * ldx + c) = v[u];
        } else if (idx < nx + nw) {
          const int j = idx - nx, c = j / (n1 / 4), col = 4 * (j % (n1 / 4));
          const float4 f = *reinterpret_cast<const float4*>(&v[u]);
          __nv_bfloat16* w = sb.w1 + c * ldw + col;
          w[0] = __float2bfloat16_rn(f.x);
          w[1] = __float2bfloat16_rn(f.y);
          w[2] = __float2bfloat16_rn(f.z);
          w[3] = __float2bfloat16_rn(f.w);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < kProjFrags; ++f) {
      const int tile = warp + f * kWarps;
      if (tile < n_tiles) {
        const int tr = tile / tiles_c, tc = tile % tiles_c;
        for (int k = 0; k < kTcChunk; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(a, sb.x + tr * 16 * ldx + k, ldx);
          wmma::load_matrix_sync(b, sb.w1 + k * ldw + tc * 16, ldw);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < kProjFrags; ++f) {
    const int tile = warp + f * kWarps;
    if (tile < n_tiles) {
      const int tr = tile / tiles_c, tc = tile % tiles_c;
      wmma::store_matrix_sync(stage + tr * 16 * lds + tc * 16, acc[f], lds, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * n1; idx += kThreads) {
    const int r = idx / n1, col = idx % n1, gi = col / hs2, d = col % hs2;
    sb.t[r * ldw + col] = __float2bfloat16_rn(
        tanhf(stage[r * lds + col] + b1[G.g[gi] * D + h * hs2 + d]));
  }
  __syncthreads();
  for (int gi = 0; gi < G.n; ++gi) {
    const float* w2v = w2m + (size_t)(G.g[gi] * H + h) * hs2 * hs;
    for (int base = tid; base < hs2 * hs / 4; base += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads;
        v[u] = idx < hs2 * hs / 4 ? __ldg(reinterpret_cast<const float4*>(w2v) + idx)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads;
        if (idx < hs2 * hs / 4) {
          const int d = (4 * idx) / hs, e = (4 * idx) % hs;
          __nv_bfloat16* w = sb.w2 + d * ldw2 + e;
          w[0] = __float2bfloat16_rn(v[u].x);
          w[1] = __float2bfloat16_rn(v[u].y);
          w[2] = __float2bfloat16_rn(v[u].z);
          w[3] = __float2bfloat16_rn(v[u].w);
        }
      }
    }
    __syncthreads();
    const int tc_n = hs / 16, n2 = tiles_r * tc_n;
    for (int tile = warp; tile < n2; tile += kWarps) {
      const int tr = tile / tc_n, tc = tile % tc_n;
      Frag o;
      wmma::fill_fragment(o, 0.f);
      for (int k = 0; k < hs2; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sb.t + tr * 16 * ldw + gi * hs2 + k, ldw);
        wmma::load_matrix_sync(b, sb.w2 + k * ldw2 + tc * 16, ldw2);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(stage + tr * 16 * lds + tc * 16, o, lds, wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < R * hs; idx += kThreads) {
      const int r = idx / hs, e = idx % hs;
      G.dst[gi][r * ldh + e] = __float2bfloat16_rn(stage[r * lds + e]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fqkv_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    T* __restrict__ out, int B, int Tn, int C, int H, int hs,
                    int R, int n_qt, float scale, FwdDrop dr) {
  extern __shared__ __align__(128) float smem[];
  const int hs2 = hs / 2, D = H * hs2, d3 = 3 * D;
  long long bid = blockIdx.x;
  const int qt = (int)(bid % n_qt);
  bid /= n_qt;
  const int h = (int)(bid % H);
  bid /= H;
  const int b = (int)(bid % B);
  const int m = (int)(bid / B);
  const int q0 = qt * R;
  const Dropout d = fqkv_dropout(dr, m, b, h);

  Tile t = carve_tile(smem, R, hs);
  float* sT = smem + tile_floats(R, hs);
  float* sX = sT + R * (hs2 + 1);
  float* sW = sX + R * (kChunk + 1);

  const T* xb = x + ((size_t)m * B + b) * Tn * C;
  const float* w1m = w1 + (size_t)m * C * d3;
  const float* b1m = b1 + (size_t)m * d3;
  const float* w2m = w2 + (size_t)m * 3 * H * hs2 * hs;
  // rows [row0, row0 + R) of virtual head g*H + h (g: 0 q, 1 k, 2 v) into dst
  auto project = [&](int row0, int g, float* dst) {
    project_rows<T>(xb, Tn, C, row0, R, w1m, d3, g * D + h * hs2, b1m,
                    w2m + (size_t)(g * H + h) * hs2 * hs, hs2, hs, sX, sW, sT,
                    dst, t.ld);
  };

  project(q0, 0, t.q);
  reset_rows(t);

  const int n_kt = qt + 1;  // causal: keys up to the end of this query tile
  const bool held = n_kt == 1;
  float o[kMaxPerThread];
#pragma unroll
  for (int u = 0; u < kMaxPerThread; ++u) o[u] = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * R;
      if (pass == 0 || !held) {
        project(k0, 1, t.k);
        if (pass == 1 || held) project(k0, 2, t.v);
        scores(t, q0, k0, scale);  // a held tile keeps its first-pass scores
      }
      if (pass == 0) {
        fold_row_max(t);
      } else {
        probabilities<T>(t);
        drop_tile(t.s, t.lds, R, q0, k0, d);
        accumulate_pv(t, o);
      }
    }
  }

  T* ob = out + (((size_t)m * H + h) * B + b) * Tn * hs;
  const int step = kThreads / hs, e = threadIdx.x % hs, i0 = threadIdx.x / hs;
  if (threadIdx.x < step * hs) {
#pragma unroll
    for (int u = 0; u < kMaxPerThread; ++u) {
      const int i = i0 + u * step, row = q0 + i;
      if (i < R && row < Tn) Io<T>::store(ob + (size_t)row * hs + e, o[u] / (t.l[i] * dr.keepf));
    }
  }
}

// The same function for bf16 above hs 128, hs a multiple of 32 and C a
// multiple of 8, every product on WMMA. At most 128 registers a thread, so that
// two blocks share an SM and one's loads overlap the other's work.
__global__ void __launch_bounds__(kThreads, 2)
    fqkv_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ w2, __nv_bfloat16* __restrict__ out,
                       int B, int Tn, int C, int H, int hs, int R, int n_qt,
                       float scale, FwdDrop dr) {
  extern __shared__ __align__(128) char smem_tc[];
  const int hs2 = hs / 2, D = H * hs2, d3 = 3 * D;
  long long bid = blockIdx.x;
  const int qt = (int)(bid % n_qt);
  bid /= n_qt;
  const int h = (int)(bid % H);
  bid /= H;
  const int b = (int)(bid % B);
  const int m = (int)(bid / B);
  const int q0 = qt * R;
  const Dropout d = fqkv_dropout(dr, m, b, h);

  const LayoutTc L = layout_tc(R, hs);
  TileTc t;
  t.R = R;
  t.hs = hs;
  t.ldo = 3 * hs2 + 4;
  t.ldh = hs + 8;
  t.lds = R + 4;
  t.ldp = R + 8;
  char* p = smem_tc;
  t.o = reinterpret_cast<float*>(p);
  p += L.stage;
  t.a = nullptr;
  t.m = reinterpret_cast<float*>(p);
  t.l = t.m + R;
  p += L.ml;
  t.q = reinterpret_cast<__nv_bfloat16*>(p);
  t.k = t.q + R * t.ldh;
  t.v = t.k + R * t.ldh;
  p += L.qkv;
  // the shared region: attention view ...
  t.s = reinterpret_cast<float*>(p);
  t.p = reinterpret_cast<__nv_bfloat16*>(t.s + R * t.lds);
  // ... and projection view
  ProjTc sb;
  sb.x = reinterpret_cast<__nv_bfloat16*>(p);
  sb.w1 = sb.x + R * (kTcChunk + 8);
  sb.t = sb.w1 + kTcChunk * (3 * hs2 + 8);
  sb.w2 = sb.t + R * (3 * hs2 + 8);

  const __nv_bfloat16* xb = x + ((size_t)m * B + b) * Tn * C;
  const float* w1m = w1 + (size_t)m * C * d3;
  const float* b1m = b1 + (size_t)m * d3;
  const float* w2m = w2 + (size_t)m * 3 * H * hs2 * hs;
  auto project = [&](int row0, const Groups& G) {
    project_groups_tc(xb, Tn, C, row0, R, w1m, d3, D, h, b1m, w2m, H, hs2, hs, G,
                      sb, t.o, t.ldh);
  };

  const int n_kt = qt + 1;  // causal: keys up to the end of this query tile
  const bool held = n_kt == 1;
  if (held) {  // the query tile is the only key tile: q, k, v in one pass
    project(q0, Groups{3, {0, 1, 2}, {t.q, t.k, t.v}});
  } else {
    project(q0, Groups{1, {0, 0, 0}, {t.q, t.q, t.q}});
  }
  reset_rows_tc(t);

  Frag o[kOutFrags];
  zero_frags(o);
  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * R;
      if (pass == 0 || !held) {
        if (!held) {
          if (pass == 0)
            project(k0, Groups{1, {1, 1, 1}, {t.k, t.k, t.k}});
          else
            project(k0, Groups{2, {1, 2, 2}, {t.k, t.v, t.v}});
        }
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

  __nv_bfloat16* ob = out + (((size_t)m * H + h) * B + b) * Tn * hs;
  const int valid = max(0, min(R, Tn - q0)) * hs;
  for (int idx = threadIdx.x; idx < valid; idx += kThreads) {
    const int i = idx / hs, e = idx % hs;
    ob[(size_t)q0 * hs + idx] = __float2bfloat16_rn(t.o[i * t.ldo + e] / (t.l[i] * dr.keepf));
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           void* out, int M, int B, int Tn, int C, int H, int hs, float scale,
           FwdDrop dr, cudaStream_t stream) {
  const int R = tile_rows(hs);
  const int n_qt = (Tn + R - 1) / R;
  const long long blocks = (long long)M * B * H * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = fqkv_smem_floats(R, hs) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fqkv_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fqkv_fwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<T*>(out), B, Tn, C, H, hs, R, n_qt, scale, dr);
  return (int)cudaGetLastError();
}

int launch_tc(const void* x, const void* w1, const void* b1, const void* w2,
              void* out, int M, int B, int Tn, int C, int H, int hs, float scale,
              FwdDrop dr, cudaStream_t stream) {
  const int R = tile_rows(hs);
  const int n_qt = (Tn + R - 1) / R;
  const long long blocks = (long long)M * B * H * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = layout_tc(R, hs).total;
  cudaError_t err = cudaFuncSetAttribute(
      fqkv_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fqkv_fwd_tc_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<__nv_bfloat16*>(out), B, Tn, C, H, hs, R, n_qt, scale, dr);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- bf16 mma body

namespace qkv {

using bf16 = __nv_bfloat16;
using wr::KeepRowW;

// The forward on mma.sync m16n8k16 for bf16 with hs % 16 == 0 and hs <= 128
// (D = 64 or 128, the padded head size; P2 = D / 2 the padded half). One
// block per (m, h, kBR batch rows, chunk of kRowsQ query rows), the chunks
// that see the most keys first: 4 warps a batch row, warp w owning rows
// 16 (w % 4).. + 15 of its batch row's chunks. kBR = 2 where B is even: the
// two rows share every chunk of w1 (half of w1's bytes from L2), and two
// such blocks share an SM. A block's time is the chain of dependent steps
// of its warps (with the ring's loads and waits taken out it still takes
// ~3/4 of the time), so more warps an SM, not fewer bytes, move it.
// - First product: the chunk's x rows times the head's w1 columns of the
//   groups being projected (q, k, v: P2 columns each, zeros past hs / 2), in
//   f32 C fragments (NG P2 / 8 n8 tiles a warp). The contraction over C
//   comes in chunks of kChunkC through a ring of kStagesQ shared-memory
//   stages filled by 16-byte cp.async (element copies where x's rows are not
//   16-byte aligned), with w2's three blocks for the head in the first group
//   and b1's columns staged in shared memory beside them.
//   The weights are bf16, rounded once a call by round_weights.cuh.
// - Epilogue in registers: + b1, tanh in f32, rounded to bf16. A product's
//   C fragments are the next product's A fragments, so t never leaves
//   registers.
// - Second product: t_g (16 x P2) . w2[g H + h] (P2 x D) with w2's block
//   through ldmatrix.trans, rounded to bf16: q stays in registers as A
//   fragments (D = 64; at D = 128 it goes to the warp's rows of sq, held it
//   would spill), k and v go to the batch row's shared memory, which every
//   warp of the row reads.
// - Attention on whole_row_mma.cuh's pieces: S = q k^T for the key slabs up
//   to the warp's last row, scaled by scale * log2(e) and masked, the exact
//   row max by quad shuffles, p = exp2(s - m), l = sum p, the JAX kernel's
//   dropout bit, P.V in f32; out = o times the reciprocal of l (1 - rate),
//   rounded once, written through the warp's rows of sq (16-byte stores).
// - T <= 64 (every model path): q, k and v of the one chunk in one pass.
//   Above 64 the block projects q once, then walks the key chunks 0..qc
//   twice, projecting k for the row max and k and v for p, P.V: p is rounded
//   at the whole row's max, as the JAX kernel rounds it.
// Rows past T are projected from zero rows of x; the causal mask hides them
// from every row that is stored. No atomics: two runs give the same bits.
constexpr int kRowsQ = 64;     // query rows of a chunk; rows of a projected chunk
constexpr int kChunkC = 32;    // the first product's contraction chunk
// The ring's depth (chunks in flight + 1) and the blocks an SM: a warp's
// chain of dependent steps, not bytes, sets a block's time, so two-row
// blocks take two stages and two blocks an SM (128 registers a thread: 16
// warps an SM in place of 8), one-row blocks (B = 1) three stages.
constexpr int kStagesPair = 2;
constexpr int kStagesOne = 3;
constexpr int kPairBlocksPerSM = 2;
// Warps a row slab in one-row blocks: 3, one a group (q, k, v), so that
// each warp's chain through the projection is a third as long (12 warps a
// block); two-row blocks keep one warp a slab holding all three groups.
constexpr int kGroupWarpsOne = 3;
template <int kBR>
constexpr int kStagesQ = kBR == 2 ? kStagesPair : kStagesOne;

struct MmaArgs {
  const bf16* x;
  const bf16* w1;  // (M, C, 3D'), rounded to bf16
  const float* b1;
  const bf16* w2;  // (M, 3H, hs / 2, hs), rounded to bf16
  bf16* out;
  int B, Tn, C, H, hs;
  float sl2;       // scale * log2(e)
  uint32_t seed, thresh;
  int on;          // dropout
  float keepf;     // 1 - rate as f32
  int gb, Bg, b0;  // the JAX kernel's batch group of the global batch, its rows, our first
  int Hg, h0;      // the model's heads, our first
  int vec_x;       // x by 16-byte cp.async
  int vec_out;     // out by 16-byte stores
};

// Element offsets (bf16) of a block's shared memory: the ring's stages (x
// chunk of kBR kRowsQ rows, then w1 chunk), w2's three blocks, then per
// batch row q (or the output's staging), k and v, rows D + 8 apart, then
// b1's columns of the three groups (f32).
template <int D, int kBR>
struct Smem {
  static constexpr int kP2 = D / 2, kLd = D + 8, kLdx = kChunkC + 8, kLdw = 3 * kP2 + 8;
  static constexpr int kStage = kBR * kRowsQ * kLdx + kChunkC * kLdw;
  static constexpr int kW2 = kStagesQ<kBR> * kStage;
  static constexpr int kQKV = kW2 + 3 * kP2 * kLd;  // batch row br's q at + 3 br kRowsQ kLd
  static constexpr int kB1 = kQKV + kBR * 3 * kRowsQ * kLd;
  static constexpr int kTotal = kB1 + 2 * 3 * kP2;
};

// Where a block is: its (m, h), first batch row and query chunk, the
// pointers of its operands, and the warp's place in it (its batch row br,
// its rows w0.. of that row's chunks).
struct Block {
  const bf16* xb;    // x[m, b0]
  const bf16* w1m;   // w1[m]
  const float* b1h;  // b1[m] at the head's column of group 0 (group g at + g D')
  const bf16* w2h;   // w2[m, h] (group g at + g H hs / 2 hs)
  int h, q0, Dm, d3, hs2;
  int br, gw, lane, w0;  // batch row, group warp (kGW = 3: its group), lane, first row
};

// w2's (hs / 2, hs) blocks of the head's three groups into rows of sw2
// (group g from row g P2), zeros past hs / 2 and hs; no commit: they join
// the first product's first group. And b1's columns of the three groups
// into sb1 (group g from g P2), zeros past hs / 2: loads at clamped
// addresses, all in flight at once (a load under a condition would wait
// for the one before it in the epilogue).
template <int D, int kBR, int kGW>
__device__ __forceinline__ void load_w2_b1(const MmaArgs& a, const Block& k, bf16* sw2,
                                           float* sb1) {
  using L = Smem<D, kBR>;
  constexpr int kV8 = D / 8, kT = 128 * kBR * kGW;
  for (int idx = threadIdx.x; idx < 3 * L::kP2 * kV8; idx += kT) {
    const int row = idx / kV8, e = 8 * (idx % kV8), g = row / L::kP2, d = row % L::kP2;
    const bool in = d < k.hs2 && e < a.hs;
    const size_t at = ((size_t)g * a.H * k.hs2 + d) * a.hs + e;
    mma::cp_async16(sw2 + row * L::kLd + e, in ? k.w2h + at : k.w2h, in);
  }
  for (int idx = threadIdx.x; idx < 3 * L::kP2; idx += kT) {
    const int g = idx / L::kP2, d = idx % L::kP2;
    const float v = __ldg(k.b1h + (size_t)g * k.Dm + min(d, k.hs2 - 1));
    sb1[idx] = d < k.hs2 ? v : 0.f;
  }
}

// Chunk c0 of the first product into ring stage st: x rows row0.. of the
// block's batch rows' chunks (kChunkC columns; batch row r / kRowsQ), and
// w1's rows c0.. at the head's columns of the NG groups gs (P2 columns a
// group, zeros past hs / 2). One commit.
template <int D, int kBR, int kGW, int NG>
__device__ __forceinline__ void load_chunk(const MmaArgs& a, const Block& k, bf16* st, int row0,
                                           int c0, const int (&gs)[NG]) {
  using L = Smem<D, kBR>;
  constexpr int kX8 = kChunkC / 8, kW8 = NG * L::kP2 / 8, kRowsX = kBR * kRowsQ;
  constexpr int kT = 128 * kBR * kGW;
  for (int idx = threadIdx.x; idx < kRowsX * kX8 + kChunkC * kW8; idx += kT) {
    if (idx < kRowsX * kX8) {
      const int r = idx / kX8, c = 8 * (idx % kX8), gr = row0 + r % kRowsQ, gc = c0 + c;
      bf16* dst = st + r * L::kLdx + c;
      const bf16* src = k.xb + ((size_t)(r / kRowsQ) * a.Tn + gr) * a.C + gc;
      if (a.vec_x) {
        const bool in = gr < a.Tn && gc < a.C;
        mma::cp_async16(dst, in ? src : k.xb, in);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = gr < a.Tn && gc + e < a.C ? src[e] : __float2bfloat16_rn(0.f);
      }
    } else {
      const int j = idx - kRowsX * kX8, c = j / kW8, col = 8 * (j % kW8);
      const int gi = col / L::kP2, d = col % L::kP2;
      const bool in = c0 + c < a.C && d < k.hs2;
      const size_t at = (size_t)(c0 + c) * k.d3 + (size_t)gs[gi] * k.Dm + k.h * k.hs2 + d;
      mma::cp_async16(st + kRowsX * L::kLdx + c * L::kLdw + col, in ? k.w1m + at : k.w1m, in);
    }
  }
  mma::cp_async_commit();
}

// The warp's 16 rows of its batch row's chunk at row0 through the factored
// projection of the NG groups gs (0 q, 1 k, 2 v), or with kGW = 3 of the
// one group gs[gw] (warps with gw >= NG idle): q to qa (or the warp's rows
// of sq), k to sk, v to sv (the batch row's), each rounded to bf16. Every
// warp of the block calls it (loads and barriers); ends with a barrier after
// which sk, sv and the ring may be read or reused.
template <int D, int kBR, int kGW, int NG>
__device__ __forceinline__ void project(const MmaArgs& a, const Block& k, bf16* ring,
                                        const bf16* sw2, const float* sb1, bf16* sq, bf16* sk,
                                        bf16* sv, int row0, const int (&gs)[NG],
                                        uint32_t (&qa)[wr::kHoldQ<D> ? D / 16 : 1][4]) {
  using L = Smem<D, kBR>;
  constexpr int kP2 = L::kP2, kNGw = kGW == 1 ? NG : 1, kN8 = kNGw * kP2 / 8;
  constexpr int kRowsX = kBR * kRowsQ;
  const int lane = k.lane, col0 = kGW == 1 ? 0 : k.gw * kP2;  // the warp's columns of a chunk
  const bool works = kGW == 1 || k.gw < NG;
  float acc[kN8][4];
#pragma unroll
  for (int nt = 0; nt < kN8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  constexpr int kStages = kStagesQ<kBR>;
  const int nk = (a.C + kChunkC - 1) / kChunkC;
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt)
    if (kt < nk) load_chunk<D, kBR, kGW, NG>(a, k, ring + kt * L::kStage, row0, kt * kChunkC, gs);
    else mma::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kt landed; every warp is done with chunk kt - 1's stage
    const int nx = kt + kStages - 1;
    if (nx < nk)
      load_chunk<D, kBR, kGW, NG>(a, k, ring + (nx % kStages) * L::kStage, row0, nx * kChunkC,
                                  gs);
    else
      mma::cp_async_commit();
    const bf16* xs = ring + (kt % kStages) * L::kStage;
    const bf16* ws = xs + kRowsX * L::kLdx;
    if (!works) continue;
#pragma unroll
    for (int kk = 0; kk < kChunkC; kk += 16) {
      uint32_t af[4];
      mma::ldsm_x4(af, mma::a_frag_addr(xs, L::kLdx, k.br * kRowsQ + k.w0, kk, lane));
#pragma unroll
      for (int nj = 0; nj < kN8 / 2; ++nj) {
        uint32_t r[4];
        mma::ldsm_x4_trans(r, mma::a_frag_addr(ws, L::kLdw, kk, col0 + 16 * nj, lane));
        mma::mma_bf16(acc[2 * nj], af, r[0], r[1]);
        mma::mma_bf16(acc[2 * nj + 1], af, r[2], r[3]);
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // w2 landed where nk < kStages - 1; the ring is free

#pragma unroll
  for (int gi = 0; gi < kNGw; ++gi) {
    if (!works) break;
    const int g = gs[kGW == 1 ? gi : k.gw];
    // t = round(tanh(pre + b1)) as the second product's A fragments
    uint32_t ta[kP2 / 16][4];
#pragma unroll
    for (int nt = 0; nt < kP2 / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * nt + mma::frag_col(lane, e);
          v[e] = d < k.hs2 ? tanhf(acc[gi * kP2 / 8 + nt][2 * hh + e] + sb1[g * kP2 + d]) : 0.f;
        }
        ta[nt >> 1][2 * (nt & 1) + hh] = mma::pack_bf16(v[0], v[1]);
      }
    float o[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
    const bf16* w2s = sw2 + g * kP2 * L::kLd;
#pragma unroll
    for (int kb = 0; kb < kP2 / 16; ++kb)
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t r[4];
        mma::ldsm_x4_trans(r, mma::a_frag_addr(w2s, L::kLd, 16 * kb, 8 * dt, lane));
        mma::mma_bf16(o[dt], ta[kb], r[0], r[1]);
        mma::mma_bf16(o[dt + 1], ta[kb], r[2], r[3]);
      }
    bf16* dst = g == 0 ? sq : g == 1 ? sk : sv;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t w = mma::pack_bf16(o[dt][2 * hh], o[dt][2 * hh + 1]);
        if (wr::kHoldQ<D> && g == 0) {
          if constexpr (wr::kHoldQ<D>) qa[dt >> 1][2 * (dt & 1) + hh] = w;
        } else {
          *reinterpret_cast<uint32_t*>(dst + (k.w0 + mma::frag_row(lane, 2 * hh)) * L::kLd +
                                       8 * dt + mma::frag_col(lane, 0)) = w;
        }
      }
  }
  __syncthreads();  // k and v are in shared memory for every warp
}

// Groups projected together: all at D = 64, one at a time at D = 128 (whose
// first product would hold 96 f32 sums a thread for three groups).
template <int D>
constexpr bool kTogether = D <= 64;

template <int D, int kBR, int kGW>
__global__ void __launch_bounds__(128 * kBR * kGW, kBR == 2 ? kPairBlocksPerSM : 1)
    fqkv_fwd_mma_kernel(const MmaArgs a) {
  using L = Smem<D, kBR>;
  constexpr int kLd = L::kLd, kSn = kRowsQ / 8;
  extern __shared__ __align__(128) char smem_q[];
  bf16* sm = reinterpret_cast<bf16*>(smem_q);
  bf16* ring = sm;
  bf16* sw2 = sm + L::kW2;
  float* sb1 = reinterpret_cast<float*>(sm + L::kB1);

  const int Tn = a.Tn, H = a.H, B = a.B, n_bb = B / kBR;
  const int n_qc = (Tn + kRowsQ - 1) / kRowsQ, n_rows = (int)(gridDim.x / n_qc);
  const int qc = n_qc - 1 - (int)(blockIdx.x / n_rows), rr = (int)(blockIdx.x % n_rows);
  const int h = rr % H, b0 = (rr / H) % n_bb * kBR, m = rr / (H * n_bb);
  const int warp = threadIdx.x / 32;
  Block k;
  k.hs2 = a.hs / 2;
  k.Dm = H * k.hs2;
  k.d3 = 3 * k.Dm;
  k.h = h;
  k.q0 = qc * kRowsQ;
  k.br = warp / (4 * kGW);
  k.gw = warp / 4 % kGW;
  k.lane = threadIdx.x % 32;
  k.w0 = 16 * (warp % 4);
  k.xb = a.x + ((size_t)m * B + b0) * Tn * a.C;
  k.w1m = a.w1 + (size_t)m * a.C * k.d3;
  k.b1h = a.b1 + (size_t)m * k.d3 + h * k.hs2;
  k.w2h = a.w2 + ((size_t)m * 3 * H + h) * k.hs2 * a.hs;
  const int lane = k.lane, w0 = k.w0, q0 = k.q0, b = b0 + k.br;
  bf16* sq = sm + L::kQKV + k.br * 3 * kRowsQ * kLd;  // this warp's batch row's q, k, v
  bf16* sk = sq + kRowsQ * kLd;
  bf16* sv = sk + kRowsQ * kLd;
  const bool active = k.gw == 0 && q0 + w0 < Tn;  // the warps that hold q: the attention
  const int qrow[2] = {q0 + w0 + (lane >> 2), q0 + w0 + (lane >> 2) + 8};
  const uint32_t n_idx = fqkv_mask_row(a.gb, a.Bg, a.b0, a.Hg, a.h0, m, b, h);
  const bool on = a.on != 0;
  const KeepRowW kr[2] = {KeepRowW(on, a.seed, n_idx, (uint32_t)qrow[0], a.thresh),
                          KeepRowW(on, a.seed, n_idx, (uint32_t)qrow[1], a.thresh)};

  load_w2_b1<D, kBR, kGW>(a, k, sw2, sb1);
  uint32_t qa[wr::kHoldQ<D> ? D / 16 : 1][4];
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  // the key slabs of key chunk kc that the warp's rows see
  auto slabs = [&](int k0) {
    const int reach = q0 + w0 + 15 - k0;
    return reach < 0 ? 0 : min(kSn / 2, reach / 16 + 1);
  };
  auto row_max = [&]() {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m2[hh] = wr::quad_max(m2[hh]);
      if (m2[hh] == -INFINITY) m2[hh] = 0.f;
    }
  };

  if (qc == 0) {  // T <= 64 and the first chunk: one pass, q, k and v together
    if constexpr (kTogether<D> || kGW == 3) {
      project<D, kBR, kGW, 3>(a, k, ring, sw2, sb1, sq, sk, sv, 0, {0, 1, 2}, qa);
    } else {
      project<D, kBR, kGW, 1>(a, k, ring, sw2, sb1, sq, sk, sv, 0, {0}, qa);
      project<D, kBR, kGW, 1>(a, k, ring, sw2, sb1, sq, sk, sv, 0, {1}, qa);
      project<D, kBR, kGW, 1>(a, k, ring, sw2, sb1, sq, sk, sv, 0, {2}, qa);
    }
    const int ns = slabs(0);
    if (active && ns > 0) {
      float s[kSn][4];
      wr::qk_scores<D, kSn>(s, qa, sq + w0 * kLd, sk, ns, lane);
      wr::mask_scale<kSn>(s, ns, 0, qrow, a.sl2, m2, lane);
      row_max();
      wr::softmax_pv<D, kSn>(o, l, s, m2, kr, on, 0, sv, ns, lane);
    }
  } else {
    project<D, kBR, kGW, 1>(a, k, ring, sw2, sb1, sq, sk, sv, q0, {0}, qa);
    for (int kc = 0; kc <= qc; ++kc) {  // the row max
      const int k0 = kc * kRowsQ, ns = slabs(k0);
      project<D, kBR, kGW, 1>(a, k, ring, sw2, sb1, sq, sk, sv, k0, {1}, qa);
      if (active && ns > 0) {
        float s[kSn][4];
        wr::qk_scores<D, kSn>(s, qa, sq + w0 * kLd, sk, ns, lane);
        wr::mask_scale<kSn>(s, ns, k0, qrow, a.sl2, m2, lane);
      }
      __syncthreads();  // every warp is done with this chunk's k
    }
    row_max();
    for (int kc = 0; kc <= qc; ++kc) {  // p at the whole row's max, l, P.V
      const int k0 = kc * kRowsQ, ns = slabs(k0);
      if constexpr (kTogether<D> || kGW == 3) {
        project<D, kBR, kGW, 2>(a, k, ring, sw2, sb1, sq, sk, sv, k0, {1, 2}, qa);
      } else {
        project<D, kBR, kGW, 1>(a, k, ring, sw2, sb1, sq, sk, sv, k0, {1}, qa);
        project<D, kBR, kGW, 1>(a, k, ring, sw2, sb1, sq, sk, sv, k0, {2}, qa);
      }
      if (active && ns > 0) {
        float s[kSn][4], mt[2] = {-INFINITY, -INFINITY};
        wr::qk_scores<D, kSn>(s, qa, sq + w0 * kLd, sk, ns, lane);
        wr::mask_scale<kSn>(s, ns, k0, qrow, a.sl2, mt, lane);
        wr::softmax_pv<D, kSn>(o, l, s, m2, kr, on, k0, sv, ns, lane);
      }
      __syncthreads();  // every warp is done with this chunk's k and v
    }
  }

  if (active) {  // out = o / (l (1 - rate)), rounded once, through the warp's rows of sq
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = __frcp_rn(wr::quad_sum(l[hh]) * a.keepf);
    uint32_t outv[D / 8][2];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        outv[dt][hh] = mma::pack_bf16(o[dt][2 * hh] * l[hh], o[dt][2 * hh + 1] * l[hh]);
    bf16* ob = a.out + ((((size_t)m * H + h) * B + b) * Tn + q0 + w0) * a.hs;
    wr::store_warp_rows<kLd, D / 8>(ob, sq + w0 * kLd, outv, a.hs, Tn - q0 - w0, a.vec_out != 0,
                                    lane, 0);
  }
}

template <int D, int kBR, int kGW>
int launch_mma(const MmaArgs& a, int M, cudaStream_t stream) {
  const int n_qc = (a.Tn + kRowsQ - 1) / kRowsQ;
  const long long blocks = (long long)M * (a.B / kBR) * a.H * n_qc;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)Smem<D, kBR>::kTotal * sizeof(bf16);
  const cudaError_t err = cudaFuncSetAttribute(
      fqkv_fwd_mma_kernel<D, kBR, kGW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fqkv_fwd_mma_kernel<D, kBR, kGW><<<(unsigned)blocks, 128 * kBR * kGW, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The weights rounded to bf16 into ws (w1, padded to 8 elements, then w2),
// then the kernel: two batch rows a block where B is even.
inline int launch(const void* x, const void* w1, const void* b1, const void* w2, void* out,
                  void* ws, int M, int B, int Tn, int C, int H, int hs, float scale,
                  const FwdDrop& dr, cudaStream_t stream) {
  const long long n_w1 = (long long)M * C * 3 * H * (hs / 2), n_w2 = (long long)M * 3 * H * (hs / 2) * hs;
  MmaArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.b1 = static_cast<const float*>(b1);
  a.out = static_cast<bf16*>(out);
  a.B = B; a.Tn = Tn; a.C = C; a.H = H; a.hs = hs;
  a.sl2 = scale * wr::kLog2e;
  a.seed = dr.seed; a.thresh = dr.thresh; a.on = dr.on; a.keepf = dr.keepf;
  a.gb = dr.gb; a.Bg = dr.Bg; a.b0 = dr.b0; a.Hg = dr.Hg; a.h0 = dr.h0;
  a.vec_x = C % 8 == 0 && flash::aligned16({x});
  a.vec_out = flash::aligned16({out});
  if (ws == nullptr || !flash::aligned16({ws})) return (int)cudaErrorInvalidValue;
  bf16* w1b = static_cast<bf16*>(ws);
  bf16* w2b = w1b + (n_w1 + 7) / 8 * 8;
  const int err = gm::round_weights(static_cast<const float*>(w1), n_w1,
                                    static_cast<const float*>(w2), n_w2, w1b, w2b, stream);
  if (err != 0) return err;
  a.w1 = w1b;
  a.w2 = w2b;
  const bool pair = B % 2 == 0;
  if (hs <= 64)
    return pair ? launch_mma<64, 2, 1>(a, M, stream) : launch_mma<64, 1, kGroupWarpsOne>(a, M, stream);
  return pair ? launch_mma<128, 2, 1>(a, M, stream) : launch_mma<128, 1, kGroupWarpsOne>(a, M, stream);
}

}  // namespace qkv

}  // namespace tat

// x (M, B, T, C) bf16 or f32; w1 (M, C, 3*H*hs/2), b1 (M, 3*H*hs/2) and
// w2 (M, 3H, hs/2, hs) f32; out (M, H, B, T, hs) in x's type. All contiguous.
// ws: a 16-byte aligned workspace of (M C 3 H hs/2 rounded up to 8) + M 3H
// hs/2 hs bf16, which the mma.sync body fills with the weights rounded once
// a call and the other bodies leave unused: this entry alone picks the body.
// Dropout (rate_on): the JAX kernel's mask rows, with batch groups of gb
// (_fqkv_pick_gb) of the global batch of Bg rows, of which x holds rows
// [b0, b0 + B) (Bg = B, b0 = 0 on one rank), and of the model's Hg heads,
// of which w1 and w2 hold heads [h0, h0 + H) (Hg = H, h0 = 0 on one rank);
// under modality parallelism b0 also carries the launch's first modality m0
// as m0 Bg (gb divides Bg, so the row's program moves by m0 Bg / gb, as the
// global call's modality m0 + m moves it); keepf = 1 - rate as f32.
// Returns the cudaError_t.
extern "C" int tat_fused_qkv_attention_fwd(const void* x, const void* w1,
                                           const void* b1, const void* w2,
                                           void* out, void* ws, int M, int B, int T,
                                           int C, int H, int hs, int is_bf16,
                                           float scale, unsigned seed,
                                           unsigned thresh, int rate_on,
                                           float keepf, int gb, int Bg, int b0, int Hg, int h0,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tat::FwdDrop dr{seed, thresh, rate_on, keepf, gb, Bg, b0, Hg, h0};
  // bf16 with hs % 16 == 0 and hs <= 128 (every model path: hs 64) takes the
  // mma.sync body; above 128, hs % 32 == 0, C % 8 == 0 and 16-byte aligned x,
  // w1 and w2 (read as 16-byte vectors) the WMMA body; the rest the FMAs
  if (is_bf16 && hs % 16 == 0 && hs <= 128)
    return tat::qkv::launch(x, w1, b1, w2, out, ws, M, B, T, C, H, hs, scale, dr, s);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
                        reinterpret_cast<uintptr_t>(w2)) % 16 == 0;
  if (is_bf16 && hs % 32 == 0 && C % 8 == 0 && aligned)
    return tat::launch_tc(x, w1, b1, w2, out, M, B, T, C, H, hs, scale, dr, s);
  if (is_bf16)
    return tat::launch<__nv_bfloat16>(x, w1, b1, w2, out, M, B, T, C, H, hs, scale, dr, s);
  return tat::launch<float>(x, w1, b1, w2, out, M, B, T, C, H, hs, scale, dr, s);
}
