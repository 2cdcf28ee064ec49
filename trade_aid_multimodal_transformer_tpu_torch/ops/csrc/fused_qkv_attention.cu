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
// group) programs (FwdDrop, fqkv_dropout).
//
// What bounds it on the H100: at the production shape (x 4x32x64x384 bf16,
// H=6, hs=64) the work is ~4.6 GFLOP, most of it the C=384 -> 3*hs/2
// projection, against ~17 MB of traffic: ~270 FLOP/byte, just under the
// ~295 ridge of bf16, so bytes bound it by a hair and operations nearly as
// much. The design keeps what the TPU kernel kept out of device memory: t
// and q/k/v live only in shared memory, x is read from L2 per (row tile,
// head), and out is written once. One block of 256 threads per (m, b, h,
// query tile of R rows). Keys are walked in tiles of R rows in two passes,
// the first for each row's exact max and the second for exp / row sum / P.V,
// so that p is rounded at the whole-row max as in the JAX kernel; where the
// causal row spans one key tile (T <= R, production) q, k and v are projected
// in one pass over C and held, otherwise K and V are projected again per pass.
//
// Two kernels: for bf16 with hs % 32 == 0 and C % 8 == 0 (production) every
// product runs on the tensor cores (WMMA 16x16x16, bf16 operands, f32 sums)
// with 16-byte vector loads; otherwise (f32, other head sizes) the products
// are f32 FMAs on the CUDA cores. What still limits the tensor-core kernel is
// latency inside a block: each chunk of C waits for its loads, then for the
// products, with barriers between; there is no double buffering or TMA yet.
#include "attention_tile.cuh"

namespace tat {

constexpr int kChunk = 32;  // contraction chunk of the first product

// Dropout arguments of a launch: seed (s0 ^ s1 of the site's salts), keep
// threshold, on/off, 1 - rate as f32, and the JAX kernel's batch group gb.
struct FwdDrop {
  uint32_t seed, thresh;
  int on;
  float keepf;
  int gb;
};

// The mask row of (m, b, h) in the JAX kernel: program pid = m * (B / gb) +
// b / gb holds gb batch rows of every head, collapsed head-major.
__device__ inline Dropout fqkv_dropout(const FwdDrop& dr, int m, int b, int h, int B, int H) {
  const int pid = m * (B / dr.gb) + b / dr.gb;
  return Dropout{dr.seed, (uint32_t)(pid * dr.gb * H + h * dr.gb + b % dr.gb), dr.thresh,
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
  const Dropout d = fqkv_dropout(dr, m, b, h, B, H);

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

// The same function for bf16, hs a multiple of 32 and C a multiple of 8,
// every product on the tensor cores. At most 128 registers a thread, so that
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
  const Dropout d = fqkv_dropout(dr, m, b, h, B, H);

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

}  // namespace tat

// x (M, B, T, C) bf16 or f32; w1 (M, C, 3*H*hs/2), b1 (M, 3*H*hs/2) and
// w2 (M, 3H, hs/2, hs) f32; out (M, H, B, T, hs) in x's type. All contiguous.
// Dropout (rate_on): the JAX kernel's mask rows, with batch groups of gb
// (_fqkv_pick_gb); keepf = 1 - rate as f32. Returns the cudaError_t.
extern "C" int tat_fused_qkv_attention_fwd(const void* x, const void* w1,
                                           const void* b1, const void* w2,
                                           void* out, int M, int B, int T,
                                           int C, int H, int hs, int is_bf16,
                                           float scale, unsigned seed,
                                           unsigned thresh, int rate_on,
                                           float keepf, int gb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tat::FwdDrop dr{seed, thresh, rate_on, keepf, gb};
  // bf16 with hs % 32 == 0 and C % 8 == 0 (production: hs 64, C 384) and
  // 16-byte aligned x, w1 and w2 (read as 16-byte vectors) take the tensor cores
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
                        reinterpret_cast<uintptr_t>(w2)) % 16 == 0;
  if (is_bf16 && hs % 32 == 0 && C % 8 == 0 && aligned)
    return tat::launch_tc(x, w1, b1, w2, out, M, B, T, C, H, hs, scale, dr, s);
  if (is_bf16)
    return tat::launch<__nv_bfloat16>(x, w1, b1, w2, out, M, B, T, C, H, hs, scale, dr, s);
  return tat::launch<float>(x, w1, b1, w2, out, M, B, T, C, H, hs, scale, dr, s);
}
