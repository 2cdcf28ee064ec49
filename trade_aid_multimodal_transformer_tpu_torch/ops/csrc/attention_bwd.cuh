// Backward of whole-row causal attention, shared by the cross-attention
// backward (short_cross_attention.cu) and the fused QKV attention backward
// (fused_qkv_attention_bwd.cu).
//
// One block of 256 threads per collapsed row r walks every stream j and every
// (query tile, key tile) pair with tiles of R rows, all in f32 shared memory
// with the products on FMAs. It recomputes, with the JAX kernels' math
// (pallas_attention.py _short_cross_bwd_kernel / _fqkv_bwd_kernel):
//   p  = exp(s - m) with s = q k^T * scale causally masked, m its row max,
//   l  = rowsum(p)                                    (f32, unmasked)
//   w  = keep ? p * (inv / l) : 0   (p / l without dropout), rounded to T
//   dp = keep ? (do v^T) * inv : 0  (do v^T without dropout)
//   D  = rowsum(w * do v^T) (cross) or rowsum(do * o) (fused)
//   ds = ((p / l) * (dp - D)) rounded to T
//   dv_j = w^T do, dk_j = scale * ds^T q, dq = sum_j scale * ds k_j
// Row statistics (m, l, D) take two or three passes over the key tiles of a
// query tile; the gradient pass walks key tiles outermost so that dk_j and
// dv_j stay in registers, and dq gathers in an f32 workspace that only this
// block touches (a fixed summation order: two runs give the same bits).
//
// What bounds it: at the production shapes every (row, stream) is one 64 x 64
// tile pair; the block's FMA products and barriers, not device memory, set
// the time (no tensor cores yet).
#pragma once

#include "attention_tile.cuh"

namespace tat {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // fused: the forward output (for D); unused by cross
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* dq_ws;      // (n, T, hs) f32 workspace
  int J, n, Tn, hs, R, n_t;
  float scale;
  int rate_on;
  uint32_t seed, thresh;
  float inv;         // 1 / (1 - rate) as f32
  // fused layout: r = (m * H + h) * B + b over q/k/v in (M, 3H, B, T, hs)
  int fused, B, H, gb;
};

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

  size_t q_off, k_off, v_off;
  uint32_t n_idx;
  if (a.fused) {
    const int b = r % a.B, h = (r / a.B) % a.H, m = r / (a.B * a.H);
    const size_t head = (size_t)a.B * plane;  // one virtual head of (M, 3H, B, T, hs)
    q_off = ((size_t)m * 3 * a.H + h) * head + b * plane;
    k_off = q_off + (size_t)a.H * head;
    v_off = k_off + (size_t)a.H * head;
    const int pid = m * (a.B / a.gb) + b / a.gb;
    n_idx = (uint32_t)(pid * a.gb * a.H + h * a.gb + b % a.gb);
  } else {
    q_off = (size_t)r * plane;
    k_off = v_off = 0;
    n_idx = (uint32_t)r;
  }
  const T* Q = static_cast<const T*>(a.q) + q_off;
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
    const T* Kj = static_cast<const T*>(a.k) + (a.fused ? k_off : ((size_t)jj * a.n + r) * plane);
    const T* Vj = static_cast<const T*>(a.v) + (a.fused ? v_off : ((size_t)jj * a.n + r) * plane);
    const Dropout d{a.fused ? a.seed : stream_seed(a.seed, jj), n_idx, a.thresh, a.rate_on != 0};

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
      if (a.fused) {  // D = rowsum(do * o)
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
          const float pl = sP[i * lds + j] / lrow[q0 + i];
          sS[i * lds + j] = Io<T>::round(pl * (sS[i * lds + j] - drow[q0 + i]));
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
      T* dK = static_cast<T*>(a.dk) + (a.fused ? k_off : ((size_t)jj * a.n + r) * plane);
      T* dV = static_cast<T*>(a.dv) + (a.fused ? v_off : ((size_t)jj * a.n + r) * plane);
      if (a.fused) {  // dk / dv of the fused path live in the dqkv buffer (dq's)
        dK = static_cast<T*>(a.dq) + k_off;
        dV = static_cast<T*>(a.dq) + v_off;
      }
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

  T* dQ = static_cast<T*>(a.dq) + q_off;
  for (size_t idx = tid; idx < plane; idx += kThreads) Io<T>::store(dQ + idx, ws[idx]);
}

template <typename T>
int launch_attn_bwd(BwdArgs a, cudaStream_t stream) {
  a.R = tile_rows(a.hs);
  a.n_t = (a.Tn + a.R - 1) / a.R;
  if (a.n <= 0 || a.n > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = attn_bwd_smem_floats(a.R, a.hs, a.n_t) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_kernel<T><<<(unsigned)a.n, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tat
