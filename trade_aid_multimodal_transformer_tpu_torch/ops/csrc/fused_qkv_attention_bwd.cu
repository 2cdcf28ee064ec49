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
// sequential grid. Here it is ten launches on one stream, each a simple
// kernel: a batched tiled GEMM (f32 FMAs, any strides) for every product,
// small elementwise kernels for tanh and dpre, the attention backward of
// attention_bwd.cuh, and a column sum for db1. The intermediates (pre/t2,
// t3, qkv, dqkv, dt3/dpre, dprec: ~40 MB at the production shape in bf16)
// go through device memory. Every sum runs in a fixed order inside one block
// (no atomics), so two runs give the same bits.
//
// What bounds it on the H100: ~13 GFLOP at the production shape (x 4x32x64x384
// bf16, H=6, hs=64), most of it the four C x 3D products; on FMAs at f32 that
// is the limit, far from the tensor cores' rate.
#include "attention_bwd.cuh"

namespace tat {

constexpr int kGM = 64, kGN = 64, kGK = 16;  // GEMM tile

// C[z](i, j) = sum_k A[z](i, k) * B[z](k, j), z = z1 * Z2 + z2; every operand
// addressed by its own strides. Operands load as f32; round_a / round_b round
// f32 operands to bf16 (weights cast to the activation type).
struct Gemm {
  const void* A;
  const void* B;
  void* C;
  int Mr, N, K, Z1, Z2;
  long long sA1, sA2, sai, sak;
  long long sB1, sB2, sbk, sbj;
  long long sC1, sC2, sci, scj;
  int round_a, round_b;
};

template <typename T>
__device__ __forceinline__ float load_op(const T* p, int round_bf16);

template <>
__device__ __forceinline__ float load_op<float>(const float* p, int round_bf16) {
  const float v = *p;
  return round_bf16 ? Io<__nv_bfloat16>::round(v) : v;
}

template <>
__device__ __forceinline__ float load_op<__nv_bfloat16>(const __nv_bfloat16* p, int) {
  return __bfloat162float(*p);
}

template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Gemm g) {
  __shared__ float As[kGK][kGM + 4];
  __shared__ float Bs[kGK][kGN + 4];
  const int z = blockIdx.z, z1 = z / g.Z2, z2 = z % g.Z2;
  const TA* A = static_cast<const TA*>(g.A) + z1 * g.sA1 + z2 * g.sA2;
  const TB* Bm = static_cast<const TB*>(g.B) + z1 * g.sB1 + z2 * g.sB2;
  TC* C = static_cast<TC*>(g.C) + z1 * g.sC1 + z2 * g.sC2;
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
      As[kk][ii] = (i < g.Mr && k < g.K) ? load_op<TA>(A + i * g.sai + k * g.sak, g.round_a) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGK * kGN / kThreads; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int kk = b_j_fast ? idx / kGN : idx % kGK, jj = b_j_fast ? idx % kGN : idx / kGK;
      const int j = j0 + jj, k = k0 + kk;
      Bs[kk][jj] = (j < g.N && k < g.K) ? load_op<TB>(Bm + k * g.sbk + j * g.sbj, g.round_b) : 0.f;
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
      if (i < g.Mr && j < g.N) Io<TC>::store(C + i * g.sci + j * g.scj, acc[a][b]);
    }
}

template <typename TA, typename TB, typename TC>
int gemm(const Gemm& g, cudaStream_t stream) {
  const dim3 grid((g.N + kGN - 1) / kGN, (g.Mr + kGM - 1) / kGM, g.Z1 * g.Z2);
  gemm_kernel<TA, TB, TC><<<grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// t2 = tanh(pre + b1) in place (f32), t3 = t2 rounded to T.
template <typename T>
__global__ void tanh_kernel(float* pre, T* t3, const float* __restrict__ b1, long long n,
                            int rows, int d3) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const int col = (int)(idx % d3);
    const long long m = idx / ((long long)rows * d3);
    const float t = tanhf(pre[idx] + b1[m * d3 + col]);
    pre[idx] = t;
    Io<T>::store(t3 + idx, t);
  }
}

// dpre = round(dt3) * (1 - t2^2) in place of dt3 (f32), dprec = dpre rounded.
template <typename T>
__global__ void dpre_kernel(float* dt3, const float* __restrict__ t2, T* dprec, long long n) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const float t = t2[idx];
    const float dp = Io<T>::round(dt3[idx]) * (1.f - t * t);
    dt3[idx] = dp;
    Io<T>::store(dprec + idx, dp);
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
             uint32_t seed, uint32_t thresh, int rate_on, float inv, int gb,
             cudaStream_t s) {
  const int is_bf16 = sizeof(T) == 2;
  const int hs2 = hs / 2, d3 = 3 * H * hs2, H3 = 3 * H;
  const long long BT = (long long)B * Tn, vhead = BT * hs;
  float* pre = static_cast<float*>(ws_f32a);  // pre, then t2
  float* dt3 = static_cast<float*>(ws_f32b);  // dt3, then dpre
  T* t3 = static_cast<T*>(ws_t3);
  T* qkv = static_cast<T*>(ws_qkv);
  T* dqkv = static_cast<T*>(ws_dqkv);
  T* dprec = static_cast<T*>(ws_dprec);

  // pre[m] (BT x d3) = x[m] (BT x C) . w1[m] (C x d3)
  Gemm g{};
  g = Gemm{x, w1, pre, (int)BT, d3, C, M, 1, BT * C, 0, C, 1, (long long)C * d3, 0, d3, 1,
           BT * d3, 0, d3, 1, 0, is_bf16};
  TAT_TRY((gemm<T, float, float>(g, s)));
  const long long n_pre = (long long)M * BT * d3;
  tanh_kernel<T><<<grid_for(n_pre), kThreads, 0, s>>>(pre, t3, static_cast<const float*>(b1),
                                                      n_pre, (int)BT, d3);
  TAT_TRY((int)cudaGetLastError());
  // qkv[m, vh] (BT x hs) = t3[m][:, vh] (BT x hs2) . w2[m, vh] (hs2 x hs)
  g = Gemm{t3, w2, qkv, (int)BT, hs, hs2, M, H3, BT * d3, hs2, d3, 1,
           (long long)H3 * hs2 * hs, (long long)hs2 * hs, hs, 1, H3 * vhead, vhead, hs, 1,
           0, is_bf16};
  TAT_TRY((gemm<T, float, T>(g, s)));
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
  a.fused = 1;
  a.B = B;
  a.H = H;
  a.gb = gb;
  TAT_TRY(launch_attn_bwd<T>(a, s));
  // dt3[m][:, vh] (BT x hs2) = dqkv[m, vh] (BT x hs) . w2[m, vh]^T (hs x hs2)
  g = Gemm{dqkv, w2, dt3, (int)BT, hs2, hs, M, H3, H3 * vhead, vhead, hs, 1,
           (long long)H3 * hs2 * hs, (long long)hs2 * hs, 1, hs, BT * d3, hs2, d3, 1,
           0, is_bf16};
  TAT_TRY((gemm<T, float, float>(g, s)));
  dpre_kernel<T><<<grid_for(n_pre), kThreads, 0, s>>>(dt3, pre, dprec, n_pre);
  TAT_TRY((int)cudaGetLastError());
  colsum_kernel<<<dim3((d3 + 31) / 32, M), kThreads, 0, s>>>(dt3, static_cast<float*>(db1),
                                                             (int)BT, d3);
  TAT_TRY((int)cudaGetLastError());
  // dw2[m, vh] (hs2 x hs) = t3[m][:, vh]^T (hs2 x BT) . dqkv[m, vh] (BT x hs)
  g = Gemm{t3, dqkv, dw2, hs2, hs, (int)BT, M, H3, BT * d3, hs2, 1, d3,
           H3 * vhead, vhead, hs, 1, (long long)H3 * hs2 * hs, (long long)hs2 * hs, hs, 1,
           0, 0};
  TAT_TRY((gemm<T, T, float>(g, s)));
  // dx[m] (BT x C) = dprec[m] (BT x d3) . w1[m]^T (d3 x C)
  g = Gemm{dprec, w1, dx, (int)BT, C, d3, M, 1, BT * d3, 0, d3, 1, (long long)C * d3, 0, 1,
           d3, BT * C, 0, C, 1, 0, is_bf16};
  TAT_TRY((gemm<T, float, T>(g, s)));
  // dw1[m] (C x d3) = x[m]^T (C x BT) . dprec[m] (BT x d3)
  g = Gemm{x, dprec, dw1, C, d3, (int)BT, M, 1, BT * C, 0, 1, C, BT * d3, 0, d3, 1,
           (long long)C * d3, 0, d3, 1, 0, 0};
  TAT_TRY((gemm<T, T, float>(g, s)));
  return 0;
}

}  // namespace tat

// x (M, B, T, C), o and dout (M, H, B, T, hs), dx (M, B, T, C): x's type;
// w1, b1, w2 and dw1 (M, C, 3D), db1 (M, 3D), dw2 (M, 3H, hs/2, hs): f32.
// Workspaces: f32a and f32b (M, B*T, 3D) f32; t3 and dprec (M, B*T, 3D) and
// qkv and dqkv (M, 3H, B, T, hs) in x's type; dq (M*H*B, T, hs) f32.
// inv = 1 / (1 - rate) as f32; gb = _fqkv_pick_gb's batch group. All
// contiguous. Returns the first failing cudaError_t, or 0.
extern "C" int tat_fused_qkv_attention_bwd(
    const void* x, const void* w1, const void* b1, const void* w2, const void* o,
    const void* dout, void* dx, void* dw1, void* db1, void* dw2, void* ws_f32a,
    void* ws_f32b, void* ws_t3, void* ws_qkv, void* ws_dqkv, void* ws_dprec, void* ws_dq,
    int M, int B, int T, int C, int H, int hs, int is_bf16, float scale, unsigned seed,
    unsigned thresh, int rate_on, float inv, int gb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tat::fqkv_bwd<__nv_bfloat16>(x, w1, b1, w2, o, dout, dx, dw1, db1, dw2, ws_f32a,
                                        ws_f32b, ws_t3, ws_qkv, ws_dqkv, ws_dprec, ws_dq, M, B,
                                        T, C, H, hs, scale, seed, thresh, rate_on, inv, gb, s);
  return tat::fqkv_bwd<float>(x, w1, b1, w2, o, dout, dx, dw1, db1, dw2, ws_f32a, ws_f32b,
                              ws_t3, ws_qkv, ws_dqkv, ws_dprec, ws_dq, M, B, T, C, H, hs,
                              scale, seed, thresh, rate_on, inv, gb, s);
}
