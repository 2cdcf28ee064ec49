// Cached-decode attention: one new query position against a KV cache row,
// cache column c visible iff c <= pos, in four forms:
//
//   plain   q (n, hs), k and v (n, S, hs)
//   transposed  k and v (n, hs, S): feature e of position c at e * S + c
//   packed  k and v (n, S / pack, pack * hs): position c at row c / pack, lane
//           block c % pack, which is the row-major (n, S, hs) array itself
//   q8      the packed form in int8 with one f32 scale per packed row,
//           k_scale and v_scale (n, S / pack)
//
// Replaces: trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py,
// _decode_kernel (decode_attention), _decode_t_kernel (decode_attention_t),
// _decode_p_kernel (decode_attention_packed) and _decode_p8_kernel
// (decode_attention_packed_q8). Each keeps its JAX kernel's rounding points:
//   plain and transposed:  s = q.k * hs^-0.5 in f32; w = p / sum(p) rounded to
//           v's type; out = sum_c w_c v_c in f32, rounded once;
//   packed: one max over every position; the unnormalised p_c rounded to v's
//           type; out = (sum_c p_c v_c in f32) / l, rounded once;
//   q8:     s = (q.k_c * hs^-0.5) * (k_scale_c / 127) with k upcast exactly;
//           p_c * (v_scale_c / 127) rounded to q's type before P.V; out =
//           (sum_c ... v_c) / l, rounded once.
// Sums run in another order than on the TPU (warp shuffles, then a fixed-order
// sum over thread groups), so f32 results agree to rounding, not bit for bit.
// pos is read from a one-element int32 array in device memory, as the TPU
// kernel reads it from SMEM, so that a captured decode step can advance it on
// the card.
//
// What bounds it on the H100: per row it reads 2 * (pos + 1) * hs cache
// elements for 4 * (pos + 1) * hs FLOP, one FLOP per byte in bf16, so memory
// bounds it by far. One block of 256 threads per row. The keys, then the
// values, pass through shared memory in tiles of up to 32 KB (one tile at the
// serving shapes), loaded with many independent loads in flight per thread;
// a warp per key column computes the scores from the tile, a block reduction
// the max and the row sum, and groups of hs threads the P.V product over
// strided columns, combined in shared memory in a fixed order. Columns past
// pos are never read. At serving shapes (24 * B or 18 * B rows, S = 64,
// hs = 64) a block moves 16 KB, so the launch and one block's latency, not
// bandwidth, set the time. The transposed form is the same body: its tile
// loader reads runs of consecutive positions per feature (coalesced) and
// stores them position-major with a row stride of hs + 1 (no bank
// conflicts), so the score and P.V steps are the plain form's. The JAX
// package keeps this layout for the TPU's lane tiling; no caller of the port
// uses it, it stands beside the other forms for users of the op.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tat_decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;           // loads in flight per thread
constexpr int kTileFloats = 8192;   // 32 KB of cache rows per tile
enum Variant { kPlain = 0, kPacked = 1, kQ8 = 2, kTransposed = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// Round an f32 value to T and back (the JAX kernels' cast points).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Block-wide max or sum of one value per thread; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();
  return r;
}

// Copy cache positions [c0, c0 + nc) of one row's cache into tile (f32,
// position c0 + j at tile[j * ldt]), every thread issuing kBatch independent
// loads before it stores any: one load at a time would wait a device-memory
// latency per element. The (S, hs) layouts read the tile's bytes in order
// (ldt = hs); the transposed (hs, S) layout reads feature e's run of nc
// positions at e * S + c0 (ldt = hs + 1).
template <bool kTrans, typename KV>
__device__ void load_tile(const KV* __restrict__ src, int c0, int nc, int hs, int S, int ldt,
                          float* tile) {
  const int n = nc * hs;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      const size_t at = kTrans ? (size_t)(idx / nc) * S + c0 + idx % nc : (size_t)c0 * hs + idx;
      v[u] = idx < n ? to_f(src[at]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx < n) tile[kTrans ? (idx % nc) * ldt + idx / nc : idx] = v[u];
    }
  }
  __syncthreads();
}

// T: the query and output type (bf16 or f32); KV: the cache type (T, or int8
// for q8). Shared memory: q (hs), scores / probabilities (S), a tile of
// cache rows (kTileFloats), P.V partial sums (groups * hs), reduction
// scratch (kWarps). Keys pass through the tile once for the scores, values
// once for P.V.
template <typename T, typename KV, int kVariant>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                  const KV* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ pos_p,
                  T* __restrict__ out, int S, int hs, int pack, float scale) {
  extern __shared__ float sm[];
  constexpr bool kTrans = kVariant == kTransposed;
  const int groups = kThreads / hs;
  const int ldt = kTrans ? hs + 1 : hs;      // tile row stride
  const int tc = min(S, kTileFloats / ldt);  // cache positions per tile
  float* qs = sm;
  float* s = qs + hs;
  float* tile = s + S;
  float* part = tile + kTileFloats;
  float* scratch = part + groups * hs;
  const size_t row = blockIdx.x;
  const KV* kr = k + row * (size_t)S * hs;
  const KV* vr = v + row * (size_t)S * hs;
  const int sp = S / pack;
  const float inv127 = (float)(1.0 / 127.0);  // the f32 of JAX's Python 1.0 / 127.0

  const int pos = __ldg(pos_p);
  const int n_vis = max(0, min(pos + 1, S));  // columns 0..pos; the rest are masked

  for (int e = threadIdx.x; e < hs; e += kThreads) qs[e] = to_f(q[row * hs + e]);

  // scores, one warp per column of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c0 = 0; c0 < n_vis; c0 += tc) {
    const int nc = min(tc, n_vis - c0);
    load_tile<kTrans>(kr, c0, nc, hs, S, ldt, tile);  // its barrier also publishes qs
    for (int j = warp; j < nc; j += kWarps) {
      float dot = 0.f;
      for (int e = lane; e < hs; e += 32) dot = fmaf(qs[e], tile[j * ldt + e], dot);
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const int c = c0 + j;
        float sc = dot * scale;
        if (kVariant == kQ8) sc = sc * (k_scale[row * sp + c / pack] * inv127);
        s[c] = sc;
      }
    }
    __syncthreads();
  }

  float mx = -INFINITY;
  for (int c = threadIdx.x; c < n_vis; c += kThreads) mx = fmaxf(mx, s[c]);
  mx = block_reduce<true>(mx, scratch);
  float sum = 0.f;
  for (int c = threadIdx.x; c < n_vis; c += kThreads) {
    const float p = expf(s[c] - mx);
    s[c] = p;
    sum += p;
  }
  const float l = block_reduce<false>(sum, scratch);  // its barrier publishes s
  // the weights that multiply v, at their variant's rounding point
  for (int c = threadIdx.x; c < n_vis; c += kThreads) {
    if (kVariant == kPlain || kTrans) s[c] = round_to<T>(s[c] / l);
    else if (kVariant == kPacked) s[c] = round_to<T>(s[c]);
    else s[c] = round_to<T>(s[c] * (v_scale[row * sp + c / pack] * inv127));
  }
  // (load_tile's barrier publishes the weights)

  // P.V: thread (g, e) sums the tile's rows g, g + groups, ... of feature e
  const int g = threadIdx.x / hs, e = threadIdx.x % hs;
  float acc = 0.f;
  for (int c0 = 0; c0 < n_vis; c0 += tc) {
    const int nc = min(tc, n_vis - c0);
    load_tile<kTrans>(vr, c0, nc, hs, S, ldt, tile);
    if (g < groups)
      for (int j = g; j < nc; j += groups) acc = fmaf(s[c0 + j], tile[j * ldt + e], acc);
    __syncthreads();
  }
  if (g < groups) part[g * hs + e] = acc;
  __syncthreads();
  for (int f = threadIdx.x; f < hs; f += kThreads) {
    float o = 0.f;
    for (int gg = 0; gg < groups; ++gg) o += part[gg * hs + f];
    if (kVariant == kPacked || kVariant == kQ8) o = o / l;
    store(out + row * hs + f, o);
  }
}

template <typename T, typename KV, int kVariant>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* pos, void* out, int n, int S, int hs,
           int pack, float scale, cudaStream_t stream) {
  if (n <= 0 || hs <= 0 || hs > kThreads || S <= 0 || pack <= 0 || S % pack != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)hs + S + kTileFloats +
                                       (size_t)(kThreads / hs) * hs + kWarps);
  auto kernel = decode_kernel<T, KV, kVariant>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)n, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(pos), static_cast<T*>(out), S, hs, pack, scale);
  return (int)cudaGetLastError();
}

}  // namespace tat_decode

// q (n, 1, hs); k, v (n, S, hs); pos a device int32[1]; out (n, 1, hs). One
// type, bf16 or f32, contiguous. Returns the cudaError_t of the launch.
extern "C" int tat_decode_attention(const void* q, const void* k, const void* v,
                                    const void* pos, void* out, int n, int S, int hs,
                                    int is_bf16, float scale, void* stream) {
  using namespace tat_decode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, kPlain>(q, k, v, nullptr, nullptr, pos, out,
                                                        n, S, hs, 1, scale, s);
  return launch<float, float, kPlain>(q, k, v, nullptr, nullptr, pos, out, n, S, hs, 1,
                                      scale, s);
}

// q (n, 1, hs); k, v (n, S / pack, pack * hs), S the number of positions.
extern "C" int tat_decode_attention_packed(const void* q, const void* k, const void* v,
                                           const void* pos, void* out, int n, int S,
                                           int hs, int pack, int is_bf16, float scale,
                                           void* stream) {
  using namespace tat_decode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, kPacked>(q, k, v, nullptr, nullptr, pos,
                                                         out, n, S, hs, pack, scale, s);
  return launch<float, float, kPacked>(q, k, v, nullptr, nullptr, pos, out, n, S, hs, pack,
                                       scale, s);
}

// q (n, 1, hs) bf16 or f32; k, v (n, S / pack, pack * hs) int8; k_scale,
// v_scale (n, S / pack) f32; out in q's type.
extern "C" int tat_decode_attention_packed_q8(const void* q, const void* k, const void* v,
                                              const void* k_scale, const void* v_scale,
                                              const void* pos, void* out, int n, int S,
                                              int hs, int pack, int is_bf16, float scale,
                                              void* stream) {
  using namespace tat_decode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, int8_t, kQ8>(q, k, v, k_scale, v_scale, pos, out, n, S, hs,
                                              pack, scale, s);
  return launch<float, int8_t, kQ8>(q, k, v, k_scale, v_scale, pos, out, n, S, hs, pack,
                                    scale, s);
}

// q (n, 1, hs); k, v (n, hs, S), the transposed cache; pos a device int32[1];
// out (n, 1, hs). One type, bf16 or f32, contiguous (K9).
extern "C" int tat_decode_attention_t(const void* q, const void* k, const void* v,
                                      const void* pos, void* out, int n, int S, int hs,
                                      int is_bf16, float scale, void* stream) {
  using namespace tat_decode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, kTransposed>(q, k, v, nullptr, nullptr, pos,
                                                             out, n, S, hs, 1, scale, s);
  return launch<float, float, kTransposed>(q, k, v, nullptr, nullptr, pos, out, n, S, hs, 1,
                                           scale, s);
}
