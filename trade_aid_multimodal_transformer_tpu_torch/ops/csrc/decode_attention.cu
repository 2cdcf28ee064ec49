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
// Sums run in another order than on the TPU (warp shuffles, then fixed-order
// sums), so f32 results agree to rounding, not bit for bit.
// pos is read from a one-element int32 array in device memory, as the TPU
// kernel reads it from SMEM, so that a captured decode step can advance it on
// the card.
//
// What bounds it on the H100: per row it reads 2 * (pos + 1) * hs cache
// elements for 4 * (pos + 1) * hs FLOP, one FLOP per byte in bf16, so memory
// bounds it by far. At the serving shapes (24 * B or 18 * B rows, S = 64,
// hs = 64) a row is 16 KB, so the latency of one row's loads, not bandwidth,
// sets the time; the design keeps every load of a row in flight at once and
// no barrier between the keys and the values.
//
// The plain, packed and q8 forms run decode_warp_kernel: a warp per cache
// row (rows of up to 128 positions; 4 rows a block, no block barrier), or W
// warps per row for longer rows, each taking a contiguous run of positions.
// L lanes hold one position (16-byte loads straight to registers: 8 bf16, 4
// f32 or 16 int8 features a lane; one element a lane where a row is not
// 16-byte aligned), so a warp step covers 32 / L positions. A warp issues
// the loads of a batch of key rows (64 positions at hs 64) at once, then
// those of its value rows right after the scores, so that they arrive while
// the softmax runs. Scores: a dot product per lane, summed over the L lanes
// by shuffles, into a row of shared memory; the max and the row sum by warp
// shuffles (with W warps the max, and for the plain form l, go through
// shared memory with one barrier each); P.V summed per lane in position
// order, then over the lane groups by shuffles, and over the W warps in warp
// order, o / l rounded once. At these shapes a row's time is the chain of
// its dependent steps (pos, the loads, the shuffle trees), so every load
// is at a clamped address (none waits behind a condition) and every tree
// is unrolled (group_sum). Every sum runs in a fixed order: two runs give
// the same bits. The host picks W and the rows a block from S, hs and the
// rows that fit on the card at once (launch_warp).
//
// The transposed form (K9) keeps the first body, decode_kernel: one block
// of 256 threads per row; the keys, then the values, pass through shared
// memory in tiles of up to 32 KB, its loader reading runs of consecutive
// positions per feature (coalesced) and storing them position-major with a
// row stride of hs + 1 (no bank conflicts); a warp per key column computes
// the scores from the tile, a block reduction the max and the row sum, and
// groups of hs threads the P.V product over strided columns, combined in
// shared memory in a fixed order. The JAX package keeps this layout for the
// TPU's lane tiling; no caller of the port uses it, it stands beside the
// other forms for users of the op.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace tat_decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;           // loads in flight per thread (decode_kernel)
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------ plain, packed, q8: a warp per row

// What a lane loads at once: 16 bytes (kE features of KV) where every
// position of the cache starts on a 16-byte boundary (kVec), else one
// element; kMaxC such chunks a lane holds for hs <= 256; kNB position steps
// a batch of loads (64 positions at hs 64: 16 steps of 4 bf16 positions, 8
// of 8 int8 or of 2 f32 positions).
template <typename KV, bool kVec>
struct Geo {
  static constexpr int kE = kVec ? 16 / (int)sizeof(KV) : 1;
  static constexpr int kMaxC = kVec ? (sizeof(KV) == 4 ? 2 : 1) : 8;
  static constexpr int kNB = kVec ? (sizeof(KV) == 2 ? 16 : 8) : 4;
  using Raw = typename std::conditional<kVec, uint4, KV>::type;
};

constexpr int kRowWarps = 4;         // rows of a block where a warp holds a row
constexpr int kMaxRowWarps = 8;      // warps of a row where a row is longer
constexpr int kWarpRowMax = 128;     // the longest row a single warp holds

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The kE features of a chunk as f32 (int8 upcast exactly).
template <typename KV>
__device__ __forceinline__ void to_floats(const uint4& r, float (&f)[16 / sizeof(KV)]) {
  if constexpr (std::is_same<KV, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(word(r, i));
  } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w = word(r, i);
      f[2 * i] = __uint_as_float(w << 16);
      f[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) f[4 * i + b] = (float)((int)(word(r, i) << (24 - 8 * b)) >> 24);
  }
}

template <typename KV>
__device__ __forceinline__ void to_floats(const KV& r, float (&f)[1]) {
  f[0] = to_f(r);
}

// v summed over the lanes whose xor with this lane is below L (the L lanes
// of a position: kBelow), or over those at xor L and above (the positions'
// groups). Every step of the tree is issued, at a compile-time offset, so
// that the trees of a batch's positions overlap (a loop to L would wait out
// each shuffle in turn).
template <bool kBelow>
__device__ __forceinline__ float group_sum(float v, int L) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, v, o);
    v += (kBelow ? o < L : o >= L) ? y : 0.f;
  }
  return v;
}

struct WarpArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* pos_p;
  void* out;
  int n, S, hs, pack;
  float scale;
  int W;  // warps a row
  int R;  // rows a block
  int L;  // lanes a position: a power of two, at least the chunks of a position, at most 32
};

// T: the query and output type (bf16 or f32); KV: the cache type (T, or
// int8 for q8). Shared memory: each row's scores, then probabilities (S
// floats), the row's warps' max and l (2 W floats), and with W > 1 their
// P.V partial sums (W hs floats).
template <typename T, typename KV, int kVariant, bool kVec>
__global__ void __launch_bounds__(32 * kMaxRowWarps)
    decode_warp_kernel(const WarpArgs a) {
  using G = Geo<KV, kVec>;
  using Raw = typename G::Raw;
  constexpr int kE = G::kE, kMaxC = G::kMaxC, kNB = G::kNB;
  extern __shared__ float smw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int W = a.W, rl = warp / W, part = warp % W;
  const int row = blockIdx.x * a.R + rl;
  if (row >= a.n) return;  // only where a block holds W = 1 rows: no barrier follows
  const int S = a.S, hs = a.hs, L = a.L, P = 32 / L;
  const int grp = lane / L, lig = lane % L, nch = hs / kE;
  float* s = smw + (size_t)rl * S;
  float* red = smw + (size_t)a.R * S + rl * 2 * W;  // [W] maxima, then [W] row sums
  float* partial = smw + (size_t)a.R * S + a.R * 2 * W + (size_t)rl * W * hs;
  const T* qr = static_cast<const T*>(a.q) + (size_t)row * hs;
  const KV* kr = static_cast<const KV*>(a.k) + (size_t)row * S * hs;
  const KV* vr = static_cast<const KV*>(a.v) + (size_t)row * S * hs;
  const int sp = S / a.pack;
  const float inv127 = (float)(1.0 / 127.0);  // the f32 of JAX's Python 1.0 / 127.0

  const int n_vis = max(0, min(__ldg(a.pos_p) + 1, S));  // columns 0..pos; the rest unread
  const int steps = (n_vis + P - 1) / P, per_warp = (steps + W - 1) / W;
  const int j_begin = min(steps, part * per_warp), j_end = min(steps, j_begin + per_warp);

  // Every load below is at a clamped address and in flight at once: a load
  // under a condition would wait for the one before it.
  float qf[kMaxC][kE];
#pragma unroll
  for (int ci = 0; ci < kMaxC; ++ci)
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int ch = lig + ci * L;
      const float v = to_f(qr[min(ch, nch - 1) * kE + e]);
      qf[ci][e] = ch < nch ? v : 0.f;
    }

  // step j: position j P + grp, the lane's chunks lig + ci L of it, and
  // (q8) its row's scale; zeros past the warp's run
  auto load = [&](Raw (&r)[kNB][kMaxC], float (&sc)[kNB], const KV* base, const float* scale,
                  int j0) {
#pragma unroll
    for (int u = 0; u < kNB; ++u) {
      const int j = j0 + u, c = j * P + grp;
      const bool in = j < j_end && c < n_vis;
#pragma unroll
      for (int ci = 0; ci < kMaxC; ++ci) {
        const int ch = lig + ci * L;
        if (in && ch < nch) {
          if constexpr (kVec)
            r[u][ci] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)c * hs + ch * kE));
          else
            r[u][ci] = base[(size_t)c * hs + ch];
        } else {
          r[u][ci] = Raw{};
        }
      }
      if (kVariant == kQ8) sc[u] = __ldg(scale + (size_t)row * sp + min(c, S - 1) / a.pack);
    }
  };

  // the keys: every step of a batch is computed (the trees overlap), and
  // stored where it lies in the run
  Raw kv[kNB][kMaxC];
  float sc[kNB];
  for (int j0 = j_begin; j0 < j_end; j0 += kNB) {
    load(kv, sc, kr, a.k_scale, j0);
#pragma unroll
    for (int u = 0; u < kNB; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int ci = 0; ci < kMaxC; ++ci) {
        float f[kE];
        to_floats<KV>(kv[u][ci], f);
#pragma unroll
        for (int e = 0; e < kE; ++e) dot = fmaf(qf[ci][e], f[e], dot);
      }
      dot = group_sum<true>(dot, L);
      const int j = j0 + u, c = j * P + grp;
      float v = dot * a.scale;
      if (kVariant == kQ8) v = v * (sc[u] * inv127);
      if (lig == 0 && j < j_end && c < n_vis) s[c] = v;
    }
  }
  load(kv, sc, vr, a.v_scale, j_begin);  // the values, in flight while the softmax runs
  __syncwarp();

  // the max over every visible position, exp and the row sum
  const int c_begin = j_begin * P, c_end = min(n_vis, j_end * P);
  float mx = -INFINITY;
  for (int c = c_begin + lane; c < c_end; c += 32) mx = fmaxf(mx, s[c]);
  mx = warp_max(mx);
  if (W > 1) {
    if (lane == 0) red[part] = mx;
    __syncthreads();
    mx = red[0];
    for (int w = 1; w < W; ++w) mx = fmaxf(mx, red[w]);
  }
  float l = 0.f;
  for (int c = c_begin + lane; c < c_end; c += 32) {
    const float p = expf(s[c] - mx);
    l += p;
    s[c] = p;
  }
  l = warp_sum(l);
  if (kVariant == kPlain && W > 1) {
    if (lane == 0) red[W + part] = l;
    __syncthreads();
    l = 0.f;
    for (int w = 0; w < W; ++w) l += red[W + w];
  }
  __syncwarp();

  // P.V with the weights at their variant's rounding point (plain: p / l;
  // packed: p; q8: p v_scale / 127, rounded to T): each lane sums its chunks
  // over its positions in order, then over the lane groups by shuffles
  float acc[kMaxC][kE];
#pragma unroll
  for (int ci = 0; ci < kMaxC; ++ci)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[ci][e] = 0.f;
  for (int j0 = j_begin; j0 < j_end; j0 += kNB) {
    if (j0 != j_begin) load(kv, sc, vr, a.v_scale, j0);
#pragma unroll
    for (int u = 0; u < kNB; ++u) {
      const int j = j0 + u, c = j * P + grp;
      const float p = s[min(c, S - 1)];
      float w = kVariant == kPlain    ? round_to<T>(p / l)
                : kVariant == kPacked ? round_to<T>(p)
                                      : round_to<T>(p * (sc[u] * inv127));
      w = j < j_end && c < n_vis ? w : 0.f;
#pragma unroll
      for (int ci = 0; ci < kMaxC; ++ci) {
        float f[kE];
        to_floats<KV>(kv[u][ci], f);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[ci][e] = fmaf(w, f[e], acc[ci][e]);
      }
    }
  }
#pragma unroll
  for (int ci = 0; ci < kMaxC; ++ci)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[ci][e] = group_sum<false>(acc[ci][e], L);

  T* orow = static_cast<T*>(a.out) + (size_t)row * hs;
  if (W == 1) {
    if (grp == 0)
#pragma unroll
      for (int ci = 0; ci < kMaxC; ++ci) {
        const int ch = lig + ci * L;
        if (ch < nch)
#pragma unroll
          for (int e = 0; e < kE; ++e)
            store(orow + ch * kE + e, kVariant == kPlain ? acc[ci][e] : acc[ci][e] / l);
      }
    return;
  }
  // W warps: their partial sums added in warp order
  if (grp == 0)
#pragma unroll
    for (int ci = 0; ci < kMaxC; ++ci) {
      const int ch = lig + ci * L;
      if (ch < nch)
#pragma unroll
        for (int e = 0; e < kE; ++e) partial[part * hs + ch * kE + e] = acc[ci][e];
    }
  if (lane == 0 && kVariant != kPlain) red[W + part] = l;
  __syncthreads();
  float lt = l;
  if (kVariant != kPlain) {
    lt = 0.f;
    for (int w = 0; w < W; ++w) lt += red[W + w];
  }
  for (int f = part * 32 + lane; f < hs; f += 32 * W) {
    float o = 0.f;
    for (int w = 0; w < W; ++w) o += partial[w * hs + f];
    store(orow + f, kVariant == kPlain ? o : o / lt);
  }
}

template <typename T, typename KV, int kVariant>
int launch_warp(const void* q, const void* k, const void* v, const void* k_scale,
                const void* v_scale, const void* pos, void* out, int n, int S, int hs,
                int pack, float scale, cudaStream_t stream) {
  if (n <= 0 || hs <= 0 || hs > kThreads || S <= 0 || pack <= 0 || S % pack != 0)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads where every position of k and v starts on a 16-byte boundary
  constexpr int kE = 16 / (int)sizeof(KV);
  const bool vec = (hs * (int)sizeof(KV)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const int nch = vec ? hs / kE : hs;
  WarpArgs a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
             static_cast<const int*>(pos), out, n, S, hs, pack, scale, 1, 1, 1};
  while (a.L < nch && a.L < 32) a.L <<= 1;
  const int nb = vec ? Geo<KV, true>::kNB : Geo<KV, false>::kNB;
  const long long steps = (S + 32 / a.L - 1) / (32 / a.L);  // at pos = S - 1
  auto kernel = vec ? decode_warp_kernel<T, KV, kVariant, true>
                    : decode_warp_kernel<T, KV, kVariant, false>;
  auto smem_of = [&](int W) {
    const size_t R = W == 1 ? kRowWarps : 1;
    return sizeof(float) * (R * S + R * 2 * W + (W > 1 ? R * W * hs : 0));
  };
  auto allow = [&](size_t smem) {
    return smem > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)smem)
                            : cudaSuccess;
  };
  if (S > kWarpRowMax) {  // a batch of loads a warp, at most kMaxRowWarps warps
    const long long w = (steps + nb - 1) / nb;
    a.W = (int)(w < kMaxRowWarps ? w : kMaxRowWarps);
    // Fewer warps a row (down to 2) while the rows' blocks do not all fit on
    // the card at once: a second wave of blocks costs more than each warp's
    // longer run of positions. A block's shared memory only shrinks with W.
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = allow(smem_of(a.W));
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    while (err == cudaSuccess && a.W > 2) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * a.W, smem_of(a.W));
      if (err != cudaSuccess || (long long)per_sm * sms >= n) break;
      a.W = (a.W + 1) / 2;
    }
    if (err != cudaSuccess) return (int)err;
  }
  a.R = a.W == 1 ? kRowWarps : 1;
  const size_t smem = smem_of(a.W);
  if (a.W == 1) {
    const cudaError_t err = allow(smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n + a.R - 1) / a.R;
  kernel<<<(unsigned)blocks, 32 * a.W * a.R, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ transposed (K9): a block per row

// The first body of this file, as it was: the template of every form, now
// instantiated for the transposed one only (K9 keeps it until its own
// redesign; a copy pruned to that form compiled to a loader that took twice
// the time on an NVIDIA H100).

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
    return launch_warp<__nv_bfloat16, __nv_bfloat16, kPlain>(q, k, v, nullptr, nullptr, pos,
                                                             out, n, S, hs, 1, scale, s);
  return launch_warp<float, float, kPlain>(q, k, v, nullptr, nullptr, pos, out, n, S, hs, 1,
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
    return launch_warp<__nv_bfloat16, __nv_bfloat16, kPacked>(q, k, v, nullptr, nullptr, pos,
                                                              out, n, S, hs, pack, scale, s);
  return launch_warp<float, float, kPacked>(q, k, v, nullptr, nullptr, pos, out, n, S, hs,
                                            pack, scale, s);
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
    return launch_warp<__nv_bfloat16, int8_t, kQ8>(q, k, v, k_scale, v_scale, pos, out, n, S,
                                                   hs, pack, scale, s);
  return launch_warp<float, int8_t, kQ8>(q, k, v, k_scale, v_scale, pos, out, n, S, hs, pack,
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
