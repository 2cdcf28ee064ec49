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
// the bodies of decode_attention (:2602), decode_attention_t (:2698),
// decode_attention_packed (:2811) and decode_attention_packed_q8 (:2925).
// Each keeps its JAX kernel's rounding points:
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
// no barrier between the keys and the values. The transposed form's rows
// are long (S 1024 at hs 64: 256 KB a row in bf16): at 384 rows bandwidth
// sets its time, at 24 rows one wave of loads over the whole card.
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
// The transposed form (K9) runs decode_t_kernel: a row is split into runs
// of consecutive positions ("chunks"), one a block, and the C blocks of a
// row form a thread block cluster (C <= 8). The lanes of a warp take
// consecutive 16-byte loads along S (8 bf16 or 4 f32 positions a lane; one
// element where a feature's run is not 16-byte aligned), coalesced, and
// each of the block's 8 warps takes 8 features of a round of 64 (hs > 64:
// several rounds), so a batch of loads is 8 a thread, issued at clamped
// addresses, the next batch before the current one is summed. A lane keeps
// its positions' partial scores in registers; the warps' partials of a pass
// are summed in warp order through shared memory. The first batch of
// values is in flight while the max and the row sum are exchanged: each
// warp's max, then its sum of p, go by shuffles to every block of the
// cluster (distributed shared memory), which each reduce them in (block,
// warp) order, so every block holds the row's own max and l before it
// rounds w = p / l (the JAX rounding point; no block rescales a partial
// result). P.V: each lane sums its positions per feature, a reduce-scatter
// over the warp's lanes (reduce_scatter) gives each lane one feature's sum,
// and the blocks' sums go to rank 0, which adds them in rank order and
// writes o once. No float atomics: two runs give the same bits. Blocks whose
// run lies past pos exchange a max of -inf and an l of 0. The host picks C
// and the chunk from n, S, hs and the clusters the card holds at once
// (plan_t). The JAX package keeps this layout for the TPU's lane tiling; no
// caller of the port uses it, it stands beside the other forms for users of
// the op.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace tat_decode {

constexpr int kMaxHs = 256;  // the largest head size of every form
enum Variant { kPlain = 0, kPacked = 1, kQ8 = 2 };

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
  if (n <= 0 || hs <= 0 || hs > kMaxHs || S <= 0 || pack <= 0 || S % pack != 0)
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

// ------------------------------------------------ transposed (K9): a row over a cluster

constexpr int kTWarps = 8;                   // warps of a K9 block
constexpr int kTThreads = 32 * kTWarps;
constexpr int kTFeat = 8;                    // features a warp takes in a round
constexpr int kTRound = kTWarps * kTFeat;    // features a round (hs > 64: several rounds)
constexpr int kTMaxCluster = 8;              // blocks a row: the portable cluster size

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// Every thread of every block of the cluster arrives; the stores before it
// (to this block's or another block's shared memory) are seen after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// The kN partial sums a of this lane (feature i of its warp slice in a[i]),
// summed over the warp's 32 lanes: each halving step keeps half the
// features and sends the other half to the lane at xor o, then a tree sums
// the rest (kN = 8: 4 + 2 + 1 + 2 shuffles where 8 trees would take 40).
// The lane returns feature (lane >> 2) & 7 for kN = 8, in general the
// feature whose index is the lane's bits 16, 8, ... read high to low. The
// order of every sum is fixed: two runs give the same bits.
template <int kN>
__device__ __forceinline__ float reduce_scatter(float (&a)[kN], int lane) {
  static_assert(kN >= 1 && kN <= 32 && (kN & (kN - 1)) == 0, "kN a power of two up to 32");
  int o = 16;
#pragma unroll
  for (int h = kN / 2; h >= 1; h /= 2, o /= 2) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? a[i] : a[i + h];
      const float keep = up ? a[i + h] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float v = a[0];
#pragma unroll
  for (; o >= 1; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct TArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pos_p;
  void* out;
  int S, hs;
  int C;      // blocks a row: the cluster
  int chunk;  // positions a block: block r of a row takes [r chunk, (r + 1) chunk)
  float scale;
};

// The lanes of a warp take consecutive loads along S (kE positions each, 16
// bytes where kVec, else one element): a pass of the block covers kP = 32 kE
// positions; each warp takes kTFeat features of a round, so a load batch is
// kTFeat loads a thread, one per feature, all at clamped addresses. Shared
// memory: q (hp floats, zero past hs), the warps' partial scores of a pass
// (two buffers of kTWarps x kP), the chunk's scores, then p (sl), the
// warps' maxima and row sums of every block of the cluster (written there
// by each block), and the blocks' P.V partial sums (C x hp, read on rank 0).
// Registers are capped for two blocks an SM (a cap for three spills, and
// ran slower on an NVIDIA H100: chip_variants.py decode_t, blocks3).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kTThreads, 2) decode_t_kernel(const TArgs ta) {
  using Raw = typename std::conditional<kVec, uint4, T>::type;
  constexpr int kE = kVec ? 16 / (int)sizeof(T) : 1;
  constexpr int kP = 32 * kE;
  extern __shared__ __align__(16) float smt[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // its wait comes before the first store to another block

  const int S = ta.S, hs = ta.hs, C = ta.C;
  const int rounds = (hs + kTRound - 1) / kTRound, hp = rounds * kTRound;
  const int sl = (ta.chunk + kP - 1) / kP * kP;
  float* qs = smt;
  float* sp = qs + hp;
  float* s = sp + 2 * kTWarps * kP;
  float* cm = s + sl;
  float* cl = cm + C * kTWarps;
  float* po = cl + C * kTWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = blockIdx.x % C;
  const size_t row = blockIdx.x / C;
  const T* qr = static_cast<const T*>(ta.q) + row * hs;
  const T* kr = static_cast<const T*>(ta.k) + row * hs * S;
  const T* vr = static_cast<const T*>(ta.v) + row * hs * S;

  for (int e = threadIdx.x; e < hp; e += kTThreads) qs[e] = e < hs ? to_f(qr[min(e, hs - 1)]) : 0.f;
  for (int i = threadIdx.x; i < C * hp; i += kTThreads) po[i] = 0.f;  // blocks with no position
  const int vis = max(0, min(__ldg(ta.pos_p) + 1, S));  // columns 0..pos; the rest unread
  const int c0 = rank * ta.chunk, c1 = min(c0 + ta.chunk, vis);  // this block's visible run
  const int len = max(0, c1 - c0);
  const int passes = (len + kP - 1) / kP, nb = passes * rounds;
  const int last = c0 + max(0, len - 1) / kE * kE;  // the run's last load

  // the batch of (pass, round): this lane's load of each of its warp's
  // features; a load past the run or a feature past hs reads the run's last
  // load or feature hs - 1 (no load waits behind a condition)
  auto load = [&](Raw (&r)[kTFeat], const T* base, int pass, int rd) {
    const int c = min(c0 + pass * kP + lane * kE, last);
#pragma unroll
    for (int i = 0; i < kTFeat; ++i) {
      const size_t at = (size_t)min(rd * kTRound + warp * kTFeat + i, hs - 1) * S + c;
      if constexpr (kVec)
        r[i] = __ldg(reinterpret_cast<const uint4*>(base + at));
      else
        r[i] = base[at];
    }
  };

  // scores: batch b is pass b / rounds, round b % rounds; the next batch's
  // loads are issued before this one is summed. A pass's partial scores go
  // through shared memory, summed over the warps in warp order.
  Raw kb[kTFeat], kn[kTFeat], vb[kTFeat], vn[kTFeat];
  float sc[kE];
  if (nb > 0) load(kb, kr, 0, 0);
  __syncthreads();  // qs
  for (int b = 0; b < nb; ++b) {
    const int pass = b / rounds, rd = b - pass * rounds;
    if (b + 1 < nb) load(kn, kr, (b + 1) / rounds, (b + 1) % rounds);
    if (rd == 0)
#pragma unroll
      for (int j = 0; j < kE; ++j) sc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kTFeat; ++i) {
      const float qv = qs[rd * kTRound + warp * kTFeat + i];
      float f[kE];
      to_floats<T>(kb[i], f);
#pragma unroll
      for (int j = 0; j < kE; ++j) sc[j] = fmaf(qv, f[j], sc[j]);
    }
    if (rd == rounds - 1) {
      float* spp = sp + (pass & 1) * kTWarps * kP;
#pragma unroll
      for (int j = 0; j < kE; ++j) spp[warp * kP + lane * kE + j] = sc[j];
      __syncthreads();
      if (threadIdx.x < kP) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kTWarps; ++w) t += spp[w * kP + threadIdx.x];
        const int at = pass * kP + threadIdx.x;
        s[at] = c0 + at < c1 ? t * ta.scale : -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < kTFeat; ++i) kb[i] = kn[i];
  }

  if (nb > 0) load(vb, vr, 0, 0);  // the first values, in flight during the exchanges

  // the row max: this block's warps' maxima go to every block of the
  // cluster, which each take the max over all of them in (block, warp) order
  float m = -INFINITY;
  if (threadIdx.x < kP)
    for (int pass = 0; pass < passes; ++pass) m = fmaxf(m, s[pass * kP + threadIdx.x]);
  m = warp_max(m);
  cluster_wait();  // every block of the cluster has started
  if (lane < C) *cluster.map_shared_rank(cm + rank * kTWarps + warp, lane) = m;
  cluster_sync();
  float mx = -INFINITY;
  for (int i = 0; i < C * kTWarps; ++i) mx = fmaxf(mx, cm[i]);

  // p = exp(s - max) and the row sum l, exchanged as the max
  float l = 0.f;
  if (threadIdx.x < kP)
    for (int pass = 0; pass < passes; ++pass) {
      const int at = pass * kP + threadIdx.x;
      const float p = expf(s[at] - mx);
      s[at] = p;
      l += p;
    }
  l = warp_sum(l);
  if (lane < C) *cluster.map_shared_rank(cl + rank * kTWarps + warp, lane) = l;
  cluster_sync();
  float lt = 0.f;
  for (int i = 0; i < C * kTWarps; ++i) lt += cl[i];

  // P.V with w = p / l rounded to T (the row's own max and l: the JAX
  // kernel's rounding point). Batch b is round b / passes, pass b % passes;
  // each round's partial sums per feature go over the warp's lanes
  // (reduce_scatter) to rank 0's shared memory, which adds the blocks'
  // sums in rank order and writes o once.
  float acc[kTFeat];
  for (int b = 0; b < nb; ++b) {
    const int rd = b / passes, pass = b - rd * passes;
    if (b + 1 < nb) load(vn, vr, (b + 1) % passes, (b + 1) / passes);
    if (pass == 0)
#pragma unroll
      for (int i = 0; i < kTFeat; ++i) acc[i] = 0.f;
    const int at = pass * kP + lane * kE, nv = c1 - c0 - at;  // positions of the load in the run
    float w[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) w[j] = j < nv ? round_to<T>(s[at + j] / lt) : 0.f;
#pragma unroll
    for (int i = 0; i < kTFeat; ++i) {
      float f[kE];
      to_floats<T>(vb[i], f);
#pragma unroll
      for (int j = 0; j < kE; ++j) acc[i] = fmaf(w[j], j < nv ? f[j] : 0.f, acc[i]);
    }
    if (pass == passes - 1) {
      const float o = reduce_scatter<kTFeat>(acc, lane);
      const int e = rd * kTRound + warp * kTFeat + (lane >> 2);
      if ((lane & 3) == 0 && e < hs) *cluster.map_shared_rank(po + rank * hp + e, 0) = o;
    }
#pragma unroll
    for (int i = 0; i < kTFeat; ++i) vb[i] = vn[i];
  }
  cluster_sync();
  if (rank == 0) {
    T* orow = static_cast<T*>(ta.out) + row * hs;
    for (int e = threadIdx.x; e < hs; e += kTThreads) {
      float o = 0.f;
      for (int r = 0; r < C; ++r) o += po[r * hp + e];
      store(orow + e, o);
    }
  }
}

template <typename T, bool kVec>
size_t smem_t(int chunk, int C, int hs) {
  constexpr int kE = kVec ? 16 / (int)sizeof(T) : 1, kP = 32 * kE;
  const size_t hp = (hs + kTRound - 1) / kTRound * kTRound, sl = (chunk + kP - 1) / kP * kP;
  return sizeof(float) * (hp + 2 * kTWarps * kP + sl + 2 * C * kTWarps + C * hp);
}

// K9's blocks a row (C, the cluster) and positions a block (chunk) at these
// shapes: each C of 1, 2, 4, 8 (chunk = S / C, rounded up to whole loads)
// costs the waves of clusters that the card holds at once times the passes
// a block takes, the chain of a block's dependent steps; the least cost
// wins, the smaller C on a tie. The shapes and the card alone decide, so
// two runs give the same bits.
struct TPlan {
  int C, chunk;
  size_t smem;
};

template <typename T, bool kVec>
cudaError_t plan_t(int n, int S, int hs, TPlan* plan) {
  constexpr int kE = kVec ? 16 / (int)sizeof(T) : 1, kP = 32 * kE;
  auto kernel = decode_t_kernel<T, kVec>;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int least = (S + kTMaxCluster - 1) / kTMaxCluster;  // the chunk of the largest cluster
  long long best = -1;
  int prev = 0;
  for (int C = 1; C <= kTMaxCluster; C *= 2) {
    int chunk = (S + C - 1) / C;
    chunk = (max(chunk, least) + kE - 1) / kE * kE;
    const int c = (S + chunk - 1) / chunk;  // every block holds a position
    if (c == prev) continue;
    prev = c;
    const size_t smem = smem_t<T, kVec>(chunk, c, hs);
    if (smem > (size_t)max_smem) continue;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kTThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters <= 0) continue;
    const long long cost = (long long)((n + clusters - 1) / clusters) * ((chunk + kP - 1) / kP);
    if (best < 0 || cost < best) {
      best = cost;
      *plan = TPlan{c, chunk, smem};
    }
  }
  return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// 16-byte loads where every feature's run of positions starts on a 16-byte
// boundary (S a multiple of the positions a load, k and v aligned)
template <typename T>
bool vec_t(const void* k, const void* v, int S) {
  return S % (16 / (int)sizeof(T)) == 0 &&
         (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
}

template <typename T>
int plan_of(int n, int S, int hs, bool vec, TPlan* plan) {
  if (n <= 0 || hs <= 0 || hs > kMaxHs || S <= 0) return (int)cudaErrorInvalidValue;
  return (int)(vec ? plan_t<T, true>(n, S, hs, plan) : plan_t<T, false>(n, S, hs, plan));
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const void* pos, void* out, int n,
             int S, int hs, float scale, cudaStream_t stream) {
  const bool vec = vec_t<T>(k, v, S);
  TPlan plan;
  const int err = plan_of<T>(n, S, hs, vec, &plan);
  if (err != 0) return err;
  auto kernel = vec ? decode_t_kernel<T, true> : decode_t_kernel<T, false>;
  if (plan.smem > 48 * 1024) {  // planning may have left a smaller limit set
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)n * plan.C));
  cfg.blockDim = dim3(kTThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const TArgs a{q, k, v, static_cast<const int*>(pos), out, S, hs, plan.C, plan.chunk, scale};
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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
  if (is_bf16) return launch_t<__nv_bfloat16>(q, k, v, pos, out, n, S, hs, scale, s);
  return launch_t<float>(q, k, v, pos, out, n, S, hs, scale, s);
}

// What tat_decode_attention_t launches for these operands: plan[0] the
// blocks a row (the cluster), plan[1] the positions a block, plan[2] 1 where
// the loads are 16 bytes wide. Returns the cudaError_t of the planning.
extern "C" int tat_decode_attention_t_plan(const void* k, const void* v, int n, int S, int hs,
                                           int is_bf16, int* plan) {
  using namespace tat_decode;
  const bool vec = is_bf16 ? vec_t<__nv_bfloat16>(k, v, S) : vec_t<float>(k, v, S);
  TPlan p{};
  const int err = is_bf16 ? plan_of<__nv_bfloat16>(n, S, hs, vec, &p)
                          : plan_of<float>(n, S, hs, vec, &p);
  plan[0] = p.C;
  plan[1] = p.chunk;
  plan[2] = vec;
  return err;
}
