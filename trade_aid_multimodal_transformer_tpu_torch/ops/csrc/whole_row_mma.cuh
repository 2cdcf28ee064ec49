// Register-fragment pieces shared by the bf16 whole-row attention kernels
// on mma.sync (flash_mma.cuh): the forwards (short_attention_fwd.cuh, K2f,
// K3f, K4f; fused_qkv_attention.cu, K1f) and the backward (attention_bwd.cuh,
// K2b, K1b's attention, K3b, K4b). A warp holds 16 query rows of S = q k^T in C fragments; the row
// max and sum are exact by quad shuffles (the four lanes of a fragment row);
// scores are scaled by scale * log2(e) and masked in place so that both
// directions form p = exp2(s - m) alike; the dropout bit is the JAX kernels'
// interpret-mode hash per fragment element; operand tiles come by 16-byte
// cp.async into rows D + 8 apart (D = 64 or 128, zeros beyond hs); results
// leave a warp staged through its own 16 rows for 16-byte stores.
#pragma once

#include "flash_mma.cuh"
#include "flash_tile.cuh"

namespace tat {
namespace wr {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreadsW = 128;  // 4 warps
constexpr int kRows = 64;       // query rows of a block (and keys of a row's tile at T <= 64)

// keep_bit() along one query row r: everything but the column's term of
// the hash is fixed per row, so it is computed once (the u32 sum wraps as
// keep_bit()'s), and only where dropout is on.
struct KeepRowW {
  uint32_t base = 0, thresh;
  __device__ __forceinline__ KeepRowW(bool on, uint32_t seed, uint32_t n_idx, uint32_t r,
                                      uint32_t thresh_)
      : thresh(thresh_) {
    if (on) base = r * 2246822519u + ((seed * 2654435761u) ^ (n_idx * 40503u));
  }
  __device__ __forceinline__ bool operator()(uint32_t c) const {
    uint32_t h = base + c * 3266489917u;
    h ^= h >> 13;
    h *= 2654435761u;
    h ^= h >> 16;
    return h >= thresh;
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Rows [0, rows) of a (rows, hs) bf16 array from src (the tile's first row)
// into dst (rows D + 8 apart), zeros beyond hs and from row `valid` on, by
// a block of kT threads; rows <= kR (the tile's height, the default).
// vec: 16-byte cp.async (the caller commits and waits), else element
// copies.
template <int D, int kR, int kT = kThreadsW>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int hs, int valid,
                                          bool vec, int rows = kR) {
  constexpr int kLd = D + 8;
  if (vec) {
    constexpr int kChunks = D / 8;
    static_assert(kR * kChunks % kT == 0, "a whole number of chunks a thread");
#pragma unroll
    for (int u = 0; u < kR * kChunks / kT; ++u) {
      const int idx = (int)threadIdx.x + u * kT;
      const int r = idx / kChunks, c = idx % kChunks;
      if (r >= rows) break;
      const bool in = r < valid && c * 8 < hs;
      mma::cp_async16(dst + r * kLd + c * 8, in ? src + (size_t)r * hs + c * 8 : src, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += kT) {
      const int r = idx / D, c = idx % D;
      dst[r * kLd + c] = (r < valid && c < hs) ? src[(size_t)r * hs + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// A warp's 16 result rows (v[dt][h]: fragment row g + 8h, columns c0 + 8dt
// + 2t and + 1, packed bf16) to rows [0, valid) of dst (the warp's first
// row of a (rows, hs) array), columns below hs, staged through the warp's
// own 16 rows of stage (kLd apart) so that device memory sees 16-byte
// stores (vec), else element stores.
template <int kLd, int kN8>
__device__ __forceinline__ void store_warp_rows(bf16* dst, bf16* stage,
                                                const uint32_t (&v)[kN8][2], int hs, int valid,
                                                bool vec, int lane, int c0) {
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < kN8; ++dt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stage + mma::frag_row(lane, 2 * h) * kLd + c0 + 8 * dt +
                                   mma::frag_col(lane, 0)) = v[dt][h];
  __syncwarp();
  const int w = min(c0 + 8 * kN8, hs) - c0, rows = min(16, valid);
  if (vec) {
    const int chunks = w / 8;
    for (int idx = lane; idx < rows * chunks; idx += 32) {
      const int r = idx / chunks, c = c0 + 8 * (idx - r * chunks);
      *reinterpret_cast<uint4*>(dst + (size_t)r * hs + c) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + c);
    }
  } else {
    for (int idx = lane; idx < rows * w; idx += 32) {
      const int r = idx / w, c = c0 + idx - r * w;
      dst[(size_t)r * hs + c] = stage[r * kLd + c];
    }
  }
  __syncwarp();
}

// s <- s * sl2 where key k0 + c <= query row (rows[h] for fragment half h),
// else -inf; returns nothing, folds each row's max into m[h] (this thread's
// part; the caller reduces over the quad).
template <int kSn>
__device__ __forceinline__ void mask_scale(float (&s)[kSn][4], int ns, int k0,
                                           const int (&rows)[2], float sl2, float (&m)[2],
                                           int lane) {
#pragma unroll
  for (int nt = 0; nt < kSn; ++nt) {
    if (nt < 2 * ns) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, c = k0 + 8 * nt + mma::frag_col(lane, i);
        const float x = c <= rows[h] ? s[nt][i] * sl2 : -INFINITY;
        s[nt][i] = x;
        m[h] = fmaxf(m[h], x);
      }
    }
  }
}

// acc (16 rows x D) += A (16 x 16 ns keys, A fragments da: dS in the
// backward's dq, p in the forward's P.V) . B (rows of a row-major key tile,
// its first row in sk: K, or V), B's fragments through ldmatrix.trans.
template <int D, int kSn>
__device__ __forceinline__ void tile_product(float (&dq)[D / 8][4],
                                             const uint32_t (&da)[kSn / 2][4], const bf16* sk,
                                             int ns, int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kk = 0; kk < kSn / 2; ++kk) {
    if (kk < ns) {
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        mma::ldsm_x4_trans(b, mma::a_frag_addr(sk, kLd, 16 * kk, 8 * dt, lane));
        mma::mma_bf16(dq[dt], da[kk], b[0], b[1]);
        mma::mma_bf16(dq[dt + 1], da[kk], b[2], b[3]);
      }
    }
  }
}

// Whether q's A fragments stay in registers (D = 64) or are read from the
// warp's rows of q in shared memory per key tile (D = 128).
template <int D>
constexpr bool kHoldQ = D <= 64;

// S = q k^T of a warp's 16 query rows (q's A fragments qa, column block kd
// of 16, or with kHoldQ false from sq, the warp's first row of q) against
// key slabs 0 .. ns - 1 of the tile in sk, in C fragments (n8 tile nt: keys
// 8nt .. 8nt + 7 of the tile); slabs from ns on are zero.
template <int D, int kSn>
__device__ __forceinline__ void qk_scores(float (&s)[kSn][4],
                                          const uint32_t (&qa)[kHoldQ<D> ? D / 16 : 1][4],
                                          const bf16* sq, const bf16* sk, int ns, int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int nt = 0; nt < kSn; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t a[4];
    if constexpr (kHoldQ<D>) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qa[kd][i];
    } else {
      mma::ldsm_x4(a, mma::a_frag_addr(sq, kLd, 0, 16 * kd, lane));
    }
#pragma unroll
    for (int kk = 0; kk < kSn / 2; ++kk) {
      if (kk < ns) {
        uint32_t b[4];
        mma::ldsm_x4(b, mma::bt_frag_addr(sk, kLd, 16 * kk, 16 * kd, lane));
        mma::mma_bf16(s[2 * kk], a, b[0], b[1]);
        mma::mma_bf16(s[2 * kk + 1], a, b[2], b[3]);
      }
    }
  }
}

// The forwards' probability pass over one key tile for a warp's 16 query
// rows: p = exp2(s - m) (s scaled and masked by mask_scale, m[h] the whole
// row's max of fragment half h), l += p before dropout, the dropout bit per
// element (kr, keyed by the tile's first key k0), p rounded and packed to
// bf16 as P.V's A fragments without leaving registers, and o += P V (V's
// rows from sv, B fragments through ldmatrix.trans). Key slabs from ns on
// are skipped.
template <int D, int kSn>
__device__ __forceinline__ void softmax_pv(float (&o)[D / 8][4], float (&l)[2],
                                           const float (&s)[kSn][4], const float (&m)[2],
                                           const KeepRowW (&kr)[2], bool on, int k0,
                                           const bf16* sv, int ns, int lane) {
  uint32_t pa[kSn / 2][4];
#pragma unroll
  for (int nt = 0; nt < kSn; ++nt) {
    if (nt < 2 * ns) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = mma::exp2_approx(s[nt][i] - m[i >> 1]);
        l[i >> 1] += p[i];
        if (on && !kr[i >> 1]((uint32_t)(k0 + 8 * nt + mma::frag_col(lane, i)))) p[i] = 0.f;
      }
      pa[nt >> 1][2 * (nt & 1)] = mma::pack_bf16(p[0], p[1]);
      pa[nt >> 1][2 * (nt & 1) + 1] = mma::pack_bf16(p[2], p[3]);
    }
  }
  tile_product<D, kSn>(o, pa, sv, ns, lane);
}

}  // namespace wr
}  // namespace tat
