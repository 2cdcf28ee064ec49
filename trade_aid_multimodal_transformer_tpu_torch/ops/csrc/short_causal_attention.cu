// Whole-row causal self-attention for 8 <= T <= 512:
// out[r] = softmax_causal(q[r] k[r]^T * hs^-0.5) . v[r], and its backward,
// over separate q, k and v or over one packed q|k|v operand.
//
// Replaces: trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py,
// _short_fwd_kernel (K3f) and _short_bwd_kernel (K3b), the custom VJP of the
// entry short_causal_attention, and _short_packed_fwd_kernel (K4f) and
// _short_packed_bwd_kernel (K4b), that of short_causal_attention_packed.
// Rounding points as there: scores, max, exp and row sum in f32, the
// unnormalised p rounded to v's type before P.V, the result o / (l * (1 -
// rate)) rounded once; the backward recomputes p, forms w = keep * p / (l *
// (1 - rate)) rounded to v's type, D = rowsum(do * o), ds = ((p / l) * (dp -
// D)) rounded to v's type, and accumulates in f32. Dropout keeps p's element
// (r, c) of collapsed row i by the hash of (seed, i, 0, 0, r, c), the JAX
// kernels' interpret-mode stream (_short_keep_mask: the seed without a
// stream offset, the row its collapsed index; in the packed form i = b H + h),
// which does not depend on the JAX kernels' group size g.
//
// The port reaches K3f in the KV-cache prefill (models/cache.py), whose q, k
// and v are projected apart so that k and v can go into the cache, and K3f +
// K3b wherever causal_attention is differentiated in the band on the card
// (ops/attention.py; flash_crossover.py times it). K4f + K4b serve
// causal_attention_packed. The packed kernels read the one (nb, 3H, T, hs)
// operand in place and K4b writes d(qkv) packed: the same bodies as K3f and
// K3b on another row addressing (the forward templated on it,
// short_attention_fwd.cuh PackedRows; the backward given it at run time,
// attention_bwd.cuh kPackedRows).
//
// What bounds them on the H100: at the production prefill (n = 24 * B rows,
// T = 56, hs = 64, bf16) the forward moves 4 * n * T * hs * 2 bytes (q, k, v
// once, the output once: 22 MB at B = 32) for 2 * n * T^2 * hs FLOP (causal
// half: 0.31 GFLOP), ~14 FLOP per byte, far under the ~295 ridge: memory
// bounds it. The backward moves 8 * n * T * hs * 2 bytes (q, k, v, o, do in;
// dq, dk, dv out) for 5 causal products, ~17 FLOP per byte: memory too. The
// forward is short_attention_fwd.cuh's with one stream: for bf16 with hs %
// 16 == 0 and hs <= 128 one block of 4 warps per (row, 64-row query chunk)
// on mma.sync with S and p in registers (two passes over the key tiles
// above T = 64), else the FMA or WMMA body; n blocks of one tile's latency
// each, not bandwidth, set its time. The backward is attention_bwd.cuh's: for bf16 one block of 4
// warps per row on mma.sync at T <= 64, a dq and a dk/dv kernel above;
// no atomics (two runs give the same bits).
#include "attention_bwd.cuh"
#include "short_attention_fwd.cuh"

namespace {

tat::BwdArgs self_bwd_args(const void* qkv_q, const void* k, const void* v, const void* o,
                           const void* dout, void* dq, void* dk, void* dv, void* dq_ws,
                           int n, int T, int hs, float scale, unsigned seed, unsigned thresh,
                           int rate_on, float inv, int layout, int H) {
  tat::BwdArgs a{};
  a.q = qkv_q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.dq_ws = static_cast<float*>(dq_ws);
  a.J = 1; a.n = n; a.Tn = T; a.hs = hs; a.scale = scale;
  a.rate_on = rate_on; a.seed = seed; a.thresh = thresh; a.inv = inv;
  a.layout = layout; a.B = a.gb = 1; a.H = H;
  return a;
}

}  // namespace

// q, k, v, out (n, T, hs); one type for all, bf16 or f32, contiguous. Dropout
// (rate_on) keeps element (r, c) of row i by the hash of (seed, i, r, c)
// against thresh and divides by l * keepf. Returns the cudaError_t of the launch.
extern "C" int tat_short_causal_attention_fwd(const void* q, const void* k, const void* v,
                                              void* out, int n, int T, int hs, int is_bf16,
                                              float scale, unsigned seed, unsigned thresh,
                                              int rate_on, float keepf, void* stream) {
  const tat::FwdDrop dr{seed, thresh, rate_on, keepf};
  return tat::launch_short_forward(q, k, v, out, /*J=*/1, n, tat::SeparateRows{n}, T, hs,
                                   is_bf16, scale, dr, /*stream_seeds=*/0,
                                   static_cast<cudaStream_t>(stream));
}

// Backward of the above (K3b): dq, dk, dv (n, T, hs) in the inputs' type from
// q, k, v, the forward's out and the output gradient dout; dq_ws is the f32
// workspace of bwd_ws_floats(n, T, hs) floats; inv is 1 / (1 - rate) as
// f32. Returns the cudaError_t.
extern "C" int tat_short_causal_attention_bwd(const void* q, const void* k, const void* v,
                                              const void* out, const void* dout, void* dq,
                                              void* dk, void* dv, void* dq_ws, int n, int T,
                                              int hs, int is_bf16, float scale, unsigned seed,
                                              unsigned thresh, int rate_on, float inv,
                                              void* stream) {
  const tat::BwdArgs a = self_bwd_args(q, k, v, out, dout, dq, dk, dv, dq_ws, n, T, hs, scale,
                                       seed, thresh, rate_on, inv, tat::kSelfRows, /*H=*/1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return tat::launch_attn_bwd<__nv_bfloat16>(a, s);
  return tat::launch_attn_bwd<float>(a, s);
}

// K4f: qkv (nb, 3H, T, hs) with the q, k and v head groups along the packed
// axis; out (nb, H, T, hs); one type, bf16 or f32, contiguous. Row i = b * H
// + h of the mask. Returns the cudaError_t of the launch.
extern "C" int tat_short_packed_attention_fwd(const void* qkv, void* out, int nb, int H, int T,
                                              int hs, int is_bf16, float scale, unsigned seed,
                                              unsigned thresh, int rate_on, float keepf,
                                              void* stream) {
  const tat::FwdDrop dr{seed, thresh, rate_on, keepf};
  return tat::launch_short_forward(qkv, qkv, qkv, out, /*J=*/1, nb * H, tat::PackedRows{H}, T,
                                   hs, is_bf16, scale, dr, /*stream_seeds=*/0,
                                   static_cast<cudaStream_t>(stream));
}

// K4b: d(qkv) (nb, 3H, T, hs) packed, from qkv, the forward's out and dout
// (nb, H, T, hs); dq_ws the f32 workspace of bwd_ws_floats(nb H, T, hs)
// floats. Returns the cudaError_t.
extern "C" int tat_short_packed_attention_bwd(const void* qkv, const void* out,
                                              const void* dout, void* dqkv, void* dq_ws, int nb,
                                              int H, int T, int hs, int is_bf16, float scale,
                                              unsigned seed, unsigned thresh, int rate_on,
                                              float inv, void* stream) {
  const tat::BwdArgs a = self_bwd_args(qkv, qkv, qkv, out, dout, dqkv, dqkv, dqkv, dq_ws,
                                       nb * H, T, hs, scale, seed, thresh, rate_on, inv,
                                       tat::kPackedRows, H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return tat::launch_attn_bwd<__nv_bfloat16>(a, s);
  return tat::launch_attn_bwd<float>(a, s);
}
