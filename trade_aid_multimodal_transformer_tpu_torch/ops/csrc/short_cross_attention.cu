// Cross attention of one query stream against J key/value streams:
// out[r] = sum_j softmax_causal(q[r] k_j[r]^T * hs^-0.5) . v_j[r], and its
// backward (dq summed over the streams, every dk_j and dv_j).
//
// Replaces: trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py,
// _short_cross_fwd_kernel (entries short_cross_attention and
// short_cross_attention_t) and _short_cross_bwd_kernel. Rounding points as
// there: scores, max, exp and row sum in f32, p rounded to v's type before
// P.V, each stream divided by its own row sum (times 1 - rate with dropout),
// the streams summed in f32, and the sum rounded once. Dropout keeps p's
// element (r, c) of stream j by the hash of (seed + (j + 1) * 1000003, row
// index, r, c), the JAX kernels' interpret-mode stream. The JAX kernel's
// transposed key/value layout was a TPU relayout workaround; these kernels
// take k and v as (J, n, T, hs).
//
// What bounds the forward on the H100: at the production shape (q 6x32x64x64
// bf16, J=3) it moves ~12.6 MB (q once, every k_j and v_j once, out once) for
// ~0.3 GFLOP (causal half), so memory bounds it (~25 FLOP/byte, far under
// the ~295 ridge). The forward's device code is short_attention_fwd.cuh,
// shared with the self-attention kernel (short_causal_attention.cu), and
// reads each input once: for bf16 with hs % 16 == 0 and hs <= 128 (every
// model path) one block of 4 warps per (row, 64-row query chunk) on
// mma.sync, S, p and the stream sum in registers, every stream's k_j and
// v_j in flight at once through a ring of three cp.async stages at T <= 64;
// f32 and the other head sizes keep the FMA and WMMA bodies. With only n
// blocks (192 at production, 6 at B=1) and the streams walked in turn, a
// block's latency, not bandwidth, sets the time. The backward is
// attention_bwd.cuh's (bf16: one block of 4 warps per row on mma.sync at
// T <= 64, the streams in turn with dq held in registers across them).
#include "attention_bwd.cuh"
#include "short_attention_fwd.cuh"

// q (n, T, hs); k, v (J, n, T, hs); out (n, T, hs); one type for all, bf16 or
// f32, contiguous. Dropout (rate_on) keeps element (r, c) of stream j of row i
// by the hash of (seed + (j + 1) * 1000003, g(i), r, c) against thresh and
// divides each stream by l * keepf; g(i) = i + (i / span) skip + base is the
// row's row in the global batch (tat::RowMap; span 1, skip 0, base 0 on one
// rank). Returns the cudaError_t of the launch.
extern "C" int tat_short_cross_attention_fwd(const void* q, const void* k,
                                             const void* v, void* out, int J,
                                             int n, int T, int hs, int is_bf16,
                                             float scale, unsigned seed,
                                             unsigned thresh, int rate_on,
                                             float keepf, int span, int skip, int base,
                                             void* stream) {
  const tat::FwdDrop dr{seed, thresh, rate_on, keepf};
  return tat::launch_short_forward(q, k, v, out, J, n,
                                   tat::SeparateRows{n, tat::RowMap{span, skip, base}}, T, hs,
                                   is_bf16, scale, dr, /*stream_seeds=*/1,
                                   static_cast<cudaStream_t>(stream));
}

// Backward of the above: dq (n, T, hs) summed over the streams, dk and dv
// (J, n, T, hs) per stream, in the inputs' type; dq_ws is the f32 workspace
// of bwd_ws_floats(n, T, hs, J) floats. inv is 1 / (1 - rate) as f32; the
// mask rows as the forward's. Returns the cudaError_t.
extern "C" int tat_short_cross_attention_bwd(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             void* dq, void* dk, void* dv,
                                             void* dq_ws, int J, int n, int T,
                                             int hs, int is_bf16, float scale,
                                             unsigned seed, unsigned thresh,
                                             int rate_on, float inv, int span, int skip,
                                             int base, void* stream) {
  tat::BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = nullptr; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.dq_ws = static_cast<float*>(dq_ws);
  a.J = J; a.n = n; a.Tn = T; a.hs = hs; a.scale = scale;
  a.rate_on = rate_on; a.seed = seed; a.thresh = thresh; a.inv = inv;
  a.layout = tat::kCrossRows; a.B = a.H = a.gb = 1;
  a.rm = tat::RowMap{span, skip, base};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return tat::launch_attn_bwd<__nv_bfloat16>(a, s);
  return tat::launch_attn_bwd<float>(a, s);
}
