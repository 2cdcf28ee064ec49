// Whole-row causal self-attention over separate q, k and v for 8 <= T <= 512:
// out[r] = softmax_causal(q[r] k[r]^T * hs^-0.5) . v[r], forward only.
//
// Replaces: trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py,
// _short_fwd_kernel (entry short_causal_attention). Rounding points as there:
// scores, max, exp and row sum in f32, the unnormalised p rounded to v's type
// before P.V, the result o / (l * (1 - rate)) rounded once. Dropout keeps
// p's element (r, c) of collapsed row i by the hash of (seed, i, r, c), the
// JAX kernel's interpret-mode stream (_short_keep_mask: the seed without a
// stream offset, the row its collapsed index). The port reaches it in the
// KV-cache prefill (models/cache.py), whose q, k and v are projected apart so
// that k and v can go into the cache; serving runs it without dropout.
//
// What bounds it on the H100: at the production prefill (n = 24 * B rows,
// T = 56, hs = 64, bf16) it moves 4 * n * T * hs * 2 bytes (q, k, v once, the
// output once: 22 MB at B = 32) for 2 * n * T^2 * hs FLOP (causal half:
// 0.31 GFLOP), ~14 FLOP per byte, far under the ~295 ridge: memory bounds it.
// It is short_attention_fwd.cuh's forward with one stream: one block per (row,
// query tile), k and v held on chip when T fits one tile (production), WMMA
// for bf16 with hs % 16 == 0. As with the cross kernel, n blocks of one
// tile's latency each (24 at B = 1), not bandwidth, set the time.
#include "short_attention_fwd.cuh"

// q, k, v, out (n, T, hs); one type for all, bf16 or f32, contiguous. Dropout
// (rate_on) keeps element (r, c) of row i by the hash of (seed, i, r, c)
// against thresh and divides by l * keepf. Returns the cudaError_t of the launch.
extern "C" int tat_short_causal_attention_fwd(const void* q, const void* k, const void* v,
                                              void* out, int n, int T, int hs, int is_bf16,
                                              float scale, unsigned seed, unsigned thresh,
                                              int rate_on, float keepf, void* stream) {
  const tat::FwdDrop dr{seed, thresh, rate_on, keepf};
  return tat::launch_short_forward(q, k, v, out, /*J=*/1, n, T, hs, is_bf16, scale, dr,
                                   /*stream_seeds=*/0, static_cast<cudaStream_t>(stream));
}
