// Blockwise (flash) cross attention for long T: one query stream against J
// key/value streams, summed (K6f), and the same with each stream's output and
// logsumexp for the backward (K6f-r):
//
//   out[r] = sum_j softmax_causal(q[r] k_j[r]^T * hs^-0.5) . v_j[r]
//
// Replaces: trade_aid_multimodal_transformer_tpu/ops/pallas_attention.py,
// _flash_cross_forward (_flash_cross_kernel) and _flash_cross_forward_res
// (_flash_cross_kernel_res). The backward has no kernel of its own there or
// here: per stream j the flash backward (K5b, flash_attention.cu) runs on
// (q, k_j, v_j, out_j, lse_j, dout) with stream j's seed, and the wrapper
// sums dq over the streams in q's type (_flash_cross_bwd).
//
// The device code is flash_fwd.cuh's forward with J streams: each stream's
// output is rounded to q's type and added to the rounded running sum in
// stream order, as the JAX kernel accumulates its revisited output block;
// dropout of stream j is keyed by seed + (j + 1) * 1000003 on the JAX block
// grid. One block per (collapsed row, query tile) holds q once for all the
// streams; which outputs it writes is chosen at launch (null pointers for
// K6f). At the production training shape (n = 48 rows, J = 3, T = 1024,
// hs 64, bf16) it moves ~50 MB (q, every k_j and v_j, the sum once) for ~19
// GFLOP of causal products, so operations bound it at ~0.020 ms (bytes at
// ~0.015 ms); K6f-r writes J more outputs and logsumexps.
#include "flash_fwd.cuh"

namespace {

int cross_fwd(const void* q, const void* k, const void* v, void* out, void* outs, void* lses,
              int J, int n, int T, int hs, int is_bf16, float scale, unsigned seed,
              unsigned thresh, int rate_on, float keepf, int blk, void* stream) {
  tat::flash::FwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse = nullptr;
  a.outs = outs; a.lses = static_cast<float*>(lses);
  a.J = J; a.n = n; a.Tq = T; a.Tk = T; a.hs = hs; a.bq = blk; a.bk = blk; a.causal = 1;
  a.scale = scale; a.keepf = keepf; a.seed = seed; a.thresh = thresh; a.on = rate_on;
  a.stream_seeds = 1;
  return tat::flash::launch_flash_fwd(a, is_bf16, static_cast<cudaStream_t>(stream));
}

}  // namespace

// K6f. q, out (n, T, hs); k, v (J, n, T, hs); one type (bf16 or f32),
// contiguous. Dropout keeps score (row, col) of stream j of collapsed row i by
// the hash of (seed + (j + 1) * 1000003, i, row / blk, col / blk, row % blk,
// col % blk) against thresh; keepf is 1 - rate. Returns the cudaError_t.
extern "C" int tat_flash_cross_attention_fwd(const void* q, const void* k, const void* v,
                                             void* out, int J, int n, int T, int hs,
                                             int is_bf16, float scale, unsigned seed,
                                             unsigned thresh, int rate_on, float keepf, int blk,
                                             void* stream) {
  return cross_fwd(q, k, v, out, nullptr, nullptr, J, n, T, hs, is_bf16, scale, seed, thresh,
                   rate_on, keepf, blk, stream);
}

// K6f-r. As K6f, and each stream's output outs (J, n, T, hs) in q's type and
// logsumexp lses (J, n, 1, T) f32.
extern "C" int tat_flash_cross_attention_fwd_res(const void* q, const void* k, const void* v,
                                                 void* out, void* outs, void* lses, int J, int n,
                                                 int T, int hs, int is_bf16, float scale,
                                                 unsigned seed, unsigned thresh, int rate_on,
                                                 float keepf, int blk, void* stream) {
  return cross_fwd(q, k, v, out, outs, lses, J, n, T, hs, is_bf16, scale, seed, thresh,
                   rate_on, keepf, blk, stream);
}
