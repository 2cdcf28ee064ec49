// The f32 weights of the fused QKV kernels rounded to bf16 once a call (the
// JAX kernels' cast of the weights to x's type), for the bf16 bodies that
// read them as tensor-core operands: K1f's mma.sync body
// (fused_qkv_attention.cu) and K1b's products (fused_qkv_attention_bwd.cu).
// The rounding is the one each block would apply (nearest even), so the
// bits are those of a cast in the loader.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tat {
namespace gm {

// out_a[i] = bf16(a[i]) for i < n1, then out_b[i] = bf16(b[i]) for i < n2.
__global__ void round_weights_kernel(const float* __restrict__ a, long long n1,
                                     const float* __restrict__ b, long long n2,
                                     __nv_bfloat16* out_a, __nv_bfloat16* out_b) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n1 + n2;
       idx += (long long)gridDim.x * blockDim.x) {
    if (idx < n1)
      out_a[idx] = __float2bfloat16_rn(a[idx]);
    else
      out_b[idx - n1] = __float2bfloat16_rn(b[idx - n1]);
  }
}

// One launch of round_weights_kernel on stream s; returns its cudaError_t.
inline int round_weights(const float* a, long long n1, const float* b, long long n2,
                         __nv_bfloat16* out_a, __nv_bfloat16* out_b, cudaStream_t s) {
  constexpr int kT = 256;
  const long long blocks = (n1 + n2 + kT - 1) / kT;
  round_weights_kernel<<<(unsigned)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096), kT, 0,
                         s>>>(a, n1, b, n2, out_a, out_b);
  return (int)cudaGetLastError();
}

}  // namespace gm
}  // namespace tat
