// Register-fragment building blocks for Hopper (sm_90a) tensor-core kernels
// on mma.sync: 16- and 4-byte asynchronous copies into shared memory (cp.async),
// fragment loads from shared memory (ldmatrix), the bf16 m16n8k16 product
// with f32 accumulators, and the maps between a fragment and its (row,
// column) elements.
//
// Fragments of mma.sync.m16n8k16 (bf16 in, f32 out), lane = threadIdx % 32,
// g = lane / 4, t = lane % 4:
//   A (16 x 16, row-major)  a[0]: (g, 2t..2t+1)      a[1]: (g + 8, 2t..2t+1)
//                           a[2]: (g, 8 + 2t..)      a[3]: (g + 8, 8 + 2t..)
//   B (16 x 8, "col")       b[0]: (2t..2t+1, g)      b[1]: (8 + 2t.., g)
//   C (16 x 8, f32)         c[0], c[1]: (g, 2t), (g, 2t + 1)
//                           c[2], c[3]: (g + 8, 2t), (g + 8, 2t + 1)
// Two packed bf16 hold the lower column in the low 16 bits. The C fragments
// of two adjacent 16 x 8 tiles, rounded and packed, are the A fragment of
// their 16 x 16 block: a product's result feeds the next product without
// leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tat {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, asynchronously; with fill false
// the 16 bytes are zeros (src is not read but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// 4 bytes from global src to shared dst, asynchronously (f32 rows of any
// alignment).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 and receives in r[m] the elements (g, 2t..2t+1)
// of matrix m (with trans, of its transpose).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: a 16 x 16, b 16 x 8, bf16; d 16 x 8, f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit (ex2.approx, subnormal results flushed
// to zero; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// Row and column inside a 16 x 8 tile of element i (0..3) of a C fragment.
__device__ __forceinline__ int frag_row(int lane, int i) { return (lane >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int frag_col(int lane, int i) { return 2 * (lane & 3) + (i & 1); }

// The address lane gives ldsm_x4 for the A fragment of the 16 x 16 block at
// (r0, c0) of a row-major bf16 array with row stride ld (elements); the same
// address with ldsm_x4_trans gives, from a row-major (k, n) array, the B
// fragments of the two 16 x 8 blocks at (r0, c0) and (r0, c0 + 8):
// r[0], r[1] and r[2], r[3].
__device__ __forceinline__ const __nv_bfloat16* a_frag_addr(const __nv_bfloat16* base, int ld,
                                                            int r0, int c0, int lane) {
  return base + (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3);
}

// The address lane gives ldsm_x4 for the B fragments of the products with
// the transposes of rows n0..n0 + 15 of a row-major (n, k) array at columns
// c0..c0 + 15: r[0], r[1] for rows n0..n0 + 7 and r[2], r[3] for n0 + 8..
__device__ __forceinline__ const __nv_bfloat16* bt_frag_addr(const __nv_bfloat16* base, int ld,
                                                             int n0, int c0, int lane) {
  return base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 + (((lane >> 3) & 1) << 3);
}

}  // namespace mma
}  // namespace tat
