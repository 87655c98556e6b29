// Tensor-core building blocks shared by the bfloat16 flash-attention forward
// (flash_attention.cu, B1), the flash-attention backward
// (flash_attention_bwd.cu, B3 and B4) and the dequant-fused matmul
// (dequant_matmul.cu, B7) on Hopper (sm_90a): asynchronous global -> shared
// copies (cp.async), 8 x 8 matrix loads from shared memory into fragments
// (ldmatrix), the m16n8k16 bfloat16 product with float32 accumulation
// (mma.sync), and the split of a float32 value into bfloat16 pieces.
// Everything sits in an anonymous namespace: each source is a library of its
// own.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4), each
// register holding two neighbouring bfloat16 values (low half first):
//   A 16 x 16, row-major: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same
//     cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B 16 x 8, k-major:    b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9; col g);
//   C 16 x 8 float32:     c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the C fragments of two neighbouring 8-column tiles are, element for
// element, the A fragment of one 16-deep step: a product's result feeds the
// next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first src_bytes (0..16) are read
// and the rest zero-filled; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
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

// Four 8 x 8 bfloat16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8, and receives in r[j] its (row g, cols 2t, 2t+1) of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The same, each matrix transposed: r[j] holds (rows 2t, 2t+1; col g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// c += a b: one m16n8k16 bfloat16 product, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values as one register of bfloat16 (x in the low half),
// each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rounding to bfloat16 (8 significant bits) moves a value by at most 2^-8 of
// it, and the difference of a float32 value and its rounding is exact in
// float32.  The splits below work on pairs, as the fragments hold them.

constexpr float kF32Max = 3.402823466e38f;  // float32's largest finite value

// A rest that is not finite becomes 0.  It is not finite exactly when the
// head is not: +-inf or NaN, or a finite value whose bfloat16 rounding
// passes bfloat16's largest finite value (|x| >= 3.3962e38, the top 0.2 %
// of float32's range), which the split takes as +-inf.  So the smaller
// pieces add nothing to such a head, and a product with the pieces follows
// IEEE rules as the plain float32 product does: +-inf, or NaN where it meets
// a 0 (not the NaN of inf - inf).  Two instructions a value.
__device__ __forceinline__ float finite_or_zero(float r) {
  return fabsf(r) <= kF32Max ? r : 0.f;
}

// hi = bf16(a, b), returned packed, and the rests (a, b) - hi.
__device__ __forceinline__ uint32_t split_head(float a, float b, float& ra,
                                               float& rb) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  ra = finite_or_zero(a - hf.x);
  rb = finite_or_zero(b - hf.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (a, b) = hi + lo + r with hi = bf16(a, b) and lo = bf16((a, b) - hi):
// |r| <= 2^-8 |(a, b) - hi| <= 2^-16 |(a, b)| (16 significant bits).  The P
// split of the flash-attention forward, and of P and dS in the backward.
__device__ __forceinline__ void split2_pack(float a, float b, uint32_t& hi,
                                            uint32_t& lo) {
  float ra, rb;
  hi = split_head(a, b, ra, rb);
  lo = pack_bf16(ra, rb);
}

// (a, b) = hi + mid + lo + r, each piece the bfloat16 rounding of what the
// ones before leave: |r| <= 2^-24 |(a, b)|, float32's own rounding step, so
// the three pieces carry x to float32 precision.  The x split of the
// dequant-fused matmul, and the operand split of the float32 backward.
__device__ __forceinline__ void split3_pack(float a, float b, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  float ra, rb;
  hi = split_head(a, b, ra, rb);
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(ra - mf.x, rb - mf.y);
}

}  // namespace
