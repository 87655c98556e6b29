// Tensor-core building blocks shared by the flash-attention forward
// (flash_attention.cu, B1 and B2), the flash-attention backward
// (flash_attention_bwd.cu, B3 and B4) and the dequant-fused matmul
// (dequant_matmul.cu, B7) on Hopper (sm_90a): asynchronous global -> shared
// copies (cp.async), 8 x 8 matrix loads from shared memory into fragments
// (ldmatrix), the m16n8k16 bfloat16 product with float32 accumulation
// (mma.sync), the split of a float32 value into bfloat16 pieces, and the
// staging and piece products of the flash-attention kernels' tiles.
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
//
// The flash-attention helpers below take a tiling Sh that names: kD (head
// dim), kF32 (float32 operands), P (bfloat16 pieces an operand: 3 for
// float32, 1 for bfloat16), THREADS, LD (padded shared row, bfloat16), BC
// (walked rows a step), NT = BC / 8, KC = BC / 16, ND = kD / 8 and
// kBlkPiece = BC * LD (one piece of one walked tile).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---- flash-attention tiles ------------------------------------------------

// Four neighbouring float32 values, split into three bfloat16 pieces, stored
// at dst + p * piece_stride (8 bytes each).
__device__ __forceinline__ void store_split4(__nv_bfloat16* dst,
                                             int piece_stride, float4 x) {
  uint32_t pc[3][2];
  split3_pack(x.x, x.y, pc[0][0], pc[1][0], pc[2][0]);
  split3_pack(x.z, x.w, pc[0][1], pc[1][1], pc[2][1]);
#pragma unroll
  for (int p = 0; p < 3; ++p)
    *reinterpret_cast<uint2*>(dst + p * piece_stride) =
        make_uint2(pc[p][0], pc[p][1]);
}

// N (1 or 2) ROWS x D tiles (row stride D in device memory) into shared
// memory as [N][P pieces][ROWS][LD] bfloat16: float32 loaded (16 loads a
// thread in flight together), split and stored; bfloat16 copied by cp.async
// (the caller commits).
template <class Sh, int ROWS, int N, typename TQ>
__device__ __forceinline__ void stage_tiles(__nv_bfloat16* dst,
                                            const TQ* src0, const TQ* src1,
                                            int tid) {
  constexpr int D = Sh::kD, LD = Sh::LD, P = Sh::P;
  if constexpr (Sh::kF32) {
    constexpr int kPer = ROWS * D / 4, kIters = N * kPer / Sh::THREADS,
                  kBatch = kIters < 16 ? kIters : 16;
#pragma unroll
    for (int n0 = 0; n0 < kIters; n0 += kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int n = 0; n < kBatch; ++n) {
        const int c = tid + (n0 + n) * Sh::THREADS;
        x[n] = __ldg(reinterpret_cast<const float4*>(c < kPer ? src0 : src1) +
                     c % kPer);
      }
#pragma unroll
      for (int n = 0; n < kBatch; ++n) {
        const int c = tid + (n0 + n) * Sh::THREADS, e = c % kPer;
        store_split4(dst + (c / kPer) * P * ROWS * LD + e / (D / 4) * LD +
                         4 * (e % (D / 4)),
                     ROWS * LD, x[n]);
      }
    }
  } else {
    constexpr int kPer = ROWS * D / 8;
    for (int c = tid; c < N * kPer; c += Sh::THREADS) {
      const int t = c / kPer, e = c % kPer, r = e / (D / 8),
                col = 8 * (e % (D / 8));
      cp_async16(dst + t * ROWS * LD + r * LD + col,
                 (t ? src1 : src0) + (size_t)r * D + col, 16);
    }
  }
}

// A float32 walked block (two BC x D tiles) into the staging buffer
// [2][BC][D], by cp.async.
template <class Sh>
__device__ __forceinline__ void stage_f32(float* stage, const float* src0,
                                          const float* src1, int tid) {
  constexpr int D = Sh::kD, kPer = Sh::BC * D / 4;
  for (int c = tid; c < 2 * kPer; c += Sh::THREADS) {
    const int t = c / kPer, e = 4 * (c % kPer);
    cp_async16(stage + t * Sh::BC * D + e, (t ? src1 : src0) + e, 16);
  }
}

// The staging buffer, split into the walked block's pieces.
template <class Sh>
__device__ __forceinline__ void split_stage(__nv_bfloat16* blk,
                                            const float* stage, int tid) {
  constexpr int D = Sh::kD, BC = Sh::BC, kPer = BC * D / 4;
#pragma unroll 8
  for (int c = tid; c < 2 * kPer; c += Sh::THREADS) {
    const int t = c / kPer, e = c % kPer, r = e / (D / 4),
              col = 4 * (e % (D / 4));
    store_split4(blk + t * Sh::P * Sh::kBlkPiece + r * Sh::LD + col,
                 Sh::kBlkPiece,
                 *reinterpret_cast<const float4*>(stage + 4 * c));
  }
}

// c[n] += the piece products a[i] b[n][j] with LO <= i + j < max(PA, PB),
// the smaller sums first; for each pair the N tiles take their products in
// turn, so that consecutive mma.sync instructions go to N independent
// accumulators.  b[n][j] holds tile n's two B registers.
template <int N, int PA, int PB, int LO>
__device__ __forceinline__ void mma_pieces(float (&c)[N][4],
                                           const uint32_t (&a)[PA][4],
                                           const uint32_t (&b)[N][PB][2]) {
  constexpr int kTop = (PA > PB ? PA : PB) - 1;
#pragma unroll
  for (int s = kTop; s >= LO; --s)
#pragma unroll
    for (int i = 0; i < PA; ++i)
      if (s - i >= 0 && s - i < PB)
#pragma unroll
        for (int n = 0; n < N; ++n)
          mma_bf16(c[n], a[i], b[n][s - i][0], b[n][s - i][1]);
}

// The B fragments (non-transposed) of the walked block's NT 8-row tiles for
// one 16-deep step of the head dim, pieces 0 .. NP - 1.
template <class Sh, int NP>
__device__ __forceinline__ void load_b(uint32_t (&b)[Sh::NT][NP][2],
                                       const __nv_bfloat16* blk, int off) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < Sh::NT; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, blk + p * Sh::kBlkPiece + j * 8 * Sh::LD + off);
      b[j][p][0] = r[0], b[j][p][1] = r[1];
      b[j + 1][p][0] = r[2], b[j + 1][p][1] = r[3];
    }
}

// acc[j] = the warp's 16 resident rows (A: shared pieces at res, or the
// registers af) times the walked block's BC rows (B, shared pieces at blk)
// over the head dim: with float32 pieces, the small-piece products over all
// of D first, then hi * hi.  S (and dP) in the flash-attention kernels.
template <class Sh>
__device__ __forceinline__ void first_product(
    float (&acc)[Sh::NT][4], const __nv_bfloat16* res,
    const uint32_t (&af)[Sh::kRegs ? Sh::KD : 1][4],
    const __nv_bfloat16* blk, int a_off, int b_off) {
  constexpr int P = Sh::P, NT = Sh::NT;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if constexpr (P > 1) {  // the products of small pieces
#pragma unroll
    for (int kk = 0; kk < Sh::KD; ++kk) {
      uint32_t a[P][4], b[NT][P][2];
#pragma unroll
      for (int p = 0; p < P; ++p)
        ldmatrix_x4(a[p], res + p * Sh::kResPiece + a_off + kk * 16);
      load_b<Sh>(b, blk, b_off + kk * 16);
      mma_pieces<NT, P, P, 1>(acc, a, b);
    }
  }
#pragma unroll
  for (int kk = 0; kk < Sh::KD; ++kk) {  // hi * hi
    uint32_t a[4], b[NT][1][2];
    if constexpr (Sh::kRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = af[kk][e];
    } else {
      ldmatrix_x4(a, res + a_off + kk * 16);
    }
    load_b<Sh>(b, blk, b_off + kk * 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, b[j][0][0], b[j][0][1]);
  }
}

// out[jd] += (this block's share, summed in fresh fragments) the warp's 16
// rows of W (the hi and lo pieces of P or dS, as A fragments over the
// walked block's BC rows) times the walked block (B, transposed: shared
// pieces at blk, rows the summed index, columns the head dim), four 8-column
// tiles of the head dim at a time.
template <class Sh>
__device__ __forceinline__ void second_product(
    float (&out)[Sh::ND][4], const uint32_t (&w)[Sh::KC][2][4],
    const __nv_bfloat16* blk, int bt_off) {
  constexpr int P = Sh::P, LD = Sh::LD, G = 4;
#pragma unroll
  for (int jd = 0; jd < Sh::ND; jd += G) {
    float c[G][4];
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Sh::KC; ++kk) {
      uint32_t b[G][P][2];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int n = 0; n < G; n += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, blk + p * Sh::kBlkPiece + kk * 16 * LD +
                                   bt_off + (jd + n) * 8);
          b[n][p][0] = r[0], b[n][p][1] = r[1];
          b[n + 1][p][0] = r[2], b[n + 1][p][1] = r[3];
        }
      mma_pieces<G, 2, P, 0>(c, w[kk], b);
    }
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[jd + n][e] += c[n][e];
  }
}

}  // namespace
