// Flash attention forward with a streamed additive bias for Hopper
// (sm_90a): B1, and B2, which is B1 plus the per-row logsumexp that the
// tiled recompute backward (flash_attention_bwd.cu) reads.
//
//   q, k, v  [B, H, S, D]   float32 or bfloat16, contiguous
//   bias     none, a key mask [B|1, H|1, 1, Sk] or a full [B|1, H|1, Sq, Sk]
//            tensor, float32 or bfloat16, addressed through element strides
//            (b, h, query) that are 0 along its broadcast dims: it is read
//            in its natural shape and never materialized to [B, H, Sq, Sk]
//   out      [B, H, Sq, D] in q's dtype
//   lse      (B2 only) [B, H, Sq] float32: m + log(l), the row's running
//            max plus the log of its denominator; -1e30 where l == 0
//
//   out = softmax(q k^T * sm_scale + bias [, causal: -1e30 where key > row]) v
//
// Every sum is taken in float32 from float32 or bfloat16 inputs, and the
// result is rounded to q's dtype once.  The running max starts at -1e30
// (the TPU kernel's constant, not -inf), so a row whose scores are all -inf
// gets p = 0 and a denominator of 0, and returns 0 (the TPU kernel's
// l == 0 guard), not NaN.  With causal,
// key blocks wholly above the diagonal of a query tile are never read.
//
// Replaces _fwd_kernel in paddle_tpu/ops/pallas_attention.py (B1; launched
// by _flash_call: grid (B*H, Sq/128, Sk/128), the running max, denominator
// and accumulator carried across the key blocks in VMEM scratch) and
// _fwd_kernel in paddle_tpu/ops/flash_attention.py (B2; launched by
// _fwd_call on the same grid, storing lse at the last key block).  The TPU
// kernels cast q, k, v to float32 and multiply P V with P in float32.
// Contracts shared with the plain PyTorch versions
// flash_attention_bias_reference (paddle_tpu_torch/ops/flash_attention_bias.py)
// and flash_attention_fwd_reference (paddle_tpu_torch/ops/flash_attention.py),
// whose wrappers check shapes (S % 128 == 0, D in {64, 128, 256}), dtypes
// and contiguity before a launch.
//
// What bounds it on this card: at BERT's shapes (S = 128, D = 64) the work
// is 4*D operations per (row, key) pair against 4*S*D elements of q, k, v
// and out per head.  In bfloat16 the bytes bound it: the tensor cores do
// the products in a fraction of the time the bytes take, even with the P
// split below (1.5x the products).  In float32 the CUDA cores' arithmetic
// bounds the float32 kernel.
//
// B1 with bfloat16 q (flash_fwd_mma_kernel) runs on the tensor cores:
//   - one block per (b*h, tile of 64 query rows), 4 warps of 16 rows; each
//     warp keeps its q fragments in registers for the whole key loop (at
//     D = 256 it reloads them from shared memory for each key block);
//   - key blocks of 64 keys (32 at D = 256) stay bfloat16 in shared memory,
//     rows padded by 16 bytes so that ldmatrix reads without bank
//     conflicts; cp.async double-buffers them, so the next block's load
//     overlaps this block's arithmetic;
//   - S = q k^T with mma.sync m16n8k16 (bfloat16 in, float32 accumulated):
//     the products of bfloat16 values are exact in float32;
//   - the bias is added and the online softmax taken on the accumulator
//     fragments in registers, the row max and sum across each quad's four
//     lanes by shuffles; the scores are kept in base-2 units (log2(e)
//     folded into sm_scale and the bias) and exponentiated with exp2f (the
//     float32 kernel keeps expf); a key mask's row (bias_sq == 0) is read
//     once for a thread's two rows;
//   - P never touches shared memory: S's accumulator layout is the A
//     operand's layout of P V.  P rounded once to bfloat16 (2^-8 relative)
//     would move an output near 0 by ~1e-4, beyond the float32 contract
//     (3e-5 + 2^-7 |out| in bfloat16).  So P is split into
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), which carry P within 2^-16
//     of itself, and O += P_lo V + P_hi V are two tensor-core products with
//     V read by ldmatrix.trans; V is exact in bfloat16.  The output is then
//     within ~1e-5 of the float32 sum before its one rounding to bfloat16.
// B1 with float32 q, and B2 in both types, keep the first design
// (flash_fwd_kernel): float32 on the CUDA cores, one block per (b*h, tile of
// 32/16/8 rows for D = 64/128/256) over 32-key blocks converted to float32
// as they are staged, lane c owning key c for the scores and head dims
// c, c + 32, ... of the accumulator, the probabilities passed to the P V
// product through a warp-private shared buffer.
//
// Built by paddle_tpu_torch/native/build.py into a library with a plain C
// interface: each entry point launches on the caller's stream and returns
// cudaGetLastError().

#include "flash_common.cuh"
#include "mma_common.cuh"

namespace {

template <typename TQ, typename TB, int VPT, bool kLse>
__global__ void __launch_bounds__(NW * 32)
    flash_fwd_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                     const TQ* __restrict__ v, const TB* __restrict__ bias,
                     TQ* __restrict__ out, float* __restrict__ lse, int H,
                     int Sq, int Sk, int bias_sb,
                     int bias_sh, int bias_sq, float sm_scale, int causal) {
  using Sh = Shape<VPT>;
  constexpr int D = Sh::D, RPW = Sh::RPW, BR = Sh::BR, KS = Sh::KS,
                NL = Sh::NL;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;             // [BR][D]
  float* k_s = q_s + BR * D;     // [BC][KS]
  float* v_s = k_s + BC * KS;    // [BC][D]
  float* p_s = v_s + BC * D;     // [NW][RPW][BC]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // heaviest tile first: under causal the last tile reads every key
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const TQ* qp = q + ((size_t)bh * Sq + r0) * D;
  const TQ* kp = k + (size_t)bh * Sk * D;
  const TQ* vp = v + (size_t)bh * Sk * D;
  const TB* bp = bias == nullptr
                     ? nullptr
                     : bias + (size_t)b * bias_sb + (size_t)h * bias_sh;

  for (int e = 4 * tid; e < BR * D; e += 4 * NW * 32)
    *reinterpret_cast<float4*>(&q_s[e]) = load4(qp + e);

  float m[RPW], l[RPW], acc[RPW][VPT];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;  // this lane's share of the row's denominator
#pragma unroll
    for (int j = 0; j < VPT; ++j) acc[i][j] = 0.f;
  }

  // key blocks wholly above the tile's diagonal are skipped (Sk, r0 and BR
  // are multiples of BC or divide it, so no block is ragged)
  const int k_end = causal ? min(Sk, r0 + BR) : Sk;
  for (int base = 0; base < k_end; base += BC) {
#pragma unroll
    for (int n = 0; n < NL; ++n) {
      const int e = tid + NW * 32 * n, c = e / (D / 4), d = 4 * (e % (D / 4));
      const size_t row = (size_t)(base + c) * D + d;
      *reinterpret_cast<float4*>(&k_s[c * KS + d]) = load4(kp + row);
      *reinterpret_cast<float4*>(&v_s[c * D + d]) = load4(vp + row);
    }
    __syncthreads();

    float sc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&k_s[lane * KS + d]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(&q_s[(warp * RPW + i) * D + d]);
        sc[i] = fmaf(q4.x, k4.x, sc[i]);
        sc[i] = fmaf(q4.y, k4.y, sc[i]);
        sc[i] = fmaf(q4.z, k4.z, sc[i]);
        sc[i] = fmaf(q4.w, k4.w, sc[i]);
      }
    }
    const int key = base + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = r0 + warp * RPW + i;
      float x = sc[i] * sm_scale;
      if (bp != nullptr) x += to_f32(bp[(size_t)row * bias_sq + key]);
      if (causal && key > row) x = kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float alpha = expf(m[i] - m_new);
      const float p = expf(x - m_new);
      l[i] = l[i] * alpha + p;
#pragma unroll
      for (int j = 0; j < VPT; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
      p_s[(warp * RPW + i) * BC + lane] = p;
    }
    __syncwarp();
#pragma unroll 2
    for (int c = 0; c < BC; c += 4) {
      float vv[4][VPT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < VPT; ++j) vv[u][j] = v_s[(c + u) * D + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&p_s[(warp * RPW + i) * BC + c]);
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          acc[i][j] = fmaf(p4.x, vv[0][j], acc[i][j]);
          acc[i][j] = fmaf(p4.y, vv[1][j], acc[i][j]);
          acc[i][j] = fmaf(p4.z, vv[2][j], acc[i][j]);
          acc[i][j] = fmaf(p4.w, vv[3][j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next block overwrites k_s, v_s and p_s
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = r0 + warp * RPW + i;
    const float denom = warp_sum(l[i]);
    const float dv = denom == 0.f ? 1.f : denom;  // l == 0 guard: output 0
    TQ* op = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      op[lane + 32 * j] = from_f32<TQ>(acc[i][j] / dv);
    if (kLse && lane == 0)  // the statistic the backward recomputes from
      lse[(size_t)bh * Sq + row] =
          denom == 0.f ? kNegInf : m[i] + logf(denom);
  }
}

template <bool kLse>
struct Fwd {
  template <typename TQ, typename TB, int VPT>
  struct Launch {
    static cudaError_t run(const Args& a) {
      using Sh = Shape<VPT>;
      const auto kernel = flash_fwd_kernel<TQ, TB, VPT, kLse>;
      const cudaError_t e = allow_smem(kernel, Sh::kSmem);
      if (e != cudaSuccess) return e;
      kernel<<<dim3(a.B * a.H, a.Sq / Sh::BR), NW * 32, Sh::kSmem,
               a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
          static_cast<const TQ*>(a.v), static_cast<const TB*>(a.bias),
          static_cast<TQ*>(a.out), a.lse, a.H, a.Sq, a.Sk, a.bias_sb,
          a.bias_sh, a.bias_sq, a.sm_scale, a.causal);
      return cudaGetLastError();
    }
  };
};

// ---- B1, bfloat16 q: the tensor-core kernel --------------------------------

constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct MmaShape {
  static constexpr int NWARP = 4, THREADS = NWARP * 32;
  static constexpr int BR = NWARP * 16;       // query rows a block
  static constexpr int BC = D == 256 ? 32 : 64;  // keys a block
  static constexpr int LD = D + 8;            // padded smem row (bf16)
  static constexpr bool kQRegs = D <= 128;    // q fragments in registers
  static constexpr int NT = BC / 8;           // 8-key score tiles
  static constexpr int ND = D / 8;            // 8-column output tiles
  static constexpr int kSmem = (BR + 4 * BC) * LD * 2;  // q, 2 x (k, v)
};

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(
      __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// rows x D bfloat16 from global (row stride D) into shared (row stride LD),
// 16 bytes a copy, asynchronously.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int tid) {
  using Sh = MmaShape<D>;
  constexpr int kChunks = ROWS * D / 8;
#pragma unroll
  for (int c = tid; c < kChunks; c += Sh::THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    cp_async16(dst + r * Sh::LD + col, src + (size_t)r * D + col, 16);
  }
}

template <typename TB, int D>
__global__ void __launch_bounds__(MmaShape<D>::THREADS)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const TB* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int H, int Sq,
                         int Sk, int bias_sb, int bias_sh, int bias_sq,
                         float sm_scale, int causal) {
  using Sh = MmaShape<D>;
  constexpr int BR = Sh::BR, BC = Sh::BC, LD = Sh::LD, NT = Sh::NT,
                ND = Sh::ND;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BR * LD;        // [2][BC][LD]
  __nv_bfloat16* v_s = k_s + 2 * BC * LD;    // [2][BC][LD]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // heaviest tile first: under causal the last tile reads every key
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* kp = k + (size_t)bh * Sk * D;
  const __nv_bfloat16* vp = v + (size_t)bh * Sk * D;
  // this thread's two rows: g and g + 8 of its warp's 16
  const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;
  const TB* b0 = nullptr;
  const TB* b1 = nullptr;
  const bool key_bias = bias_sq == 0;  // one bias row for every query
  if (bias != nullptr) {
    const TB* bp = bias + (size_t)b * bias_sb + (size_t)h * bias_sh;
    b0 = bp + (size_t)row0 * bias_sq;
    b1 = bp + (size_t)row1 * bias_sq;
  }

  const int k_end = causal ? min(Sk, r0 + BR) : Sk;
  const int n_blocks = k_end / BC;
  const float qk_scale = sm_scale * kLog2e;
  stage_rows<D, BR>(q_s, q + ((size_t)bh * Sq + r0) * D, tid);
  stage_rows<D, BC>(k_s, kp, tid);
  stage_rows<D, BC>(v_s, vp, tid);
  cp_async_commit();

  // ldmatrix row addresses of this lane (see mma_common.cuh): q as the A
  // operand, k as B (non-transposed), v as B (transposed)
  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
  const int a_col = (lane / 16) * 8;
  const int kb_row = (lane % 8) + (lane / 16) * 8;
  const int kb_col = ((lane / 8) % 2) * 8;
  const int vb_row = (lane % 8) + ((lane / 8) % 2) * 8;
  const int vb_col = (lane / 16) * 8;

  uint32_t qf[Sh::kQRegs ? D / 16 : 1][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;  // this lane's shares of the two denominators

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int buf = blk & 1;
    if (blk + 1 < n_blocks) {  // the next block's load overlaps this one
      const size_t off = (size_t)(blk + 1) * BC * D;
      stage_rows<D, BC>(k_s + (buf ^ 1) * BC * LD, kp + off, tid);
      stage_rows<D, BC>(v_s + (buf ^ 1) * BC * LD, vp + off, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (Sh::kQRegs) {
      if (blk == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[kk], q_s + a_row * LD + kk * 16 + a_col);
      }
    }
    const __nv_bfloat16* ks = k_s + buf * BC * LD;
    const __nv_bfloat16* vs = v_s + buf * BC * LD;

    // S = q k^T for this warp's 16 rows and the block's BC keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (Sh::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, q_s + a_row * LD + kk * 16 + a_col);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (j * 8 + kb_row) * LD + kk * 16 + kb_col);
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // scale, bias, causal mask, in base-2 units (x log2(e)); the block's
    // row maxima
    const int base = blk * BC;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int key = base + j * 8 + 2 * t;
      float2 bb0 = make_float2(0.f, 0.f), bb1 = bb0;
      if (b0 != nullptr) {
        bb0 = load2(b0 + key);
        bb1 = key_bias ? bb0 : load2(b1 + key);
      }
      s[j][0] = fmaf(s[j][0], qk_scale, bb0.x * kLog2e);
      s[j][1] = fmaf(s[j][1], qk_scale, bb0.y * kLog2e);
      s[j][2] = fmaf(s[j][2], qk_scale, bb1.x * kLog2e);
      s[j][3] = fmaf(s[j][3], qk_scale, bb1.y * kLog2e);
      if (causal) {
        if (key > row0) s[j][0] = kNegInf;
        if (key + 1 > row0) s[j][1] = kNegInf;
        if (key > row1) s[j][2] = kNegInf;
        if (key + 1 > row1) s[j][3] = kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {  // across the quad's lanes
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0, m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= al0, o[j][1] *= al0;
      o[j][2] *= al1, o[j][3] *= al1;
    }

    // O += P_lo V + P_hi V, P from the score fragments in registers
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      // a0: row g, a1: row g + 8 of the first 8-key tile; a2, a3 the same
      // of the second
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split2_pack(s[2 * kk + e / 2][2 * (e % 2)],
                    s[2 * kk + e / 2][2 * (e % 2) + 1], ph[e], pl[e]);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + vb_row) * LD + j * 8 + vb_col);
        mma_bf16(o[j], pl, bv[0], bv[1]);
        mma_bf16(o[j], ph, bv[0], bv[1]);
        mma_bf16(o[j + 1], pl, bv[2], bv[3]);
        mma_bf16(o[j + 1], ph, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the next block's load overwrites this buffer
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float d0 = l0 == 0.f ? 1.f : l0;  // l == 0 guard: output 0
  const float d1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* op0 = out + ((size_t)bh * Sq + row0) * D + 2 * t;
  __nv_bfloat16* op1 = out + ((size_t)bh * Sq + row1) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<uint32_t*>(op0 + j * 8) =
        pack_bf16(o[j][0] / d0, o[j][1] / d0);
    *reinterpret_cast<uint32_t*>(op1 + j * 8) =
        pack_bf16(o[j][2] / d1, o[j][3] / d1);
  }
}

template <typename TB, int D>
cudaError_t launch_mma(const Args& a) {
  using Sh = MmaShape<D>;
  const auto kernel = flash_fwd_mma_kernel<TB, D>;
  const cudaError_t e = allow_smem(kernel, Sh::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.B * a.H, a.Sq / Sh::BR), Sh::THREADS, Sh::kSmem,
           a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<__nv_bfloat16*>(a.out), a.H, a.Sq, a.Sk, a.bias_sb,
      a.bias_sh, a.bias_sq, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t launch_mma_d(const Args& a) {
  switch (a.D) {
    case 64:
      return launch_mma<TB, 64>(a);
    case 128:
      return launch_mma<TB, 128>(a);
    case 256:
      return launch_mma<TB, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// B1 in bfloat16: the tensor-core kernel, by bias type.
int launch_bf16_b1(const Args& a, int bias_dtype) {
  if (a.bias == nullptr || bias_dtype == kF32)
    return static_cast<int>(launch_mma_d<float>(a));
  if (bias_dtype == kBF16)
    return static_cast<int>(launch_mma_d<__nv_bfloat16>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

Args fwd_args(const void* q, const void* k, const void* v, const void* bias,
              void* out, float* lse, int B, int H, int Sq, int Sk, int D,
              int bias_sb, int bias_sh, int bias_sq, float sm_scale,
              int causal, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.out = out, a.lse = lse;
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.D = D;
  a.bias_sb = bias_sb, a.bias_sh = bias_sh, a.bias_sq = bias_sq;
  a.sm_scale = sm_scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

extern "C" {

const char* paddle_flash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B1.  q, k, v [B, H, S, D]; bias strides in elements (0 along broadcast
// dims).  Returns cudaGetLastError() after the launch.
int paddle_flash_attention_bias_fwd(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, int B, int H, int Sq, int Sk,
                                    int D, int bias_sb, int bias_sh,
                                    int bias_sq, float sm_scale, int causal,
                                    int q_dtype, int bias_dtype,
                                    void* stream) {
  const Args a = fwd_args(q, k, v, bias, out, nullptr, B, H, Sq, Sk, D,
                          bias_sb, bias_sh, bias_sq, sm_scale, causal, stream);
  if (q_dtype == kBF16) return launch_bf16_b1(a, bias_dtype);
  if (q_dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_bias<Fwd<false>::Launch, float>(
      a, bias_dtype));
}

// B2.  As B1, and lse [B, H, Sq] float32.
int paddle_flash_attention_fwd_lse(const void* q, const void* k,
                                   const void* v, const void* bias, void* out,
                                   float* lse, int B, int H, int Sq, int Sk,
                                   int D, int bias_sb, int bias_sh,
                                   int bias_sq, float sm_scale, int causal,
                                   int q_dtype, int bias_dtype,
                                   void* stream) {
  return dispatch<Fwd<true>::Launch>(
      fwd_args(q, k, v, bias, out, lse, B, H, Sq, Sk, D, bias_sb, bias_sh,
               bias_sq, sm_scale, causal, stream),
      q_dtype, bias_dtype);
}

}  // extern "C"
