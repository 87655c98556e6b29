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
// Every sum is held to float32 from float32 or bfloat16 inputs, and the
// result is rounded to q's dtype once.  The running max starts at -1e30
// (the TPU kernel's constant, not -inf), so a row whose scores are all -inf
// gets p = 0 and a denominator of 0, and returns 0 (the TPU kernel's
// l == 0 guard), not NaN, with lse exactly -1e30.  With causal, key blocks
// wholly above the diagonal of a query tile are never read.
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
// and out per head.  On the tensor cores the bytes bound it, in bfloat16
// and in float32, even with the splits below (1.5x the products for
// bfloat16 q, 5.5x for float32).  On the CUDA cores float32 arithmetic
// would bound it.
//
// Which kernel runs which instance (dtype of q, D; B1 and B2 alike, B2
// adding its lse store, kLse):
//   bfloat16, D = 64, 128, 256  flash_fwd_mma_kernel, 1 piece an operand
//   float32,  D = 64, 128       flash_fwd_mma_kernel, 3 pieces an operand
//   float32,  D = 256           flash_fwd_kernel (CUDA cores)
//
// flash_fwd_mma_kernel (mma.sync, the tensor cores):
//   - one block per (b*h, tile of 16 query rows a warp), the heaviest
//     causal tile first: 4 warps (64 rows), and 8 warps for float32 at
//     D = 128; key blocks of 64 keys for bfloat16 (32 at D = 256) and of 32
//     keys for float32, which keeps the float32 D = 64 instance at 70 KB of
//     shared memory, three blocks an SM with its registers capped at 168;
//   - S = q k^T with mma.sync m16n8k16 (bfloat16 in, float32 accumulated).
//     The products of bfloat16 values are exact in float32, so bfloat16 q
//     takes one product.  A float32 operand is split into three bfloat16
//     pieces (split3_pack: within 2^-24 of it) as it is staged, and S takes
//     the piece pairs (i, j) with i + j <= 2, the dropped ones below 2^-24
//     of it: 6 products, all small-piece products first and hi * hi last
//     (the tensor cores' float32 accumulation does not round as IEEE
//     additions do, so the large products come last in the chain);
//   - the bias is added and the online softmax taken on the accumulator
//     fragments in registers, the row max and sum across each quad's four
//     lanes by shuffles; the scores are kept in base-2 units (log2(e)
//     folded into sm_scale and the bias) and exponentiated with exp2f; lse
//     is stored as (m + log2 l) ln 2, and exactly -1e30 where l == 0; a key
//     mask's row (bias_sq == 0) is read once for a thread's two rows;
//   - P never touches shared memory: S's accumulator layout is the A
//     operand's layout of P V.  P rounded once to bfloat16 (2^-8 relative)
//     would move an output near 0 by ~1e-4, beyond the float32 contract
//     (3e-5; 3e-5 + 2^-7 |out| in bfloat16).  So P is split into two
//     pieces (split2_pack: within 2^-16 of it), and V read by
//     ldmatrix.trans.  bfloat16 V is exact in one piece: O += P_lo V +
//     P_hi V, 2 products chained into the running output.  float32 V has
//     three pieces: the 5 products P_i V_j with i + j <= 2, small first, go
//     into a fresh fragment for each key block, which is added on the CUDA
//     cores as O = O alpha + fresh;
//   - in the CPU emulation (tests/test_torch_tensor_core_fwd_numerics.py)
//     three pieces an operand and two for P stay within 0.2 of the 3e-5
//     tolerance on out and lse; two pieces an operand exceed half of it
//     (causal), and P in one piece misses it many times over;
//   - staging: rows are padded by 16 bytes so that ldmatrix reads without
//     bank conflicts.  bfloat16 key blocks are copied by cp.async straight
//     into shared memory, double-buffered, so the next block's load overlaps
//     this block's products.  A float32 key block is copied by cp.async into
//     a float32 buffer during this block's products and split into its
//     pieces at the top of the next step.  The q tile is staged once
//     (bfloat16 by cp.async; float32 with all its loads a thread in flight
//     together, then split) and kept as fragments in registers for
//     bfloat16 at D <= 128; elsewhere (float32's three pieces, which would
//     take 48 registers at D = 64) read by ldmatrix for each key block.
// flash_fwd_kernel keeps the first design for float32 at D = 256, where the
// three pieces of the q tile and of a 32-key block and the float32 stage
// take 268 KB of shared memory, more than a block has: float32 on the CUDA
// cores, one block per (b*h, tile of 8 rows) over 32-key blocks staged as
// float32, lane c owning key c for the scores and head dims c, c + 32, ...
// of the accumulator, the probabilities passed to the P V product through a
// warp-private shared buffer.  No path of the repo runs D = 256.
//
// Built by paddle_tpu_torch/native/build.py into a library with a plain C
// interface: each entry point launches on the caller's stream and returns
// cudaGetLastError().

#include "flash_common.cuh"
#include "mma_common.cuh"

#include <type_traits>

namespace {

// ---- float32 at D = 256: the first design, on the CUDA cores ---------------

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

// ---- the tensor-core kernel -------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The float32 tiling is the measured choice on the H100: at D = 64 the q
// pieces are read from shared memory and the registers capped for three
// blocks an SM (12 warps); at D = 128, where the shared memory allows one
// block an SM, the block takes 8 warps.  Wider key blocks for float32 took
// more registers than they saved in barriers.
template <typename TQ, int D>
struct MmaFwd {
  static constexpr bool kF32 = std::is_same<TQ, float>::value;
  static constexpr int kD = D;
  static constexpr int P = kF32 ? 3 : 1;       // bfloat16 pieces an operand
  static constexpr int NWARP = kF32 && D == 128 ? 8 : 4;
  static constexpr int THREADS = NWARP * 32;
  static constexpr int MIN_BLOCKS = kF32 && D == 64 ? 3 : 1;  // an SM
  static constexpr int BR = NWARP * 16;        // query rows a block
  static constexpr int BC = kF32 || D == 256 ? 32 : 64;  // keys a step
  static constexpr int LD = D + 8;             // padded shared row (bfloat16)
  static constexpr bool kRegs = !kF32 && D <= 128;  // q in registers
  static constexpr int NBUF = kF32 ? 1 : 2;    // key-block buffers
  static constexpr int NT = BC / 8;            // 8-key score tiles
  static constexpr int ND = D / 8;             // 8-column output tiles
  static constexpr int KD = D / 16, KC = BC / 16;  // 16-deep steps
  static constexpr int kResPiece = BR * LD, kBlkPiece = BC * LD;  // bf16
  static constexpr int kRes = P * kResPiece;                      // bf16
  static constexpr int kBlk = 2 * P * kBlkPiece;                  // bf16
  static constexpr int kStage = kF32 ? 2 * BC * D : 0;            // float
  static constexpr int kSmem = kStage * 4 + (kRes + NBUF * kBlk) * 2;
};

// B1 (kLse false) and B2 (kLse true) on the tensor cores, bfloat16 or
// float32 q (TQ), float32 or bfloat16 bias (TB).  The operands come as
// parameters, not as the Args block: read from a structure passed by value
// they cost B1 in bfloat16 over a tenth of its time on the H100.
template <typename TQ, typename TB, int D, bool kLse>
__global__ void __launch_bounds__(MmaFwd<TQ, D>::THREADS,
                                  MmaFwd<TQ, D>::MIN_BLOCKS)
    flash_fwd_mma_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                         const TQ* __restrict__ v, const TB* __restrict__ bias,
                         TQ* __restrict__ out, float* __restrict__ lse, int H,
                         int Sq, int Sk, int bias_sb, int bias_sh, int bias_sq,
                         float sm_scale, int causal) {
  using Sh = MmaFwd<TQ, D>;
  constexpr int P = Sh::P, BR = Sh::BR, BC = Sh::BC, LD = Sh::LD,
                NT = Sh::NT, ND = Sh::ND, KC = Sh::KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);         // [2][BC][D]
  __nv_bfloat16* q_s =
      reinterpret_cast<__nv_bfloat16*>(stage + Sh::kStage);  // [P][BR][LD]
  __nv_bfloat16* blk = q_s + Sh::kRes;       // [NBUF][2: k, v][P][BC][LD]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // heaviest tile first: under causal the last tile reads every key
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const TQ* kp = k + (size_t)bh * Sk * D;
  const TQ* vp = v + (size_t)bh * Sk * D;
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

  // key blocks wholly above the tile's diagonal are skipped (Sk and r0 are
  // multiples of BR, a multiple of BC)
  const int k_end = causal ? min(Sk, r0 + BR) : Sk;
  const int n_blocks = k_end / BC;
  const float qk_scale = sm_scale * kLog2e;
  if constexpr (Sh::kF32)  // the first key block, during the q tile's loads
    stage_f32<Sh>(stage, reinterpret_cast<const float*>(kp),
                  reinterpret_cast<const float*>(vp), tid);
  else
    stage_tiles<Sh, BC, 2>(blk, kp, vp, tid);
  const TQ* qp = q + ((size_t)bh * Sq + r0) * D;
  stage_tiles<Sh, BR, 1>(q_s, qp, qp, tid);
  cp_async_commit();

  // ldmatrix offsets of this lane (see mma_common.cuh): q as A, k as B
  // (non-transposed: n = key, k = head dim), v as B transposed (k = key,
  // n = head dim)
  const int a_off = (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                    (lane / 16) * 8;
  const int b_off = ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int bt_off = ((lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;

  uint32_t qf[Sh::kRegs ? Sh::KD : 1][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;  // this lane's shares of the two denominators

  for (int i = 0; i < n_blocks; ++i) {
    const int base = i * BC;
    int buf = 0;
    if constexpr (Sh::kF32) {
      cp_async_wait<0>();
      __syncthreads();  // block i staged; every warp is done with block i - 1
      split_stage<Sh>(blk, stage, tid);
      __syncthreads();  // block i's pieces ready; the staging buffer free
      if (i + 1 < n_blocks) {  // the next block's load overlaps this one
        const size_t off = (size_t)(base + BC) * D;
        stage_f32<Sh>(stage, reinterpret_cast<const float*>(kp) + off,
                      reinterpret_cast<const float*>(vp) + off, tid);
        cp_async_commit();
      }
    } else {
      buf = i & 1;
      if (i + 1 < n_blocks) {  // the next block's load overlaps this one
        const size_t off = (size_t)(base + BC) * D;
        stage_tiles<Sh, BC, 2>(blk + (buf ^ 1) * Sh::kBlk, kp + off,
                               vp + off, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    if constexpr (Sh::kRegs) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < Sh::KD; ++kk)
          ldmatrix_x4(qf[kk], q_s + a_off + kk * 16);
      }
    }
    const __nv_bfloat16* kb = blk + buf * Sh::kBlk;
    const __nv_bfloat16* vb = kb + P * Sh::kBlkPiece;

    // S = q k^T for this warp's 16 rows and the block's BC keys
    float s[NT][4];
    first_product<Sh>(s, q_s, qf, kb, a_off, b_off);

    // scale, bias, causal mask, in base-2 units (x log2(e)); the block's
    // row maxima
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

    // O += P V, P's pieces from the score fragments in registers: a0 row g,
    // a1 row g + 8 of the first 8-key tile, a2, a3 the same of the second
    uint32_t pf[KC][2][4];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split2_pack(s[2 * kk + e / 2][2 * (e % 2)],
                    s[2 * kk + e / 2][2 * (e % 2) + 1], pf[kk][0][e],
                    pf[kk][1][e]);
    if constexpr (Sh::kF32) {
      second_product<Sh>(o, pf, vb, bt_off);  // a fresh fragment, then added
    } else {  // lo, then hi, chained into the running output
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
#pragma unroll
        for (int j = 0; j < ND; j += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vb + kk * 16 * LD + bt_off + j * 8);
          mma_bf16(o[j], pf[kk][1], bv[0], bv[1]);
          mma_bf16(o[j], pf[kk][0], bv[0], bv[1]);
          mma_bf16(o[j + 1], pf[kk][1], bv[2], bv[3]);
          mma_bf16(o[j + 1], pf[kk][0], bv[2], bv[3]);
        }
      __syncthreads();  // the next block's load overwrites this buffer
    }
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float d0 = l0 == 0.f ? 1.f : l0;  // l == 0 guard: output 0
  const float d1 = l1 == 0.f ? 1.f : l1;
  TQ* op0 = out + ((size_t)bh * Sq + row0) * D + 2 * t;
  TQ* op1 = op0 + 8 * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {  // divided as stored
    const float x0 = o[j][0] / d0, x1 = o[j][1] / d0;
    const float y0 = o[j][2] / d1, y1 = o[j][3] / d1;
    if constexpr (Sh::kF32) {
      *reinterpret_cast<float2*>(op0 + j * 8) = make_float2(x0, x1);
      *reinterpret_cast<float2*>(op1 + j * 8) = make_float2(y0, y1);
    } else {
      *reinterpret_cast<uint32_t*>(op0 + j * 8) = pack_bf16(x0, x1);
      *reinterpret_cast<uint32_t*>(op1 + j * 8) = pack_bf16(y0, y1);
    }
  }
  if constexpr (kLse) {  // the statistic the backward recomputes from
    if (t == 0) {
      float* lp = lse + (size_t)bh * Sq;
      lp[row0] = l0 == 0.f ? kNegInf : (m0 + log2f(l0)) * kLn2;
      lp[row1] = l1 == 0.f ? kNegInf : (m1 + log2f(l1)) * kLn2;
    }
  }
}

// One launch of either forward kernel; both take the same parameters.
template <typename TQ, typename TB, class K>
cudaError_t launch(K kernel, int rows, int threads, int smem, const Args& a) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.B * a.H, a.Sq / rows), threads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
      static_cast<const TQ*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<TQ*>(a.out), a.lse, a.H, a.Sq, a.Sk, a.bias_sb, a.bias_sh,
      a.bias_sq, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <bool kLse>
struct Fwd {
  // D = 64 and 128, and bfloat16 at 256, on the tensor cores; float32 at
  // D = 256 (VPT 8) on the CUDA cores.
  template <typename TQ, typename TB, int VPT>
  struct Launch {
    static cudaError_t run(const Args& a) {
      if constexpr (std::is_same<TQ, float>::value && VPT == 8) {
        using Sh = Shape<VPT>;
        return launch<TQ, TB>(flash_fwd_kernel<TQ, TB, VPT, kLse>, Sh::BR,
                              NW * 32, Sh::kSmem, a);
      } else {
        using Sh = MmaFwd<TQ, 32 * VPT>;
        return launch<TQ, TB>(flash_fwd_mma_kernel<TQ, TB, 32 * VPT, kLse>,
                              Sh::BR, Sh::THREADS, Sh::kSmem, a);
      }
    }
  };
};

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
  return dispatch<Fwd<false>::Launch>(
      fwd_args(q, k, v, bias, out, nullptr, B, H, Sq, Sk, D, bias_sb,
               bias_sh, bias_sq, sm_scale, causal, stream),
      q_dtype, bias_dtype);
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
