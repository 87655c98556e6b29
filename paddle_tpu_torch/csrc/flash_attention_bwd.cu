// Flash attention backward for Hopper (sm_90a): the tiled recompute from
// (q, k, v, lse, delta), as two kernels, dq (B3) and dk/dv (B4).
//
//   q, do    [B, H, Sq, D]  float32 or bfloat16, contiguous
//   k, v     [B, H, Sk, D]  same dtype
//   bias     none, a key mask [B|1, H|1, 1, Sk] or a full [B|1, H|1, Sq, Sk]
//            tensor, float32 or bfloat16, addressed through element strides
//            (b, h, query) that are 0 along its broadcast dims
//   lse      [B, H, Sq] float32, the forward's m + log(l) per row
//   delta    [B, H, Sq] float32, rowsum(do * out), taken by the caller
//   dq       [B, H, Sq, D] in q's dtype; dk, dv [B, H, Sk, D] in k's
//
//   S  = q k^T * sm_scale + bias [, causal: -1e30 where key > row]
//   P  = exp(S - lse)          the difference taken in float32, after the
//                              mask add, as the TPU kernels take it
//   dP = do v^T
//   dS = P * (dP - delta) * sm_scale
//   dq = dS k        dv = P^T do        dk = dS^T q
//
// Every product is held to float32 from float32 or bfloat16 inputs; each
// result is rounded to its dtype once.  The bias gets no gradient (a
// constant by contract).
//
// Replaces _bwd_dq_kernel (B3) and _bwd_dkv_kernel (B4) in
// paddle_tpu/ops/flash_attention.py, launched by _bwd_call on the grids
// (B*H, Sq/128, Sk/128) and (B*H, Sk/128, Sq/128), each carrying its result
// block in VMEM scratch across the innermost, sequential grid axis; they cast
// every operand to float32.  Here that axis is a loop inside a block, and the
// split into two kernels gives every output exactly one writer: no atomics,
// the same bits run to run.
//
// What bounds them on this card: 6*D (B3) and 8*D (B4) multiply-adds' worth
// of operations per (row, key) pair against the operands read once.  On the
// CUDA cores in float32 the arithmetic bounds them; the tensor cores do it in
// bfloat16 faster than the bytes arrive, even at the float32 split below
// (17 and 22 bfloat16 products where 3 and 4 would do).
//
// D = 64 and 128 (flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel) run on
// the tensor cores.  Both are one routine with the roles of rows and keys
// swapped:
//   - B3: one block per (b*h, tile of 64 query rows), walking the key blocks;
//     B4: one block per (b*h, tile of 64 keys), walking the query blocks.
//     Each of 4 warps owns 16 rows of the resident tile (q and do in B3, k
//     and v in B4).  B4 computes S^T = k q^T and dP^T = v do^T directly, so
//     that P^T and dS^T come out in the accumulator layout and no transpose
//     goes through shared memory; its bias is read transposed (row = the
//     walked query, column = the owned key).  With causal, key blocks wholly
//     above a query tile (B3) and query blocks wholly before a key tile (B4)
//     are skipped, the heaviest tile first;
//   - the products run on mma.sync m16n8k16, bfloat16 in, float32
//     accumulated: S and dP from the resident rows (A) and the walked block
//     (B, by ldmatrix), then the second products with the P and dS
//     fragments as A straight from the S and dP accumulators (their layouts
//     agree, mma_common.cuh) and the walked block by ldmatrix.trans as B:
//     dq = dS k in B3, dv = P^T do and dk = dS^T q in B4;
//   - float32 exactness: a float32 operand is split into three bfloat16
//     pieces (split3_pack: hi + mid + lo within 2^-24 of it) as it is staged
//     into shared memory, and P and dS into two (split2_pack: 2^-16) as their
//     fragments are formed; a product takes the piece pairs (i, j) with
//     i + j <= 2, the dropped ones below 2^-24 of it: 6 bfloat16 products for
//     S and dP, 5 for each second product.  In the CPU emulation
//     (tests/test_torch_tensor_core_bwd_numerics.py) two pieces an operand
//     leave up to 0.68 of the 1e-4 tolerance at the card's sizes, three
//     0.16.  bfloat16 operands are exact in one piece (1 product for S and
//     dP, 2 for the second products).  An operand of +-inf or NaN is its
//     own head piece with zeros after it (mma_common.cuh), so the products
//     follow IEEE rules;
//   - the tensor cores' float32 accumulation does not round as IEEE
//     additions do, so the error grows with the products chained into one
//     accumulator.  S and dP take all their small-piece products first
//     (magnitudes 2^-8 of the result) and the hi * hi ones last, which
//     leaves D/16 large ones in the chain; each walked block's share of dq,
//     dk and dv goes into a fresh fragment, small pieces first, that is
//     added to the running float32 sum on the CUDA cores;
//   - staging: a bfloat16 walked block is copied by cp.async straight into
//     shared memory, double-buffered, so the next block's load overlaps this
//     block's products; a float32 one is copied by cp.async into a float32
//     buffer during this block's products and split into its pieces at the
//     top of the next step.  Rows are padded by 16 bytes so that ldmatrix
//     reads without bank conflicts.  The resident tile is staged once
//     (bfloat16 by cp.async; float32 by 16 loads a thread in flight
//     together, then split), and read by ldmatrix each step, or kept as
//     fragments in registers where they fit (bfloat16 at D = 64);
//   - dead rows (lse = -1e30, every score -inf) give P = 0, dS = 0 and dq
//     exactly 0, as in the plain versions.
// Walked blocks are 32 rows (64 in B3 for bfloat16), which keeps the float32
// instances at 99 KB of shared memory (2 blocks an SM) at D = 64.
//
// D = 256 keeps the first design (flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
// B4's two [16 x 256] float32 accumulators a warp would take every register a
// thread has, and B3's float32 resident pieces 203 KB of shared memory.
// Float32 on the CUDA cores: one block per (b*h, tile of 8 rows),
// 32-key (or 32-query) blocks staged as float32, lane c owning key c for S
// and dP, P and dS passed to the second products through warp-private shared
// buffers, where lane c owns head dims c, c + 32, ...  No path of the repo
// trains at D = 256.
//
// Contracts shared with the plain PyTorch versions
// flash_attention_bwd_dq_reference and flash_attention_bwd_dkv_reference in
// paddle_tpu_torch/ops/flash_attention.py, whose wrappers check shapes
// (S % 128 == 0, D in {64, 128, 256}), dtypes and contiguity before a
// launch.  Built by paddle_tpu_torch/native/build.py into a library with a
// plain C interface: each entry point launches on the caller's stream and
// returns cudaGetLastError().

#include "flash_common.cuh"
#include "mma_common.cuh"

#include <type_traits>

namespace {

// ---- D = 64, 128: the tensor-core kernels -----------------------------------

template <typename TQ, int D, bool kDkv>
struct MmaBwd {
  static constexpr bool kF32 = std::is_same<TQ, float>::value;
  static constexpr int kD = D;
  static constexpr int P = kF32 ? 3 : 1;       // bfloat16 pieces an operand
  static constexpr int NWARP = 4, THREADS = NWARP * 32;
  static constexpr int BR = NWARP * 16;        // resident rows a block
  static constexpr int BC = (!kF32 && !kDkv) ? 64 : 32;  // walked rows a step
  static constexpr int LD = D + 8;             // padded shared row (bfloat16)
  static constexpr bool kRegs = !kF32 && D == 64;  // resident A in registers
  static constexpr int NBUF = kF32 ? 1 : 2;    // walked-block buffers
  static constexpr int NT = BC / 8;            // 8-column tiles of S and dP
  static constexpr int ND = D / 8;             // 8-column tiles of the output
  static constexpr int KD = D / 16, KC = BC / 16;  // 16-deep steps
  static constexpr int kResPiece = BR * LD, kBlkPiece = BC * LD;  // bf16
  static constexpr int kRes = 2 * P * kResPiece;                  // bf16
  static constexpr int kBlk = 2 * P * kBlkPiece;                  // bf16
  static constexpr int kStage = kF32 ? 2 * BC * D : 0;            // float
  static constexpr int kSmem = kStage * 4 + (kRes + NBUF * kBlk) * 2;
};

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

// Two ROWS x D tiles (row stride D in device memory) into shared memory as
// [2][P pieces][ROWS][LD] bfloat16: float32 loaded (16 loads a thread in
// flight together), split and stored; bfloat16 copied by cp.async (the
// caller commits).
template <class Sh, int ROWS, typename TQ>
__device__ __forceinline__ void stage_pair(__nv_bfloat16* dst, const TQ* src0,
                                           const TQ* src1, int tid) {
  constexpr int D = Sh::kD, LD = Sh::LD, P = Sh::P;
  if constexpr (Sh::kF32) {
    constexpr int kPer = ROWS * D / 4, kIters = 2 * kPer / Sh::THREADS,
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
    for (int c = tid; c < 2 * kPer; c += Sh::THREADS) {
      const int t = c / kPer, e = c % kPer, r = e / (D / 8),
                col = 8 * (e % (D / 8));
      cp_async16(dst + t * ROWS * LD + r * LD + col,
                 (t ? src1 : src0) + (size_t)r * D + col, 16);
    }
  }
}

// A float32 walked block into the staging buffer [2][BC][D], by cp.async.
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
// of D first, then hi * hi.
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

// Rows g and g + 8 of a warp's 16 as bfloat16 or float32 pairs at row
// stride D: the result tile's store.
template <int ND, typename TQ>
__device__ __forceinline__ void store_rows(TQ* p0, TQ* p1,
                                           const float (&o)[ND][4]) {
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    if constexpr (std::is_same<TQ, float>::value) {
      *reinterpret_cast<float2*>(p0 + j * 8) = make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(p1 + j * 8) = make_float2(o[j][2], o[j][3]);
    } else {
      *reinterpret_cast<uint32_t*>(p0 + j * 8) = pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(p1 + j * 8) = pack_bf16(o[j][2], o[j][3]);
    }
  }
}

// B3 (kDkv false: resident q, do; walked k, v; out0 = dq) and B4 (kDkv true:
// resident k, v; walked q, do; out0 = dk, out1 = dv) on the tensor cores.
template <typename TQ, typename TB, int D, bool kDkv>
__device__ __forceinline__ void bwd_mma(const Args& a) {
  using Sh = MmaBwd<TQ, D, kDkv>;
  constexpr int BR = Sh::BR, BC = Sh::BC, LD = Sh::LD, NT = Sh::NT,
                ND = Sh::ND, KC = Sh::KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);           // [2][BC][D]
  __nv_bfloat16* res =
      reinterpret_cast<__nv_bfloat16*>(stage + Sh::kStage);    // [2][P][BR][LD]
  __nv_bfloat16* blk = res + Sh::kRes;               // [NBUF][2][P][BC][LD]

  const TQ* __restrict__ q = static_cast<const TQ*>(a.q);
  const TQ* __restrict__ k = static_cast<const TQ*>(a.k);
  const TQ* __restrict__ v = static_cast<const TQ*>(a.v);
  const TQ* __restrict__ dout = static_cast<const TQ*>(a.dout);
  const TB* __restrict__ bias = static_cast<const TB*>(a.bias);
  const float sm_scale = a.sm_scale;
  const int H = a.H, Sq = a.Sq, Sk = a.Sk, bias_sq = a.bias_sq,
            causal = a.causal;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // B3: the last query tile reads every key under causal; B4: the first key
  // tile is read by every query.  Heaviest first.
  const int r0 = kDkv ? blockIdx.y * BR : (gridDim.y - 1 - blockIdx.y) * BR;
  const int s_res = kDkv ? Sk : Sq, s_walk = kDkv ? Sq : Sk;
  const TQ* res0 = (kDkv ? k : q) + ((size_t)bh * s_res + r0) * D;
  const TQ* res1 = (kDkv ? v : dout) + ((size_t)bh * s_res + r0) * D;
  const TQ* walk0 = (kDkv ? q : k) + (size_t)bh * s_walk * D;
  const TQ* walk1 = (kDkv ? dout : v) + (size_t)bh * s_walk * D;
  const float* lsep = a.lse + (size_t)bh * Sq;
  const float* deltap = a.delta + (size_t)bh * Sq;
  // walked range: B3 the keys up to the tile's diagonal under causal; B4 the
  // queries from the tile's first key on
  const int w_begin = (kDkv && causal) ? r0 : 0;
  const int w_end = (!kDkv && causal) ? min(Sk, r0 + BR) : s_walk;
  const int n_blocks = max(0, (w_end - w_begin) / BC);

  // this thread's two resident rows (g and g + 8 of its warp's 16)
  const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;
  const TB* bp = bias == nullptr ? nullptr
                                 : bias + (size_t)b * a.bias_sb +
                                       (size_t)h * a.bias_sh;
  const bool key_bias = bias_sq == 0;  // one bias row for every query
  // B3: the two query rows' lse, delta and bias rows; B4: a key mask's two
  // keys (a full bias is read per element, transposed)
  float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f, kb0 = 0.f, kb1 = 0.f;
  const TB* b0 = nullptr;
  const TB* b1 = nullptr;
  if constexpr (!kDkv) {
    lse0 = lsep[row0], lse1 = lsep[row1];
    dl0 = deltap[row0], dl1 = deltap[row1];
    if (bp != nullptr) {
      b0 = bp + (size_t)row0 * bias_sq;
      b1 = bp + (size_t)row1 * bias_sq;
    }
  } else if (bp != nullptr && key_bias) {
    kb0 = to_f32(bp[row0]), kb1 = to_f32(bp[row1]);
  }

  if (n_blocks > 0) {  // the first walked block, and (bf16) the resident tile
    const size_t off = (size_t)w_begin * D;
    if constexpr (Sh::kF32)
      stage_f32<Sh>(stage, reinterpret_cast<const float*>(walk0) + off,
                    reinterpret_cast<const float*>(walk1) + off, tid);
    else
      stage_pair<Sh, BC>(blk, walk0 + off, walk1 + off, tid);
  }
  stage_pair<Sh, BR>(res, res0, res1, tid);
  cp_async_commit();

  // ldmatrix offsets of this lane (see mma_common.cuh): resident rows as A,
  // walked rows as B (non-transposed: n = walked row, k = head dim) and as
  // B transposed (k = walked row, n = head dim)
  const int a_off = (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                    (lane / 16) * 8;
  const int b_off = ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int bt_off = ((lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;

  uint32_t rf0[Sh::kRegs ? Sh::KD : 1][4], rf1[Sh::kRegs ? Sh::KD : 1][4];
  float acc0[ND][4], acc1[kDkv ? ND : 1][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc0[j][e] = 0.f;
      if constexpr (kDkv) acc1[j][e] = 0.f;
    }

  for (int i = 0; i < n_blocks; ++i) {
    const int base = w_begin + i * BC;
    int buf = 0;
    if constexpr (Sh::kF32) {
      cp_async_wait<0>();
      __syncthreads();  // block i staged; every warp is done with block i - 1
      split_stage<Sh>(blk, stage, tid);
      __syncthreads();  // block i's pieces ready; the staging buffer free
      if (i + 1 < n_blocks) {  // the next block's load overlaps this one
        const size_t off = (size_t)(base + BC) * D;
        stage_f32<Sh>(stage, reinterpret_cast<const float*>(walk0) + off,
                      reinterpret_cast<const float*>(walk1) + off, tid);
        cp_async_commit();
      }
    } else {
      buf = i & 1;
      if (i + 1 < n_blocks) {
        const size_t off = (size_t)(base + BC) * D;
        stage_pair<Sh, BC>(blk + (buf ^ 1) * Sh::kBlk, walk0 + off,
                           walk1 + off, tid);
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
        for (int kk = 0; kk < Sh::KD; ++kk) {
          ldmatrix_x4(rf0[kk], res + a_off + kk * 16);
          ldmatrix_x4(rf1[kk], res + Sh::P * Sh::kResPiece + a_off + kk * 16);
        }
      }
    }
    const __nv_bfloat16* wb0 = blk + buf * Sh::kBlk;   // q (B4) or k (B3)
    const __nv_bfloat16* wb1 = wb0 + Sh::P * Sh::kBlkPiece;  // do or v

    // S (B4: S^T) and dP (dP^T) for the warp's 16 rows and the block's BC
    float s[NT][4], dp[NT][4];
    first_product<Sh>(s, res, rf0, wb0, a_off, b_off);
    first_product<Sh>(dp, res + Sh::P * Sh::kResPiece, rf1, wb1, a_off,
                      b_off);

    // P and dS, element by element, as the plain version takes them; then
    // their hi and lo pieces as A fragments: a0 row g, a1 row g + 8 of the
    // first 8-column tile, a2, a3 the same of the second
    uint32_t pf[kDkv ? KC : 1][2][4], dsf[KC][2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = base + j * 8 + 2 * t;  // walked index of c0 (c1: + 1)
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = s[j][e] * sm_scale;
      float l[4], dl[4];
      if constexpr (!kDkv) {
        l[0] = l[1] = lse0, l[2] = l[3] = lse1;
        dl[0] = dl[1] = dl0, dl[2] = dl[3] = dl1;
        if (b0 != nullptr) {
          const float2 bb0 = load2(b0 + col);
          const float2 bb1 = key_bias ? bb0 : load2(b1 + col);
          x[0] += bb0.x, x[1] += bb0.y, x[2] += bb1.x, x[3] += bb1.y;
        }
        if (causal) {
          if (col > row0) x[0] = kNegInf;
          if (col + 1 > row0) x[1] = kNegInf;
          if (col > row1) x[2] = kNegInf;
          if (col + 1 > row1) x[3] = kNegInf;
        }
      } else {
        const float2 lq = __ldg(reinterpret_cast<const float2*>(lsep + col));
        const float2 dd =
            __ldg(reinterpret_cast<const float2*>(deltap + col));
        l[0] = l[2] = lq.x, l[1] = l[3] = lq.y;
        dl[0] = dl[2] = dd.x, dl[1] = dl[3] = dd.y;
        if (bp != nullptr) {
          if (key_bias) {
            x[0] += kb0, x[1] += kb0, x[2] += kb1, x[3] += kb1;
          } else {  // the bias tile transposed: row = query, column = key
            const TB* bq = bp + (size_t)col * bias_sq;
            x[0] += to_f32(bq[row0]);
            x[1] += to_f32(bq[bias_sq + row0]);
            x[2] += to_f32(bq[row1]);
            x[3] += to_f32(bq[bias_sq + row1]);
          }
        }
        if (causal) {
          if (row0 > col) x[0] = kNegInf;
          if (row0 > col + 1) x[1] = kNegInf;
          if (row1 > col) x[2] = kNegInf;
          if (row1 > col + 1) x[3] = kNegInf;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(x[e] - l[e]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl[e]) * sm_scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 2 * kk + e / 2, c = 2 * (e % 2);
        split2_pack(dp[j][c], dp[j][c + 1], dsf[kk][0][e], dsf[kk][1][e]);
        if constexpr (kDkv)
          split2_pack(s[j][c], s[j][c + 1], pf[kk][0][e], pf[kk][1][e]);
      }

    // B3: dq += dS k.  B4: dk += dS^T q, dv += P^T do.
    second_product<Sh>(acc0, dsf, wb0, bt_off);
    if constexpr (kDkv) second_product<Sh>(acc1, pf, wb1, bt_off);
    if constexpr (!Sh::kF32) __syncthreads();  // the next load overwrites it
  }
  cp_async_wait<0>();  // a tile staged for no walked block

  const size_t o0 = ((size_t)bh * s_res + row0) * D + 2 * t;
  const size_t o1 = o0 + 8 * D;
  TQ* out0 = static_cast<TQ*>(kDkv ? a.dk : a.dq);
  store_rows<ND>(out0 + o0, out0 + o1, acc0);
  if constexpr (kDkv) {
    TQ* out1 = static_cast<TQ*>(a.dv);
    store_rows<ND>(out1 + o0, out1 + o1, acc1);
  }
}

// B3: dq of one (b*h, tile of 64 query rows).
template <typename TQ, typename TB, int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_mma_kernel(const Args a) {
  bwd_mma<TQ, TB, D, false>(a);
}

// B4: dk and dv of one (b*h, tile of 64 keys).
template <typename TQ, typename TB, int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_mma_kernel(const Args a) {
  bwd_mma<TQ, TB, D, true>(a);
}

template <typename TQ, typename TB, int D, bool kDkv>
cudaError_t launch_mma(const Args& a) {
  using Sh = MmaBwd<TQ, D, kDkv>;
  auto kernel = flash_bwd_dq_mma_kernel<TQ, TB, D>;
  if constexpr (kDkv) kernel = flash_bwd_dkv_mma_kernel<TQ, TB, D>;
  const cudaError_t e = allow_smem(kernel, Sh::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.B * a.H, (kDkv ? a.Sk : a.Sq) / Sh::BR), Sh::THREADS,
           Sh::kSmem, a.stream>>>(a);
  return cudaGetLastError();
}

// ---- D = 256: the first design, float32 on the CUDA cores -------------------

template <int VPT>
struct BwdShape {
  static constexpr int D = Shape<VPT>::D, RPW = Shape<VPT>::RPW,
                       BR = Shape<VPT>::BR, KS = Shape<VPT>::KS;
  // B3: q, do [BR][D]; k, v [BC][KS]; dS [BR][BC]
  static constexpr int kSmemDq =
      (2 * BR * D + 2 * BC * KS + BR * BC) * sizeof(float);
  // B4: k, v [BR][D]; q, do [BC][KS]; P, dS [BR][BC]; lse, delta [BC]
  static constexpr int kSmemDkv =
      (2 * BR * D + 2 * BC * KS + 2 * BR * BC + 2 * BC) * sizeof(float);
};

// ROWS rows of D elements, contiguous in device memory, into shared memory
// as float32 with a row stride of STRIDE floats.
template <typename T, int ROWS, int D, int STRIDE>
__device__ __forceinline__ void stage(float* dst, const T* src, int tid) {
  for (int e = tid; e < ROWS * D / 4; e += NW * 32) {
    const int r = e / (D / 4), d = 4 * (e % (D / 4));
    *reinterpret_cast<float4*>(&dst[r * STRIDE + d]) =
        load4(src + (size_t)r * D + d);
  }
}

// acc[i][j] += sum_c w[row i][c] * x[c][lane + 32 j]: the second products
// (dS k, P^T do, dS^T q), lane owning head dims lane, lane + 32, ...
template <int RPW, int VPT, int XS>
__device__ __forceinline__ void accumulate(float (&acc)[RPW][VPT],
                                           const float* w_rows,
                                           const float* x_s, int lane) {
#pragma unroll 2
  for (int c = 0; c < BC; c += 4) {
    float xx[4][VPT];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < VPT; ++j) xx[u][j] = x_s[(c + u) * XS + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float4 w4 = *reinterpret_cast<const float4*>(&w_rows[i * BC + c]);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        acc[i][j] = fmaf(w4.x, xx[0][j], acc[i][j]);
        acc[i][j] = fmaf(w4.y, xx[1][j], acc[i][j]);
        acc[i][j] = fmaf(w4.z, xx[2][j], acc[i][j]);
        acc[i][j] = fmaf(w4.w, xx[3][j], acc[i][j]);
      }
    }
  }
}

// B3: dq of one (b*h, tile of BR query rows).
template <typename TQ, typename TB, int VPT>
__global__ void __launch_bounds__(NW * 32)
    flash_bwd_dq_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                        const TQ* __restrict__ v, const TB* __restrict__ bias,
                        const TQ* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, TQ* __restrict__ dq,
                        int H, int Sq, int Sk, int bias_sb, int bias_sh,
                        int bias_sq, float sm_scale, int causal) {
  using Sh = BwdShape<VPT>;
  constexpr int D = Sh::D, RPW = Sh::RPW, BR = Sh::BR, KS = Sh::KS;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // [BR][D]
  float* do_s = q_s + BR * D;     // [BR][D]
  float* k_s = do_s + BR * D;     // [BC][KS]
  float* v_s = k_s + BC * KS;     // [BC][KS]
  float* ds_s = v_s + BC * KS;    // [NW][RPW][BC]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // heaviest tile first: under causal the last tile reads every key
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const TQ* kp = k + (size_t)bh * Sk * D;
  const TQ* vp = v + (size_t)bh * Sk * D;
  const TB* bp = bias == nullptr
                     ? nullptr
                     : bias + (size_t)b * bias_sb + (size_t)h * bias_sh;

  stage<TQ, BR, D, D>(q_s, q + ((size_t)bh * Sq + r0) * D, tid);
  stage<TQ, BR, D, D>(do_s, dout + ((size_t)bh * Sq + r0) * D, tid);

  float lse_r[RPW], delta_r[RPW], acc[RPW][VPT];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const size_t row = (size_t)bh * Sq + r0 + warp * RPW + i;
    lse_r[i] = lse[row];
    delta_r[i] = delta[row];
#pragma unroll
    for (int j = 0; j < VPT; ++j) acc[i][j] = 0.f;
  }
  float* ds_w = ds_s + warp * RPW * BC;

  const int k_end = causal ? min(Sk, r0 + BR) : Sk;
  for (int base = 0; base < k_end; base += BC) {
    stage<TQ, BC, D, KS>(k_s, kp + (size_t)base * D, tid);
    stage<TQ, BC, D, KS>(v_s, vp + (size_t)base * D, tid);
    __syncthreads();  // also orders the q and do tiles before their first use

    float sc[RPW], dp[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&k_s[lane * KS + d]);
      const float4 v4 = *reinterpret_cast<const float4*>(&v_s[lane * KS + d]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = (warp * RPW + i) * D + d;
        const float4 q4 = *reinterpret_cast<const float4*>(&q_s[r]);
        const float4 o4 = *reinterpret_cast<const float4*>(&do_s[r]);
        sc[i] = fmaf(q4.x, k4.x, sc[i]);
        sc[i] = fmaf(q4.y, k4.y, sc[i]);
        sc[i] = fmaf(q4.z, k4.z, sc[i]);
        sc[i] = fmaf(q4.w, k4.w, sc[i]);
        dp[i] = fmaf(o4.x, v4.x, dp[i]);
        dp[i] = fmaf(o4.y, v4.y, dp[i]);
        dp[i] = fmaf(o4.z, v4.z, dp[i]);
        dp[i] = fmaf(o4.w, v4.w, dp[i]);
      }
    }
    const int key = base + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = r0 + warp * RPW + i;
      float x = sc[i] * sm_scale;
      if (bp != nullptr) x += to_f32(bp[(size_t)row * bias_sq + key]);
      if (causal && key > row) x = kNegInf;
      const float p = expf(x - lse_r[i]);
      ds_w[i * BC + lane] = p * (dp[i] - delta_r[i]) * sm_scale;
    }
    __syncwarp();
    accumulate<RPW, VPT, KS>(acc, ds_w, k_s, lane);
    __syncthreads();  // the next block overwrites k_s, v_s and ds_s
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    TQ* op = dq + ((size_t)bh * Sq + r0 + warp * RPW + i) * D;
#pragma unroll
    for (int j = 0; j < VPT; ++j) op[lane + 32 * j] = from_f32<TQ>(acc[i][j]);
  }
}

// B4: dk and dv of one (b*h, tile of BR keys).
template <typename TQ, typename TB, int VPT>
__global__ void __launch_bounds__(NW * 32)
    flash_bwd_dkv_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                         const TQ* __restrict__ v, const TB* __restrict__ bias,
                         const TQ* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, TQ* __restrict__ dk,
                         TQ* __restrict__ dv, int H, int Sq, int Sk,
                         int bias_sb, int bias_sh, int bias_sq, float sm_scale,
                         int causal) {
  using Sh = BwdShape<VPT>;
  constexpr int D = Sh::D, RPW = Sh::RPW, BR = Sh::BR, KS = Sh::KS;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;               // [BR][D]
  float* v_s = k_s + BR * D;       // [BR][D]
  float* q_s = v_s + BR * D;       // [BC][KS]
  float* do_s = q_s + BC * KS;     // [BC][KS]
  float* p_s = do_s + BC * KS;     // [NW][RPW][BC]
  float* ds_s = p_s + BR * BC;     // [NW][RPW][BC]
  float* lse_s = ds_s + BR * BC;   // [BC]
  float* delta_s = lse_s + BC;     // [BC]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // under causal the first key tile is read by every query: heaviest first
  const int k0 = blockIdx.y * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const TQ* qp = q + (size_t)bh * Sq * D;
  const TQ* dop = dout + (size_t)bh * Sq * D;
  const float* lsep = lse + (size_t)bh * Sq;
  const float* deltap = delta + (size_t)bh * Sq;
  const TB* bp = bias == nullptr
                     ? nullptr
                     : bias + (size_t)b * bias_sb + (size_t)h * bias_sh;

  stage<TQ, BR, D, D>(k_s, k + ((size_t)bh * Sk + k0) * D, tid);
  stage<TQ, BR, D, D>(v_s, v + ((size_t)bh * Sk + k0) * D, tid);

  float acc_k[RPW][VPT], acc_v[RPW][VPT];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < VPT; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  float* p_w = p_s + warp * RPW * BC;
  float* ds_w = ds_s + warp * RPW * BC;

  // query blocks wholly before the key tile see none of its keys
  const int q_begin = causal ? k0 / BC * BC : 0;
  for (int base = q_begin; base < Sq; base += BC) {
    stage<TQ, BC, D, KS>(q_s, qp + (size_t)base * D, tid);
    stage<TQ, BC, D, KS>(do_s, dop + (size_t)base * D, tid);
    if (tid < BC) {
      lse_s[tid] = lsep[base + tid];
      delta_s[tid] = deltap[base + tid];
    }
    __syncthreads();  // also orders the k and v tiles before their first use

    float sc[RPW], dp[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(&q_s[lane * KS + d]);
      const float4 o4 = *reinterpret_cast<const float4*>(&do_s[lane * KS + d]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = (warp * RPW + i) * D + d;
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[r]);
        const float4 v4 = *reinterpret_cast<const float4*>(&v_s[r]);
        sc[i] = fmaf(q4.x, k4.x, sc[i]);
        sc[i] = fmaf(q4.y, k4.y, sc[i]);
        sc[i] = fmaf(q4.z, k4.z, sc[i]);
        sc[i] = fmaf(q4.w, k4.w, sc[i]);
        dp[i] = fmaf(o4.x, v4.x, dp[i]);
        dp[i] = fmaf(o4.y, v4.y, dp[i]);
        dp[i] = fmaf(o4.z, v4.z, dp[i]);
        dp[i] = fmaf(o4.w, v4.w, dp[i]);
      }
    }
    const int row = base + lane;  // this lane's query
    const float lse_q = lse_s[lane], delta_q = delta_s[lane];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int key = k0 + warp * RPW + i;
      float x = sc[i] * sm_scale;
      // the bias tile transposed: its row is the staged query, its column
      // the key this warp owns
      if (bp != nullptr) x += to_f32(bp[(size_t)row * bias_sq + key]);
      if (causal && key > row) x = kNegInf;
      const float p = expf(x - lse_q);
      p_w[i * BC + lane] = p;
      ds_w[i * BC + lane] = p * (dp[i] - delta_q) * sm_scale;
    }
    __syncwarp();
    accumulate<RPW, VPT, KS>(acc_v, p_w, do_s, lane);
    accumulate<RPW, VPT, KS>(acc_k, ds_w, q_s, lane);
    __syncthreads();  // the next block overwrites the staged buffers
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const size_t off = ((size_t)bh * Sk + k0 + warp * RPW + i) * D;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      dk[off + lane + 32 * j] = from_f32<TQ>(acc_k[i][j]);
      dv[off + lane + 32 * j] = from_f32<TQ>(acc_v[i][j]);
    }
  }
}

// D = 64 and 128 on the tensor cores, D = 256 (VPT 8) on the CUDA cores.
template <typename TQ, typename TB, int VPT>
struct LaunchDq {
  static cudaError_t run(const Args& a) {
    if constexpr (VPT <= 4) {
      return launch_mma<TQ, TB, 32 * VPT, false>(a);
    } else {
      using Sh = BwdShape<VPT>;
      const auto kernel = flash_bwd_dq_kernel<TQ, TB, VPT>;
      const cudaError_t e = allow_smem(kernel, Sh::kSmemDq);
      if (e != cudaSuccess) return e;
      kernel<<<dim3(a.B * a.H, a.Sq / Sh::BR), NW * 32, Sh::kSmemDq,
               a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
          static_cast<const TQ*>(a.v), static_cast<const TB*>(a.bias),
          static_cast<const TQ*>(a.dout), a.lse, a.delta,
          static_cast<TQ*>(a.dq), a.H, a.Sq, a.Sk, a.bias_sb, a.bias_sh,
          a.bias_sq, a.sm_scale, a.causal);
      return cudaGetLastError();
    }
  }
};

template <typename TQ, typename TB, int VPT>
struct LaunchDkv {
  static cudaError_t run(const Args& a) {
    if constexpr (VPT <= 4) {
      return launch_mma<TQ, TB, 32 * VPT, true>(a);
    } else {
      using Sh = BwdShape<VPT>;
      const auto kernel = flash_bwd_dkv_kernel<TQ, TB, VPT>;
      const cudaError_t e = allow_smem(kernel, Sh::kSmemDkv);
      if (e != cudaSuccess) return e;
      kernel<<<dim3(a.B * a.H, a.Sk / Sh::BR), NW * 32, Sh::kSmemDkv,
               a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
          static_cast<const TQ*>(a.v), static_cast<const TB*>(a.bias),
          static_cast<const TQ*>(a.dout), a.lse, a.delta,
          static_cast<TQ*>(a.dk), static_cast<TQ*>(a.dv), a.H, a.Sq, a.Sk,
          a.bias_sb, a.bias_sh, a.bias_sq, a.sm_scale, a.causal);
      return cudaGetLastError();
    }
  }
};

Args bwd_args(const void* q, const void* k, const void* v, const void* bias,
              const void* dout, const float* lse, const float* delta, int B,
              int H, int Sq, int Sk, int D, int bias_sb, int bias_sh,
              int bias_sq, float sm_scale, int causal, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.dout = dout;
  a.lse = const_cast<float*>(lse), a.delta = delta;
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.D = D;
  a.bias_sb = bias_sb, a.bias_sh = bias_sh, a.bias_sq = bias_sq;
  a.sm_scale = sm_scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

extern "C" {

const char* paddle_flash_bwd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B3.  Strides in elements (0 along the bias's broadcast dims).  Returns
// cudaGetLastError() after the launch.
int paddle_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* bias, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq, int B, int H, int Sq, int Sk,
                                  int D, int bias_sb, int bias_sh, int bias_sq,
                                  float sm_scale, int causal, int q_dtype,
                                  int bias_dtype, void* stream) {
  Args a = bwd_args(q, k, v, bias, dout, lse, delta, B, H, Sq, Sk, D, bias_sb,
                    bias_sh, bias_sq, sm_scale, causal, stream);
  a.dq = dq;
  return dispatch<LaunchDq>(a, q_dtype, bias_dtype);
}

// B4.
int paddle_flash_attention_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   int B, int H, int Sq, int Sk, int D,
                                   int bias_sb, int bias_sh, int bias_sq,
                                   float sm_scale, int causal, int q_dtype,
                                   int bias_dtype, void* stream) {
  Args a = bwd_args(q, k, v, bias, dout, lse, delta, B, H, Sq, Sk, D, bias_sb,
                    bias_sh, bias_sq, sm_scale, causal, stream);
  a.dk = dk, a.dv = dv;
  return dispatch<LaunchDkv>(a, q_dtype, bias_dtype);
}

}  // extern "C"
