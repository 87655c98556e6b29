// Paged decode attention and paged chunk attention for Hopper (sm_90a).
//
// Two kernels read one layer's K/V page pool straight through a slot's page
// table, with an online softmax across the live positions:
//
//   paged_decode_kernel      one query row per slot        q   [S, H, D]
//   paged_chunk_mma_kernel   R query rows per slot, each   q   [S, R, H, D]
//                            row with its own causal length
//
//   k/v pages  [P, page, H, D]  float32, bfloat16, or int8 with
//   k/v scales [P, page, H]     float32 (one scale per position and head)
//   page_table [S, pps] int32, lengths [S] / row lengths [S, R] int32
//   out        q's shape and dtype; every sum is taken in float32
//
// Contract shared with the plain PyTorch versions in
// paddle_tpu_torch/ops/paged_attention.py: position t of a row takes part
// iff t < length (lengths are clamped to pps * page, the width of the page
// table); a row with no live position returns 0 (the TPU kernels' l == 0
// guard); int8 elements are multiplied by their scale in registers, so
// float K/V never exists in device memory.  Table entries past the live
// pages of a slot's widest row (the trash page 0, or stale ids) are never
// read.
//
// Split over positions (flash-decoding), planned by the wrapper from shapes
// alone (ops/paged_attention.py plan_split; no length is read on the host):
// a row's walk [0, length) is cut into ranges of `chunk` positions, whole
// pages, and range i is taken by split i, a block of its own.  A block whose
// range starts at or past its length (B6: its tile's widest row) exits at
// once.  A row of at most `chunk` positions is finished by split 0, which
// writes its output.  A longer row's live splits each write a partial
// (m, l, acc[D]) to a float32 workspace [rows, H, nsplit, D + 4], and
// paged_combine_kernel, launched right after on the same stream, merges the
// partials of those rows only (it reads the lengths on the device).  A
// second small kernel and not a "last block to arrive" counter: it needs no
// zeroed state between calls (the workspace comes from torch.empty), stays
// deterministic, and is safe when replicas launch on several streams at
// once.  With nsplit == 1 no workspace exists and no combine runs.
//
// Built by paddle_tpu_torch/native/build.py into a library with a plain C
// interface: each entry point launches on the caller's stream and returns
// cudaGetLastError().

#include "mma_common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' running-max start
constexpr float kLog2e = 1.4426950408889634f;

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// A masked score: -inf, so that exp2(score - m) is 0 even while the running
// max is still -1e30 (a row with nothing live yet).
__device__ __forceinline__ float masked() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 4 bytes global -> shared by cp.async (zero-filled past src_bytes).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 16 bytes of a pool row: N elements of T.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Pack<int8_t> {
  static constexpr int N = 16;
};

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x), x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z), x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[4 * i + b] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * b)));
}

// ---------------------------------------------------------------------------
// B5: paged decode attention.
//
// Replaces _decode_kernel in paddle_tpu/ops/pallas_decode_attention.py (the
// TPU grid (slot, page) that carries m, l and acc across pages in VMEM).
//
// What bounds it on this card: device memory.  A call must read the live
// K/V of every slot once (2 * length * H * D elements a slot) and does ~4
// operations per element it reads; one query row gives the tensor cores
// nothing to do, so it stays on the CUDA cores in float32.  What the design
// does about it:
//   - grid (split, head, slot): the positions are split across blocks (see
//     the plan above), so a few long slots still fill the card's 132 SMs;
//   - each position's row of one head (D elements) is read by a group of
//     LPR = D * sizeof(T) / 16 lanes with one 16-byte load each, so a warp
//     load covers 32 / LPR neighbouring positions (f32 D = 64: 2, bf16 4,
//     int8 8), and a lane keeps U = 4 K and 4 V loads in flight;
//   - the dot product is reduced inside the lane group (log2(LPR)
//     shuffles); the split's page ids are read once into shared memory;
//     an int8 row's two scales are read once per (position, head), k's
//     applied to the score after the product and v's folded into p;
//   - scores are kept in base-2 units (log2(e) folded into q) and each lane
//     group runs its own online softmax; the groups, then the 4 warps, are
//     merged at the end.
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecUnroll = 4;        // K (and V) loads a lane keeps in flight
constexpr int kMaxSplitPages = 64;   // page ids of a split, in shared memory

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kDecWarps * 32)
    paged_decode_kernel(const TQ* __restrict__ q,
                        const TKV* __restrict__ k_pages,
                        const TKV* __restrict__ v_pages,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
                        const int* __restrict__ page_table,
                        const int* __restrict__ lengths, TQ* __restrict__ out,
                        float* __restrict__ ws, int H, int page, int pps,
                        int nsplit, int chunk, float sm_scale) {
  constexpr int EPL = Pack<TKV>::N;   // elements a lane loads
  constexpr int LPR = D / EPL;        // lanes a row
  constexpr int RPW = 32 / LPR;       // rows a warp load
  constexpr int U = kDecUnroll;
  constexpr int STEP = kDecWarps * RPW * U;  // positions a block step
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row lanes");
  __shared__ int pid_s[kMaxSplitPages];
  __shared__ float sm_m[kDecWarps], sm_l[kDecWarps];
  __shared__ float sm_acc[kDecWarps][D];

  const int split = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  const int len = max(0, min(lengths[s], pps * page));
  const int start = split * chunk;
  if (split > 0 && start >= len) return;  // an empty range
  const int end = min(len, start + chunk);
  const int* table = page_table + (size_t)s * pps + start / page;
  const int npg = (end - start + page - 1) / page;
  for (int i = tid; i < npg; i += kDecWarps * 32) pid_s[i] = table[i];

  const float qk_scale = sm_scale * kLog2e;
  const TQ* qp = q + ((size_t)s * H + h) * D + sub * EPL;
  float qv[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) qv[j] = to_f32(qp[j]) * qk_scale;
  __syncthreads();

  float m = kNegInf, l = 0.f, acc[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) acc[j] = 0.f;

  for (int base = start + warp * RPW * U; base < end; base += STEP) {
    uint4 kr[U], vr[U];
    float ks[U], vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * RPW + grp;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ks[u] = vs[u] = 0.f;
      if (t < end) {
        const int off = t - start;
        const size_t row =
            ((size_t)pid_s[off / page] * page + off % page) * H + h;
        kr[u] = ldg16(k_pages + row * D + sub * EPL);
        vr[u] = ldg16(v_pages + row * D + sub * EPL);
        if constexpr (kQuant) {
          ks[u] = __ldg(k_scales + row);
          vs[u] = __ldg(v_scales + row);
        }
      }
    }
    float sc[U];
    float mx = masked();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      unpack(kr[u], kf);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < EPL; ++j) part = fmaf(qv[j], kf[j], part);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if constexpr (kQuant) part *= ks[u];
      sc[u] = base + u * RPW + grp < end ? part : masked();
      mx = fmaxf(mx, sc[u]);
    }
    const float mn = fmaxf(m, mx), alpha = exp2f(m - mn);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = exp2f(sc[u] - mn);  // 0 where masked
      l += p;
      const float pv = kQuant ? p * vs[u] : p;
      float vf[EPL];
      unpack(vr[u], vf);
#pragma unroll
      for (int j = 0; j < EPL; ++j) acc[j] = fmaf(pv, vf[j], acc[j]);
    }
    m = mn;
  }

  // merge the warp's lane groups, then the block's warps
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, mo), a = exp2f(m - mn), b = exp2f(mo - mn);
    l = l * a + lo * b;
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      acc[j] = acc[j] * a + __shfl_xor_sync(0xffffffffu, acc[j], o) * b;
    m = mn;
  }
  if (lane == 0) sm_m[warp] = m, sm_l[warp] = l;
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < EPL; ++j) sm_acc[warp][sub * EPL + j] = acc[j];
  }
  __syncthreads();
  if (tid >= D) return;
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float L = 0.f, A = 0.f;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) {
    const float c = exp2f(sm_m[w] - mx);
    L += sm_l[w] * c;
    A += sm_acc[w][tid] * c;
  }
  if (len <= chunk) {  // split 0 holds the whole row: no live position, 0
    out[((size_t)s * H + h) * D + tid] = from_f32<TQ>(L == 0.f ? 0.f : A / L);
  } else {
    float* p = ws + (((size_t)s * H + h) * nsplit + split) * (D + 4);
    p[tid] = A;
    if (tid == 0) p[D] = mx, p[D + 1] = L;
  }
}

// ---------------------------------------------------------------------------
// The merge of the splits' partials (B5 and B6): one warp per (row, head)
// whose row is longer than `chunk`; lane l owns head dims l, l + 32, ...
// Reads the live splits only (ceil(length / chunk) of them).
// ---------------------------------------------------------------------------

template <typename TQ, int D>
__global__ void __launch_bounds__(128)
    paged_combine_kernel(const float* __restrict__ ws,
                         const int* __restrict__ lengths,
                         TQ* __restrict__ out, int rows, int H, int cap,
                         int nsplit, int chunk) {
  constexpr int VPT = D / 32;
  const int idx = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (idx >= rows * H) return;
  const int len = max(0, min(lengths[idx / H], cap));
  if (len <= chunk) return;  // finished by split 0
  const int n = min(nsplit, (len + chunk - 1) / chunk);
  const float* p = ws + (size_t)idx * nsplit * (D + 4);
  float mx = kNegInf;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, p[(size_t)i * (D + 4) + D]);
  mx = warp_max(mx);
  // lane i weighs partial b + i; each lane's accumulator slices of 8
  // partials are loaded together
  float L = 0.f, a[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) a[j] = 0.f;
  for (int b = 0; b < n; b += 32) {
    const int cnt = min(32, n - b);
    float c = 0.f, lw = 0.f;
    if (lane < cnt) {
      const float* pi = p + (size_t)(b + lane) * (D + 4);
      c = exp2f(pi[D] - mx);
      lw = pi[D + 1] * c;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lw += __shfl_xor_sync(~0u, lw, o);
    L += lw;
    for (int u0 = 0; u0 < cnt; u0 += 8) {
      float v[8][VPT];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < VPT; ++j)
          v[u][j] = u0 + u < cnt
                        ? p[(size_t)(b + u0 + u) * (D + 4) + lane + 32 * j]
                        : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float cu = __shfl_sync(~0u, c, u0 + u);
#pragma unroll
        for (int j = 0; j < VPT; ++j) a[j] = fmaf(v[u][j], cu, a[j]);
      }
    }
  }
  TQ* o = out + (size_t)idx * D;
#pragma unroll
  for (int j = 0; j < VPT; ++j) o[lane + 32 * j] = from_f32<TQ>(a[j] / L);
}

// ---------------------------------------------------------------------------
// B6: paged chunk attention.
//
// Replaces _chunk_kernel in paddle_tpu/ops/pallas_decode_attention.py (B5
// with R query rows per slot and per-row causal lengths; its page skip is
// taken over the widest row).
//
// What bounds it on this card: the score and P V products where many rows
// share the positions (a whole-prompt prefill, R = 128 .. 1024, and the
// chunked prefill's 128-row chunks); device memory where few rows do (a
// prefix-hit suffix of a few rows, speculative verify at R = 4).  On the
// CUDA cores float32 arithmetic bounded the first; on the tensor cores the
// design's bfloat16 products (below) still bound the largest prefills (R >=
// 512 with a float32 pool) and the bytes bound the rest.  What the design
// does about it
// (paged_chunk_mma_kernel, a paged variant of B2's flash_fwd_mma_kernel in
// flash_attention.cu, on mma.sync m16n8k16, bfloat16 in, float32
// accumulated):
//   - one block per (tile of query rows, split, head, slot), a warp per 16
//     rows, the heaviest tile first: 64 rows (4 warps, two blocks an SM)
//     for calls of up to 64 rows, else 128 (8 warps, one block an SM: a
//     staged key block serves twice the rows); rows past R are rows of
//     length 0, and a warp with no row below R, or none reaching the
//     current key block, skips the products (it still stages);
//   - key blocks of BC = 32 positions (two pages at page 16), staged by
//     cp.async through the page table (a position's row of head h sits at
//     stride H * D in its page): a bfloat16 pool straight into the padded
//     bfloat16 tile, double-buffered, the next block's copy issued before
//     this block's products; a float32 or int8 pool into one staging
//     buffer, the next block's copy issued once this block is converted
//     (float32 split into three bfloat16 pieces, split3_pack: within
//     2^-24; int8 is exact in bfloat16, one piece, and its scales come
//     along).  A second staging buffer, to keep two blocks in flight, did
//     not shorten a step on the H100 (PERF.md, section 6);
//   - S = q k^T takes the piece pairs (i, j) with i + j < max(pieces), the
//     small ones first and hi * hi last (q: three pieces if float32, one if
//     bfloat16; K: three for a float32 pool, one for bfloat16 and int8); an
//     int8 score column is multiplied by its k scale after the product;
//   - the per-row causal mask is applied only in the key blocks that cross
//     a row's length (or the split's end); masked scores are -inf;
//   - P (with an int8 row's v scale folded in) is split into two pieces
//     (split2_pack: within 2^-16; one bfloat16 rounding of P misses the
//     float32 tolerance) and P V is summed in a fresh fragment for each key
//     block, added in float32 (the tensor cores' accumulation is not IEEE):
//     6 + 5 products a (row, position) for float32 q over a float32 pool,
//     3 + 5 for bfloat16 q over it, 3 + 2 for float32 q over bfloat16 or
//     int8, 1 + 2 for bfloat16 q over them;
//   - where (tiles x heads x slots) is under three rounds of the blocks the
//     132 SMs hold, the walk of each tile is split over positions (the plan
//     above), which also cuts the heaviest tiles of a long causal prefill
//     into pieces.
// ---------------------------------------------------------------------------

template <typename TQ, typename TKV, int D, int NW>
struct PagedMma {
  static constexpr bool kQF32 = std::is_same<TQ, float>::value;
  static constexpr bool kF32 = std::is_same<TKV, float>::value;
  static constexpr bool kI8 = std::is_same<TKV, int8_t>::value;
  // float32 and int8 pools land raw in a staging buffer first
  static constexpr bool kStaged = !std::is_same<TKV, __nv_bfloat16>::value;
  static constexpr int kD = D;
  static constexpr int PQ = kQF32 ? 3 : 1;  // bfloat16 pieces of q
  static constexpr int P = kF32 ? 3 : 1;    // bfloat16 pieces of K and V
  static constexpr int NWARP = NW, THREADS = NWARP * 32;
  static constexpr int MIN_BLOCKS = NW == 4 ? 2 : 1;  // an SM
  static constexpr int BR = NWARP * 16;       // query rows a tile
  static constexpr int BC = 32;               // positions a key block
  static constexpr int LD = D + 8;            // padded shared row (bfloat16)
  static constexpr bool kQRegs = PQ == 1;     // q fragments in registers
  static constexpr int NBUF = kStaged ? 1 : 2;  // bfloat16 key blocks
  static constexpr int NT = BC / 8, ND = D / 8;   // 8-wide tiles
  static constexpr int KD = D / 16, KC = BC / 16;  // 16-deep steps
  static constexpr int kResPiece = BR * LD, kBlkPiece = BC * LD;  // bf16
  static constexpr int kBlk = 2 * P * kBlkPiece;  // bf16: a key block's k, v
  static constexpr int kRowChunks = D * (int)sizeof(TKV) / 16;  // a row's
  static constexpr int kChunks = 2 * BC * kRowChunks;  // 16 B: k, v block
  static constexpr int kStage = kStaged ? 2 * BC * D * (int)sizeof(TKV) : 0;
  static constexpr int kScales = kI8 ? 4 * BC * 4 : 0;  // staged, converted
  static constexpr int kSmem = kStage + kScales + (PQ * kResPiece +
                                                   NBUF * kBlk) * 2;
};

template <typename TQ, typename TKV, int D, int NW>
__global__ void __launch_bounds__(PagedMma<TQ, TKV, D, NW>::THREADS,
                                  PagedMma<TQ, TKV, D, NW>::MIN_BLOCKS)
    paged_chunk_mma_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ k_pages,
                           const TKV* __restrict__ v_pages,
                           const float* __restrict__ k_scales,
                           const float* __restrict__ v_scales,
                           const int* __restrict__ page_table,
                           const int* __restrict__ row_lengths,
                           TQ* __restrict__ out, float* __restrict__ ws,
                           int R, int H, int page, int pps, int nsplit,
                           int chunk, float sm_scale) {
  using Sh = PagedMma<TQ, TKV, D, NW>;
  constexpr int PQ = Sh::PQ, P = Sh::P, BR = Sh::BR, BC = Sh::BC,
                LD = Sh::LD, NT = Sh::NT, ND = Sh::ND, KD = Sh::KD,
                KC = Sh::KC, THREADS = Sh::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* stage = reinterpret_cast<TKV*>(smem_raw);   // [2: k, v][BC][D] raw
  float* sc_stage = reinterpret_cast<float*>(smem_raw + Sh::kStage);
  float* sc_blk = sc_stage + 2 * BC;  // k scale * qk_scale, v scale
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + Sh::kStage + Sh::kScales);             // [PQ][BR][LD]
  __nv_bfloat16* blk = q_s + PQ * Sh::kResPiece;   // [NBUF][2][P][BC][LD]
  __shared__ int red[Sh::NWARP];

  const int n_tiles = (R + BR - 1) / BR;
  const int tile = n_tiles - 1 - blockIdx.x / nsplit;  // heaviest first
  const int split = blockIdx.x % nsplit;
  const int h = blockIdx.y, s = blockIdx.z;
  const int r0 = tile * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int cap = pps * page;
  const int* table = page_table + (size_t)s * pps;
  const int* lens = row_lengths + (size_t)s * R;

  // the q tile (rows past R are zeros) is loaded first: its loads overlap
  // the lengths' and the page table's
  const TQ* qb = q + ((size_t)s * R * H + h) * D;
  constexpr int kQIt = Sh::kQF32 ? BR * D / 4 / THREADS : 1;
  float4 qx[kQIt];
  if constexpr (Sh::kQF32) {
#pragma unroll
    for (int n = 0; n < kQIt; ++n) {
      const int c = tid + n * THREADS, r = c / (D / 4), col = 4 * (c % (D / 4));
      qx[n] = r0 + r < R ? __ldg(reinterpret_cast<const float4*>(
                               qb + (size_t)(r0 + r) * H * D + col))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int c = tid; c < BR * D / 8; c += THREADS) {
      const int r = c / (D / 8), col = 8 * (c % (D / 8));
      const bool ok = r0 + r < R;
      cp_async16(q_s + r * LD + col,
                 ok ? qb + (size_t)(r0 + r) * H * D + col : qb, ok ? 16 : 0);
    }
  }

  // the tile's widest row bounds the positions its blocks read
  int lr = 0;
  if (tid < BR && r0 + tid < R) lr = max(0, min(lens[r0 + tid], cap));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lr = max(lr, __shfl_xor_sync(~0u, lr, o));
  if (lane == 0) red[warp] = lr;
  __syncthreads();
  int max_len = 0;
#pragma unroll
  for (int w = 0; w < Sh::NWARP; ++w) max_len = max(max_len, red[w]);
  const int start = split * chunk;
  if (split > 0 && start >= max_len) {  // an empty range
    cp_async_wait<0>();
    return;
  }
  const int end = min(max_len, start + chunk);
  const int n_blocks = end > start ? (end - start + BC - 1) / BC : 0;

  // this thread's two rows, g and g + 8 of its warp's 16, and the limits
  // of their live positions in this split
  const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;
  const int len0 = row0 < R ? max(0, min(lens[row0], cap)) : 0;
  const int len1 = row1 < R ? max(0, min(lens[row1], cap)) : 0;
  const int lim0 = min(len0, end), lim1 = min(len1, end);
  int wmin = min(lim0, lim1), wmax = max(lim0, lim1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmin = min(wmin, __shfl_xor_sync(~0u, wmin, o));
    wmax = max(wmax, __shfl_xor_sync(~0u, wmax, o));
  }
  const bool active = r0 + warp * 16 < R;
  const float qk_scale = sm_scale * kLog2e;

  // cp.async of the key block at position kb into buffer buf (staging
  // buffer, or bfloat16 key block): 16 bytes a chunk, zero-filled past the
  // split's end
  auto issue = [&](int kb, int buf) {
    constexpr int kIt = (Sh::kChunks + THREADS - 1) / THREADS;
#pragma unroll
    for (int n = 0; n < kIt; ++n) {
      const int c = tid + n * THREADS;
      if (Sh::kChunks % THREADS != 0 && c >= Sh::kChunks) break;
      const int kv = c / (Sh::kChunks / 2), e = c % (Sh::kChunks / 2);
      const int key = e / Sh::kRowChunks, col = e % Sh::kRowChunks;
      const int pos = kb + key;
      const TKV* pool = kv ? v_pages : k_pages;
      const TKV* src = pool;
      int bytes = 0;
      if (pos < end) {
        src = pool + (((size_t)table[pos / page] * page + pos % page) * H +
                      h) * D + col * Pack<TKV>::N;
        bytes = 16;
      }
      void* dst;
      if constexpr (Sh::kStaged)
        dst = stage + (kv * BC + key) * D + col * Pack<TKV>::N;
      else
        dst = blk + buf * Sh::kBlk + kv * Sh::kBlkPiece + key * LD + col * 8;
      cp_async16(dst, src, bytes);
    }
    if constexpr (Sh::kI8) {
      if (tid < 2 * BC) {
        const int kv = tid / BC, pos = kb + tid % BC;
        const float* sp = kv ? v_scales : k_scales;
        int bytes = 0;
        if (pos < end) {
          sp += ((size_t)table[pos / page] * page + pos % page) * H + h;
          bytes = 4;
        }
        cp_async4(sc_stage + tid, sp, bytes);
      }
    }
  };

  // the staging buffer into the key block's bfloat16 pieces
  auto convert = [&]() {
    if constexpr (Sh::kF32) {
      split_stage<Sh>(blk, reinterpret_cast<const float*>(stage), tid);
    } else if constexpr (Sh::kI8) {
      constexpr int kPer = BC * D / 16;
#pragma unroll
      for (int c = tid; c < 2 * kPer; c += THREADS) {
        const int kv = c / kPer, e = c % kPer, key = e / (D / 16),
                  col = 16 * (e % (D / 16));
        float x[16];
        unpack(*reinterpret_cast<const uint4*>(stage + (kv * BC + key) * D +
                                               col),
               x);
        __nv_bfloat16* dst = blk + kv * Sh::kBlkPiece + key * LD + col;
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                       pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
        *reinterpret_cast<uint4*>(dst + 8) =
            make_uint4(pack_bf16(x[8], x[9]), pack_bf16(x[10], x[11]),
                       pack_bf16(x[12], x[13]), pack_bf16(x[14], x[15]));
      }
      if (tid < 2 * BC)
        sc_blk[tid] = tid < BC ? sc_stage[tid] * qk_scale : sc_stage[tid];
    }
  };

  if (n_blocks > 0) issue(start, 0);
  cp_async_commit();  // block 0 (and a bfloat16 q tile)
  if constexpr (Sh::kQF32) {  // float32 q, split into its pieces
#pragma unroll
    for (int n = 0; n < kQIt; ++n) {
      const int c = tid + n * THREADS, r = c / (D / 4), col = 4 * (c % (D / 4));
      store_split4(q_s + r * LD + col, Sh::kResPiece, qx[n]);
    }
  }

  // ldmatrix offsets of this lane (see mma_common.cuh): q as A, k as B
  // (n = position, k = head dim), v as B transposed (k = position, n = head
  // dim)
  const int a_off = (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                    (lane / 16) * 8;
  const int b_off = ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int bt_off = ((lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;

  uint32_t qf[Sh::kQRegs ? KD : 1][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;  // this lane's shares of the two denominators

  for (int i = 0; i < n_blocks; ++i) {
    const int kb = start + i * BC;
    int buf = 0;
    if constexpr (Sh::kStaged) {
      cp_async_wait<0>();
      __syncthreads();  // block i staged; every warp done with block i - 1
      convert();
      __syncthreads();  // block i's pieces ready; the staging buffer free
      if (i + 1 < n_blocks) {  // the next block's load overlaps this one
        issue(kb + BC, 0);
        cp_async_commit();
      }
    } else {
      buf = i & 1;
      if (i + 1 < n_blocks) {
        issue(kb + BC, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    if constexpr (Sh::kQRegs) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldmatrix_x4(qf[kk], q_s + a_off + kk * 16);
      }
    }
    if (active && kb < wmax) {  // some row of the warp reaches this block
      const __nv_bfloat16* kblk = blk + buf * Sh::kBlk;
      const __nv_bfloat16* vblk = kblk + P * Sh::kBlkPiece;

      // S = q k^T: the small-piece products over all of D, then hi * hi
      float sacc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
      if constexpr (PQ > 1 || P > 1) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t a[PQ][4], b[NT][P][2];
#pragma unroll
          for (int p = 0; p < PQ; ++p) {
            if constexpr (Sh::kQRegs) {
#pragma unroll
              for (int e = 0; e < 4; ++e) a[p][e] = qf[kk][e];
            } else {
              ldmatrix_x4(a[p], q_s + p * Sh::kResPiece + a_off + kk * 16);
            }
          }
          load_b<Sh, P>(b, kblk, b_off + kk * 16);
          mma_pieces<NT, PQ, P, 1>(sacc, a, b);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4], b[NT][1][2];
        if constexpr (Sh::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldmatrix_x4(a, q_s + a_off + kk * 16);
        }
        load_b<Sh, 1>(b, kblk, b_off + kk * 16);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(sacc[j], a, b[j][0][0], b[j][0][1]);
      }

      // scale (an int8 column by its k scale), the causal mask where the
      // block crosses a row's limit, in base-2 units; the row maxima
      const bool edge = kb + BC > wmin;
      float mx0 = masked(), mx1 = masked();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + 2 * t, key = kb + c;
        float f0 = qk_scale, f1 = qk_scale;
        if constexpr (Sh::kI8) f0 = sc_blk[c], f1 = sc_blk[c + 1];
        sacc[j][0] *= f0, sacc[j][1] *= f1;
        sacc[j][2] *= f0, sacc[j][3] *= f1;
        if (edge) {
          if (key >= lim0) sacc[j][0] = masked();
          if (key + 1 >= lim0) sacc[j][1] = masked();
          if (key >= lim1) sacc[j][2] = masked();
          if (key + 1 >= lim1) sacc[j][3] = masked();
        }
        mx0 = fmaxf(mx0, fmaxf(sacc[j][0], sacc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[j][2], sacc[j][3]));
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {  // across the quad's lanes
        mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, w));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0, m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sacc[j][0] = exp2f(sacc[j][0] - mn0);
        sacc[j][1] = exp2f(sacc[j][1] - mn0);
        sacc[j][2] = exp2f(sacc[j][2] - mn1);
        sacc[j][3] = exp2f(sacc[j][3] - mn1);
        sum0 += sacc[j][0] + sacc[j][1];
        sum1 += sacc[j][2] + sacc[j][3];
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][0] *= al0, o[j][1] *= al0;
        o[j][2] *= al1, o[j][3] *= al1;
      }

      // O += P V: P (an int8 column times its v scale) in two pieces from
      // the score fragments in registers, a fresh fragment a key block
      uint32_t pf[KC][2][4];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * kk + e / 2;
          float x = sacc[j][2 * (e % 2)], y = sacc[j][2 * (e % 2) + 1];
          if constexpr (Sh::kI8) {
            x *= sc_blk[BC + j * 8 + 2 * t];
            y *= sc_blk[BC + j * 8 + 2 * t + 1];
          }
          split2_pack(x, y, pf[kk][0][e], pf[kk][1][e]);
        }
      second_product<Sh>(o, pf, vblk, bt_off);
    }
    if constexpr (!Sh::kStaged) __syncthreads();  // the buffer is reloaded
  }
  cp_async_wait<0>();

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(~0u, l0, w);
    l1 += __shfl_xor_sync(~0u, l1, w);
  }
  if (!active) return;
  // a row of at most `chunk` positions is whole in split 0: its output; a
  // longer one's live splits write partials for paged_combine_kernel
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0, len = half ? len1 : len0;
    const float mr = half ? m1 : m0, lr_ = half ? l1 : l0;
    if (row >= R) continue;
    if (len <= chunk) {
      if (split != 0) continue;
      const float d = lr_ == 0.f ? 1.f : lr_;  // no live position: 0
      TQ* op = out + (((size_t)s * R + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float x0 = o[j][2 * half] / d, x1 = o[j][2 * half + 1] / d;
        if constexpr (Sh::kQF32)
          *reinterpret_cast<float2*>(op + j * 8) = make_float2(x0, x1);
        else
          *reinterpret_cast<uint32_t*>(op + j * 8) = pack_bf16(x0, x1);
      }
    } else if (len > start) {
      float* pp =
          ws + ((((size_t)s * R + row) * H + h) * nsplit + split) * (D + 4);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<float2*>(pp + j * 8 + 2 * t) =
            make_float2(o[j][2 * half], o[j][2 * half + 1]);
      if (t == 0) pp[D] = mr, pp[D + 1] = lr_;
    }
  }
}

// ---- launches ----------------------------------------------------------------

struct Args {
  const void *q, *k_pages, *v_pages, *k_scales, *v_scales, *page_table,
      *lengths;
  void* out;
  float* ws;
  int S, R, H, D, page, pps, nsplit, chunk;
  int tile_rows;  // B6: 64 (4 warps) or 128 (8 warps)
  float sm_scale;
  cudaStream_t stream;
};

template <typename TQ, int D>
cudaError_t launch_combine(const Args& a) {
  if (a.nsplit == 1) return cudaSuccess;
  const int rows = a.S * a.R * a.H;
  paged_combine_kernel<TQ, D><<<(rows + 3) / 4, 128, 0, a.stream>>>(
      a.ws, static_cast<const int*>(a.lengths), static_cast<TQ*>(a.out),
      a.S * a.R, a.H, a.pps * a.page, a.nsplit, a.chunk);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
struct Decode {
  static cudaError_t run(const Args& a) {
    if (a.chunk / a.page > kMaxSplitPages) return cudaErrorInvalidValue;
    paged_decode_kernel<TQ, TKV, D>
        <<<dim3(a.nsplit, a.H, a.S), kDecWarps * 32, 0, a.stream>>>(
            static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pages),
            static_cast<const TKV*>(a.v_pages),
            static_cast<const float*>(a.k_scales),
            static_cast<const float*>(a.v_scales),
            static_cast<const int*>(a.page_table),
            static_cast<const int*>(a.lengths), static_cast<TQ*>(a.out), a.ws,
            a.H, a.page, a.pps, a.nsplit, a.chunk, a.sm_scale);
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? e : launch_combine<TQ, D>(a);
  }
};

template <typename TQ, typename TKV, int D, int NW>
cudaError_t launch_chunk(const Args& a) {
  using Sh = PagedMma<TQ, TKV, D, NW>;
  auto kernel = paged_chunk_mma_kernel<TQ, TKV, D, NW>;
  if (Sh::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
    if (e != cudaSuccess) return e;
  }
  const int tiles = (a.R + Sh::BR - 1) / Sh::BR;
  kernel<<<dim3(tiles * a.nsplit, a.H, a.S), Sh::THREADS, Sh::kSmem,
           a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pages),
      static_cast<const TKV*>(a.v_pages),
      static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales),
      static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.lengths), static_cast<TQ*>(a.out), a.ws,
      a.R, a.H, a.page, a.pps, a.nsplit, a.chunk, a.sm_scale);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : launch_combine<TQ, D>(a);
}

template <typename TQ, typename TKV, int D>
struct Chunk {
  static cudaError_t run(const Args& a) {
    switch (a.tile_rows) {
      case 64:
        return launch_chunk<TQ, TKV, D, 4>(a);
      case 128:
        return launch_chunk<TQ, TKV, D, 8>(a);
      default:
        return cudaErrorInvalidValue;
    }
  }
};

template <template <typename, typename, int> class L, typename TQ,
          typename TKV>
cudaError_t by_d(const Args& a) {
  switch (a.D) {
    case 32:
      return L<TQ, TKV, 32>::run(a);
    case 64:
      return L<TQ, TKV, 64>::run(a);
    case 128:
      return L<TQ, TKV, 128>::run(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <template <typename, typename, int> class L, typename TQ>
cudaError_t by_kv(const Args& a, int kv_dtype) {
  switch (kv_dtype) {
    case kF32:
      return by_d<L, TQ, float>(a);
    case kBF16:
      return by_d<L, TQ, __nv_bfloat16>(a);
    case kI8:
      return by_d<L, TQ, int8_t>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// The plan's invariants (ops/paged_attention.py plan_split): nsplit ranges
// of `chunk` positions, whole pages, cover the table's width, and more than
// one needs a workspace.
template <template <typename, typename, int> class L>
int dispatch(const Args& a, int q_dtype, int kv_dtype) {
  if (a.page < 1 || a.nsplit < 1 || a.chunk < a.page ||
      a.chunk % a.page != 0 ||
      (long long)a.nsplit * a.chunk < (long long)a.pps * a.page ||
      (a.nsplit > 1 && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (q_dtype) {
    case kF32:
      return static_cast<int>(by_kv<L, float>(a, kv_dtype));
    case kBF16:
      return static_cast<int>(by_kv<L, __nv_bfloat16>(a, kv_dtype));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [S, H, D]; lengths [S]; workspace [S, H, nsplit, D + 4] float32 (null
// when nsplit == 1).  Returns cudaGetLastError() after the launches.
int paddle_paged_decode_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scales,
                                  const void* v_scales, const void* page_table,
                                  const void* lengths, void* out,
                                  void* workspace, int S, int H, int D,
                                  int page, int pps, int nsplit, int chunk,
                                  float sm_scale, int q_dtype, int kv_dtype,
                                  void* stream) {
  const Args a{q,        k_pages,  v_pages, k_scales,
               v_scales, page_table, lengths, out,
               static_cast<float*>(workspace), S, 1, H, D, page, pps,
               nsplit, chunk, 0, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Decode>(a, q_dtype, kv_dtype);
}

// q [S, R, H, D]; row_lengths [S, R]; workspace [S, R, H, nsplit, D + 4]
// float32 (null when nsplit == 1); query rows a block: 64 or 128.  Returns
// cudaGetLastError().
int paddle_paged_chunk_attention(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales, const void* page_table,
                                 const void* row_lengths, void* out,
                                 void* workspace, int S, int R, int H, int D,
                                 int page, int pps, int nsplit, int chunk,
                                 int tile_rows, float sm_scale, int q_dtype,
                                 int kv_dtype, void* stream) {
  const Args a{q,        k_pages,    v_pages,     k_scales,
               v_scales, page_table, row_lengths, out,
               static_cast<float*>(workspace), S, R, H, D, page, pps,
               nsplit, chunk, tile_rows, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Chunk>(a, q_dtype, kv_dtype);
}

}  // extern "C"
