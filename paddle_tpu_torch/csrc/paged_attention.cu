// Paged decode attention and paged chunk attention for Hopper (sm_90a).
//
// Two kernels read one layer's K/V page pool straight through a slot's page
// table, with an online softmax across the live positions:
//
//   paged_decode_kernel  one query row per slot            q   [S, H, D]
//   paged_chunk_kernel   R query rows per slot, each row   q   [S, R, H, D]
//                        with its own causal length
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
// float K/V never exists in device memory.  Table entries past a row's
// live pages (the trash page 0, or stale ids) are never read.
//
// Built by paddle_tpu_torch/native/build.py into a library with a plain C
// interface: each entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' mask constant

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lane `lane` of a warp owns head dims lane, lane + 32, ... (VPT of them),
// so each step of a row read is 32 neighbouring elements: coalesced for
// every element type.
template <typename T, int VPT>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int lane,
                                         float scale, float (&dst)[VPT]) {
#pragma unroll
  for (int j = 0; j < VPT; ++j) dst[j] = to_f32(row[lane + 32 * j]) * scale;
}

// ---------------------------------------------------------------------------
// B5: paged decode attention.
//
// Replaces _decode_kernel in paddle_tpu/ops/pallas_decode_attention.py (the
// TPU grid (slot, page) that carries m, l and acc across pages in VMEM).
//
// Bound by device memory: each call must read the live K/V of every slot
// (2 * length * H * D elements per slot) and does only ~4 flops per
// element it reads.  What this simple design does about it: one block per
// (slot, head) reads each live position of that head exactly once, as one
// coalesced row of D elements; its NDW warps take interleaved groups of
// DU positions and issue the group's K and V loads together, so every
// lane keeps 2 * DU * VPT loads in flight.  Each warp runs its own online
// softmax in registers and the block merges the NDW partial results in
// shared memory at the end: nothing is carried between blocks.
// ---------------------------------------------------------------------------

constexpr int NDW = 8;  // warps per decode block
constexpr int DU = 4;   // positions per warp per step

template <typename TQ, typename TKV, int VPT>
__global__ void __launch_bounds__(NDW * 32)
    paged_decode_kernel(const TQ* __restrict__ q,
                        const TKV* __restrict__ k_pages,
                        const TKV* __restrict__ v_pages,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
                        const int* __restrict__ page_table,
                        const int* __restrict__ lengths, TQ* __restrict__ out,
                        int H, int page, int pps, float sm_scale) {
  constexpr int D = 32 * VPT;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  const int s = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(0, min(lengths[s], pps * page));
  const int* table = page_table + (size_t)s * pps;

  float qv[VPT];
  load_row<TQ, VPT>(q + ((size_t)s * H + h) * D, lane, 1.f, qv);

  float m = kNegInf, l = 0.f, acc[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) acc[j] = 0.f;

  for (int base = warp * DU; base < len; base += NDW * DU) {
    float kf[DU][VPT], vf[DU][VPT];
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      const int t = base + u;
      if (t < len) {
        const size_t row =
            ((size_t)table[t / page] * page + (t % page)) * H + h;
        const float ks = kQuant ? k_scales[row] : 1.f;
        const float vs = kQuant ? v_scales[row] : 1.f;
        load_row<TKV, VPT>(k_pages + row * D, lane, ks, kf[u]);
        load_row<TKV, VPT>(v_pages + row * D, lane, vs, vf[u]);
      } else {
#pragma unroll
        for (int j = 0; j < VPT; ++j) kf[u][j] = vf[u][j] = 0.f;
      }
    }
    float sc[DU];
    float m_cur = kNegInf;
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) part += qv[j] * kf[u][j];
      sc[u] = base + u < len ? warp_sum(part) * sm_scale : kNegInf;
      m_cur = fmaxf(m_cur, sc[u]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < VPT; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      const float p = base + u < len ? expf(sc[u] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int j = 0; j < VPT; ++j) acc[j] += p * vf[u][j];
    }
    m = m_new;
  }

  __shared__ float sm_m[NDW], sm_l[NDW], sm_acc[NDW][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) sm_acc[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  if (warp != 0) return;
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < NDW; ++w) mx = fmaxf(mx, sm_m[w]);
  float denom = 0.f, o[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) o[j] = 0.f;
#pragma unroll
  for (int w = 0; w < NDW; ++w) {
    const float c = expf(sm_m[w] - mx);
    denom += sm_l[w] * c;
#pragma unroll
    for (int j = 0; j < VPT; ++j) o[j] += sm_acc[w][lane + 32 * j] * c;
  }
  if (denom == 0.f) denom = 1.f;  // no live position: the output is 0
  TQ* op = out + ((size_t)s * H + h) * D;
#pragma unroll
  for (int j = 0; j < VPT; ++j) op[lane + 32 * j] = from_f32<TQ>(o[j] / denom);
}

// ---------------------------------------------------------------------------
// B6: paged chunk attention.
//
// Replaces _chunk_kernel in paddle_tpu/ops/pallas_decode_attention.py (B5
// with R query rows per slot and per-row causal lengths; its page skip is
// taken over the widest row).
//
// Bound by device memory at decode-like row counts and by its score
// arithmetic when many rows share the positions (a whole-prompt prefill).
// What this design does about it: one block per (slot, head, tile of BR
// rows) walks the positions up to the widest row of its tile in blocks of
// BC = 32, and stages each block of K and V once in shared memory (int8
// dequantized on the way in), so each live position is read from device
// memory once per (head, row tile), coalesced across D.  The next block's
// K/V is loaded into registers while the current one is computed.  Each of
// the CW warps owns RPW rows:
//   scores  lane c owns position c of the block and takes its dot product
//           with each of the warp's rows (q rows read from shared memory
//           as broadcasts), so no cross-lane sum is needed per position;
//   softmax one warp max per row per block; the denominator is kept as a
//           per-lane partial sum and reduced once at the end;
//   P.V     lane l owns head dims l, l + 32, ...; the probabilities go
//           through a warp-private shared buffer.
// Row tiles are launched heaviest first: under a causal prefill the last
// tile reads every position.
// ---------------------------------------------------------------------------

constexpr int CW = 4;   // warps per chunk block
constexpr int BC = 32;  // positions staged per step, one per lane

template <int VPT>
struct ChunkShape {
  static constexpr int D = 32 * VPT;
  static constexpr int RPW = VPT <= 2 ? 8 : 4;  // rows per warp
  static constexpr int BR = CW * RPW;           // rows per block
  static constexpr int KS = D + 4;              // padded K row (floats)
  static constexpr int NL = BC * D / 4 / (CW * 32);  // float4 per thread
};

// Four neighbouring elements as float4 (16, 8 or 4 bytes, aligned: every
// row starts at a multiple of D elements and D is a multiple of 32).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

template <typename TQ, typename TKV, int VPT>
__global__ void __launch_bounds__(CW * 32)
    paged_chunk_kernel(const TQ* __restrict__ q,
                       const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ page_table,
                       const int* __restrict__ row_lengths,
                       TQ* __restrict__ out, int R, int H, int page, int pps,
                       float sm_scale) {
  using Sh = ChunkShape<VPT>;
  constexpr int D = Sh::D, RPW = Sh::RPW, BR = Sh::BR, KS = Sh::KS,
                NL = Sh::NL;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  __shared__ __align__(16) float q_s[BR][D];
  __shared__ __align__(16) float k_s[BC][KS];
  __shared__ __align__(16) float v_s[BC][D];
  __shared__ __align__(16) float p_s[CW][RPW][BC];

  const int s = blockIdx.x, h = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BR;  // heaviest tile first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cap = pps * page;
  const int* table = page_table + (size_t)s * pps;
  const int* lens = row_lengths + (size_t)s * R;

  // the widest row of the tile bounds the positions the block reads
  int max_len = 0;
  for (int i = 0; i < BR && r0 + i < R; ++i)
    max_len = max(max_len, min(lens[r0 + i], cap));

  for (int e = tid; e < BR * D; e += CW * 32) {
    const int i = e / D, d = e % D;
    q_s[i][d] = r0 + i < R
                    ? to_f32(q[(((size_t)s * R + r0 + i) * H + h) * D + d])
                    : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][VPT];
  int len[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + warp * RPW + i;
    len[i] = r < R ? max(0, min(lens[r], cap)) : 0;
    m[i] = kNegInf;
    l[i] = 0.f;  // this lane's share of the row's denominator
#pragma unroll
    for (int j = 0; j < VPT; ++j) acc[i][j] = 0.f;
  }

  // thread tid stages float4 number tid + CW*32*n of each [BC, D] block
  float4 kr[NL], vr[NL];
  auto fetch = [&](int base) {
#pragma unroll
    for (int n = 0; n < NL; ++n) {
      const int e = tid + CW * 32 * n, c = e / (D / 4), d = 4 * (e % (D / 4));
      const int t = base + c;
      if (t < max_len) {
        const size_t row = ((size_t)table[t / page] * page + t % page) * H + h;
        kr[n] = load4(k_pages + row * D + d);
        vr[n] = load4(v_pages + row * D + d);
        if (kQuant) {
          const float ks = k_scales[row], vs = v_scales[row];
          kr[n] = make_float4(kr[n].x * ks, kr[n].y * ks, kr[n].z * ks,
                              kr[n].w * ks);
          vr[n] = make_float4(vr[n].x * vs, vr[n].y * vs, vr[n].z * vs,
                              vr[n].w * vs);
        }
      } else {  // zeros, so masked positions add 0 * 0 and never NaN
        kr[n] = vr[n] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };

  if (max_len > 0) fetch(0);
  for (int base = 0; base < max_len; base += BC) {
#pragma unroll
    for (int n = 0; n < NL; ++n) {
      const int e = tid + CW * 32 * n, c = e / (D / 4), d = 4 * (e % (D / 4));
      *reinterpret_cast<float4*>(&k_s[c][d]) = kr[n];
      *reinterpret_cast<float4*>(&v_s[c][d]) = vr[n];
    }
    __syncthreads();
    if (base + BC < max_len) fetch(base + BC);  // in flight while we compute

    float sc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&k_s[lane][d]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(&q_s[warp * RPW + i][d]);
        sc[i] = fmaf(q4.x, k4.x, sc[i]);
        sc[i] = fmaf(q4.y, k4.y, sc[i]);
        sc[i] = fmaf(q4.z, k4.z, sc[i]);
        sc[i] = fmaf(q4.w, k4.w, sc[i]);
      }
    }
    const int pos = base + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool live = pos < len[i];
      const float x = live ? sc[i] * sm_scale : kNegInf;
      float bmax = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
      const float m_new = fmaxf(m[i], bmax);
      const float alpha = expf(m[i] - m_new);
      const float p = live ? expf(x - m_new) : 0.f;
      l[i] = l[i] * alpha + p;
#pragma unroll
      for (int j = 0; j < VPT; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
      p_s[warp][i][lane] = p;
    }
    __syncwarp();
#pragma unroll 4
    for (int c = 0; c < BC; c += 4) {
      float vv[4][VPT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < VPT; ++j) vv[u][j] = v_s[c + u][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(&p_s[warp][i][c]);
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
    const int r = r0 + warp * RPW + i;
    const float denom = warp_sum(l[i]);
    if (r >= R) continue;
    const float dv = denom == 0.f ? 1.f : denom;  // no live position: 0
    TQ* op = out + (((size_t)s * R + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      op[lane + 32 * j] = from_f32<TQ>(acc[i][j] / dv);
  }
}

struct Args {
  const void *q, *k_pages, *v_pages, *k_scales, *v_scales, *page_table,
      *lengths;
  void* out;
  int S, R, H, D, page, pps;
  float sm_scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int VPT>
cudaError_t launch_decode(const Args& a) {
  paged_decode_kernel<TQ, TKV, VPT>
      <<<dim3(a.S, a.H), NDW * 32, 0, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pages),
          static_cast<const TKV*>(a.v_pages),
          static_cast<const float*>(a.k_scales),
          static_cast<const float*>(a.v_scales),
          static_cast<const int*>(a.page_table),
          static_cast<const int*>(a.lengths), static_cast<TQ*>(a.out), a.H,
          a.page, a.pps, a.sm_scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int VPT>
cudaError_t launch_chunk(const Args& a) {
  constexpr int BR = ChunkShape<VPT>::BR;
  paged_chunk_kernel<TQ, TKV, VPT>
      <<<dim3(a.S, a.H, (a.R + BR - 1) / BR), CW * 32, 0, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pages),
          static_cast<const TKV*>(a.v_pages),
          static_cast<const float*>(a.k_scales),
          static_cast<const float*>(a.v_scales),
          static_cast<const int*>(a.page_table),
          static_cast<const int*>(a.lengths), static_cast<TQ*>(a.out), a.R,
          a.H, a.page, a.pps, a.sm_scale);
  return cudaGetLastError();
}

template <bool kChunk, typename TQ, typename TKV>
cudaError_t dispatch_d(const Args& a) {
  switch (a.D) {
    case 32:
      return kChunk ? launch_chunk<TQ, TKV, 1>(a) : launch_decode<TQ, TKV, 1>(a);
    case 64:
      return kChunk ? launch_chunk<TQ, TKV, 2>(a) : launch_decode<TQ, TKV, 2>(a);
    case 128:
      return kChunk ? launch_chunk<TQ, TKV, 4>(a) : launch_decode<TQ, TKV, 4>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kChunk, typename TQ>
cudaError_t dispatch_kv(const Args& a, int kv_dtype) {
  switch (kv_dtype) {
    case kF32:
      return dispatch_d<kChunk, TQ, float>(a);
    case kBF16:
      return dispatch_d<kChunk, TQ, __nv_bfloat16>(a);
    case kI8:
      return dispatch_d<kChunk, TQ, int8_t>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kChunk>
cudaError_t dispatch(const Args& a, int q_dtype, int kv_dtype) {
  switch (q_dtype) {
    case kF32:
      return dispatch_kv<kChunk, float>(a, kv_dtype);
    case kBF16:
      return dispatch_kv<kChunk, __nv_bfloat16>(a, kv_dtype);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [S, H, D]; lengths [S].  Returns cudaGetLastError() after the launch.
int paddle_paged_decode_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scales,
                                  const void* v_scales, const void* page_table,
                                  const void* lengths, void* out, int S, int H,
                                  int D, int page, int pps, float sm_scale,
                                  int q_dtype, int kv_dtype, void* stream) {
  const Args a{q,        k_pages, v_pages, k_scales, v_scales,
               page_table, lengths, out,   S,        1,
               H,        D,       page,    pps,      sm_scale,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<false>(a, q_dtype, kv_dtype));
}

// q [S, R, H, D]; row_lengths [S, R].  Returns cudaGetLastError().
int paddle_paged_chunk_attention(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales, const void* page_table,
                                 const void* row_lengths, void* out, int S,
                                 int R, int H, int D, int page, int pps,
                                 float sm_scale, int q_dtype, int kv_dtype,
                                 void* stream) {
  const Args a{q,          k_pages,     v_pages, k_scales, v_scales,
               page_table, row_lengths, out,     S,        R,
               H,          D,           page,    pps,      sm_scale,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<true>(a, q_dtype, kv_dtype));
}

}  // extern "C"
