// Flash attention forward with a streamed additive bias (B1) for Hopper
// (sm_90a).
//
//   q, k, v  [B, H, S, D]   float32 or bfloat16, contiguous
//   bias     none, a key mask [B|1, H|1, 1, Sk] or a full [B|1, H|1, Sq, Sk]
//            tensor, float32 or bfloat16, addressed through element strides
//            (b, h, query) that are 0 along its broadcast dims: it is read
//            in its natural shape and never materialized to [B, H, Sq, Sk]
//   out      [B, H, Sq, D] in q's dtype
//
//   out = softmax(q k^T * sm_scale + bias [, causal: -1e30 where key > row]) v
//
// Every sum is taken in float32 from float32 or bfloat16 inputs, and the
// result is rounded to q's dtype once.  A row whose softmax denominator is 0
// returns 0 (the TPU kernel's l == 0 guard).  With causal, key blocks wholly
// above the diagonal of a query tile are never read.
//
// Replaces _fwd_kernel in paddle_tpu/ops/pallas_attention.py (launched by
// _flash_call: grid (B*H, Sq/128, Sk/128), the running max, denominator and
// accumulator carried across the key blocks in VMEM scratch).  Contract
// shared with the plain PyTorch version flash_attention_bias_reference in
// paddle_tpu_torch/ops/flash_attention_bias.py, whose wrapper checks shapes
// (S % 128 == 0, D in {64, 128, 256}), dtypes and contiguity before a launch.
//
// What bounds it on this card: at BERT's shapes (S = 128, D = 64) the work
// is ~4*S*D operations per (row, key) pair against 4*S*D*4 bytes of q, k, v
// and out per head: in bfloat16 the bytes bound it (the tensor cores would
// do the arithmetic in a fifth of the time the bytes take); in float32 the
// CUDA cores' arithmetic does.  This first kernel is simple and computes in
// float32 on the CUDA cores:
//   - one block per (b*h, tile of BR query rows), so nothing is carried
//     between blocks: the TPU grid's sequential key axis becomes a loop over
//     key blocks of BC = 32 inside the block;
//   - the q tile and each key block's K and V are staged once in shared
//     memory (converted to float32 on the way in), so each element is read
//     from device memory once per (head, query tile);
//   - each of the NW warps owns RPW rows; lane c owns key c of the block for
//     the scores (no cross-lane sum per key), keeps its share of each row's
//     denominator, and owns head dims c, c + 32, ... of the accumulator; the
//     running max is one warp max per row per block; the probabilities reach
//     the P.V product through a warp-private shared buffer.
// Tensor cores (wgmma) and TMA staging are later work.
//
// Built by paddle_tpu_torch/native/build.py into a library with a plain C
// interface: the entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask constant

enum DType : int { kF32 = 0, kBF16 = 1 };

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

// Four neighbouring elements as float4 (16 or 8 bytes, aligned: every row
// starts at a multiple of D elements and D is a multiple of 32).
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int NW = 4;   // warps per block
constexpr int BC = 32;  // keys staged per step, one per lane

template <int VPT>
struct Shape {
  static constexpr int D = 32 * VPT;
  static constexpr int RPW = VPT <= 2 ? 8 : 8 / VPT * 2;  // rows per warp
  static constexpr int BR = NW * RPW;  // rows per block: 32, 16, 8
  static constexpr int KS = D + 4;     // padded K row (floats)
  static constexpr int NL = BC * D / 4 / (NW * 32);  // float4 per thread
  static constexpr int kSmem =
      (BR * D + BC * KS + BC * D + NW * RPW * BC) * sizeof(float);
};

template <typename TQ, typename TB, int VPT>
__global__ void __launch_bounds__(NW * 32)
    flash_fwd_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                     const TQ* __restrict__ v, const TB* __restrict__ bias,
                     TQ* __restrict__ out, int H, int Sq, int Sk, int bias_sb,
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
  }
}

struct Args {
  const void *q, *k, *v, *bias;
  void* out;
  int B, H, Sq, Sk, D, bias_sb, bias_sh, bias_sq;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename TQ, typename TB, int VPT>
cudaError_t launch(const Args& a) {
  using Sh = Shape<VPT>;
  const auto kernel = flash_fwd_kernel<TQ, TB, VPT>;
  if (Sh::kSmem > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.B * a.H, a.Sq / Sh::BR), NW * 32, Sh::kSmem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k),
      static_cast<const TQ*>(a.v), static_cast<const TB*>(a.bias),
      static_cast<TQ*>(a.out), a.H, a.Sq, a.Sk, a.bias_sb, a.bias_sh,
      a.bias_sq, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <typename TQ, typename TB>
cudaError_t dispatch_d(const Args& a) {
  switch (a.D) {
    case 64:
      return launch<TQ, TB, 2>(a);
    case 128:
      return launch<TQ, TB, 4>(a);
    case 256:
      return launch<TQ, TB, 8>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_bias(const Args& a, int bias_dtype) {
  // no bias: the float instantiation with a null pointer
  if (a.bias == nullptr || bias_dtype == kF32) return dispatch_d<TQ, float>(a);
  if (bias_dtype == kBF16) return dispatch_d<TQ, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* paddle_flash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v [B, H, S, D]; bias strides in elements (0 along broadcast dims).
// Returns cudaGetLastError() after the launch.
int paddle_flash_attention_bias_fwd(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, int B, int H, int Sq, int Sk,
                                    int D, int bias_sb, int bias_sh,
                                    int bias_sq, float sm_scale, int causal,
                                    int q_dtype, int bias_dtype,
                                    void* stream) {
  const Args a{q,       k,       v,       bias,     out,
               B,       H,       Sq,      Sk,       D,
               bias_sb, bias_sh, bias_sq, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case kF32:
      return static_cast<int>(dispatch_bias<float>(a, bias_dtype));
    case kBF16:
      return static_cast<int>(dispatch_bias<__nv_bfloat16>(a, bias_dtype));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
