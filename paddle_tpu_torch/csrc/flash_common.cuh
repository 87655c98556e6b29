// Shared pieces of the flash-attention kernels for Hopper (sm_90a): the
// forward kernels in flash_attention.cu (B1, and B2 with the logsumexp) and
// the backward kernels in flash_attention_bwd.cu (B3, B4).  Type
// conversion, 16-byte loads, warp reductions, the tiling constants and the
// argument block the C entry points fill.  Everything sits in an anonymous
// namespace: each source is a library of its own.
#pragma once

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

// Two neighbouring elements as float2, through the read-only cache (8- or
// 4-byte aligned: the bias's strides and key index are even).
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(
      __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
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

// Operands of one call; the bias strides are in elements, 0 along the
// bias's broadcast dims.  dout, lse, delta and the d* outputs are used by
// the backward kernels only, lse also by the forward that stores it.
struct Args {
  const void *q, *k, *v, *bias;
  void* out;
  int B, H, Sq, Sk, D, bias_sb, bias_sh, bias_sq;
  float sm_scale;
  int causal;
  cudaStream_t stream;
  float* lse = nullptr;
  const void* dout = nullptr;
  const float* delta = nullptr;
  void *dq = nullptr, *dk = nullptr, *dv = nullptr;
};

// Dispatch on head dim, bias dtype and q dtype to Launch<TQ, TB, VPT>::run.
template <template <typename, typename, int> class Launch, typename TQ,
          typename TB>
cudaError_t dispatch_d(const Args& a) {
  switch (a.D) {
    case 64:
      return Launch<TQ, TB, 2>::run(a);
    case 128:
      return Launch<TQ, TB, 4>::run(a);
    case 256:
      return Launch<TQ, TB, 8>::run(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <template <typename, typename, int> class Launch, typename TQ>
cudaError_t dispatch_bias(const Args& a, int bias_dtype) {
  // no bias: the float instantiation with a null pointer
  if (a.bias == nullptr || bias_dtype == kF32)
    return dispatch_d<Launch, TQ, float>(a);
  if (bias_dtype == kBF16) return dispatch_d<Launch, TQ, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

template <template <typename, typename, int> class Launch>
int dispatch(const Args& a, int q_dtype, int bias_dtype) {
  switch (q_dtype) {
    case kF32:
      return static_cast<int>(dispatch_bias<Launch, float>(a, bias_dtype));
    case kBF16:
      return static_cast<int>(
          dispatch_bias<Launch, __nv_bfloat16>(a, bias_dtype));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Opt in to more than 48 KB of dynamic shared memory where a tiling needs it.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
