// Weight-only dequant-fused matmul for Hopper (sm_90a): B7.
//
//   x      [M, K]  float32 or bfloat16, row-major, contiguous
//   q      [K, N]  int8 or float8 e4m3 (__nv_fp8_e4m3) carrier, row-major
//   scale  [N]     float32, one step size per output channel
//   out    [M, N]  float32 or bfloat16, row-major
//
//   out[m, n] = sum_k x[m, k] * (float(q[k, n]) * scale[n])
//
// with every product and sum in float32, rounded to out's type once.  The
// weight is dequantized as the plain version (dequant_matmul_reference in
// paddle_tpu_torch/ops/quant_ops.py) dequantizes it: float(q) * scale, one
// float32 multiply per element, applied when the W tile is staged (not once
// per column after the K loop), so the two differ only in summation order.
// Every M, K, N is taken: tiles at the edges are guarded (N = 2 and K = 768
// included), so no shape falls back to the plain version.
//
// Replaces _dequant_matmul_kernel in paddle_tpu/ops/quant_ops.py (launched by
// _dequant_matmul_call: grid (M/256, N/256, K/512), the K axis sequential on
// the TPU core with a float32 accumulator in VMEM scratch, the carrier tile
// dequantized in VMEM; shapes those tiles do not divide fall back to the jnp
// reference there).
//
// What bounds it on this card: the main path's largest call (BERT-base FFN-up
// at batch 32: M = 4096, K = 768, N = 3072, float32 x, int8 W) does 2*M*K*N =
// 19.3 GFLOP against 12.6 MB of x, 2.4 MB of W and 50.3 MB of out: 0.289 ms
// of float32 operations on the CUDA cores (67 TFLOP/s) against 0.0195 ms of
// bytes (3.35 TB/s), so operations bound it; at batch 1 (M = 128) the same
// product is still bounded by operations (0.0090 ms against 0.0013 ms).  The
// weight stays 8-bit in device memory (a quarter of float32's bytes); the
// design keeps its float32 form out of device memory and the CUDA cores fed:
//   - one block per 64 x 64 output tile, 256 threads, each owning a 4 x 4
//     register micro-tile; the TPU grid's sequential K axis is a loop over
//     K in steps of 32 inside the block, so nothing is carried between blocks
//     and there are no atomics;
//   - each step stages the x tile (converted to float32, stored k-major so a
//     thread reads its 4 rows as one float4) and the W tile, dequantized to
//     float32 once in shared memory: each weight byte is converted once per
//     block, not once per multiply-add; W is read as 4-byte words where the
//     row allows it;
//   - float32 FMAs on the CUDA cores.
// wgmma on bf16 or fp8, TMA staging and a split-K for batch-1 serving are
// later work.
//
// Built by paddle_tpu_torch/native/build.py into a library with a plain C
// interface: the entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;  // output tile, K step
constexpr int TM = 4, TN = 4;             // micro-tile of one thread
constexpr int THREADS = (BM / TM) * (BN / TN);
constexpr int XS_LD = BM + 4;  // k-major x tile, rows padded, 16-byte aligned

enum XDType : int { kF32 = 0, kBF16 = 1 };
enum WDType : int { kInt8 = 0, kFp8E4M3 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The value of one carrier byte (the low 8 bits of b).
template <int W>
__device__ __forceinline__ float carrier(uint32_t b);
template <>
__device__ __forceinline__ float carrier<kInt8>(uint32_t b) {
  return static_cast<float>(static_cast<int8_t>(b & 0xFFu));
}
template <>
__device__ __forceinline__ float carrier<kFp8E4M3>(uint32_t b) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(b & 0xFFu);
  return static_cast<float>(v);
}

template <typename XT, int W, typename OT>
__global__ void __launch_bounds__(THREADS)
    dequant_matmul_kernel(const XT* __restrict__ x,
                          const uint8_t* __restrict__ q,
                          const float* __restrict__ scale,
                          OT* __restrict__ out, int M, int K, int N,
                          int q_words) {
  __shared__ __align__(16) float xs[BK][XS_LD];  // x tile, k-major
  __shared__ __align__(16) float ws[BK][BN];     // dequantized W tile

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // This thread stages W columns wc..wc+3 of the tile in every K step (the
  // tile is BK * BN / 4 words and the thread count a multiple of BN / 4),
  // so their scales are read once.
  const int wc = (tid % (BN / 4)) * 4;
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    sc[j] = n0 + wc + j < N ? scale[n0 + wc + j] : 0.f;
  const bool full_words = q_words && n0 + wc + 3 < N;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: a warp reads BK consecutive elements of one row (coalesced)
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int r = tid / BK + i * (THREADS / BK), c = tid % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = gm < M && gk < K ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    // W tile: BK rows of BN bytes, one 4-byte word a thread per pass
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int r = (tid + i * THREADS) / (BN / 4);
      const int gk = k0 + r;
      const uint8_t* row = q + (size_t)gk * N + n0 + wc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk < K) {
        if (full_words) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(row);
          v.x = carrier<W>(w) * sc[0];
          v.y = carrier<W>(w >> 8) * sc[1];
          v.z = carrier<W>(w >> 16) * sc[2];
          v.w = carrier<W>(w >> 24) * sc[3];
        } else {
          const int left = N - (n0 + wc);
          if (left > 0) v.x = carrier<W>(row[0]) * sc[0];
          if (left > 1) v.y = carrier<W>(row[1]) * sc[1];
          if (left > 2) v.z = carrier<W>(row[2]) * sc[2];
          if (left > 3) v.w = carrier<W>(row[3]) * sc[3];
        }
      }
      *reinterpret_cast<float4*>(&ws[r][wc]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) out[(size_t)gm * N + gn] = from_f32<OT>(acc[i][j]);
    }
  }
}

template <typename XT, int W, typename OT>
int launch(const void* x, const void* q, const float* scale, void* out, int M,
           int K, int N, cudaStream_t stream) {
  // 4-byte words of a W row are aligned when N is a multiple of 4 and the
  // carrier starts on a 4-byte boundary
  const int q_words =
      N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 ? 1 : 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dequant_matmul_kernel<XT, W, OT><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(q), scale,
      static_cast<OT*>(out), M, K, N, q_words);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, int W>
int by_out(int out_dtype, const void* x, const void* q, const float* scale,
           void* out, int M, int K, int N, cudaStream_t stream) {
  if (out_dtype == kF32)
    return launch<XT, W, float>(x, q, scale, out, M, K, N, stream);
  if (out_dtype == kBF16)
    return launch<XT, W, __nv_bfloat16>(x, q, scale, out, M, K, N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename XT>
int by_carrier(int w_dtype, int out_dtype, const void* x, const void* q,
               const float* scale, void* out, int M, int K, int N,
               cudaStream_t stream) {
  if (w_dtype == kInt8)
    return by_out<XT, kInt8>(out_dtype, x, q, scale, out, M, K, N, stream);
  if (w_dtype == kFp8E4M3)
    return by_out<XT, kFp8E4M3>(out_dtype, x, q, scale, out, M, K, N,
                                stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* paddle_dequant_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B7.  x [M, K] (x_dtype: 0 float32, 1 bfloat16), q [K, N] (w_dtype: 0 int8,
// 1 float8 e4m3), scale [N] float32, out [M, N] (out_dtype: 0 float32, 1
// bfloat16); M, N >= 1.  Returns cudaGetLastError() after the launch.
int paddle_dequant_matmul(const void* x, const void* q, const float* scale,
                          void* out, int M, int K, int N, int x_dtype,
                          int w_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return by_carrier<float>(w_dtype, out_dtype, x, q, scale, out, M, K, N,
                             s);
  if (x_dtype == kBF16)
    return by_carrier<__nv_bfloat16>(w_dtype, out_dtype, x, q, scale, out, M,
                                     K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
