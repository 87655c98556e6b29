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
// Every product and sum runs in float32 from float32 or bfloat16 inputs;
// each result is rounded to its dtype once.  The bias gets no gradient (a
// constant by contract).
//
// Replaces _bwd_dq_kernel (B3) and _bwd_dkv_kernel (B4) in
// paddle_tpu/ops/flash_attention.py, launched by _bwd_call on the grids
// (B*H, Sq/128, Sk/128) and (B*H, Sk/128, Sq/128), each carrying its result
// block in VMEM scratch across the innermost, sequential grid axis.  Here
// that axis is a loop inside a block, and the split into two kernels gives
// every output exactly one writer: no atomics, the same bits run to run.
//   - B3: one block owns (b*h, a tile of BR query rows): q and do of the
//     tile stay in shared memory, dq in registers, and the block walks the
//     key blocks of BC = 32 (K and V staged in shared memory, float32).
//     With causal, key blocks wholly above the tile's diagonal are skipped.
//   - B4: one block owns (b*h, a tile of BR keys): k and v of the tile stay
//     in shared memory, dk and dv in registers, and the block walks the
//     query blocks of 32 rows (q, do, lse and delta staged).  The bias is
//     read with the roles of the two tile indices swapped: row = the staged
//     query, column = the owned key.  With causal, query blocks wholly
//     before the key tile are skipped.
//   - In both, each of the NW warps owns RPW rows of the resident tile and
//     lane c owns row c of the staged block for S and dP (no cross-lane sum
//     per score); P and dS reach the second products through warp-private
//     shared buffers, where lane c owns head dims c, c + 32, ...
// BR follows the head dim as in the forward (32 / 16 / 8 rows for D = 64 /
// 128 / 256), which keeps the two [BR, D] accumulators of B4 at 32
// registers a thread and its shared memory at 42 / 52 / 85 KB.
//
// What bounds them on this card: 6*D (B3) and 8*D (B4) operations per
// (row, key) pair against the operands read once: in float32 the CUDA
// cores' arithmetic, in bfloat16 the bytes (the tensor cores would outrun
// them).  These first kernels compute in float32 on the CUDA cores; wgmma
// and TMA staging are later work.
//
// Contracts shared with the plain PyTorch versions
// flash_attention_bwd_dq_reference and flash_attention_bwd_dkv_reference in
// paddle_tpu_torch/ops/flash_attention.py, whose wrappers check shapes
// (S % 128 == 0, D in {64, 128, 256}), dtypes and contiguity before a
// launch.  Built by paddle_tpu_torch/native/build.py into a library with a
// plain C interface: each entry point launches on the caller's stream and
// returns cudaGetLastError().

#include "flash_common.cuh"

namespace {

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

template <typename TQ, typename TB, int VPT>
struct LaunchDq {
  static cudaError_t run(const Args& a) {
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
};

template <typename TQ, typename TB, int VPT>
struct LaunchDkv {
  static cudaError_t run(const Args& a) {
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
