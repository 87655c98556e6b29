// Weight-only dequant-fused matmul for Hopper (sm_90a): B7.
//
//   x      [M, K]  float32 or bfloat16, row-major, contiguous
//   q      [K, N]  int8 or float8 e4m3 (__nv_fp8_e4m3) carrier, row-major
//   scale  [N]     float32, one step size per output channel
//   out    [M, N]  float32 or bfloat16, row-major
//
//   out[m, n] = sum_k x[m, k] * (float(q[k, n]) * scale[n])
//
// held to float32: the plain version (dequant_matmul_reference in
// paddle_tpu_torch/ops/quant_ops.py) dequantizes the weight in float32 and
// runs a float32 matmul, and the kernel agrees with it within 2^-20 of
// sum_k |x w| per element.  Every M, K, N is taken: tiles at the edges are
// guarded and zero-padded (N = 2, K = 300, unaligned rows included), so no
// shape falls back to the plain version.
//
// Replaces _dequant_matmul_kernel in paddle_tpu/ops/quant_ops.py (launched by
// _dequant_matmul_call: grid (M/256, N/256, K/512), the K axis sequential on
// the TPU core with a float32 accumulator in VMEM scratch, x and the
// dequantized carrier tile cast to float32; shapes those tiles do not
// divide fall back to the jnp reference there).
//
// What bounds it on this card: the main path's largest call (BERT-base FFN-up
// at batch 32: M = 4096, K = 768, N = 3072, float32 x, int8 W) moves 12.6 MB
// of x, 2.4 MB of W and 50.3 MB of out (0.0195 ms at 3.35 TB/s) and does
// 2*M*K*N = 19.3 GFLOP: 0.289 ms on the CUDA cores in float32 (67 TFLOP/s).
// The tensor cores multiply bfloat16 at 989 TFLOP/s, and the product can be
// made exact enough there:
//   - every int8 code (-127..127) and every finite e4m3 value has at most
//     8 significant bits, so the carrier is exact in bfloat16; the scale is
//     not applied to it but once per column after the K sum, which differs
//     from the plain version's float(q) * scale per element by one rounding
//     (2^-24 of each term);
//   - float32 x splits into three bfloat16 pieces, x = hi + mid + lo within
//     2^-24 |x| (split3_pack in mma_common.cuh); each piece times an exact
//     carrier value is exact in float32, so three bfloat16 products with
//     float32 accumulation give the float32 product: 3*2*M*K*N operations,
//     0.059 ms at the bfloat16 peak for the main call.  bfloat16 x is one
//     piece and one product;
//   - the tensor cores' float32 accumulation does not round as IEEE
//     additions do (with every product in one accumulator the error reached
//     the tolerance at K = 768), so for float32 x each K
//     step's twelve products go into a fresh accumulator, small pieces
//     first, that is then added to the running float32 sum on the CUDA
//     cores.
// The design:
//   - one block of 2 warpgroups per 128 x 128 output tile; warpgroup G owns
//     rows 64G .. 64G + 63 and runs wgmma m64n128k16: A (x, or its pieces)
//     from registers, each warp's 16 rows in the mma.m16n8k16 A layout, so
//     that float32 x is split as its fragments are formed; B (the carrier)
//     from shared memory by descriptor; K in steps of 64;
//   - x (as float32 or bfloat16) and the raw carrier bytes are staged with
//     cp.async into a ring of 3 steps, so the loads of the steps ahead
//     overlap this step's products, with one barrier a step; edges and the
//     K tail are zero-filled in both operands; a carrier row that is not
//     16-byte aligned (N % 16 != 0) and an x row that is not (K % 4 != 0 in
//     float32, % 8 in bfloat16) are staged by narrower plain loads instead;
//   - while a step's products run, the next step's carrier tile is widened
//     to bfloat16, once per block, into the K-major, 128-byte-swizzled
//     layout wgmma reads (double-buffered);
//   - small M splits K (the batch-1 FFN, the pooler, the NSP head launch
//     too few tiles for 132 SMs): blockIdx.z takes a K range, writes its
//     unscaled float32 partial sums to a workspace the wrapper allocates, and
//     a second kernel sums the partials in a fixed order, applies the scale
//     and rounds: deterministic, no atomics.  The split is planned in
//     Python (plan_split_k in ops/quant_ops.py).
//
// Built by paddle_tpu_torch/native/build.py into a library with a plain C
// interface: the entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

// One block of 2 warpgroups (8 warps) per 128 x 128 output tile: warpgroup
// G owns rows 64G .. 64G + 63, each of its warps 16 of them, all 128
// columns; K in steps of 64.
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int KS = BK / 16;  // 16-deep steps a K step
constexpr int THREADS = 256;
// The carrier tile as wgmma reads it: K-major, 128-byte swizzle: row n holds
// its 64 k as eight 16-byte chunks, chunk c stored at c ^ (n % 8); 8-row
// atoms of 1024 bytes.
constexpr int WB_BYTES = BN * BK * 2;

enum XDType : int { kF32 = 0, kBF16 = 1 };
enum WDType : int { kInt8 = 0, kFp8E4M3 = 1 };

template <typename XT>
struct XTile {
  static constexpr int LD = BK + 8;
  static constexpr int EPC = 16 / sizeof(XT);
  static constexpr int STAGES = 3;
  static constexpr int SMEM = 1024 + 2 * WB_BYTES +  // 1024: the alignment
                              STAGES * BM * LD * (int)sizeof(XT) +
                              STAGES * BK * BN;
};

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

template <int W>
__device__ __forceinline__ void carrier4(uint32_t w, float (&f)[4]);
template <>
__device__ __forceinline__ void carrier4<kInt8>(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
}
template <>
__device__ __forceinline__ void carrier4<kFp8E4M3>(uint32_t w,
                                                   float (&f)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>((w >> (8 * i)) & 0xFFu);
    f[i] = static_cast<float>(v);
  }
}

template <typename XT>
__device__ __forceinline__ void stage_x(XT* xs, const XT* __restrict__ x,
                                        int M, int K, int m0, int k0, int ke,
                                        bool vec, int tid) {
  using T = XTile<XT>;
  if (vec) {
    constexpr int PER_ROW = BK / T::EPC;
#pragma unroll
    for (int c = tid; c < BM * PER_ROW; c += THREADS) {
      const int r = c / PER_ROW, col = (c % PER_ROW) * T::EPC;
      const int gm = m0 + r, gk = k0 + col;
      const int n = gm < M ? min(max(ke - gk, 0), T::EPC) : 0;
      cp_async16(xs + r * T::LD + col,
                 n ? x + (size_t)gm * K + gk : x, n * (int)sizeof(XT));
    }
  } else {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, col = e % BK;
      const int gm = m0 + r, gk = k0 + col;
      xs[r * T::LD + col] =
          gm < M && gk < ke ? x[(size_t)gm * K + gk] : from_f32<XT>(0.f);
    }
  }
}

__device__ __forceinline__ void stage_w(uint8_t* wr,
                                        const uint8_t* __restrict__ q, int N,
                                        int n0, int k0, int ke, bool vec,
                                        int tid) {
  if (vec) {
#pragma unroll
    for (int c = tid; c < BK * BN / 16; c += THREADS) {
      const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      const int gk = k0 + r, gn = n0 + col;
      const int n = gk < ke ? min(max(N - gn, 0), 16) : 0;
      cp_async16(wr + r * BN + col, n ? q + (size_t)gk * N + gn : q, n);
    }
  } else {
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, col = e % BN;
      const int gk = k0 + r, gn = n0 + col;
      wr[e] = gk < ke && gn < N ? q[(size_t)gk * N + gn] : 0;
    }
  }
}

// Widen the raw carrier tile [BK][BN] (n contiguous) to bfloat16 in the
// swizzled K-major layout above.  Thread t takes n = 4 (t % 32) .. + 3 and
// the 8 k of chunk t / 32.
template <int W>
__device__ __forceinline__ void widen_w(uint8_t* wb, const uint8_t* wr,
                                        int tid) {
  const int nq = tid % 32, c = tid / 32;
  uint32_t packed[4][4];  // [n - 4 nq][k pair]: bfloat16 pairs
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // rows k = 8c + 2i, 8c + 2i + 1
    float f0[4], f1[4];
    const uint8_t* row = wr + (8 * c + 2 * i) * BN + 4 * nq;
    carrier4<W>(*reinterpret_cast<const uint32_t*>(row), f0);
    carrier4<W>(*reinterpret_cast<const uint32_t*>(row + BN), f1);
#pragma unroll
    for (int j = 0; j < 4; ++j) packed[j][i] = pack_bf16(f0[j], f1[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 4 * nq + j;
    *reinterpret_cast<uint4*>(wb + (n / 8) * 1024 + (n % 8) * 128 +
                              ((c ^ (n % 8)) * 16)) =
        make_uint4(packed[j][0], packed[j][1], packed[j][2], packed[j][3]);
  }
}

// Descriptor of a K-major, 128-byte-swizzled operand: start address,
// leading offset 1 (unused by this layout), stride 1024 bytes between 8-row
// atoms, layout type 1 (128B swizzle).  A 16-deep step at k starts 2k bytes
// into the atom.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// must neither move nor reuse them across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= a b for this warpgroup's 64 x 128 tile: a from registers (this
// warp's 16 rows, the mma.m16n8k16 A layout), b [16 x 128] by descriptor;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

template <typename OT>
__device__ __forceinline__ void store2(OT* p, float a, float b, bool pair,
                                       bool second) {
  if (pair) {
    if constexpr (std::is_same<OT, float>::value) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
    }
  } else {
    p[0] = from_f32<OT>(a);
    if (second) p[1] = from_f32<OT>(b);
  }
}

// This warp's A fragments of one K step of float32 x, split into three
// bfloat16 pieces.
template <int LD>
__device__ __forceinline__ void split_x(uint32_t (&pc)[KS][3][4],
                                        const float* xb, int wrow, int g,
                                        int t) {
#pragma unroll
  for (int h = 0; h < KS; ++h) {
    const float* base = xb + (wrow + g) * LD + 16 * h + 2 * t;
    const float2 v[4] = {*reinterpret_cast<const float2*>(base),
                         *reinterpret_cast<const float2*>(base + 8 * LD),
                         *reinterpret_cast<const float2*>(base + 8),
                         *reinterpret_cast<const float2*>(base + 8 * LD + 8)};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3_pack(v[e].x, v[e].y, pc[h][2][e], pc[h][1][e], pc[h][0][e]);
  }
}

template <typename XT, int W, typename OT>
__global__ void __launch_bounds__(THREADS)
    dequant_matmul_mma_kernel(const XT* __restrict__ x,
                              const uint8_t* __restrict__ q,
                              const float* __restrict__ scale,
                              OT* __restrict__ out, float* __restrict__ ws,
                              int M, int K, int N, int k_chunk, int x_vec,
                              int w_vec) {
  using T = XTile<XT>;
  constexpr int S = T::STAGES;
  constexpr bool kF = std::is_same<XT, float>::value;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint8_t* wb = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  XT* xs = reinterpret_cast<XT*>(wb + 2 * WB_BYTES);  // [S][BM][LD]
  uint8_t* wr =                                        // [S][BK][BN]
      reinterpret_cast<uint8_t*>(xs + S * BM * T::LD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;  // this warp's 16 rows of the block's 128
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_chunk, ke = min(K, kb + k_chunk);
  const int steps = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  const auto load = [&](int step) {
    if (step < steps) {
      const int slot = step % S, k0 = kb + step * BK;
      stage_x(xs + slot * BM * T::LD, x, M, K, m0, k0, ke, x_vec, tid);
      stage_w(wr + slot * BK * BN, q, N, n0, k0, ke, w_vec, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) load(s);
  if (steps > 0) {
    cp_async_wait<S - 2>();
    __syncthreads();
    widen_w<W>(wb, wr, tid);
    fence_async_smem();
  }
  float p[kF ? 64 : 1];            // one K step's products (float32 x)
  uint32_t pc[kF ? KS : 1][3][4];  // x's pieces [16-deep step][lo, mid, hi]
  uint32_t a[kF ? 1 : KS][4];      // bfloat16 x's fragments
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S - 3>();  // step s + 1 landed, as far as this thread goes
    // One barrier a step: every thread's copies of step s + 1 and the
    // widened carrier of step s are visible (the latter to the tensor cores
    // too), and every warp is done with step s - 1, whose slots the next
    // load and widening overwrite.
    __syncthreads();
    load(s + S - 1);
    const XT* xb = xs + (s % S) * BM * T::LD;
    const uint8_t* wbs = wb + (s & 1) * WB_BYTES;
    if constexpr (kF) {
      split_x<T::LD>(pc, xb, wrow, g, t);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < KS; ++h)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          wgmma_128(p, pc[h][c], wgmma_desc(wbs + 32 * h), h + c > 0);
    } else {
#pragma unroll
      for (int h = 0; h < KS; ++h)
        ldmatrix_x4(a[h], xb + (wrow + (lane % 8) + ((lane / 8) % 2) * 8) *
                                   T::LD +
                               16 * h + (lane / 16) * 8);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < KS; ++h)
        wgmma_128(acc, a[h], wgmma_desc(wbs + 32 * h), 1);
    }
    wgmma_commit();
    if (s + 1 < steps) {  // the next step's carrier, while the products run
      widen_w<W>(wb + ((s + 1) & 1) * WB_BYTES, wr + ((s + 1) % S) * BK * BN,
                 tid);
      fence_async_smem();
    }
    wgmma_wait<0>();
    if constexpr (kF) {
      fence_regs(p);
#pragma unroll
      for (int h = 0; h < KS; ++h)
#pragma unroll
        for (int c = 0; c < 3; ++c) fence_regs(pc[h][c]);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += p[e];
    } else {
      fence_regs(acc);
#pragma unroll
      for (int h = 0; h < KS; ++h) fence_regs(a[h]);
    }
  }

  const bool even = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int gn = n0 + j * 8 + 2 * t;
    if (gn >= N) continue;
    const bool second = gn + 1 < N;
    const float s0 = ws == nullptr ? scale[gn] : 1.f;
    const float s1 = ws == nullptr && second ? scale[gn + 1] : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wrow + g + 8 * h;
      if (gm >= M) continue;
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      if (ws == nullptr) {
        store2(out + (size_t)gm * N + gn, a * s0, b * s1, even && second,
               second);
      } else {
        store2(ws + ((size_t)blockIdx.z * M + gm) * N + gn, a, b,
               even && second, second);
      }
    }
  }
}

// out[m, n] = (the sum over the splits of ws[split][m][n]) * scale[n], in a
// fixed order.  Few splits: a thread an element, the splits in order.  Many
// (kWarp): a warp an element, lane l summing splits l, l + 32, ... in order,
// then a fixed shuffle tree.
template <typename OT, bool kWarp>
__global__ void __launch_bounds__(256)
    dequant_matmul_splitk_sum_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ scale,
                                     OT* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t total = (size_t)M * N;
  const size_t stride = (size_t)gridDim.x * blockDim.x / (kWarp ? 32 : 1);
  const int lane = threadIdx.x % 32;
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) /
                  (kWarp ? 32 : 1);
       i < total; i += stride) {
    float s = 0.f;
    if (kWarp) {
      for (int z = lane; z < splits; z += 32) s += ws[(size_t)z * total + i];
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, w);
    } else {
      for (int z = 0; z < splits; ++z) s += ws[(size_t)z * total + i];
    }
    if (!kWarp || lane == 0) out[i] = from_f32<OT>(s * scale[i % N]);
  }
}

template <typename XT, int W, typename OT>
int launch(const void* x, const void* q, const float* scale, void* out,
           float* ws, int M, int K, int N, int splits, int k_chunk,
           cudaStream_t stream) {
  if (splits < 1 || (splits > 1 && ws == nullptr) ||
      (long long)splits * k_chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int EPC = XTile<XT>::EPC;
  const int x_vec = K % EPC == 0 && k_chunk % EPC == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const auto kernel = dequant_matmul_mma_kernel<XT, W, OT>;
  constexpr int kSmem = XTile<XT>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, kSmem, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(q), scale,
      static_cast<OT*>(out), splits > 1 ? ws : nullptr, M, K, N, k_chunk,
      x_vec, w_vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  // a warp an element where there are many splits and few elements
  const bool by_warp = splits > 8 && (long long)M * N <= 8192;
  const long long threads = (long long)M * N * (by_warp ? 32 : 1);
  const long long want = (threads + 255) / 256, most = 132LL * 16;
  const int blocks = static_cast<int>(want < most ? want : most);
  if (by_warp)
    dequant_matmul_splitk_sum_kernel<OT, true><<<blocks, 256, 0, stream>>>(
        ws, scale, static_cast<OT*>(out), M, N, splits);
  else
    dequant_matmul_splitk_sum_kernel<OT, false><<<blocks, 256, 0, stream>>>(
        ws, scale, static_cast<OT*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, int W>
int by_out(int out_dtype, const void* x, const void* q, const float* scale,
           void* out, float* ws, int M, int K, int N, int splits, int k_chunk,
           cudaStream_t stream) {
  if (out_dtype == kF32)
    return launch<XT, W, float>(x, q, scale, out, ws, M, K, N, splits,
                                k_chunk, stream);
  if (out_dtype == kBF16)
    return launch<XT, W, __nv_bfloat16>(x, q, scale, out, ws, M, K, N,
                                        splits, k_chunk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename XT>
int by_carrier(int w_dtype, int out_dtype, const void* x, const void* q,
               const float* scale, void* out, float* ws, int M, int K, int N,
               int splits, int k_chunk, cudaStream_t stream) {
  if (w_dtype == kInt8)
    return by_out<XT, kInt8>(out_dtype, x, q, scale, out, ws, M, K, N, splits,
                             k_chunk, stream);
  if (w_dtype == kFp8E4M3)
    return by_out<XT, kFp8E4M3>(out_dtype, x, q, scale, out, ws, M, K, N,
                                splits, k_chunk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* paddle_dequant_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B7.  x [M, K] (x_dtype: 0 float32, 1 bfloat16), q [K, N] (w_dtype: 0 int8,
// 1 float8 e4m3), scale [N] float32, out [M, N] (out_dtype: 0 float32, 1
// bfloat16); M, N >= 1.  K is cut into `splits` ranges of k_chunk (the last
// one shorter; splits * k_chunk >= K); with splits > 1, ws is a float32
// workspace of splits * M * N elements.  Returns cudaGetLastError() after
// the launches.
int paddle_dequant_matmul(const void* x, const void* q, const float* scale,
                          void* out, float* ws, int M, int K, int N,
                          int splits, int k_chunk, int x_dtype, int w_dtype,
                          int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return by_carrier<float>(w_dtype, out_dtype, x, q, scale, out, ws, M, K,
                             N, splits, k_chunk, s);
  if (x_dtype == kBF16)
    return by_carrier<__nv_bfloat16>(w_dtype, out_dtype, x, q, scale, out,
                                     ws, M, K, N, splits, k_chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
