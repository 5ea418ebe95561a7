// Shared pieces of the int8 kernels (int8_matmul.cu, fused_mlp_int8.cu, prompt_attn_int8.cu).
//
// The decode-M weight product of fp32 activations (bf16 activations take the
// tensor-core product of int8_mma.cuh).  A CTA of NT = 256 threads owns BN = 128 output
// columns and up to MB <= 16 activation rows, and walks a range of the
// contraction axis in tiles of KT = 64 weight rows:
//
//   - the int8 weight tile [KT, BN] is copied to shared memory with 16-byte loads
//     along N (two per thread), the activation tile [MB, KT] is copied transposed
//     to shared memory as fp32; the next tile's loads are issued into registers
//     before the current tile is computed, so one tile's reads are in flight while
//     the other is multiplied;
//   - warp w takes rows 8w..8w+7 of each tile, lane t columns 4t..4t+3: one
//     32-bit shared load gives its four int8 weights, converted to fp32 in
//     registers (int8 values are exact in fp32), and each float4 of
//     activations (a broadcast) feeds 16 fused multiply-adds into acc[MB][4];
//   - after the loop the eight warps' sums are added in shared memory in warp
//     order (reduce_warps): no atomics, so every run gives the same bits.
//
// Scales multiply the fp32 sums once, at the end, as the Pallas kernels do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mimic_q {

constexpr int NT = 256;      // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int BN = 128;      // output columns per CTA: 32 lanes x 4
constexpr int KT = 64;       // weight rows per staged tile: 8 warps x 8
constexpr int MB_MAX = 16;   // activation rows per CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded through T (the activation dtype), as JAX's .astype(x.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// out_dtype: 0 = float32, 1 = bfloat16
__device__ __forceinline__ void store_out(void* out, size_t i, int out_dtype, float v) {
  if (out_dtype == 0) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  }
}

// four int8 packed little-endian in a 32-bit word → four exact floats
__device__ __forceinline__ void unpack4(uint32_t w, float f[4]) {
  f[0] = static_cast<float>(static_cast<int8_t>(w & 0xffu));
  f[1] = static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu));
  f[2] = static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu));
  f[3] = static_cast<float>(static_cast<int8_t>(w >> 24));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[m][j] += sum over k in [k_begin, k_end) of x[m0 + m][k] * W[k][col(4 * lane + j)]
// x: [M, ldx] row-major activations.  wrow(k, c) gives the address of the 16
// weight bytes of row k for the tile's 16-byte chunk c (0..7), or nullptr for
// columns beyond the edge (read as zero).
template <int MB, class WRow>
__device__ __forceinline__ void accumulate(const float* x, int ldx, int M, int m0, int k_begin,
                                           int k_end, const WRow& wrow, int8_t (*Ws)[BN],
                                           float (*Xs)[MB_MAX], float (&acc)[MB][4]) {
  static_assert(MB % 4 == 0 && MB <= MB_MAX, "MB must be 4, 8 or 16");
  constexpr int XE = KT * MB / NT;  // activation elements per thread and tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int4 wreg[2];
  float xreg[XE];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + NT * e, row = i >> 3, c = i & 7, k = k0 + row;
      const int4* src = k < k_end ? wrow(k, c) : nullptr;
      wreg[e] = src != nullptr ? __ldg(src) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int i = tid + NT * e, m = i / KT, k = k0 + i % KT;
      xreg[e] = (m0 + m < M && k < k_end) ? x[static_cast<size_t>(m0 + m) * ldx + k] : 0.f;
    }
  };

  if (k_begin < k_end) fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + NT * e;
      *reinterpret_cast<int4*>(&Ws[i >> 3][(i & 7) * 16]) = wreg[e];
    }
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int i = tid + NT * e;
      Xs[i % KT][i / KT] = xreg[e];
    }
    __syncthreads();
    if (k0 + KT < k_end) fetch(k0 + KT);
#pragma unroll
    for (int r = 0; r < KT / NWARPS; ++r) {
      const int kk = warp * (KT / NWARPS) + r;
      float wf[4];
      unpack4(*reinterpret_cast<const uint32_t*>(&Ws[kk][4 * lane]), wf);
#pragma unroll
      for (int m4 = 0; m4 < MB / 4; ++m4) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[kk][4 * m4]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[4 * m4 + 0][j] = fmaf(xv.x, wf[j], acc[4 * m4 + 0][j]);
          acc[4 * m4 + 1][j] = fmaf(xv.y, wf[j], acc[4 * m4 + 1][j]);
          acc[4 * m4 + 2][j] = fmaf(xv.z, wf[j], acc[4 * m4 + 2][j]);
          acc[4 * m4 + 3][j] = fmaf(xv.w, wf[j], acc[4 * m4 + 3][j]);
        }
      }
    }
  }
}

// Red[m][c] = sum of the warps' acc, added in warp order (deterministic).
template <int MB>
__device__ __forceinline__ void reduce_warps(const float (&acc)[MB][4], float (*Red)[BN]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = 0; w < NWARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        float4* p = reinterpret_cast<float4*>(&Red[m][4 * lane]);
        float4 v = w == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *p;
        v.x += acc[m][0];
        v.y += acc[m][1];
        v.z += acc[m][2];
        v.w += acc[m][3];
        *p = v;
      }
    }
    __syncthreads();
  }
}

// out[m][n] = (sum over z of work[z][m][n]) * scale[n], in z order, as out_dtype
static __global__ void splitk_reduce(const float* __restrict__ work,
                                     const float* __restrict__ scale, void* out, int M, int N,
                                     int nsplit, int out_dtype) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t MN = static_cast<size_t>(M) * N;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < nsplit; ++z) s += work[z * MN + i];
  store_out(out, i, out_dtype, s * scale[i % N]);
}

static inline cudaError_t launch_reduce(const float* work, const float* scale, void* out, int M, int N,
                                 int nsplit, int out_dtype, cudaStream_t stream) {
  const size_t MN = static_cast<size_t>(M) * N;
  const unsigned blocks = static_cast<unsigned>((MN + 255) / 256);
  splitk_reduce<<<blocks, 256, 0, stream>>>(work, scale, out, M, N, nsplit, out_dtype);
  return cudaGetLastError();
}

// the activation rows one CTA takes for M rows
static inline int rows_per_cta(int M) { return M <= 4 ? 4 : M <= 8 ? 8 : 16; }

}  // namespace mimic_q
