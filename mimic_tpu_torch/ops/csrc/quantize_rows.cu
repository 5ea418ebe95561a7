// quantize_rows — per-row symmetric int8 of the activations that feed w8a8_matmul:
//   s[m] = max(max_k |x[m][k]|, 1e-8) * (fp32) 1/127,
//   x8[m][k] = clamp(rint(x[m][k] / s[m]), -127, 127)   (half to even).
//
// Stands for the XLA fusion of mimic_tpu/ops/quant.py::quantize_rows (quant.py:370),
// which the TPU path runs as one elementwise pass before each W8A8 product; it is
// not a Pallas kernel.  Contract (mimic_tpu_torch/ops/quant.py::quantize_rows):
// bit-identical to the jitted JAX function, fp32 or bf16 rows.  XLA multiplies by
// the fp32 constant 1/127 (INV_127); the second division is a true IEEE one
// (__fdiv_rn, never a reciprocal multiply, which differs in the last bit for some
// x and moves a rint that sits on a half).
//
// What bounds it on the H100: bytes.  One read of x and one write of x8 and s:
// at M 2048 K 4096 bf16, 25 MB, 7.5 us at 3.35 TB/s.
//
// Design.  One CTA of 256 threads per row.  The row is read once, with 16-byte
// loads, into shared memory while each thread keeps its running |x| max; the max
// is reduced across the CTA (warp shuffles, then one word per warp); the
// quantized row is written from shared memory, 8 (bf16) or 4 (fp32) int8 per
// store.  A row too long for the CTA's shared memory (more than 48 KB, K above
// 24,576 bf16 / 12,288 fp32, longer than any row of the path) is read a second
// time from global memory (L2) instead of shared memory; rows whose length or
// start is not a multiple of 16 bytes take scalar loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mimic_qrows {

constexpr int THREADS = 256;
constexpr int MAX_STAGED = 48 * 1024;     // bytes of a row kept in shared memory
constexpr float INV_127 = 1.0f / 127.0f;  // the fp32 constant XLA multiplies by
constexpr float FLOOR = 1e-8f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int8_t quant(float x, float s) {
  const float q = rintf(__fdiv_rn(x, s));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

// VEC: the row is read and written in 16-byte vectors of E elements
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ x8, float* __restrict__ s,
                         int K, int staged) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  __shared__ float wmax[THREADS / 32];
  constexpr int E = 16 / sizeof(T);
  const int m = blockIdx.x, tid = threadIdx.x;
  const T* xr = x + static_cast<size_t>(m) * K;
  int8_t* qr = x8 + static_cast<size_t>(m) * K;
  T* cache = reinterpret_cast<T*>(row_smem);

  float amax = 0.f;
  if constexpr (VEC) {
    const int nv = K / E;
    for (int i = tid; i < nv; i += THREADS) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(xr) + i);
      if (staged) reinterpret_cast<int4*>(cache)[i] = v;
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < E; ++k) amax = fmaxf(amax, fabsf(to_f(e[k])));
    }
  } else {
    for (int k = tid; k < K; k += THREADS) {
      const T v = xr[k];
      if (staged) cache[k] = v;
      amax = fmaxf(amax, fabsf(to_f(v)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((tid & 31) == 0) wmax[tid >> 5] = amax;
  __syncthreads();  // also publishes the staged row
  amax = wmax[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, wmax[w]);
  const float sc = __fmul_rn(fmaxf(amax, FLOOR), INV_127);
  if (tid == 0) s[m] = sc;

  const T* src = staged ? cache : xr;
  if constexpr (VEC) {
    const int nv = K / E;
    for (int i = tid; i < nv; i += THREADS) {
      const int4 v = reinterpret_cast<const int4*>(src)[i];
      const T* e = reinterpret_cast<const T*>(&v);
      uint32_t w[E / 4];
#pragma unroll
      for (int k = 0; k < E / 4; ++k) {
        w[k] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          w[k] |= static_cast<uint32_t>(static_cast<uint8_t>(quant(to_f(e[4 * k + b]), sc))) << (8 * b);
      }
      if constexpr (E == 8) {
        reinterpret_cast<uint2*>(qr)[i] = make_uint2(w[0], w[1]);
      } else {
        reinterpret_cast<uint32_t*>(qr)[i] = w[0];
      }
    }
  } else {
    for (int k = tid; k < K; k += THREADS) qr[k] = quant(to_f(src[k]), sc);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* x8, void* s, int M, int K, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = K % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x8) % (E) == 0;
  const size_t row_bytes = static_cast<size_t>(K) * sizeof(T);
  const int staged = row_bytes <= MAX_STAGED;
  const int smem = staged ? static_cast<int>(row_bytes) : 0;
  auto kernel = vec ? quantize_rows_kernel<T, true> : quantize_rows_kernel<T, false>;
  static bool sized = false;  // per instantiation of launch<T>: both kernels sized at once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(quantize_rows_kernel<T, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_STAGED);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(quantize_rows_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_STAGED);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  kernel<<<M, THREADS, smem, st>>>(static_cast<const T*>(x), static_cast<int8_t*>(x8),
                                   static_cast<float*>(s), K, staged);
  return cudaGetLastError();
}

}  // namespace mimic_qrows

// dtype: 0 = float32, 1 = bfloat16.  x [M, K] row-major, x8 [M, K] int8, s [M] fp32.
extern "C" int mimic_quantize_rows(const void* x, void* x8, void* s, int M, int K, int dtype,
                                   void* stream) {
  using namespace mimic_qrows;
  if (M <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(x, x8, s, M, K, st);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(x, x8, s, M, K, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
