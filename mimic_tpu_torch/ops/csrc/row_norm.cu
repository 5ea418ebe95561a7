// row_norm — LayerNorm (with or without bias) and RMSNorm over the last axis of
// rows [M, D], the statistics and the affine in fp32 and one rounding to the
// rows' type:
//   layer_norm: mean = sum(x) / D, var = sum((x - mean)^2) / D,
//               y = ((x - mean) * rstd) * w + b
//   rms_norm:   var = sum(x^2) / D, y = (x * rstd) * w
//   with rstd = 1 / sqrt(var + eps), a true square root and a true division.
//
// Replaces no Pallas kernel.  On the TPU, XLA fuses mimic_tpu/models/layers.py::
// layer_norm (:28) and ::rms_norm (:20) into one pass over the rows; the port's
// plain versions (mimic_tpu_torch/ops/norms.py::layer_norm_plain, ::rms_norm_plain)
// run as about ten separate fp32 passes over device memory.  This kernel gives the
// port the one pass.  Contract (ops/norms.py::layer_norm, ::rms_norm): the plain
// version's steps, each rounded to fp32 as the plain version rounds it (the affine
// by __fmul_rn / __fadd_rn, never contracted to a fused multiply-add), the sums
// taken in another order, one rounding to bf16 at the end.
//
// What bounds it on the H100: bytes.  One read of x and one write of y,
// 2·M·D·sizeof(T); w and b (D each) come from L1.  At the SigLIP rows of an
// idefics2-8b train step, 99,840 × 1152 bf16: 460 MB, 0.137 ms at 3.35 TB/s.
//
// Design.  Each row is held by a group of G lanes of one warp (G a power of two,
// at most 32, chosen from D), each lane keeping NV 16-byte vectors of it in
// registers (E = 8 bf16 or 4 fp32 elements each); lane g holds vectors g, g+G,
// g+2G, ..., so each load instruction of a warp reads 32 neighbouring vectors.
// The row is read once, all NV loads issued before the first use; the mean, then
// the variance around it, are taken from the registers (two fp32 passes over
// registers, each reduced across the group by warp shuffles: no shared memory, no
// second kernel), and the normalized row is written once, 16 bytes a store.  NV is
// a template argument: the smallest of 1, 2, 4, 5, 8, 10, 16, 32 that covers
// D / (32 E), so one algorithm serves every width that is a whole number of
// vectors up to 32 · 32 vectors (8192 bf16, 4096 fp32); a lane's slots past the
// row's last vector stay idle (1152 bf16: 144 vectors over 32 lanes × 5 slots).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mimic_rownorm {

constexpr int THREADS = 128;
constexpr int MAX_NV = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16& out) { out = __float2bfloat16_rn(v); }

// E consecutive affine values (w or b) from element e0, as fp32, from bf16 or fp32
template <int E>
__device__ __forceinline__ void load_affine(const void* p, int bf16, int e0, float (&out)[E]) {
  if (bf16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + e0;
    if constexpr (E == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < E; ++k) out[k] = to_f(h[k]);
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(q));
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < E; ++k) out[k] = to_f(h[k]);
    }
  } else {
    const float* q = static_cast<const float*>(p) + e0;
#pragma unroll
    for (int k = 0; k < E; k += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(q + k));
      out[k] = v.x;
      out[k + 1] = v.y;
      out[k + 2] = v.z;
      out[k + 3] = v.w;
    }
  }
}

// sum over the G lanes of this lane's group (G a power of two: the xor partners of
// offsets below G stay inside the group); every lane of the warp takes part
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// w_bf16: w and b stored in bf16 (else fp32); b null: no bias
template <typename T, bool RMS, int NV>
__global__ void __launch_bounds__(THREADS)
    row_norm_kernel(const T* __restrict__ x, const void* __restrict__ w,
                    const void* __restrict__ b, T* __restrict__ y, int M, int D, int G,
                    int w_bf16, float eps) {
  constexpr int E = 16 / sizeof(T);
  const int sub = threadIdx.x & (G - 1);  // this lane's place in its row's group
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / G) + threadIdx.x / G;
  const bool live = row < M;               // a dead group still joins the shuffles
  const int nvec = D / E;
  const size_t base = live ? static_cast<size_t>(row) * D : 0;
  const int4* xr = reinterpret_cast<const int4*>(x + base);

  int4 v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = sub + j * G;
    v[j] = live && i < nvec ? __ldg(xr + i) : make_int4(0, 0, 0, 0);
  }

  // pass 1 over the registers: sum(x) (layer_norm) or sum(x^2) (rms_norm); the
  // idle slots hold zeros and add nothing
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float xf = to_f(e[k]);
      s = RMS ? fmaf(xf, xf, s) : s + xf;
    }
  }
  s = group_sum(s, G);
  const float fd = static_cast<float>(D);
  float mean = 0.f, var;
  if constexpr (RMS) {
    var = __fdiv_rn(s, fd);
  } else {
    mean = __fdiv_rn(s, fd);
    // pass 2 over the registers: sum((x - mean)^2) over the row's own slots
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (sub + j * G < nvec) {
        const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float d = __fsub_rn(to_f(e[k]), mean);
          s2 = fmaf(d, d, s2);
        }
      }
    }
    var = __fdiv_rn(group_sum(s2, G), fd);
  }
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  if (!live) return;

  int4* yr = reinterpret_cast<int4*>(y + base);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = sub + j * G;
    if (i < nvec) {
      const T* e = reinterpret_cast<const T*>(&v[j]);
      float wv[E], bv[E];
      load_affine<E>(w, w_bf16, i * E, wv);
      if (!RMS && b != nullptr) load_affine<E>(b, w_bf16, i * E, bv);
      int4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float xf = to_f(e[k]);
        float t = __fmul_rn(RMS ? xf : __fsub_rn(xf, mean), rstd);
        t = __fmul_rn(t, wv[k]);
        if (!RMS && b != nullptr) t = __fadd_rn(t, bv[k]);
        from_f(t, o[k]);
      }
      yr[i] = out;
    }
  }
}

// lanes a row (G) and 16-byte vectors a lane (NV) at width D; false where the
// kernel does not take D
template <typename T>
bool plan(int D, int* G, int* NV) {
  constexpr int E = 16 / sizeof(T);
  if (D <= 0 || D % E) return false;
  const int nvec = D / E;
  int g = 1;
  while (g < 32 && g < nvec) g <<= 1;
  const int need = (nvec + g - 1) / g;
  static const int choices[] = {1, 2, 4, 5, 8, 10, 16, MAX_NV};
  for (int c : choices) {
    if (c >= need) {
      *G = g;
      *NV = c;
      return true;
    }
  }
  return false;
}

template <typename T, bool RMS>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int M, int D,
                   int w_bf16, float eps, cudaStream_t st) {
  int G, NV;
  if (!plan<T>(D, &G, &NV)) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((static_cast<long long>(M) + THREADS / G - 1) /
                                              (THREADS / G));
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
#define MIMIC_ROW_NORM_CASE(N)                                                             \
  case N:                                                                                  \
    row_norm_kernel<T, RMS, N><<<grid, THREADS, 0, st>>>(xt, w, b, yt, M, D, G, w_bf16, eps); \
    break;
  switch (NV) {
    MIMIC_ROW_NORM_CASE(1)
    MIMIC_ROW_NORM_CASE(2)
    MIMIC_ROW_NORM_CASE(4)
    MIMIC_ROW_NORM_CASE(5)
    MIMIC_ROW_NORM_CASE(8)
    MIMIC_ROW_NORM_CASE(10)
    MIMIC_ROW_NORM_CASE(16)
    MIMIC_ROW_NORM_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef MIMIC_ROW_NORM_CASE
  return cudaGetLastError();
}

}  // namespace mimic_rownorm

// dtype: 0 = float32, 1 = bfloat16 (the rows'); out: the kernel's lanes a row and
// 16-byte vectors a lane at width D.  Returns cudaErrorInvalidValue where the
// kernel does not take D.
extern "C" int mimic_row_norm_plan(int D, int dtype, int* lanes, int* vectors) {
  using namespace mimic_rownorm;
  const bool ok = dtype == 0   ? plan<float>(D, lanes, vectors)
                  : dtype == 1 ? plan<__nv_bfloat16>(D, lanes, vectors)
                               : false;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// x, y [M, D] row-major, 16-byte aligned; w, b [D] (b null: no bias; unused by
// rms_norm), in w_dtype (0 = float32, 1 = bfloat16), aligned to E of their
// elements; rms: 0 = layer_norm, 1 = rms_norm.
extern "C" int mimic_row_norm(const void* x, const void* w, const void* b, void* y, int M, int D,
                              int dtype, int w_dtype, int rms, float eps, void* stream) {
  using namespace mimic_rownorm;
  if (M <= 0 || (w_dtype != 0 && w_dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = rms ? launch<float, true>(x, w, b, y, M, D, w_dtype, eps, st)
            : launch<float, false>(x, w, b, y, M, D, w_dtype, eps, st);
  } else if (dtype == 1) {
    e = rms ? launch<__nv_bfloat16, true>(x, w, b, y, M, D, w_dtype, eps, st)
            : launch<__nv_bfloat16, false>(x, w, b, y, M, D, w_dtype, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
