// fused_mlp_int8 — one layer's SwiGLU MLP at decode M from int8 weights:
//   out = (silu((xn @ Wg) * sg) * ((xn @ Wu) * su), rounded to xn's dtype) @ Wd * sd
//
// Replaces the Pallas kernel mimic_tpu/ops/quant.py::_mlp_kernel (pallas_call at
// quant.py:591, fused_mlp_stacked).  Contract: xn [M, D] fp32 or bf16; gate|up
// [D, 2F] int8 (gate in columns [0, F), up in [F, 2F)) with scales [2F] fp32;
// down [F, D] int8 with scales [D] fp32 (the wrapper offsets all four pointers
// to one layer of their stacks); out [M, D].  As in JAX, the gate/up scales
// apply before silu and silu(g)*u is rounded to the activation dtype before the
// down product; the down scale applies once, at the end.
//
// What bounds it on the H100.  A decode step streams 3*D*F int8 bytes per layer
// (176 MB at D 4096, F 14336: 53 us at 3.35 TB/s) with M multiply-adds per byte
// on the fp32 cores.
//
// Design.  On the TPU the F-block grid axis runs in order and carries one
// [M, D] fp32 accumulator in VMEM.  Here the F-blocks run in parallel: one CTA
// per 64 columns of F (224 CTAs at F 14336) computes its gate and up columns
// over the whole D (one 128-column tile: 64 gate + 64 up, int8_common.cuh's
// accumulate), applies the scales and silu(g)*u in shared memory (the [M, 2F]
// intermediate never reaches device memory), then multiplies that [M, 64] block
// by its 64 rows of Wd and writes an fp32 [M, D] partial.  A second kernel adds
// the partials in block order and applies sd: no atomics, runs repeat bit for
// bit.  The partials cost 224*M*D*4 bytes (44 MB at M 12) against the 176 MB
// of weights; fewer, wider F-blocks would leave SMs idle.

#include "int8_common.cuh"

namespace mimic_q {

constexpr int FB = 64;  // F columns per CTA: half of the BN-wide gate|up tile

template <typename T, int MB>
__global__ void __launch_bounds__(NT)
    fused_mlp_kernel(const T* __restrict__ xn, const int8_t* __restrict__ gu,
                     const float* __restrict__ gu_scale, const int8_t* __restrict__ down,
                     float* __restrict__ work, int M, int D, int F) {
  __shared__ __align__(16) int8_t Ws[KT][BN];
  __shared__ __align__(16) float Xs[KT][MB_MAX];
  __shared__ __align__(16) float Red[MB_MAX][BN];
  __shared__ float Hs[MB_MAX][FB];
  const int fb = blockIdx.x, f0 = fb * FB, m0 = blockIdx.y * MB;
  const size_t F2 = 2 * static_cast<size_t>(F);

  // gate and up columns of this F-block over the whole D
  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  auto wrow = [&](int k, int c) -> const int4* {
    const int col = c < 4 ? f0 + c * 16 : F + f0 + (c - 4) * 16;
    return reinterpret_cast<const int4*>(gu + static_cast<size_t>(k) * F2 + col);
  };
  accumulate<T, MB>(xn, D, M, m0, 0, D, wrow, Ws, Xs, acc);
  reduce_warps<MB>(acc, Red);

  // h = silu(g * sg) * (u * su), rounded to T (rows beyond M give 0)
  for (int i = threadIdx.x; i < MB * FB; i += NT) {
    const int m = i / FB, f = i % FB;
    const float g = Red[m][f] * gu_scale[f0 + f];
    const float u = Red[m][FB + f] * gu_scale[F + f0 + f];
    Hs[m][f] = round_to<T>(g / (1.f + expf(-g)) * u);
  }
  __syncthreads();

  // partial down product of this F-block: thread t owns 4 columns of D per pass
  for (int d0 = 4 * threadIdx.x; d0 < D; d0 += 4 * NT) {
    float acc2[MB][4];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc2[m][j] = 0.f;
#pragma unroll 8
    for (int f = 0; f < FB; ++f) {
      float wf[4];
      unpack4(__ldg(reinterpret_cast<const unsigned int*>(
                  down + static_cast<size_t>(f0 + f) * D + d0)),
              wf);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float h = Hs[m][f];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[m][j] = fmaf(h, wf[j], acc2[m][j]);
      }
    }
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      if (m0 + m < M) {
        float4* dst = reinterpret_cast<float4*>(
            work + (static_cast<size_t>(fb) * M + m0 + m) * D + d0);
        *dst = make_float4(acc2[m][0], acc2[m][1], acc2[m][2], acc2[m][3]);
      }
    }
  }
}

template <typename T, int MB>
static cudaError_t run(const void* xn, const int8_t* gu, const float* gs, const int8_t* down,
                       float* work, int M, int D, int F, cudaStream_t stream) {
  dim3 grid(F / FB, (M + MB - 1) / MB);
  fused_mlp_kernel<T, MB>
      <<<grid, NT, 0, stream>>>(static_cast<const T*>(xn), gu, gs, down, work, M, D, F);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t run_rows(const void* xn, const int8_t* gu, const float* gs,
                            const int8_t* down, float* work, int M, int D, int F,
                            cudaStream_t stream) {
  switch (rows_per_cta(M)) {
    case 4:
      return run<T, 4>(xn, gu, gs, down, work, M, D, F, stream);
    case 8:
      return run<T, 8>(xn, gu, gs, down, work, M, D, F, stream);
    default:
      return run<T, 16>(xn, gu, gs, down, work, M, D, F, stream);
  }
}

}  // namespace mimic_q

// dtype, out_dtype: 0 = float32, 1 = bfloat16.  work: fp32 [F / 64 * M * D].
// Needs F % 64 == 0 and D % 16 == 0.
extern "C" int mimic_fused_mlp_int8(const void* xn, const void* gu, const void* gu_scale,
                                    const void* down, const void* down_scale, void* work,
                                    void* out, int M, int D, int F, int dtype, int out_dtype,
                                    void* stream) {
  using namespace mimic_q;
  if (F % FB != 0 || D % 16 != 0 || M <= 0 || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* g8 = static_cast<const int8_t*>(gu);
  const int8_t* d8 = static_cast<const int8_t*>(down);
  const float* gs = static_cast<const float*>(gu_scale);
  float* ws = static_cast<float*>(work);
  cudaError_t e;
  if (dtype == 0) {
    e = run_rows<float>(xn, g8, gs, d8, ws, M, D, F, st);
  } else if (dtype == 1) {
    e = run_rows<__nv_bfloat16>(xn, g8, gs, d8, ws, M, D, F, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_reduce(ws, static_cast<const float*>(down_scale), out, M, D,
                                        F / FB, out_dtype, st));
}
