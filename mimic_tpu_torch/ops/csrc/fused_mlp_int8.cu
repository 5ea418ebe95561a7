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
// (176 MB at D 4096, F 14336: 53 us at 3.35 TB/s) with 2 M operations per byte.
//
// bf16 activations (every decode step of the int8 modes): two products on the
// tensor cores (int8_mma.cuh), one launch each.  The first multiplies xn by
// gate|up with column tiles of 64 gate and the 64 matching up columns, so its
// epilogue applies the scales and silu(g)*u and writes h = [M, F] bf16, the
// value JAX rounds (344 KB at M 12, through L2); the [M, 2F] fp32 intermediate
// never reaches device memory.  The second is the int8 matmul of h by Wd with
// sd.  Each sums its K split inside a thread-block cluster: no fp32 partial in
// device memory, no atomics, the same bits on every run.
//
// fp32 activations (the tiny fp32 slices): the scalar kernel.  One CTA per 64
// columns of F computes its gate and up columns over the whole D
// (int8_common.cuh's accumulate), applies the scales and silu(g)*u in shared
// memory, then multiplies that [M, 64] block by its 64 rows of Wd and writes an
// fp32 [M, D] partial; a second kernel adds the partials in block order and
// applies sd.

#include "int8_common.cuh"
#include "int8_mma.cuh"

namespace mimic_q {

constexpr int FB = 64;  // F columns per CTA: half of the BN-wide gate|up tile

template <int MB>
__global__ void __launch_bounds__(NT)
    fused_mlp_kernel(const float* __restrict__ xn, const int8_t* __restrict__ gu,
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
  accumulate<MB>(xn, D, M, m0, 0, D, wrow, Ws, Xs, acc);
  reduce_warps<MB>(acc, Red);

  // h = silu(g * sg) * (u * su) (rows beyond M give 0)
  for (int i = threadIdx.x; i < MB * FB; i += NT) {
    const int m = i / FB, f = i % FB;
    const float g = Red[m][f] * gu_scale[f0 + f];
    const float u = Red[m][FB + f] * gu_scale[F + f0 + f];
    Hs[m][f] = g / (1.f + expf(-g)) * u;
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

template <int MB>
static cudaError_t run(const float* xn, const int8_t* gu, const float* gs, const int8_t* down,
                       float* work, int M, int D, int F, cudaStream_t stream) {
  dim3 grid(F / FB, (M + MB - 1) / MB);
  fused_mlp_kernel<MB><<<grid, NT, 0, stream>>>(xn, gu, gs, down, work, M, D, F);
  return cudaGetLastError();
}

static cudaError_t run_rows(const float* xn, const int8_t* gu, const float* gs,
                            const int8_t* down, float* work, int M, int D, int F,
                            cudaStream_t stream) {
  switch (rows_per_cta(M)) {
    case 4:
      return run<4>(xn, gu, gs, down, work, M, D, F, stream);
    case 8:
      return run<8>(xn, gu, gs, down, work, M, D, F, stream);
    default:
      return run<16>(xn, gu, gs, down, work, M, D, F, stream);
  }
}

// the two products of the bf16 path (distinct names, so that a profile tells
// them from int8_matmul's)
template <int MT>
__global__ void __launch_bounds__(TC_THREADS, 2)
    fused_mlp_gateup_kernel(const __nv_bfloat16* __restrict__ xn, const int8_t* __restrict__ gu,
                            const float* __restrict__ gu_scale, __nv_bfloat16* h, int M, int D,
                            int F, int kchunk) {
  int8_mma_body<MT, EPI_SWIGLU>(xn, D, gu, 2 * F, gu_scale, h, M, D, 2 * F, F, kchunk, 1);
}

template <int MT>
__global__ void __launch_bounds__(TC_THREADS, 2)
    fused_mlp_down_kernel(const __nv_bfloat16* __restrict__ h, const int8_t* __restrict__ down,
                          const float* __restrict__ down_scale, void* out, int M, int D, int F,
                          int kchunk, int out_dtype) {
  int8_mma_body<MT, EPI_SCALE>(h, F, down, D, down_scale, out, M, F, D, 0, kchunk, out_dtype);
}

template <int MT>
static cudaError_t run_mma(const __nv_bfloat16* xn, const int8_t* gu, const float* gs,
                           const int8_t* down, const float* ds, __nv_bfloat16* h, void* out,
                           int M, int D, int F, int ks_gu, int ks_down, int out_dtype,
                           cudaStream_t st) {
  cudaError_t e = launch_mma<fused_mlp_gateup_kernel<MT>>(F / 64, ks_gu, M, false, st, xn, gu, gs, h, M,
                             D, F, mma_kchunk(D, ks_gu));
  if (e != cudaSuccess) return e;
  return launch_mma<fused_mlp_down_kernel<MT>>((D + TC_BN - 1) / TC_BN, ks_down, M, true, st,
                    static_cast<const __nv_bfloat16*>(h), down, ds, out, M, D, F,
                    mma_kchunk(F, ks_down), out_dtype);
}

}  // namespace mimic_q

// bf16 activations on the tensor cores: xn [M, D] bf16, h [M, F] bf16 (the
// rounded silu(g)*u, written by the first product), out [M, D]; ks_gu, ks_down
// in {1, 2, 4, 8}: the cluster sizes of the two products.  Needs F % 64 == 0 and
// D % 16 == 0.
extern "C" int mimic_fused_mlp_int8_mma(const void* xn, const void* gu, const void* gu_scale,
                                        const void* down, const void* down_scale, void* h,
                                        void* out, int M, int D, int F, int ks_gu, int ks_down,
                                        int out_dtype, void* stream) {
  using namespace mimic_q;
  if (F % 64 != 0 || D % 16 != 0 || M <= 0 || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const __nv_bfloat16*>(xn);
  const auto* g8 = static_cast<const int8_t*>(gu);
  const auto* d8 = static_cast<const int8_t*>(down);
  const auto* gs = static_cast<const float*>(gu_scale);
  const auto* ds = static_cast<const float*>(down_scale);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      M <= 8 ? run_mma<1>(x, g8, gs, d8, ds, hb, out, M, D, F, ks_gu, ks_down, out_dtype, st)
             : run_mma<2>(x, g8, gs, d8, ds, hb, out, M, D, F, ks_gu, ks_down, out_dtype, st);
  return static_cast<int>(e);
}

// fp32 activations xn [M, D]; out_dtype: 0 = float32, 1 = bfloat16.  work: fp32
// [F / 64 * M * D].  Needs F % 64 == 0 and D % 16 == 0.
extern "C" int mimic_fused_mlp_int8(const void* xn, const void* gu, const void* gu_scale,
                                    const void* down, const void* down_scale, void* work,
                                    void* out, int M, int D, int F, int out_dtype, void* stream) {
  using namespace mimic_q;
  if (F % FB != 0 || D % 16 != 0 || M <= 0 || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* g8 = static_cast<const int8_t*>(gu);
  const int8_t* d8 = static_cast<const int8_t*>(down);
  const float* gs = static_cast<const float*>(gu_scale);
  float* ws = static_cast<float*>(work);
  const cudaError_t e = run_rows(static_cast<const float*>(xn), g8, gs, d8, ws, M, D, F, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_reduce(ws, static_cast<const float*>(down_scale), out, M, D,
                                        F / FB, out_dtype, st));
}
