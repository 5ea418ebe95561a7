// int8_matmul — weight-only int8 matmul at decode M: out = (x @ W8) * scale.
//
// Replaces the Pallas kernels mimic_tpu/ops/quant.py::_kernel (pallas_call at
// quant.py:281, int8_matmul) and ::_kernel_stacked (quant.py:354,
// int8_matmul_stacked).  The stacked form needs no kernel of its own here: a
// layer of a contiguous [L, K, N] stack is a pointer offset, which the wrapper
// applies (mimic_tpu_torch/ops/quant.py), so one kernel serves both.
//
// Contract: x [M, K] fp32 or bf16, W [K, N] int8 row-major (N a multiple of
// 16), scale [N] fp32; out [M, N] fp32 or bf16.  Products accumulate in fp32
// (int8 and bf16 values and their products are exact there) and the scale
// multiplies the sum once, as in the Pallas kernel.
//
// What bounds it on the H100.  At decode (M = 4-12) the product is a stream of
// K*N weight bytes with M multiply-adds per byte: 25 MB for the fused q/k/v
// (K 4096, N 6144), 17 MB for o, 132 MB for the lm head, 7.5-39 us at 3.35 TB/s.
//
// bf16 activations (every decode step of the int8 modes): int8_mma.cuh, the
// product on the tensor cores with its split-K sum inside a thread-block
// cluster; one launch, no workspace.  The wrapper chooses ksplit (its plan()
// fills the SMs with whole column tiles).
//
// fp32 activations (the tiny fp32 slices): the scalar kernel.  A grid over N in
// 128-column tiles, the contraction axis split so that the grid holds about 528
// CTAs, each walking its K range in 64-row tiles (int8_common.cuh::accumulate);
// each CTA writes an fp32 partial [rows, 128] and a second kernel adds the
// partials in split order and applies the scale, so runs repeat bit for bit.
// M beyond 16 rows takes more CTAs along z on both paths (the weights are then
// read once per 16 rows; qdot sends larger M to a dequantized torch.matmul).

#include "int8_common.cuh"
#include "int8_mma.cuh"

namespace mimic_q {

constexpr int TARGET_CTAS = 528;

static void plan(int M, int K, int N, int* ksplit, int* kchunk) {
  const int tiles = ((N + BN - 1) / BN) * ((M + MB_MAX - 1) / MB_MAX);
  const int ktiles = (K + KT - 1) / KT;
  int want = (TARGET_CTAS + tiles - 1) / tiles;
  want = want < 1 ? 1 : (want > ktiles ? ktiles : want);
  const int per = (ktiles + want - 1) / want;
  *kchunk = per * KT;
  *ksplit = (ktiles + per - 1) / per;
}

template <int MB>
__global__ void __launch_bounds__(NT)
    int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                       float* __restrict__ work, int M, int K, int N, int kchunk) {
  __shared__ __align__(16) int8_t Ws[KT][BN];
  __shared__ __align__(16) float Xs[KT][MB_MAX];
  __shared__ __align__(16) float Red[MB_MAX][BN];
  const int n0 = blockIdx.x * BN, z = blockIdx.y, m0 = blockIdx.z * MB;
  const int k_begin = z * kchunk;
  const int k_end = min(K, k_begin + kchunk);

  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  auto wrow = [&](int k, int c) -> const int4* {
    const int n = n0 + c * 16;
    return n < N ? reinterpret_cast<const int4*>(w + static_cast<size_t>(k) * N + n) : nullptr;
  };
  accumulate<MB>(x, K, M, m0, k_begin, k_end, wrow, Ws, Xs, acc);
  reduce_warps<MB>(acc, Red);

  for (int i = threadIdx.x; i < MB * BN; i += NT) {
    const int m = i / BN, c = i % BN, n = n0 + c;
    if (m0 + m < M && n < N) work[(static_cast<size_t>(z) * M + m0 + m) * N + n] = Red[m][c];
  }
}

template <int MB>
static cudaError_t run(const float* x, const int8_t* w, float* work, int M, int K, int N,
                       int ksplit, int kchunk, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, ksplit, (M + MB - 1) / MB);
  int8_matmul_kernel<MB><<<grid, NT, 0, stream>>>(x, w, work, M, K, N, kchunk);
  return cudaGetLastError();
}

static cudaError_t run_rows(const float* x, const int8_t* w, float* work, int M, int K, int N,
                            int ksplit, int kchunk, cudaStream_t stream) {
  switch (rows_per_cta(M)) {
    case 4:
      return run<4>(x, w, work, M, K, N, ksplit, kchunk, stream);
    case 8:
      return run<8>(x, w, work, M, K, N, ksplit, kchunk, stream);
    default:
      return run<16>(x, w, work, M, K, N, ksplit, kchunk, stream);
  }
}

template <int MT>
__global__ void __launch_bounds__(TC_THREADS, 2)
    int8_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
                           const int8_t* __restrict__ w, const float* __restrict__ scale,
                           void* out, int M, int K, int N, int kchunk, int out_dtype) {
  int8_mma_body<MT, EPI_SCALE>(x, ldx, w, N, scale, out, M, K, N, 0, kchunk, out_dtype);
}

}  // namespace mimic_q

// the number of K splits, so the caller can size the fp32 workspace [ksplit, M, N]
extern "C" int mimic_int8_matmul_ksplit(int M, int K, int N) {
  int ksplit, kchunk;
  mimic_q::plan(M, K, N, &ksplit, &kchunk);
  return ksplit;
}

// fp32 activations x [M, K]; out_dtype: 0 = float32, 1 = bfloat16.  work: fp32
// [ksplit * M * N].
extern "C" int mimic_int8_matmul(const void* x, const void* w, const void* scale, void* work,
                                 void* out, int M, int K, int N, int ksplit, int out_dtype,
                                 void* stream) {
  using namespace mimic_q;
  int want_split, kchunk;
  plan(M, K, N, &want_split, &kchunk);
  if (ksplit != want_split || N % 16 != 0 || M <= 0 || K <= 0 || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  float* ws = static_cast<float*>(work);
  const cudaError_t e = run_rows(static_cast<const float*>(x), w8, ws, M, K, N, ksplit, kchunk, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      launch_reduce(ws, static_cast<const float*>(scale), out, M, N, ksplit, out_dtype, st));
}

// bf16 activations on the tensor cores.  x [M, ldx] (ldx % 8 == 0, >= K, columns
// K..ldx zero), w [K, N], scale [N]; ksplit in {1, 2, 4, 8}: the cluster of CTAs
// that share a column tile; out_dtype: 0 = float32, 1 = bfloat16.
extern "C" int mimic_int8_matmul_mma(const void* x, int ldx, const void* w, const void* scale,
                                     void* out, int M, int K, int N, int ksplit, int out_dtype,
                                     void* stream) {
  using namespace mimic_q;
  if (N % 16 != 0 || M <= 0 || K <= 0 || ldx % 8 != 0 || ldx < K || out_dtype < 0 ||
      out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w8 = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const int tiles = (N + TC_BN - 1) / TC_BN, kchunk = mma_kchunk(K, ksplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      M <= 8 ? launch_mma<int8_matmul_mma_kernel<1>>(tiles, ksplit, M, false, st, xb, ldx, w8, sc, out,
                          M, K, N, kchunk, out_dtype)
             : launch_mma<int8_matmul_mma_kernel<2>>(tiles, ksplit, M, false, st, xb, ldx, w8, sc, out,
                          M, K, N, kchunk, out_dtype);
  return static_cast<int>(e);
}
