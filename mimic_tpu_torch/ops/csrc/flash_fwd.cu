// flash_fwd — online-softmax attention forward emitting lse and lse_unmasked.
//
// Replaces the Pallas kernel mimic_tpu/ops/flash_attention.py::_kernel (called
// through flash_attention, its pallas_call at flash_attention.py:270).  Same
// contract; see attn_common.cuh.
//
// Design.  On the TPU the key axis is the innermost, sequential grid axis and
// the running (max, sum, accumulator) live in VMEM scratch between grid steps.
// CUDA blocks run in no order, so here one CTA per (batch, head, 64-row query
// tile) loops over 64-key tiles itself and keeps the running state in
// registers.  Two running pairs are kept: the masked pair feeds out and lse;
// the unmasked pair, over every key, feeds lse_u (MimIC's log Z2).
//
// Which tiles are visited.  With need_unmasked, every tile is visited: a tile
// above the causal diagonal or fully padded still carries lse_u's terms, and
// skipping it would give a wrong mu with no error.  Then a row with no
// attendable key (a left-padded prompt row) comes out as the mean of v over all
// S keys, identical to onepass_fwd and to the plain version.  Without
// need_unmasked, tiles wholly above the causal diagonal of the CTA's query tile
// and tiles whose keys are all masked are skipped; rows with at least one
// attendable key are unchanged by that, while a row with none gets the mean of
// v over the keys of the tiles that were visited (as the JAX _kernel does).
//
// What bounds it on the H100.  The score and P.V products run as scalar fp32
// FMAs from shared memory, 4 FMAs per shared load in the score tile and 1 in
// P.V, so the kernel is bound by shared-memory bandwidth and FMA issue, far
// below the tensor cores' bf16 rate.  K/V tiles are re-read from device memory
// once per query tile (T/64 times in all), which the 50 MB L2 absorbs at the
// slice's shapes.  Moving the two products to wgmma with TMA-fed tiles is the
// next step; the contract and the bookkeeping stay as they are.

#include "attn_common.cuh"

namespace mimic {

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  float* Qs = smem + Smem<D>::Q_OFF;
  float* Ks = smem + Smem<D>::K_OFF;
  float* Vs = smem + Smem<D>::V_OFF;
  float* Ps = smem + Smem<D>::P_OFF;
  int* Ms = reinterpret_cast<int*>(smem + Smem<D>::M_OFF);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int t = q0 + row;
  float* prow = Ps + row * Smem<D>::PS;

  RowState st;
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  load_q<T, D>(a, Qs, b, h, q0);
  for (int k0 = 0; k0 < a.S; k0 += BK) {
    if (!a.need_unmasked) {
      // uniform across the CTA: all later tiles are above the diagonal too
      if (a.causal && k0 > q0 + BQ - 1) break;
      const int s = k0 + static_cast<int>(threadIdx.x);
      const bool valid = threadIdx.x < BK && s < a.S &&
                         a.key_mask[static_cast<size_t>(b) * a.S + s] != 0;
      if (!__syncthreads_or(valid)) continue;
    }
    load_kv<T, D>(a, Ks, Vs, Ms, b, hk, k0, true);
    __syncthreads();
    score_tile<D>(Qs, Ks, Ps);
    __syncthreads();
    if (a.need_unmasked) update_unmasked(prow, Ms, part, st);
    const float alpha = update_masked<T>(prow, Ms, part, k0, t, a.causal, st, true);
#pragma unroll
    for (int j = 0; j < D / 4; ++j) acc[j] *= alpha;
    __syncthreads();
    accumulate_pv<D>(prow, Vs, part, acc);
    __syncthreads();
  }
  store_row<T, D>(a, st, acc, b, h, t, part);
}

template <typename T, int D>
struct FlashLauncher {
  static cudaError_t run(const AttnArgs& a, cudaStream_t stream) {
    return launch(flash_fwd_kernel<T, D>, Smem<D>::BYTES, a, stream);
  }
};

}  // namespace mimic

extern "C" int mimic_flash_fwd(const void* q, const void* k, const void* v, const void* key_mask,
                               void* out, void* lse, void* lse_u, int B, int T, int S, int H,
                               int Hkv, int D, int dtype, float scale, int causal,
                               int need_unmasked, void* stream) {
  mimic::AttnArgs a = mimic::make_args(q, k, v, key_mask, out, lse, lse_u, B, T, S, H, Hkv,
                                       scale, causal, need_unmasked);
  return static_cast<int>(mimic::dispatch<mimic::FlashLauncher>(
      dtype, D, a, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* mimic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
