// onepass_fwd — full-row attention forward emitting lse and lse_unmasked.
//
// Replaces the Pallas kernel mimic_tpu/ops/flash_attention.py::_onepass_kernel
// (called through onepass_attention, its pallas_call at flash_attention.py:532).
// Same contract as flash_fwd; see attn_common.cuh.
//
// The TPU kernel holds a whole [bq, S] fp32 score row block in VMEM and
// finishes the row's max and sum before the P.V product.  A 4992-key fp32 row
// block does not fit the 227 KB of shared memory a CTA can have on the H100.
//
// bf16 inputs: the tensor-core kernel of attn_mma.cuh, ONE sweep over the key
// axis with an online softmax (Q.K^T once per tile), entered with skip_tiles =
// 0: every key tile is looked at, so a row with no attendable key (a padded
// ViT slot, a left-padded prompt row) is the mean of v over all S keys, what
// the plain version computes.  What bounds it and what the design does about
// it is in that header.  The online rescaling of the accumulator that the
// full-row form avoided costs D/8 multiplies per row and tile, nothing beside
// the second Q.K^T sweep it replaces.
//
// fp32 inputs: the scalar two-sweep kernel below (sweep 1 the row's final max
// and sum, sweep 2 Q.K^T again and P.V with the final max), kept because the
// fp32 slice is held to the CPU's plain path at 1e-4 and to identical beam
// tokens.  It does 1.5x the operations as fp32 FMAs from shared memory; fp32
// is not on the main path.

#include "attn_common.cuh"
#include "attn_mma.cuh"

namespace mimic {

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) onepass_fwd_kernel(AttnArgs a) {
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

  load_q<T, D>(a, Qs, b, h, q0);

  // sweep 1: the row's final max and sum
  RowState st;
  for (int k0 = 0; k0 < a.S; k0 += BK) {
    load_kv<T, D>(a, Ks, Vs, Ms, b, hk, k0, false);
    __syncthreads();
    score_tile<D>(Qs, Ks, Ps);
    __syncthreads();
    if (a.need_unmasked) update_unmasked(prow, Ms, part, st);
    update_masked<T>(prow, Ms, part, k0, t, a.causal, st, false);
    __syncthreads();
  }

  // sweep 2: P.V with the final max (no rescaling of the accumulator)
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < a.S; k0 += BK) {
    load_kv<T, D>(a, Ks, Vs, Ms, b, hk, k0, true);
    __syncthreads();
    score_tile<D>(Qs, Ks, Ps);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = part * 16 + c;
      const float x = masked_score(prow[col], Ms[col], k0 + col, t, a.causal);
      prow[col] = round_to<T>(expf(x - st.m));
    }
    __syncthreads();
    accumulate_pv<D>(prow, Vs, part, acc);
    __syncthreads();
  }
  store_row<T, D>(a, st, acc, b, h, t, part);
}

template <typename T, int D>
struct OnepassLauncher {
  static cudaError_t run(const AttnArgs& a, cudaStream_t stream) {
    return launch(onepass_fwd_kernel<T, D>, Smem<D>::BYTES, a, stream);
  }
};

}  // namespace mimic

extern "C" int mimic_onepass_fwd(const void* q, const void* k, const void* v,
                                 const void* key_mask, void* out, void* lse, void* lse_u, int B,
                                 int T, int S, int H, int Hkv, int D, int Dv, int dtype,
                                 float scale, int causal, int need_unmasked, void* stream) {
  mimic::AttnArgs a = mimic::make_args(q, k, v, key_mask, out, lse, lse_u, B, T, S, H, Hkv,
                                       scale, causal, need_unmasked);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 1) {
    e = mimic::mma::launch_bf16(D, Dv, a, /*skip_tiles=*/0, st);
  } else if (Dv != D) {
    e = cudaErrorInvalidValue;  // fp32: one head width for q, k and v
  } else if (dtype == 0 && D == 64) {
    e = mimic::OnepassLauncher<float, 64>::run(a, st);
  } else if (dtype == 0 && D == 72) {
    e = mimic::OnepassLauncher<float, 72>::run(a, st);
  } else if (dtype == 0 && D == 80) {
    e = mimic::OnepassLauncher<float, 80>::run(a, st);
  } else if (dtype == 0 && D == 128) {
    e = mimic::OnepassLauncher<float, 128>::run(a, st);
  }
  return static_cast<int>(e);
}
