// flash_fwd — online-softmax attention forward emitting lse and lse_unmasked.
//
// Replaces the Pallas kernel mimic_tpu/ops/flash_attention.py::_kernel (called
// through flash_attention, its pallas_call at flash_attention.py:270).  Same
// contract; see attn_common.cuh.
//
// On the TPU the key axis is the innermost, sequential grid axis and the
// running (max, sum, accumulator) live in VMEM scratch between grid steps.
// CUDA blocks run in no order, so here one CTA per (batch, head, query tile)
// loops over the key tiles itself and keeps the running state in registers.
// Two running pairs are kept: the masked pair feeds out and lse; the unmasked
// pair, over every key < S, feeds lse_u (MimIC's log Z2).
//
// bf16 inputs: the tensor-core kernel of attn_mma.cuh (wgmma for both products,
// a TMA-fed ring of K/V tiles handed over through mbarriers, 128 query rows per
// CTA, softmax in registers in the log2 domain; its header says what bounds it
// and what the design does about it).  With need_unmasked every key tile is
// scored, because a tile above the causal diagonal or fully padded still
// carries lse_u's terms, but its P.V is done only where a row of the warpgroup
// still has no attendable key (such a row comes out as the mean of v over all
// S keys, as in onepass_fwd and the plain version).  Without need_unmasked the
// sweep ends at the CTA's causal diagonal and wholly masked tiles are passed
// over; rows with an attendable key are unchanged by that, a row with none gets
// the mean of v over the keys of the tiles its warpgroup visited (as the JAX
// _kernel does).
//
// fp32 inputs: the scalar kernel below (64 x 64 tiles in fp32 shared memory,
// fp32 FMAs), kept because the fp32 slice is held to the CPU's plain path at
// 1e-4 and to identical beam tokens, which bf16 or TF32 products would break.
// It is bound by shared-memory bandwidth and FMA issue; fp32 is not on the
// main path.

#include "attn_common.cuh"
#include "attn_mma.cuh"

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 1) {
    e = mimic::mma::launch_bf16(D, a, /*skip_tiles=*/need_unmasked ? 0 : 1, st);
  } else if (dtype == 0 && D == 64) {
    e = mimic::FlashLauncher<float, 64>::run(a, st);
  } else if (dtype == 0 && D == 72) {
    e = mimic::FlashLauncher<float, 72>::run(a, st);
  } else if (dtype == 0 && D == 80) {
    e = mimic::FlashLauncher<float, 80>::run(a, st);
  } else if (dtype == 0 && D == 128) {
    e = mimic::FlashLauncher<float, 128>::run(a, st);
  }
  return static_cast<int>(e);
}

// The tiling of the bf16 forward for head dim D: query rows per CTA, rows per
// warpgroup and keys per tile.  ops/flash_attention.py::attention_tiled_plain
// walks the same tiles on the CPU; a test on the card holds the two together.
extern "C" int mimic_attn_fwd_tiling(int D, int* block_m, int* group_rows, int* block_n) {
  *group_rows = 64;
  if (D == 64) {
    *block_m = mimic::mma::Cfg<64>::BM;
    *block_n = mimic::mma::Cfg<64>::BN;
  } else if (D == 72) {
    *block_m = mimic::mma::Cfg<72>::BM;
    *block_n = mimic::mma::Cfg<72>::BN;
  } else if (D == 80) {
    *block_m = mimic::mma::Cfg<80>::BM;
    *block_n = mimic::mma::Cfg<80>::BN;
  } else if (D == 128) {
    *block_m = mimic::mma::Cfg<128>::BM;
    *block_n = mimic::mma::Cfg<128>::BN;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

extern "C" const char* mimic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
