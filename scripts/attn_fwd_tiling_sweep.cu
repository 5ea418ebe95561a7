// Tilings of the bf16 attention forward (mimic_tpu_torch/ops/csrc/attn_mma.cuh) side by
// side in one library, for scripts/attn_fwd_tiling_sweep.py.  Variants 0-7 are
// CfgT<D, warpgroups, ring slots, CTAs per SM>; 0 and 3 are the tilings D80 and D64 had
// before their redesign.  Variant 9 is D72 as the package builds it; 8 is the same
// tiling with a full sweep, as D72 ran before its sweep ended at the batch's last
// attendable key.  -DSWEEP_D=<D> builds the variants of that head width alone (the
// others return -2).

#include "attn_mma.cuh"
using namespace mimic;
using namespace mimic::mma;

#ifndef SWEEP_D
#define SWEEP_D 0
#endif

template <int D, class C>
static int run(const AttnArgs& a, int skip, cudaStream_t s) {
  if constexpr (SWEEP_D != 0 && SWEEP_D != D)
    return -2;
  else
    return static_cast<int>(a.need_unmasked ? launch_one<D, true, C>(a, skip, s)
                                            : launch_one<D, false, C>(a, skip, s));
}
template <int D, class C>
static int occ() {
  if constexpr (SWEEP_D != 0 && SWEEP_D != D) {
    return -2;
  } else {
    int n = -1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attn_fwd_mma_kernel<D, false, C>, C::THREADS,
                                                  C::BYTES);
    return n;
  }
}
// D72's tiling with the full sweep
struct CfgD72FullSweep : Cfg<72> {
  static constexpr bool ENDS_AT_LAST_KEY = false;
};

#define VARIANTS(X)                        \
  X(0, 80, (CfgT<80, 2, 3, 1>))            \
  X(1, 80, (Cfg<80>))                      \
  X(2, 80, (CfgT<80, 1, 3, 3>))            \
  X(3, 64, (CfgT<64, 2, 3, 2>))            \
  X(4, 64, (Cfg<64>))                      \
  X(5, 64, (CfgT<64, 1, 2, 4>))            \
  X(6, 64, (CfgT<64, 1, 3, 3>))            \
  X(7, 64, (CfgT<64, 1, 4, 3>))            \
  X(8, 72, (CfgD72FullSweep))              \
  X(9, 72, (Cfg<72>))

template <class T> struct Unwrap;
template <class T> struct Unwrap<void(T)> { using type = T; };
#define CASE_RUN(i, D, C) case i: return run<D, Unwrap<void C>::type>(a, skip, st);
#define CASE_OCC(i, D, C) case i: return occ<D, Unwrap<void C>::type>();

extern "C" int sweep_attn(int variant, const void* q, const void* k, const void* v, const void* km,
                          void* out, void* lse, void* lse_u, int B, int T, int S, int H, int Hkv,
                          float scale, int causal, int need_unmasked, int skip, void* stream) {
  AttnArgs a = make_args(q, k, v, km, out, lse, lse_u, B, T, S, H, Hkv, scale, causal, need_unmasked);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) { VARIANTS(CASE_RUN) }
  return -1;
}
extern "C" int sweep_occupancy(int variant) {
  switch (variant) { VARIANTS(CASE_OCC) }
  return -1;
}
