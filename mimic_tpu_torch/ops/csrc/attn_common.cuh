// Shared pieces of the attention kernels: the contract and argument block of
// the two forward kernels (flash_fwd.cu, onepass_fwd.cu), and the scalar fp32
// tiles that their fp32 instantiations and the backward pair (flash_bwd.cu)
// are built from.  bf16 forward inputs take the tensor-core kernel of
// attn_mma.cuh instead.
//
// Contract (both forward kernels), in the JAX package's layout:
//   q [B,T,H,D], k/v [B,S,Hkv,D] (fp32 or bf16, contiguous), key_mask [B,S] int32
//   (nonzero = attend), out [B,T,H,D] in the input dtype, lse / lse_u [B,T,H] fp32.
//   GQA: kv_head = h / (H / Hkv).  Causal masking compares absolute indices
//   (query t attends key s iff s <= t).  lse is the masked log-normalizer; lse_u
//   the log-normalizer over every key < S, ignoring causal and key masks (MimIC's
//   log Z2); with need_unmasked == 0, lse_u is a copy of lse.
//
// Masked scores sit at the finite NEG = -1e30 (keys beyond S at -inf, so they
// never count), and the denominator is clamped at 1e-30: a row with no
// attendable key comes out finite, as the mean of v over the keys the kernel
// visited, exactly as in the JAX kernels.
//
// Tiling of the scalar kernels: one CTA of 256 threads owns BQ = 64 query rows
// of one (batch, head) and walks the key axis in tiles of BK = 64 held in shared
// memory as fp32.  Scores of a tile are computed by a 16x16 thread grid, each
// thread a 4x4 register block, with scalar fp32 FMAs.  The softmax
// bookkeeping and the P.V product use a second mapping, four threads per
// query row, so each row's running (max, sum) pair lives in the registers of
// the four threads that also own that row's output accumulator.
//
// Head dims other than multiples of 4 are not taken; D = 72 (SigLIP) needs no
// padding: shared-memory rows are D + 1 floats wide (an odd stride, so the 16
// rows a warp reads at one column fall in 16 different banks) and loops run to
// D exactly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mimic {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;
constexpr float NEG = -1.0e30f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* key_mask;
  void* out;
  float* lse;
  float* lse_u;
  int B, T, S, H, Hkv;
  float scale;
  int causal;
  int need_unmasked;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p is rounded through the input dtype before the P.V product, as the JAX
// kernels cast p to v's dtype before their PV matmul
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

template <int D>
struct Smem {
  static_assert(D % 4 == 0 && D <= 256, "head dim must be a multiple of 4, at most 256");
  static constexpr int DS = (D % 2 == 0) ? D + 1 : D;  // odd row stride
  static constexpr int PS = BK + 1;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * DS;
  static constexpr int V_OFF = K_OFF + BK * DS;
  static constexpr int P_OFF = V_OFF + BK * D;
  static constexpr int M_OFF = P_OFF + BQ * PS;
  static constexpr int BYTES = (M_OFF + BK) * 4;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Q tile [BQ, D] → shared fp32, pre-multiplied by the score scale; rows >= T are 0
template <typename T, int D>
__device__ void load_q(const AttnArgs& a, float* Qs, int b, int h, int q0) {
  const T* q = static_cast<const T*>(a.q);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    int r = i / D, d = i - r * D, t = q0 + r;
    float x = 0.f;
    if (t < a.T) x = to_f(q[((static_cast<size_t>(b) * a.T + t) * a.H + h) * D + d]) * a.scale;
    Qs[r * Smem<D>::DS + d] = x;
  }
}

// K (and V) tile [BK, D] → shared fp32, zero beyond S; Ms[c] = 1 attendable,
// 0 masked, -1 beyond S
template <typename T, int D>
__device__ void load_kv(const AttnArgs& a, float* Ks, float* Vs, int* Ms, int b, int hk,
                        int k0, bool with_v) {
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  for (int i = threadIdx.x; i < BK * D; i += NTHREADS) {
    int r = i / D, d = i - r * D, s = k0 + r;
    float kx = 0.f, vx = 0.f;
    if (s < a.S) {
      size_t off = ((static_cast<size_t>(b) * a.S + s) * a.Hkv + hk) * D + d;
      kx = to_f(k[off]);
      if (with_v) vx = to_f(v[off]);
    }
    Ks[r * Smem<D>::DS + d] = kx;
    if (with_v) Vs[r * D + d] = vx;
  }
  if (threadIdx.x < BK) {
    int s = k0 + threadIdx.x;
    Ms[threadIdx.x] =
        s < a.S ? (a.key_mask[static_cast<size_t>(b) * a.S + s] != 0 ? 1 : 0) : -1;
  }
}

// raw scaled scores of the tile → Ps[BQ][BK+1]
template <int D>
__device__ void score_tile(const float* Qs, const float* Ks, float* Ps) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * Smem<D>::DS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * Smem<D>::DS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * Smem<D>::PS + tx + 16 * j] = s[i][j];
}

// the masked score of key column c for query row t
__device__ __forceinline__ float masked_score(float s, int mk, int key, int t, int causal) {
  if (mk < 0) return -INFINITY;
  if (mk == 0 || (causal && key > t)) return NEG;
  return s;
}

// Running (max, sum) pairs of one query row; the four threads of a row hold
// identical copies.
struct RowState {
  float m = NEG, l = 0.f;    // masked pair → out, lse
  float mu = NEG, lu = 0.f;  // unmasked pair → lse_u
};

// Fold the unmasked scores of this thread's 16 columns of the tile into st.mu/lu.
__device__ __forceinline__ void update_unmasked(const float* prow, const int* Ms, int part,
                                                RowState& st) {
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    int col = part * 16 + c;
    if (Ms[col] >= 0) mx = fmaxf(mx, prow[col]);
  }
  float m_new = fmaxf(st.mu, quad_max(mx));
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    int col = part * 16 + c;
    if (Ms[col] >= 0) sum += expf(prow[col] - m_new);
  }
  st.lu = st.lu * expf(st.mu - m_new) + quad_sum(sum);
  st.mu = m_new;
}

// Fold the masked scores into st.m/l.  With write_p, overwrite this thread's
// columns of prow with p = exp(x - m_new) (rounded through T) and return the
// rescale factor of the old accumulator.
template <typename T>
__device__ __forceinline__ float update_masked(float* prow, const int* Ms, int part, int k0,
                                               int t, int causal, RowState& st, bool write_p) {
  float x[16];
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    int col = part * 16 + c;
    x[c] = masked_score(prow[col], Ms[col], k0 + col, t, causal);
    mx = fmaxf(mx, x[c]);
  }
  float m_new = fmaxf(st.m, quad_max(mx));
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    float p = expf(x[c] - m_new);
    sum += p;
    if (write_p) prow[part * 16 + c] = round_to<T>(p);
  }
  float alpha = expf(st.m - m_new);
  st.l = st.l * alpha + quad_sum(sum);
  st.m = m_new;
  return alpha;
}

// p (already exp(x - m), rounded) of this thread's row times V, into acc[D/4]
// (columns part, part + 4, ...)
template <int D>
__device__ __forceinline__ void accumulate_pv(const float* prow, const float* Vs, int part,
                                              float* acc) {
#pragma unroll 4
  for (int key = 0; key < BK; ++key) {
    float p = prow[key];
    const float* vrow = Vs + key * D;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) acc[j] = fmaf(p, vrow[part + 4 * j], acc[j]);
  }
}

// write out, lse, lse_u of row t (this thread's columns of out)
template <typename T, int D>
__device__ __forceinline__ void store_row(const AttnArgs& a, const RowState& st, const float* acc,
                                          int b, int h, int t, int part) {
  if (t >= a.T) return;
  float l_safe = fmaxf(st.l, 1e-30f);
  float inv = 1.f / l_safe;
  size_t row = (static_cast<size_t>(b) * a.T + t) * a.H + h;
  T* o = static_cast<T*>(a.out) + row * D;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) o[part + 4 * j] = from_f<T>(acc[j] * inv);
  if (part == 0) {
    float lse = st.m + logf(l_safe);
    a.lse[row] = lse;
    a.lse_u[row] = a.need_unmasked ? st.mu + logf(fmaxf(st.lu, 1e-30f)) : lse;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const AttnArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

inline AttnArgs make_args(const void* q, const void* k, const void* v, const void* key_mask,
                          void* out, void* lse, void* lse_u, int B, int T, int S, int H,
                          int Hkv, float scale, int causal, int need_unmasked) {
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.key_mask = static_cast<const int32_t*>(key_mask);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.lse_u = static_cast<float*>(lse_u);
  a.B = B;
  a.T = T;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.scale = scale;
  a.causal = causal;
  a.need_unmasked = need_unmasked;
  return a;
}

}  // namespace mimic
