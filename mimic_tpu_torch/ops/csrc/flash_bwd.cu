// flash_bwd_dq / flash_bwd_dkv — attention backward from the saved log-normalizers.
//
// Replace the Pallas kernels mimic_tpu/ops/flash_backward.py::_dq_kernel (its
// pallas_call at flash_backward.py:202) and ::_dkv_kernel (pallas_call at :227).
// Same math: with s = scale q.k, recomputed in fp32,
//
//   p    = exp(s - lse)     on attendable keys (key mask, causal), else 0
//   p_u  = exp(s - lse_u)   on every key < S  (only when need_unmasked)
//   ds   = p (dO.v^T - delta + g_lse) + g_lse_u p_u,   delta = sum_d dO out
//   dq   = scale sum_s ds k,   dk = scale sum_t ds q,   dv = sum_t p dO
//
// delta is computed by the caller (as the JAX package does outside its kernels).
// Layout: q, g_out [B,T,H,D]; k, v [B,S,Hkv,D] (fp32 or bf16, contiguous);
// key_mask [B,S] int32; lse, lse_u, delta, g_lse, g_lse_u [B,T,H] fp32;
// dq [B,T,H,D], dk, dv [B,S,Hkv,D] in the input dtype, accumulated in fp32.
//
// Design.  On the TPU the reduction axis is the innermost, sequential grid axis
// and the sums live in VMEM scratch between grid steps; dk/dv are emitted per
// expanded head and folded over the GQA group outside the kernel.  CUDA blocks
// run in no order, so here each CTA owns its outputs and loops itself, and the
// GQA fold happens inside the launch (no [B,H,S,D] fp32 scratch, no atomics,
// the same result from run to run).
//
// bf16 inputs take the tensor-core kernels of attn_bwd_mma.cuh (wgmma products,
// p and ds rounded to bf16 before the second products as the JAX kernels do, a
// cp.async ring of swizzled bf16 tiles, the dkv items split over a thread-block
// cluster); its note says what bounds them and what the design does about it.
// fp32 inputs keep the scalar kernels below:
//   - flash_bwd_dq: one CTA per (batch, head, 64-row query tile) walks all key
//     tiles; each query row's dq lives in the registers of four threads.
//   - flash_bwd_dkv: one CTA per (batch, kv head, 64-key tile) walks the G query
//     heads of its group and all query tiles; each key row's dk and dv live in
//     the registers of four threads.
// Both products of a tile (s = q.k^T and dp = dO.v^T) run as scalar fp32 FMAs
// from shared memory through the forward's score_tile (attn_common.cuh), bound
// by shared-memory bandwidth and FMA issue; 166 KB of fp32 tiles per CTA.
//
// Which tiles are visited.  With need_unmasked every tile is visited: a tile
// above the causal diagonal or wholly padded still carries g_lse_u p_u, and
// skipping it would give a wrong mu-gradient with no error.  Without it, tiles
// wholly above the diagonal (and, in the dq kernel, wholly masked key tiles)
// contribute nothing and are skipped.  Rows with no attendable key have p = 0
// everywhere (their lse sits near NEG = -1e30 and is never exponentiated) but
// keep their p_u terms.

#include "attn_bwd_mma.cuh"
#include "attn_common.cuh"

namespace mimic {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g_out;
  const int32_t* key_mask;
  const float* lse;
  const float* lse_u;
  const float* delta;
  const float* g_lse;
  const float* g_lse_u;
  void* dq;
  void* dk;
  void* dv;
  int B, T, S, H, Hkv;
  float scale;
  int causal;
  int need_unmasked;
};

template <int D>
struct BwdSmem {
  static constexpr int DS = Smem<D>::DS;
  static constexpr int PS = Smem<D>::PS;
  static constexpr int Q_OFF = 0;                  // [BQ][DS] scale * q
  static constexpr int G_OFF = Q_OFF + BQ * DS;    // [BQ][DS] g_out
  static constexpr int K_OFF = G_OFF + BQ * DS;    // [BK][DS] k
  static constexpr int V_OFF = K_OFF + BK * DS;    // [BK][DS] v
  static constexpr int S_OFF = V_OFF + BK * DS;    // [BQ][PS] s, then ds
  static constexpr int P_OFF = S_OFF + BQ * PS;    // [BQ][PS] dp, then p
  static constexpr int R_OFF = P_OFF + BQ * PS;    // 5 x [BQ] per-row scalars
  static constexpr int M_OFF = R_OFF + 5 * BQ;     // [BK] key status
  static constexpr int BYTES = (M_OFF + BK) * 4;
};

// 64 rows of a [B, R, NH, D] tensor at (b, head h, rows r0..) → shared fp32
// [64][DS], times mul; rows >= R are 0
template <typename T, int D>
__device__ void load_rows(const void* src, float* dst, int b, int h, int r0, int R, int NH,
                          float mul) {
  const T* p = static_cast<const T*>(src);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    int r = i / D, d = i - r * D, t = r0 + r;
    float x = 0.f;
    if (t < R) x = to_f(p[((static_cast<size_t>(b) * R + t) * NH + h) * D + d]) * mul;
    dst[r * BwdSmem<D>::DS + d] = x;
  }
}

// per-row scalars of query rows q0.. of head h: lse, lse_u, g_lse - delta,
// g_lse_u, and a validity flag (rows >= T are invalid)
__device__ void load_row_scalars(const BwdArgs& a, float* R, int b, int h, int q0) {
  if (threadIdx.x < BQ) {
    int r = threadIdx.x, t = q0 + r;
    float lse = 0.f, lse_u = 0.f, c = 0.f, gu = 0.f, ok = 0.f;
    if (t < a.T) {
      size_t row = (static_cast<size_t>(b) * a.T + t) * a.H + h;
      lse = a.lse[row];
      lse_u = a.lse_u[row];
      c = a.g_lse[row] - a.delta[row];
      gu = a.g_lse_u[row];
      ok = 1.f;
    }
    R[r] = lse;
    R[BQ + r] = lse_u;
    R[2 * BQ + r] = c;
    R[3 * BQ + r] = gu;
    R[4 * BQ + r] = ok;
  }
}

// key status of keys k0..: 1 attendable, 0 masked, -1 beyond S
__device__ void load_key_status(const BwdArgs& a, int* Ms, int b, int k0) {
  if (threadIdx.x < BK) {
    int s = k0 + threadIdx.x;
    Ms[threadIdx.x] =
        s < a.S ? (a.key_mask[static_cast<size_t>(b) * a.S + s] != 0 ? 1 : 0) : -1;
  }
}

// Elementwise pass over the tile: Ss holds s, Ps holds dp on entry; on exit Ss
// holds ds and (with write_p) Ps holds p.
template <int D>
__device__ void tile_ds(const BwdArgs& a, float* Ss, float* Ps, const float* R, const int* Ms,
                        int q0, int k0, bool write_p) {
  constexpr int PS = BwdSmem<D>::PS;
  for (int i = threadIdx.x; i < BQ * BK; i += NTHREADS) {
    const int r = i / BK, c = i - r * BK;
    const int t = q0 + r, key = k0 + c, mk = Ms[c];
    const float s = Ss[r * PS + c];
    float p = 0.f, ds = 0.f;
    if (mk >= 0 && R[4 * BQ + r] != 0.f) {
      if (mk > 0 && !(a.causal && key > t)) {
        p = expf(s - R[r]);
        ds = p * (Ps[r * PS + c] + R[2 * BQ + r]);
      }
      if (a.need_unmasked) ds += R[3 * BQ + r] * expf(s - R[BQ + r]);
    }
    Ss[r * PS + c] = ds;
    if (write_p) Ps[r * PS + c] = p;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(BwdArgs a) {
  using L = BwdSmem<D>;
  extern __shared__ float smem[];
  float* Qs = smem + L::Q_OFF;
  float* Gs = smem + L::G_OFF;
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* Ss = smem + L::S_OFF;
  float* Ps = smem + L::P_OFF;
  float* R = smem + L::R_OFF;
  int* Ms = reinterpret_cast<int*>(smem + L::M_OFF);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const float* srow = Ss + row * L::PS;

  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  load_rows<T, D>(a.q, Qs, b, h, q0, a.T, a.H, a.scale);
  load_rows<T, D>(a.g_out, Gs, b, h, q0, a.T, a.H, 1.f);
  load_row_scalars(a, R, b, h, q0);
  for (int k0 = 0; k0 < a.S; k0 += BK) {
    if (!a.need_unmasked) {
      // uniform across the CTA: all later tiles are above the diagonal too
      if (a.causal && k0 > q0 + BQ - 1) break;
      const int s = k0 + static_cast<int>(threadIdx.x);
      const bool valid = threadIdx.x < BK && s < a.S &&
                         a.key_mask[static_cast<size_t>(b) * a.S + s] != 0;
      if (!__syncthreads_or(valid)) continue;
    }
    load_rows<T, D>(a.k, Ks, b, hk, k0, a.S, a.Hkv, 1.f);
    load_rows<T, D>(a.v, Vs, b, hk, k0, a.S, a.Hkv, 1.f);
    load_key_status(a, Ms, b, k0);
    __syncthreads();
    score_tile<D>(Qs, Ks, Ss);
    score_tile<D>(Gs, Vs, Ps);
    __syncthreads();
    tile_ds<D>(a, Ss, Ps, R, Ms, q0, k0, false);
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      const float d = srow[key];
      const float* krow = Ks + key * L::DS;
#pragma unroll
      for (int j = 0; j < D / 4; ++j) acc[j] = fmaf(d, krow[part + 4 * j], acc[j]);
    }
    __syncthreads();
  }
  const int t = q0 + row;
  if (t < a.T) {
    T* o = static_cast<T*>(a.dq) + ((static_cast<size_t>(b) * a.T + t) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) o[part + 4 * j] = from_f<T>(acc[j] * a.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(BwdArgs a) {
  using L = BwdSmem<D>;
  extern __shared__ float smem[];
  float* Qs = smem + L::Q_OFF;
  float* Gs = smem + L::G_OFF;
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* Ss = smem + L::S_OFF;
  float* Ps = smem + L::P_OFF;
  float* R = smem + L::R_OFF;
  int* Ms = reinterpret_cast<int*>(smem + L::M_OFF);

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int key = threadIdx.x >> 2, part = threadIdx.x & 3;

  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) dk[j] = dv[j] = 0.f;

  load_rows<T, D>(a.k, Ks, b, hk, k0, a.S, a.Hkv, 1.f);
  load_rows<T, D>(a.v, Vs, b, hk, k0, a.S, a.Hkv, 1.f);
  load_key_status(a, Ms, b, k0);
  __syncthreads();
  // without need_unmasked a tile of masked keys has p = ds = 0 for every row
  const bool any_key = __syncthreads_or(threadIdx.x < BK && Ms[threadIdx.x] > 0);
  if (a.need_unmasked || any_key) {
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      for (int q0 = 0; q0 < a.T; q0 += BQ) {
        // uniform across the CTA: the whole tile lies above the causal diagonal
        if (!a.need_unmasked && a.causal && k0 > q0 + BQ - 1) continue;
        load_rows<T, D>(a.q, Qs, b, h, q0, a.T, a.H, a.scale);
        load_rows<T, D>(a.g_out, Gs, b, h, q0, a.T, a.H, 1.f);
        load_row_scalars(a, R, b, h, q0);
        __syncthreads();
        score_tile<D>(Qs, Ks, Ss);
        score_tile<D>(Gs, Vs, Ps);
        __syncthreads();
        tile_ds<D>(a, Ss, Ps, R, Ms, q0, k0, true);
        __syncthreads();
#pragma unroll 2
        for (int r = 0; r < BQ; ++r) {
          const float ds = Ss[r * L::PS + key];
          const float p = Ps[r * L::PS + key];
          const float* qrow = Qs + r * L::DS;
          const float* grow = Gs + r * L::DS;
#pragma unroll
          for (int j = 0; j < D / 4; ++j) {
            dk[j] = fmaf(ds, qrow[part + 4 * j], dk[j]);
            dv[j] = fmaf(p, grow[part + 4 * j], dv[j]);
          }
        }
        __syncthreads();
      }
    }
  }
  const int s = k0 + key;
  if (s < a.S) {
    size_t off = ((static_cast<size_t>(b) * a.S + s) * a.Hkv + hk) * D;
    T* ok = static_cast<T*>(a.dk) + off;
    T* ov = static_cast<T*>(a.dv) + off;
    // q was loaded pre-multiplied by scale, so dk needs no further factor
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      ok[part + 4 * j] = from_f<T>(dk[j]);
      ov[part + 4 * j] = from_f<T>(dv[j]);
    }
  }
}

template <typename Kernel>
cudaError_t launch_bwd(Kernel kernel, dim3 grid, int smem, const BwdArgs& a,
                       cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

inline bwd::Args mma_args(const BwdArgs& a) {
  using bf = __nv_bfloat16;
  return {static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
          static_cast<const bf*>(a.g_out), a.key_mask, a.lse, a.lse_u, a.delta, a.g_lse,
          a.g_lse_u, static_cast<bf*>(a.dq), static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
          a.B, a.T, a.S, a.H, a.Hkv, a.scale, a.causal, a.need_unmasked};
}

// Only the text tower trains (the ViT and connector are frozen and run without
// a graph), so head dim 128 only.  dtype: 0 = float32 (scalar kernels),
// 1 = bfloat16 (tensor cores; dkv's items split over clusters of `split` CTAs).
template <bool DQ>
cudaError_t dispatch_bwd(int dtype, int D, int split, const BwdArgs& a, cudaStream_t stream) {
  if (D != 128 || a.H % a.Hkv != 0) return cudaErrorInvalidValue;
  constexpr int smem = BwdSmem<128>::BYTES;
  if (dtype == 1) return DQ ? bwd::launch_dq(mma_args(a), stream)
                            : bwd::launch_dkv(mma_args(a), split, stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (DQ) {
    dim3 grid((a.T + BQ - 1) / BQ, a.H, a.B);
    return launch_bwd(flash_bwd_dq_kernel<float, 128>, grid, smem, a, stream);
  }
  dim3 grid((a.S + BK - 1) / BK, a.Hkv, a.B);
  return launch_bwd(flash_bwd_dkv_kernel<float, 128>, grid, smem, a, stream);
}

inline BwdArgs make_bwd_args(const void* q, const void* k, const void* v, const void* g_out,
                             const void* key_mask, const void* lse, const void* lse_u,
                             const void* delta, const void* g_lse, const void* g_lse_u, void* dq,
                             void* dk, void* dv, int B, int T, int S, int H, int Hkv, float scale,
                             int causal, int need_unmasked) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.g_out = g_out;
  a.key_mask = static_cast<const int32_t*>(key_mask);
  a.lse = static_cast<const float*>(lse);
  a.lse_u = static_cast<const float*>(lse_u);
  a.delta = static_cast<const float*>(delta);
  a.g_lse = static_cast<const float*>(g_lse);
  a.g_lse_u = static_cast<const float*>(g_lse_u);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
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

extern "C" int mimic_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g_out,
                                  const void* key_mask, const void* lse, const void* lse_u,
                                  const void* delta, const void* g_lse, const void* g_lse_u,
                                  void* dq, int B, int T, int S, int H, int Hkv, int D, int dtype,
                                  float scale, int causal, int need_unmasked, void* stream) {
  mimic::BwdArgs a = mimic::make_bwd_args(q, k, v, g_out, key_mask, lse, lse_u, delta, g_lse,
                                          g_lse_u, dq, nullptr, nullptr, B, T, S, H, Hkv, scale,
                                          causal, need_unmasked);
  return static_cast<int>(
      mimic::dispatch_bwd<true>(dtype, D, 1, a, static_cast<cudaStream_t>(stream)));
}

extern "C" int mimic_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g_out,
                                   const void* key_mask, const void* lse, const void* lse_u,
                                   const void* delta, const void* g_lse, const void* g_lse_u,
                                   void* dk, void* dv, int B, int T, int S, int H, int Hkv, int D,
                                   int dtype, float scale, int causal, int need_unmasked,
                                   int split, void* stream) {
  mimic::BwdArgs a = mimic::make_bwd_args(q, k, v, g_out, key_mask, lse, lse_u, delta, g_lse,
                                          g_lse_u, nullptr, dk, dv, B, T, S, H, Hkv, scale,
                                          causal, need_unmasked);
  return static_cast<int>(
      mimic::dispatch_bwd<false>(dtype, D, split, a, static_cast<cudaStream_t>(stream)));
}

// the bf16 kernels' tiling: query rows per dq CTA, keys per dq tile, keys per dkv
// CTA, query rows per dkv tile, the largest dkv split
extern "C" int mimic_flash_bwd_tiling(int* dq_rows, int* dq_keys, int* dkv_keys, int* dkv_rows,
                                      int* max_split) {
  *dq_rows = mimic::bwd::DQ_ROWS;
  *dq_keys = mimic::bwd::DQ_KEYS;
  *dkv_keys = mimic::bwd::DKV_KEYS;
  *dkv_rows = mimic::bwd::DKV_ROWS;
  *max_split = mimic::bwd::MAX_SPLIT;
  return 0;
}
