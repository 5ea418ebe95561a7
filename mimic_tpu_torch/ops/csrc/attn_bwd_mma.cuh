// The tensor-core form of the two bf16 attention backward kernels
// (flash_bwd.cu: flash_bwd_dq, flash_bwd_dkv).  Contract and math: flash_bwd.cu.
// fp32 inputs keep the scalar kernels there; only __nv_bfloat16 comes here.
//
// Replaces mimic_tpu/ops/flash_backward.py::_dq_kernel and ::_dkv_kernel.
//
// What bounds it on the H100.  At the MimIC shift pass (B2, T = S = 256, 32/8
// heads, D 128, lse_u) a launch moves 13-15 MB and does 2.6-3.0 G operations:
// the bound is bytes, 4-5 us, and what a launch really costs is its fixed part:
// the launch, filling the pipeline, and (dkv) the cluster's sum.  At B1
// T = S = 2048 it is operations (86-103 G, 0.09-0.10 ms at the bf16 peak): the
// five products of a tile belong on the tensor cores, and the loads beside them.
//
// Design.
//  * Products: warpgroup wgmma (bf16 x bf16 -> fp32), with the descriptor
//    conventions of attn_wgmma_ops.cuh that the forward kernel probed.  A CTA is
//    one warpgroup of 128 threads owning 64 rows: query rows in dq, keys in dkv.
//  * dq: per key tile of 64, S = Q.K^T and dP = dO.V^T (both operands K-major from
//    shared memory), then p = ex2(S c - lse log2 e) in registers (c = scale log2 e:
//    the scale is folded into the exponent, q is never pre-scaled).  On an
//    attendable pair p_u = p 2^(lse2 - lse_u2), so ds = p (dP + g_lse - delta +
//    g_lse_u 2^(lse2 - lse_u2)) costs one exponential; a masked pair within T x S
//    has ds = g_lse_u p_u.  ds is rounded to bf16 and the accumulator registers ARE
//    the A operand of dq += ds.K, K the transposed (MN-major) B operand, as P and V
//    in the forward's P.V.  dq is multiplied by the scale once, at the end.
//  * dkv: the CTA computes the TRANSPOSED tiles S^T = K.Q^T and dP^T = V.dO^T over
//    32 query rows (m64n32), so p^T and ds^T come out with keys as rows and feed
//    dv += p^T.dO and dk += ds^T.Q from registers, dO and Q read MN-major: no
//    transposed A operand is needed.  The CTA walks the (GQA head, query tile)
//    items of its key tile: the GQA fold happens inside the launch, in a fixed order.
//  * Enough CTAs at short rows: the items of a key tile are split over the CTAs of
//    a thread-block cluster (1, 2, 4 or 8, from the wrapper's plan: the smallest
//    split that gives every SM a CTA, at most the number of items).  Each rank adds
//    its items in order into fp32 registers and parks the sums in its shared
//    memory; rank r then adds, for its 64 / split key rows, the sums of ranks
//    0..split-1 in rank order through distributed shared memory, scales dk, rounds
//    once and stores.  No atomics, no fp32 partials in device memory, the same bits
//    on every launch.
//  * Shared memory is bf16 in the forward's layout: a row of D = 128 is two
//    64-column blocks, each stored [rows][128 B] with the 128-byte swizzle (chunk c
//    of row r at c ^ (r & 7)).  Tiles arrive by 16-byte cp.async.cg (rows beyond T
//    or S zero-filled) into a ring of two stages: the next tile is in flight while
//    this one is computed; a proxy fence hands them to wgmma.  dq: 97 KB (Q and dO
//    resident, K/V ring); dkv: 69 KB (K and V resident, ring of Q, dO and the five
//    per-row fp32 scalars; the fp32 sums overlay it at the end).  Two CTAs per SM.
//  * Tile-visiting rules (the contract's), decided per CTA tile, since a wgmma
//    is issued by the whole warpgroup.  With need_unmasked every tile is visited:
//    g_lse_u p_u lives above the diagonal and on padded keys.  Without it, dq ends
//    its sweep at the CTA's causal diagonal and passes over tiles with no
//    attendable key; dkv passes over items wholly above the diagonal, and a dkv CTA
//    with no attendable key writes zeros.  (dq still loads a wholly masked key tile
//    it does not compute.)  A visited tile runs all of its products, also dP and
//    dv where p = 0: a wgmma under a branch made ptxas serialize every wgmma of the
//    kernel (C7511 / C7520; dq 0.469 against 0.414 ms at B1 T = S = 2048, NVIDIA
//    H100 80GB HBM3 at 700 W), which
//    cost more than the skipped products.  A row with no attendable key has p = 0
//    everywhere (its NEG lse is never exponentiated) and keeps its p_u terms.
//  * Before this form: mma.sync.m16n8k16 with ldmatrix operands, four warps of 16
//    rows (0.49 / 0.95 ms at B1 T = S = 2048, 212-240 registers); pairs of warps
//    sharing 16 rows with half of D each (16 warps per SM) did not help.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_wgmma_ops.cuh"

namespace mimic {
namespace bwd {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;   // one warpgroup
constexpr int D = 128;         // head dim: two 64-column blocks
constexpr int DQ_ROWS = 64;    // query rows per dq CTA
constexpr int DQ_KEYS = 64;    // keys per dq tile
constexpr int DKV_KEYS = 64;   // keys per dkv CTA
constexpr int DKV_ROWS = 32;   // query rows per dkv tile
constexpr int MAX_SPLIT = 8;   // portable cluster size
constexpr int RED_STRIDE = D + 8;  // floats per row of the parked fp32 sums (conflict-free float2)
constexpr float LOG2E = 1.4426950408889634f;

// bytes of a tile of `rows` rows of D bf16 (two blocks [rows][128 B])
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * 2 * 128; }

// dq: Q, dO [64 rows]; two stages of K, V [64 keys]
constexpr int DQ_SMEM = 1024 + 2 * tile_bytes(DQ_ROWS) + 2 * 2 * tile_bytes(DQ_KEYS);
// dkv: K, V [64 keys]; two stages of Q, dO [32 rows] and 5 x 32 fp32 row scalars
constexpr int DKV_STAGE = 2 * tile_bytes(DKV_ROWS) + 1024;
constexpr int DKV_TILES = 2 * tile_bytes(DKV_KEYS) + 2 * DKV_STAGE;
constexpr int DKV_RED = 2 * DKV_KEYS * RED_STRIDE * 4;
constexpr int DKV_SMEM = 1024 + (DKV_TILES > DKV_RED ? DKV_TILES : DKV_RED);

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g_out;
  const int32_t* key_mask;
  const float* lse;
  const float* lse_u;
  const float* delta;
  const float* g_lse;
  const float* g_lse_u;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, T, S, H, Hkv;
  float scale;
  int causal;
  int need_unmasked;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// all but the N newest groups of tiles have landed, visible to every thread's
// wgmma once the barrier has passed
template <int N>
__device__ __forceinline__ void tiles_landed() {
  cp_wait<N>();
  wg::fence_async_shared();
  __syncthreads();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// keep the compiler from moving reads or writes of a wgmma accumulator across this point
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// rows r0 .. r0 + ROWS - 1 of head h of a bf16 [B, L, heads, D] array -> a tile of
// two 64-column blocks [ROWS][128 B], 128-byte swizzled; rows at or beyond L
// arrive as zeros
template <int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int b, int h,
                                          int r0, int L, int heads) {
  for (int i = threadIdx.x; i < ROWS * 16; i += THREADS) {
    const int r = i >> 4, c = i & 15, t = r0 + r;
    const bool ok = t < L;
    const __nv_bfloat16* p =
        src + ((static_cast<size_t>(b) * L + (ok ? t : 0)) * heads + h) * D + c * 8;
    cp_async16(dst + (c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4), p, ok);
  }
}

// acc[ROWS_B / 2] = A[64 rows] . B[ROWS_B rows]^T over D: both tiles K-major from
// shared memory (the forward's Q.K^T); issued, not waited for
template <int ROWS_A, int ROWS_B>
__device__ __forceinline__ void rows_dot(float (&acc)[ROWS_B / 2], uint32_t sA, uint32_t sB) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint64_t da = wg::make_desc(sA + (ks / 4) * ROWS_A * 128 + (ks % 4) * 32, 16, 1024,
                                      wg::SW_128);
    const uint64_t db = wg::make_desc(sB + (ks / 4) * ROWS_B * 128 + (ks % 4) * 32, 16, 1024,
                                      wg::SW_128);
    if constexpr (ROWS_B == 64) {
      wg::wgmma_ss_n64(acc, da, db, ks > 0);
    } else {
      wg::wgmma_ss_n32(acc, da, db, ks > 0);
    }
  }
}

// acc[64] += A . B[ROWS_B rows][D]: A in registers (ROWS_B / 16 k16 steps of the
// accumulator-shaped fragment), B read MN-major (the forward's P.V); issued, not
// waited for
template <int ROWS_B>
__device__ __forceinline__ void cols_dot(float (&acc)[64], const uint32_t (&a)[ROWS_B / 16][4],
                                         uint32_t sB) {
#pragma unroll
  for (int ks = 0; ks < ROWS_B / 16; ++ks)
    wg::wgmma_rs_n128(acc, a[ks],
                      wg::make_desc(sB + ks * 16 * 128, ROWS_B * 128, 1024, wg::SW_128), 1);
}

// accumulator tile [64 x 16 KS] (per warp: [2 KS][4]) -> the bf16 A fragments of KS
// k16 steps
template <int KS>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[KS][4], const float (&x)[2 * KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    a[ks][0] = pack_bf16(x[2 * ks][0], x[2 * ks][1]);
    a[ks][1] = pack_bf16(x[2 * ks][2], x[2 * ks][3]);
    a[ks][2] = pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    a[ks][3] = pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// flat view of an accumulator tile for the wgmma wrappers
template <int N>
__device__ __forceinline__ float (&flat(float (&x)[N][4]))[4 * N] {
  return reinterpret_cast<float(&)[4 * N]>(x);
}

__global__ void __launch_bounds__(THREADS, 2) bwd_dq_mma_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sG = sQ + tile_bytes(DQ_ROWS);
  auto sK = [&](int st) { return sG + tile_bytes(DQ_ROWS) + st * 2 * tile_bytes(DQ_KEYS); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * DQ_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int wrow0 = q0 + warp * 16;
  const float c = a.scale * LOG2E;
  const bool unm = a.need_unmasked != 0;

  // this thread's rows wrow0 + g and wrow0 + g + 8: their scalars.  On an attendable
  // pair p_u = p 2^(lse2 - lseu2), so ds = p (dP + cr) with cr = g_lse - delta +
  // g_lse_u 2^(lse2 - lseu2): one exponential per pair
  int t[2];
  bool row_ok[2];
  float lse2[2], lseu2[2], cr[2], gu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    t[r] = wrow0 + g + 8 * r;
    row_ok[r] = t[r] < a.T;
    lse2[r] = lseu2[r] = cr[r] = gu[r] = 0.f;
    if (row_ok[r]) {
      const size_t row = (static_cast<size_t>(b) * a.T + t[r]) * a.H + h;
      lse2[r] = a.lse[row] * LOG2E;
      lseu2[r] = a.lse_u[row] * LOG2E;
      gu[r] = unm ? a.g_lse_u[row] : 0.f;
      // a row with no attendable key: lse2 is NEG log2 e and the ratio 0
      cr[r] = a.g_lse[row] - a.delta[row] + gu[r] * ex2(lse2[r] - lseu2[r]);
    }
  }
  const bool rows_full = wrow0 + 15 < a.T;

  int ntiles = (a.S + DQ_KEYS - 1) / DQ_KEYS;
  if (!unm && a.causal) ntiles = min(ntiles, (q0 + DQ_ROWS - 1) / DQ_KEYS + 1);

  load_tile<DQ_ROWS>(sQ, a.q, b, h, q0, a.T, a.H);
  load_tile<DQ_ROWS>(sG, a.g_out, b, h, q0, a.T, a.H);
  load_tile<DQ_KEYS>(sK(0), a.k, b, hk, 0, a.S, a.Hkv);
  load_tile<DQ_KEYS>(sK(0) + tile_bytes(DQ_KEYS), a.v, b, hk, 0, a.S, a.Hkv);
  cp_commit();

  const int32_t* km = a.key_mask + static_cast<size_t>(b) * a.S;
  bool mk[2];  // this lane's keys 32 w + lane of the current tile
#pragma unroll
  for (int w = 0; w < 2; ++w) mk[w] = 32 * w + lane < a.S && km[32 * w + lane] != 0;

  float dq[D / 8][4];
  zero(dq);

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * DQ_KEYS, st = it & 1;
    if (it + 1 < ntiles) {
      load_tile<DQ_KEYS>(sK(st ^ 1), a.k, b, hk, k0 + DQ_KEYS, a.S, a.Hkv);
      load_tile<DQ_KEYS>(sK(st ^ 1) + tile_bytes(DQ_KEYS), a.v, b, hk, k0 + DQ_KEYS, a.S, a.Hkv);
    }
    cp_commit();
    uint32_t bits[2];  // bit i of word w: key k0 + 32 w + i is attendable by the key mask
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      bits[w] = __ballot_sync(0xffffffffu, mk[w]);
      const int s = k0 + DQ_KEYS + 32 * w + lane;
      mk[w] = s < a.S && km[s] != 0;
    }
    tiles_landed<1>();

    // without need_unmasked a tile with no attendable (row, key) pair adds nothing
    const bool dead = (bits[0] | bits[1]) == 0u || (a.causal && k0 > q0 + DQ_ROWS - 1);
    if (unm || !dead) {
      const uint32_t sKt = sK(st), sVt = sKt + tile_bytes(DQ_KEYS);
      float s[DQ_KEYS / 8][4], dp[DQ_KEYS / 8][4];
      wg::fence();
      rows_dot<DQ_ROWS, DQ_KEYS>(flat(s), sQ, sKt);
      rows_dot<DQ_ROWS, DQ_KEYS>(flat(dp), sG, sVt);
      wg::commit();
      wg::wait<0>();
      reg_fence(flat(s));
      reg_fence(flat(dp));
      // s becomes ds; element [j][e] is row t[e / 2], key k0 + 8 j + 2 t4 + e % 2,
      // whose key-mask bit is bit 8 (j % 4) + e % 2 of word j / 4 shifted by 2 t4.
      // A clean warp tile (every key attendable from each of its rows) tests nothing.
      const bool clean = rows_full && (bits[0] & bits[1]) == 0xffffffffu &&
                         !(a.causal && k0 + DQ_KEYS - 1 > wrow0);
      if (clean) {
#pragma unroll
        for (int j = 0; j < DQ_KEYS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = ex2(fmaf(s[j][e], c, -lse2[e >> 1])) * (dp[j][e] + cr[e >> 1]);
      } else {
#pragma unroll
        for (int j = 0; j < DQ_KEYS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, key = k0 + 8 * j + 2 * t4 + (e & 1);
            const bool in = row_ok[r] && key < a.S;
            const bool att = in && ((bits[j >> 2] >> (2 * t4 + 8 * (j & 3) + (e & 1))) & 1u) &&
                             !(a.causal && key > t[r]);
            float ds = 0.f;
            if (att) {
              ds = ex2(fmaf(s[j][e], c, -lse2[r])) * (dp[j][e] + cr[r]);
            } else if (unm && in) {
              ds = gu[r] * ex2(fmaf(s[j][e], c, -lseu2[r]));
            }
            s[j][e] = ds;
          }
      }
      uint32_t da[DQ_KEYS / 16][4];
      to_a_frags<DQ_KEYS / 16>(da, s);
      reg_fence(flat(dq));
      wg::fence();
      cols_dot<DQ_KEYS>(flat(dq), da, sKt);
      wg::commit();
      wg::wait<0>();
      reg_fence(flat(dq));
    }
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    uint32_t* o = reinterpret_cast<uint32_t*>(
        a.dq + ((static_cast<size_t>(b) * a.T + t[r]) * a.H + h) * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      o[4 * j + t4] = pack_bf16(dq[j][2 * r] * a.scale, dq[j][2 * r + 1] * a.scale);
  }
}

__global__ void __launch_bounds__(THREADS, 2) bwd_dkv_mma_kernel(Args a, int split) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + tile_bytes(DKV_KEYS);
  auto stage = [&](int st) { return sV + tile_bytes(DKV_KEYS) + st * DKV_STAGE; };
  float* red = reinterpret_cast<float*>(smem_raw + (sK - smem_u32(smem_raw)));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int rank = blockIdx.x % split, k0 = (blockIdx.x / split) * DKV_KEYS;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int nqt = (a.T + DKV_ROWS - 1) / DKV_ROWS;
  const int n_items = G * nqt;
  const int lo = rank * n_items / split, hi = (rank + 1) * n_items / split;
  const float c = a.scale * LOG2E;
  const bool unm = a.need_unmasked != 0;

  // this thread's keys k0 + 16 warp + g and + 8
  int kr[2];
  bool key_in[2], key_att[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kr[r] = k0 + warp * 16 + g + 8 * r;
    key_in[r] = kr[r] < a.S;
    key_att[r] = key_in[r] && a.key_mask[static_cast<size_t>(b) * a.S + kr[r]] != 0;
  }
  // a vote, so that the compiler sees it uniform over the warp: the item loop it
  // steers issues wgmmas, which ptxas serializes under a branch it cannot prove uniform
  const bool cta_any = __any_sync(0xffffffffu, __syncthreads_or(key_att[0] || key_att[1]));

  // item i: GQA head i / nqt of the group, query tile i % nqt
  auto visited = [&](int i) {
    if (unm) return true;
    return cta_any && !(a.causal && k0 > (i % nqt) * DKV_ROWS + DKV_ROWS - 1);
  };
  auto next = [&](int i) {
    while (i < hi && !visited(i)) ++i;
    return i;
  };
  auto load_item = [&](int i, uint32_t dst) {
    const int h = hk * G + i / nqt, q0 = (i % nqt) * DKV_ROWS;
    load_tile<DKV_ROWS>(dst, a.q, b, h, q0, a.T, a.H);
    load_tile<DKV_ROWS>(dst + tile_bytes(DKV_ROWS), a.g_out, b, h, q0, a.T, a.H);
    // per query row of the tile: lse, lse_u, delta, g_lse, g_lse_u
    for (int j = tid; j < 5 * DKV_ROWS; j += THREADS) {
      const int arr = j / DKV_ROWS, r = j % DKV_ROWS, tq = q0 + r;
      const bool ok = tq < a.T;
      const float* src = arr == 0   ? a.lse
                         : arr == 1 ? a.lse_u
                         : arr == 2 ? a.delta
                         : arr == 3 ? a.g_lse
                                    : a.g_lse_u;
      cp_async4(dst + 2 * tile_bytes(DKV_ROWS) + 4 * j,
                src + (static_cast<size_t>(b) * a.T + (ok ? tq : 0)) * a.H + h, ok);
    }
  };

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);

  int cur = next(lo);
  if (cur < hi) {
    load_tile<DKV_KEYS>(sK, a.k, b, hk, k0, a.S, a.Hkv);
    load_tile<DKV_KEYS>(sV, a.v, b, hk, k0, a.S, a.Hkv);
    load_item(cur, stage(0));
  }
  cp_commit();
  for (int n = 0; cur < hi; ++n) {
    const int st = n & 1;
    const int nxt = next(cur + 1);
    if (nxt < hi) load_item(nxt, stage(st ^ 1));
    cp_commit();
    tiles_landed<1>();

    const int q0 = (cur % nqt) * DKV_ROWS;
    const uint32_t sQ = stage(st), sG = sQ + tile_bytes(DKV_ROWS);
    // lse, lse_u, delta, g_lse, g_lse_u of the tile's rows
    const float* R = reinterpret_cast<const float*>(
        smem_raw + (sG + tile_bytes(DKV_ROWS) - smem_u32(smem_raw)));
    // every visited item runs all four products (p = 0 where nothing is attendable)
    float s[DKV_ROWS / 8][4], dp[DKV_ROWS / 8][4];
    wg::fence();
    rows_dot<DKV_KEYS, DKV_ROWS>(flat(s), sK, sQ);
    rows_dot<DKV_KEYS, DKV_ROWS>(flat(dp), sV, sG);
    wg::commit();
    wg::wait<0>();
    reg_fence(flat(s));
    reg_fence(flat(dp));
    // element [j][e] is key kr[e / 2], query row q0 + 8 j + 2 t4 + e % 2;
    // s becomes ds^T, dp becomes p^T
#pragma unroll
    for (int j = 0; j < DKV_ROWS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * j + 2 * t4 + (e & 1), tq = q0 + col;
        const bool in = key_in[r] && tq < a.T;
        const bool att = in && key_att[r] && !(a.causal && kr[r] > tq);
        float p = 0.f, ds = 0.f;
        if (att) {
          p = ex2(fmaf(s[j][e], c, -R[col] * LOG2E));
          ds = p * (dp[j][e] + R[3 * DKV_ROWS + col] - R[2 * DKV_ROWS + col]);
        }
        if (unm && in)
          ds += R[4 * DKV_ROWS + col] * ex2(fmaf(s[j][e], c, -R[DKV_ROWS + col] * LOG2E));
        s[j][e] = ds;
        dp[j][e] = p;
      }
    // both products in one group: their A registers stay untouched until the wait
    uint32_t pa[DKV_ROWS / 16][4], da[DKV_ROWS / 16][4];
    to_a_frags<DKV_ROWS / 16>(pa, dp);
    to_a_frags<DKV_ROWS / 16>(da, s);
    reg_fence(flat(dk));
    reg_fence(flat(dv));
    wg::fence();
    cols_dot<DKV_ROWS>(flat(dv), pa, sG);
    cols_dot<DKV_ROWS>(flat(dk), da, sQ);
    wg::commit();
    wg::wait<0>();
    reg_fence(flat(dk));
    reg_fence(flat(dv));
    __syncthreads();  // this stage is refilled by the next iteration's loads
    cur = nxt;
  }
  cp_wait<0>();
  __syncthreads();

  // the CTA's sums -> shared fp32 [2][64 keys][RED_STRIDE] (over the tiles)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kl = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(red + kl * RED_STRIDE + col) =
          make_float2(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<float2*>(red + (DKV_KEYS + kl) * RED_STRIDE + col) =
          make_float2(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  // rank r: key rows [r * 64 / split, (r + 1) * 64 / split), the ranks' sums in rank order
  const float* part[MAX_SPLIT];
#pragma unroll
  for (int p = 0; p < MAX_SPLIT; ++p)
    part[p] = split == 1 ? red : cluster.map_shared_rank(red, p < split ? p : 0);
  const int per = DKV_KEYS / split;
  for (int i = tid; i < 2 * per * (D / 2); i += THREADS) {
    const int which = i / (per * (D / 2));  // 0: dk, 1: dv
    const int rem = i % (per * (D / 2));
    const int kl = rank * per + rem / (D / 2), col = 2 * (rem % (D / 2));
    const int s = k0 + kl;
    const int off = (which * DKV_KEYS + kl) * RED_STRIDE + col;
    float2 v[MAX_SPLIT];
#pragma unroll
    for (int p = 0; p < MAX_SPLIT; ++p)
      v[p] = p < split ? *reinterpret_cast<const float2*>(part[p] + off) : make_float2(0.f, 0.f);
    float x = v[0].x, y = v[0].y;
#pragma unroll
    for (int p = 1; p < MAX_SPLIT; ++p)
      if (p < split) {
        x += v[p].x;
        y += v[p].y;
      }
    if (s >= a.S) continue;
    const float mul = which == 0 ? a.scale : 1.f;
    __nv_bfloat16* o = (which == 0 ? a.dk : a.dv) +
                       ((static_cast<size_t>(b) * a.S + s) * a.Hkv + hk) * D + col;
    *reinterpret_cast<uint32_t*>(o) = pack_bf16(x * mul, y * mul);
  }
  if (split > 1) cluster.sync();  // keep red alive until every rank has read it
}

// the shared-memory limit is raised once per kernel (also outside a CUDA graph's capture)
template <typename Kernel>
cudaError_t size_once(Kernel kernel, int bytes, bool& sized) {
  if (sized) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  sized = e == cudaSuccess;
  return e;
}

inline cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  static bool sized = false;
  cudaError_t e = size_once(bwd_dq_mma_kernel, DQ_SMEM, sized);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + DQ_ROWS - 1) / DQ_ROWS, a.H, a.B);
  bwd_dq_mma_kernel<<<grid, THREADS, DQ_SMEM, stream>>>(a);
  return cudaGetLastError();
}

// grid (key tiles x split, Hkv, B) in clusters of (split, 1, 1)
inline cudaError_t launch_dkv(const Args& a, int split, cudaStream_t stream) {
  if (split < 1 || split > MAX_SPLIT || (split & (split - 1)) != 0) return cudaErrorInvalidValue;
  static bool sized = false;
  cudaError_t e = size_once(bwd_dkv_mma_kernel, DKV_SMEM, sized);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.S + DKV_KEYS - 1) / DKV_KEYS * split, a.Hkv, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = DKV_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, bwd_dkv_mma_kernel, a, split);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace bwd
}  // namespace mimic
