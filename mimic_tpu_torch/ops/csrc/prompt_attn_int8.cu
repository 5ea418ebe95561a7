// prompt_attn_int8 — decode-step attention over the beam-shared int8 prompt KV,
// emitting the unnormalised partial softmax state (o, m, l).
//
// Replaces the Pallas kernel mimic_tpu/ops/decode_attention.py::_kernel
// (pallas_call at decode_attention.py:199, prompt_attention_int8).  Contract,
// folded layout (the wrapper folds beams into the query-group axis): q
// [B0, Hkv, M, 128] fp32 or bf16, prescaled by 1/sqrt(D); k8, v8 [B0, Hkv, Sp, 128]
// int8 with scales ks, vs [B0, Hkv, Sp] fp32; mask [B0, Sp] int32 (nonzero =
// attend); Sp a multiple of 128, M <= 32.  Out: o [B0, Hkv, M, 128] = sum_s
// p[s] * vs[s] * v8[s], m [B0, Hkv, M] (natural log) and l = sum_s p[s], all
// fp32, with p = exp2(s - m) and s = (q * log2 e rounded to q's dtype) . k8 * ks
// in the log2 domain.  As in JAX: masked keys score the finite NEG = -1e30
// (never -inf), p * vs is rounded to q's dtype before the PV product, and a
// block whose keys are all masked is wiped by a later real block's rescale.
// Runs repeat bit for bit (no atomics; every sum in a fixed order).
//
// What bounds it on the H100: bytes.  A decode step reads 2 * Sp * 128 int8
// bytes per (batch row, kv head) and does 4 * M operations per key and d; at
// call B (B0 2, Hkv 8, Sp 4096, M 12) that is 16.8 MB and 0.4 G operations per
// layer: 5.2 us at 3.35 TB/s.
//
// bf16 (the serving path): one launch, no workspace.
//  * Grid (split, Hkv, B0), the split CTAs of one (batch row, kv head) a
//    thread-block cluster; the wrapper's plan (decode_attention.prompt_split)
//    picks the split (1-8, at most one per 128-key chunk) that fills the SMs in
//    one wave: 16 x 8 CTAs at call B, 32 x 4 at call A.  Rank r takes chunks
//    [r n / split, (r + 1) n / split) of the n = Sp / 128.
//  * Each of the CTA's 8 warps owns keys 16w .. 16w + 15 of every chunk and
//    runs on its own: it streams its keys' 2 KB of k, 2 KB of v and their scales
//    and mask through a private cp.async ring of 4 stages, with no CTA barrier
//    in the loop, and keeps its own online softmax, one step per pair of
//    chunks at M <= 16 (two independent score chains per step, one rescale per
//    32 keys; decode_attention.prompt_steps), per chunk above.
//  * Scores on the tensor cores: mma.sync.m16n8k16 bf16 with q (M rows padded to
//    16 or 32, prepared once per CTA as A fragments in shared memory) and the
//    key tile as the B operand: the contraction over d is permuted alike on
//    both operands, so a lane's B fragments are consecutive bytes of one key
//    row (two 16-byte loads give all eight k16 steps), converted exactly to
//    bf16 by int8_mma.cuh's prmt conversion.
//  * P.V on the tensor cores as o^T = v^T . p^T: v's [key, d] bytes are the A
//    operand read as they lie (int8_mma.cuh's k permutation: four consecutive
//    key rows, 16 consecutive d per lane), and the score accumulators, scaled
//    by vs and rounded to bf16, are the B operand as they stand (the key order
//    of the score tiles is chosen so).  The running-max rescale of o moves each
//    row's factor to the lanes that hold its columns by four shuffles.
//  * Merges in a fixed order: the 8 warps' partials in warp order in shared
//    memory, then the CTAs' partials in rank order through distributed shared
//    memory, each rank writing its slice of (o, m, l).
//  * Key tiles in shared memory are swizzled (k: chunk ^ 4 (row & 1); v: chunk ^
//    2 ((row >> 2) & 3)), so every 16-byte fragment load is free of bank conflicts.
//
// fp32 (the CPU-parity slice, not the serving path): the scalar form below.  One
// CTA per (128-key chunk, kv head, batch row) computes the chunk's scores,
// softmax and P.V in fp32 on the CUDA cores and writes a partial (o, m, l) to a
// workspace; a second kernel merges the chunks' partials in chunk order.

#include <cooperative_groups.h>

#include <type_traits>

#include "int8_common.cuh"
#include "int8_mma.cuh"

namespace mimic_q {

constexpr int BKEY = 128;       // keys per CTA
constexpr int HD = 128;         // head dim
constexpr int MMAX = 32;        // folded query rows (beams x groups)
constexpr int KROW = HD + 4;    // bytes per key row in shared memory
constexpr int PROW = BKEY + 1;  // floats per row of the probability tile

struct PromptSmem {
  float q[MMAX][HD];
  float p[MMAX][PROW];
  int8_t k[BKEY][KROW];
  int8_t v[BKEY][HD];
  float ks[BKEY];
  float vs[BKEY];
  int mask[BKEY];
  float mrow[MMAX];
  float lrow[MMAX];
};

template <typename T>
__global__ void __launch_bounds__(NT)
    prompt_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                       const float* __restrict__ ks, const int8_t* __restrict__ v8,
                       const float* __restrict__ vs, const int* __restrict__ mask,
                       float* __restrict__ work, int M, int Sp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PromptSmem& s = *reinterpret_cast<PromptSmem*>(smem_raw);
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Hkv = gridDim.y, B0 = gridDim.z;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  const int s0 = chunk * BKEY;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // q * log2 e, rounded to T as the JAX wrapper does; rows >= M are zero
  for (int i = tid; i < MMAX * HD; i += NT) {
    const int m = i / HD, d = i % HD;
    s.q[m][d] = m < M ? round_to<T>(to_f(q[(bh * M + m) * HD + d]) * LOG2E) : 0.f;
  }
  const int4* kg = reinterpret_cast<const int4*>(k8 + (bh * Sp + s0) * HD);
  const int4* vg = reinterpret_cast<const int4*>(v8 + (bh * Sp + s0) * HD);
  for (int i = tid; i < BKEY * HD / 16; i += NT) {
    const int row = i / (HD / 16), c = i % (HD / 16);
    const int4 kv = __ldg(kg + i);
    unsigned int* dst = reinterpret_cast<unsigned int*>(&s.k[row][c * 16]);
    dst[0] = kv.x;
    dst[1] = kv.y;
    dst[2] = kv.z;
    dst[3] = kv.w;
    reinterpret_cast<int4*>(&s.v[0][0])[i] = __ldg(vg + i);
  }
  if (tid < BKEY) {
    s.ks[tid] = ks[bh * Sp + s0 + tid];
    s.vs[tid] = vs[bh * Sp + s0 + tid];
    s.mask[tid] = mask[static_cast<size_t>(b) * Sp + s0 + tid];
  }
  __syncthreads();

  // scores: thread (key j, half) takes rows half, half + 2, ... (half is
  // uniform across a warp, so the row test below is too)
  {
    const int j = tid & (BKEY - 1), half = tid >> 7;
    float acc[MMAX / 2];
#pragma unroll
    for (int r = 0; r < MMAX / 2; ++r) acc[r] = 0.f;
    const unsigned int* krow = reinterpret_cast<const unsigned int*>(&s.k[j][0]);
#pragma unroll 4
    for (int dq = 0; dq < HD / 4; ++dq) {
      float kf[4];
      unpack4(krow[dq], kf);
#pragma unroll
      for (int r = 0; r < MMAX / 2; ++r) {
        const int m = half + 2 * r;
        if (m < M) {
          const float4 qv = *reinterpret_cast<const float4*>(&s.q[m][4 * dq]);
          acc[r] = fmaf(qv.x, kf[0], acc[r]);
          acc[r] = fmaf(qv.y, kf[1], acc[r]);
          acc[r] = fmaf(qv.z, kf[2], acc[r]);
          acc[r] = fmaf(qv.w, kf[3], acc[r]);
        }
      }
    }
    const float kscale = s.ks[j];
    const bool on = s.mask[j] != 0;
#pragma unroll
    for (int r = 0; r < MMAX / 2; ++r) {
      const int m = half + 2 * r;
      if (m < M) s.p[m][j] = on ? acc[r] * kscale : NEG;
    }
  }
  __syncthreads();

  // the chunk's softmax, one warp per row: p = exp2(s - max), l = sum p,
  // then p * vs rounded to T in place
  for (int m = warp; m < M; m += NWARPS) {
    float x[BKEY / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < BKEY / 32; ++c) {
      x[c] = s.p[m][lane + 32 * c];
      mx = fmaxf(mx, x[c]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < BKEY / 32; ++c) {
      const int col = lane + 32 * c;
      const float p = exp2f(x[c] - mx);
      sum += p;
      s.p[m][col] = round_to<T>(p * s.vs[col]);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      s.mrow[m] = mx;
      s.lrow[m] = sum;
    }
  }
  __syncthreads();

  // P.V: warp w takes rows w, w + 8, ...; lane t columns 4t..4t+3
  float o[MMAX / NWARPS][4];
#pragma unroll
  for (int r = 0; r < MMAX / NWARPS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < BKEY; ++j) {
    float vf[4];
    unpack4(reinterpret_cast<const unsigned int*>(&s.v[j][0])[lane], vf);
#pragma unroll
    for (int r = 0; r < MMAX / NWARPS; ++r) {
      const int m = warp + NWARPS * r;
      if (m < M) {
        const float p = s.p[m][j];
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] = fmaf(p, vf[c], o[r][c]);
      }
    }
  }

  // the chunk's partial: work [nchunks][B0 * Hkv][M][HD + 2] = (o, m, l)
  const size_t rows = static_cast<size_t>(B0) * Hkv * M;
#pragma unroll
  for (int r = 0; r < MMAX / NWARPS; ++r) {
    const int m = warp + NWARPS * r;
    if (m < M) {
      float* dst = work + (chunk * rows + bh * M + m) * (HD + 2);
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[4 * lane + c] = o[r][c];
      if (lane == 0) {
        dst[HD] = s.mrow[m];
        dst[HD + 1] = s.lrow[m];
      }
    }
  }
}

// merge the chunks' partials of one row (blockIdx.x) in chunk order; one thread per column
static __global__ void prompt_attn_merge(const float* __restrict__ work, float* __restrict__ o,
                                         float* __restrict__ m_out, float* __restrict__ l_out,
                                         int rows, int nchunks) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  float mt = NEG;
  for (int c = 0; c < nchunks; ++c) mt = fmaxf(mt, work[(c * rows + row) * (HD + 2) + HD]);
  float acc = 0.f, l = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const float* p = work + (c * rows + row) * (HD + 2);
    const float a = exp2f(p[HD] - mt);
    acc = fmaf(p[d], a, acc);
    l = fmaf(p[HD + 1], a, l);
  }
  o[row * HD + d] = acc;
  if (d == 0) {
    m_out[row] = mt * LN2;  // back to the natural-log domain for the merge
    l_out[row] = l;
  }
}

static cudaError_t run_scalar(const float* q, const int8_t* k8, const float* ks,
                              const int8_t* v8, const float* vs, const int* mask, float* work,
                              float* o, float* m, float* l, int B0, int Hkv, int M, int Sp,
                              cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(PromptSmem));
  cudaError_t e = cudaFuncSetAttribute(prompt_attn_kernel<float>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(Sp / BKEY, Hkv, B0);
  prompt_attn_kernel<float><<<grid, NT, bytes, stream>>>(q, k8, ks, v8, vs, mask, work, M, Sp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = B0 * Hkv * M;
  prompt_attn_merge<<<rows, HD, 0, stream>>>(work, o, m, l, rows, Sp / BKEY);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (see the top of the file)
// ---------------------------------------------------------------------------

constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_KEYS = BKEY / PA_WARPS;  // keys of a chunk per warp: 16
constexpr int PA_STAGES = 4;              // slots of a warp's ring
constexpr int PA_MAX_SPLIT = 8;           // portable cluster size
constexpr int PA_TILE = PA_KEYS * HD;     // bytes of a warp's k (or v) tile
constexpr int PA_STAGE = 2 * PA_TILE + 3 * PA_KEYS * 4;  // k, v, ks, vs, mask
constexpr int PA_RING = PA_WARPS * PA_STAGES * PA_STAGE;
static_assert(PA_KEYS == 16, "a warp's keys are two n8 score tiles, one k16 step of P.V");

template <int MT>
struct PaSmem {
  static constexpr int ROWS = 16 * MT;                 // padded query rows
  static constexpr int NREG = 64 * MT;                 // o^T accumulators per lane
  static constexpr int PART = NREG * 32;               // floats of a partial o, in fragment order
  static constexpr int QFRAG = PA_RING;                // [MT][8][32] uint4
  static constexpr int CTA = QFRAG + MT * 8 * 32 * 16; // the CTA's partial o
  static constexpr int STATS = CTA + PART * 4;         // row statistics, floats:
  static constexpr int WM = 0;                         //   the warps' m [PA_WARPS][ROWS]
  static constexpr int WL = WM + PA_WARPS * ROWS;      //   the warps' l
  static constexpr int WF = WL + PA_WARPS * ROWS;      //   the warps' factors
  static constexpr int CM = WF + PA_WARPS * ROWS;      //   the CTA's m [ROWS]
  static constexpr int CL = CM + ROWS;                 //   the CTA's l
  static constexpr int RM = CL + ROWS;                 //   the ranks' m [PA_MAX_SPLIT][ROWS]
  static constexpr int RL = RM + PA_MAX_SPLIT * ROWS;  //   the ranks' l
  static constexpr int RF = RL + PA_MAX_SPLIT * ROWS;  //   the ranks' factors
  static constexpr int NSTATS = RF + PA_MAX_SPLIT * ROWS;
  static constexpr int BYTES = STATS + NSTATS * 4;
  // after the key loop a warp's ring holds its partial o
  static_assert(PART * 4 <= PA_STAGES * PA_STAGE, "a warp's partial fits its ring");
};

// query row and head-dim column of o^T accumulator j (the flattened
// [mt][i2][nt][e] of the kernel) of lane (g, t)
__host__ __device__ constexpr int frag_row(int j, int lane) {
  return 16 * (j >> 6) + 8 * ((j >> 2) & 1) + 2 * (lane & 3) + (j & 1);
}
__host__ __device__ constexpr int frag_col(int j, int lane) {
  return 16 * (lane >> 2) + 2 * ((j >> 3) & 7) + ((j >> 1) & 1);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// two floats rounded to bf16 (nearest even), packed {lo, hi}
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the exact bf16 pair of bytes J, J2 of a word whose sign bits are flipped
template <int J, int J2>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t u) {
  return pack_bf16(biased_byte_to_f32<J>(u), biased_byte_to_f32<J2>(u));
}

// key of column n (0..7) of score tile T (0, 1) within a warp's 16 keys: lane
// (g, t)'s accumulator columns 2t, 2t + 1 are keys 4t + 2T, 4t + 2T + 1, so its
// P^T fragment (keys 4t .. 4t + 3) is tile 0's and tile 1's pair
__host__ __device__ constexpr int score_key(int T, int n) { return 4 * (n >> 1) + 2 * T + (n & 1); }

template <int MT>
__global__ void __launch_bounds__(PA_THREADS, 1)
    prompt_attn_mma_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k8,
                           const float* __restrict__ ks, const int8_t* __restrict__ v8,
                           const float* __restrict__ vs, const int* __restrict__ mask,
                           float* __restrict__ o_out, float* __restrict__ m_out,
                           float* __restrict__ l_out, int M, int Sp) {
  using L = PaSmem<MT>;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t smem0 = smem_u32(smem);
  const int split = gridDim.x, rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * gridDim.y + h;
  const int nchunks = Sp / BKEY;
  const int c_begin = rank * nchunks / split, nloc = (rank + 1) * nchunks / split - c_begin;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // this warp's ring; stage layout: k [16][128] (chunk ^ 4 (row & 1)), v [16][128]
  // (chunk ^ 2 ((row >> 2) & 3)), ks [16], vs [16], mask [16]
  const uint32_t ring = smem0 + warp * PA_STAGES * PA_STAGE;
  const int8_t* kg = k8 + (bh * Sp) * HD;
  const int8_t* vg = v8 + (bh * Sp) * HD;
  const float* ksg = ks + bh * Sp;
  const float* vsg = vs + bh * Sp;
  const int* mg = mask + static_cast<size_t>(b) * Sp;
  auto issue = [&](int i) {
    if (i < nloc) {
      const uint32_t st = ring + (i % PA_STAGES) * PA_STAGE;
      const int s0 = (c_begin + i) * BKEY + warp * PA_KEYS;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = lane + 32 * e, r = idx >> 3, cc = idx & 7;
        cp_async16(st + r * HD + ((cc ^ ((r & 1) << 2)) << 4), kg + (s0 + r) * HD + cc * 16, true);
        cp_async16(st + PA_TILE + r * HD + ((cc ^ (((r >> 2) & 3) << 1)) << 4),
                   vg + (s0 + r) * HD + cc * 16, true);
      }
      if (lane < 12) {
        const int arr = lane >> 2, part = lane & 3;
        const void* src = arr == 0 ? static_cast<const void*>(ksg + s0 + 4 * part)
                          : arr == 1 ? static_cast<const void*>(vsg + s0 + 4 * part)
                                     : static_cast<const void*>(mg + s0 + 4 * part);
        cp_async16(st + 2 * PA_TILE + arr * PA_KEYS * 4 + part * 16, src, true);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };

  // a warp takes NB chunks' slices per softmax step: two at one m16 tile of rows
  // (two independent score chains, one rescale per 32 keys), one at two tiles
  constexpr int NB = MT == 1 ? 2 : 1;
#pragma unroll
  for (int i = 0; i < PA_STAGES - NB; ++i) issue(i);

  // q * log2 e rounded to bf16 (as the JAX wrapper does), as the A fragments of the
  // eight k16 steps: step c, lane (g, t) holds d0 = 64 (c >> 2) + 16 t + 4 (c & 3)
  // and d0 + 1 (a0, a1: rows g, g + 8), d0 + 2 and d0 + 3 (a2, a3); rows >= M zero.
  // Made while the first key tiles are on their way.
  {
    uint4* qfrag = reinterpret_cast<uint4*>(smem + L::QFRAG);
    const __nv_bfloat16* qb = q + bh * M * HD;
    auto q4 = [&](int r, int d0, float (&v)[4]) {
      if (r < M) {
        const uint2 raw = *reinterpret_cast<const uint2*>(qb + r * HD + d0);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = round_to<__nv_bfloat16>(__bfloat162float(e[i]) * LOG2E);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = 0.f;
      }
    };
    for (int i = tid; i < MT * 8 * 32; i += PA_THREADS) {
      const int mt = i >> 8, c = (i >> 5) & 7, ln = i & 31, gg = ln >> 2, tt = ln & 3;
      const int d0 = 64 * (c >> 2) + 16 * tt + 4 * (c & 3), r0 = 16 * mt + gg;
      float v0[4], v1[4];
      q4(r0, d0, v0);
      q4(r0 + 8, d0, v1);
      qfrag[i] = make_uint4(pack_rn(v0[0], v0[1]), pack_rn(v1[0], v1[1]), pack_rn(v0[2], v0[3]),
                            pack_rn(v1[2], v1[3]));
    }
  }
  __syncthreads();

  float o[MT][8][2][4];  // o^T: [d tile i][query n8 tile][c]; d = 16 g + 2 i (+1 for c2, c3)
  float m_run[MT][2], l_run[MT][2];  // rows g, g + 8 of each m16 tile; l per lane
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][i][nt][e] = 0.f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m_run[mt][hr] = -INFINITY;
      l_run[mt][hr] = 0.f;
    }
  }

  const uint32_t qfrag = smem0 + L::QFRAG + lane * 16;

  // one softmax step over the slices of chunks i .. i + NS - 1 (in ring slots
  // (i + b) % PA_STAGES)
  auto step = [&](auto ns_tag, int i) {
    constexpr int NS = decltype(ns_tag)::value;
    uint32_t st[NS];
#pragma unroll
    for (int b = 0; b < NS; ++b) st[b] = ring + ((i + b) % PA_STAGES) * PA_STAGE;

    // scores of the slices' 16 keys each
    float sc[MT][NS][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int b = 0; b < NS; ++b)
#pragma unroll
        for (int T = 0; T < 2; ++T)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[mt][b][T][e] = 0.f;
    uint4 kw[NS][2][2];
#pragma unroll
    for (int b = 0; b < NS; ++b)
#pragma unroll
      for (int T = 0; T < 2; ++T) {
        const int r = score_key(T, g);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          kw[b][T][hh] = lds128(st[b] + r * HD + (((4 * hh + t) ^ ((r & 1) << 2)) << 4));
      }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint4 a[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) a[mt] = lds128(qfrag + (mt * 8 + c) * 32 * 16);
#pragma unroll
      for (int b = 0; b < NS; ++b)
#pragma unroll
        for (int T = 0; T < 2; ++T) {
          const uint32_t u = word_of(kw[b][T][c >> 2], c & 3) ^ 0x80808080u;
          const uint32_t b0 = bf16_pair<0, 1>(u), b1 = bf16_pair<2, 3>(u);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t af[4] = {a[mt].x, a[mt].y, a[mt].z, a[mt].w};
            mma_bf16(sc[mt][b][T], af, b0, b1);
          }
        }
    }

    // online softmax over the step's keys: accumulator e of tile T is key
    // 4t + 2T + (e & 1) of its slice, row g + 8 (e >> 1)
    float ksv[NS][2][2], vsv[NS][2][2];
    bool on[NS][2][2];
#pragma unroll
    for (int b = 0; b < NS; ++b) {
      const float* sks = reinterpret_cast<const float*>(smem + (st[b] - smem0) + 2 * PA_TILE);
      const float4 ks4 = *reinterpret_cast<const float4*>(sks + 4 * t);
      const float4 vs4 = *reinterpret_cast<const float4*>(sks + PA_KEYS + 4 * t);
      const int4 mk4 = *reinterpret_cast<const int4*>(sks + 2 * PA_KEYS + 4 * t);
      ksv[b][0][0] = ks4.x, ksv[b][0][1] = ks4.y, ksv[b][1][0] = ks4.z, ksv[b][1][1] = ks4.w;
      vsv[b][0][0] = vs4.x, vsv[b][0][1] = vs4.y, vsv[b][1][0] = vs4.z, vsv[b][1][1] = vs4.w;
      on[b][0][0] = mk4.x != 0, on[b][0][1] = mk4.y != 0, on[b][1][0] = mk4.z != 0;
      on[b][1][1] = mk4.w != 0;
    }
    uint32_t pb[MT][NS][2][2];  // P^T B fragments: [mt][slice][query n8 tile][b0, b1]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int b = 0; b < NS; ++b)
#pragma unroll
          for (int T = 0; T < 2; ++T)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sc[mt][b][T][2 * hr + e];
              x = on[b][T][e] ? x * ksv[b][T][e] : NEG;
              mx = fmaxf(mx, x);
            }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][hr], mx);
        alpha[hr] = exp2f(m_run[mt][hr] - m_new);
        m_run[mt][hr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int b = 0; b < NS; ++b) {
          float pv[2][2];
#pragma unroll
          for (int T = 0; T < 2; ++T)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = exp2f(sc[mt][b][T][2 * hr + e] - m_new);
              sum += p;
              pv[T][e] = p * vsv[b][T][e];
            }
          pb[mt][b][hr][0] = pack_rn(pv[0][0], pv[0][1]);  // keys 4t, 4t + 1
          pb[mt][b][hr][1] = pack_rn(pv[1][0], pv[1][1]);  // keys 4t + 2, 4t + 3
        }
        l_run[mt][hr] = l_run[mt][hr] * alpha[hr] + sum;
      }
      // o^T's columns 8 nt + 2t (+1) are rows held by lanes 4 (2t) and 4 (2t + 1).
      // Where no row's max moved every factor is exactly 1: skipped (a warp vote).
      if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float f0 = __shfl_sync(0xffffffffu, alpha[nt], 8 * t);
        const float f1 = __shfl_sync(0xffffffffu, alpha[nt], 8 * t + 4);
#pragma unroll
        for (int i2 = 0; i2 < 8; ++i2) {
          o[mt][i2][nt][0] *= f0;
          o[mt][i2][nt][1] *= f1;
          o[mt][i2][nt][2] *= f0;
          o[mt][i2][nt][3] *= f1;
        }
      }
    }

    // o^T += v^T . p^T, a slice at a time: lane rows 4t .. 4t + 3, bytes 16 g ..
    // 16 g + 15 (d)
#pragma unroll
    for (int b = 0; b < NS; ++b) {
      uint32_t vw[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * t + r;
        const uint4 v = lds128(st[b] + PA_TILE + row * HD + ((g ^ (((row >> 2) & 3) << 1)) << 4));
        vw[r][0] = v.x ^ 0x80808080u;
        vw[r][1] = v.y ^ 0x80808080u;
        vw[r][2] = v.z ^ 0x80808080u;
        vw[r][3] = v.w ^ 0x80808080u;
      }
#pragma unroll
      for (int i2 = 0; i2 < 8; ++i2) {
        // instance i2: A row g is d = 16 g + 2 i2, row g + 8 is d + 1
        uint32_t a[4];
        const int w = i2 >> 1;
        if (i2 & 1) {
          a[0] = pack_bf16(biased_byte_to_f32<2>(vw[0][w]), biased_byte_to_f32<2>(vw[1][w]));
          a[1] = pack_bf16(biased_byte_to_f32<3>(vw[0][w]), biased_byte_to_f32<3>(vw[1][w]));
          a[2] = pack_bf16(biased_byte_to_f32<2>(vw[2][w]), biased_byte_to_f32<2>(vw[3][w]));
          a[3] = pack_bf16(biased_byte_to_f32<3>(vw[2][w]), biased_byte_to_f32<3>(vw[3][w]));
        } else {
          a[0] = pack_bf16(biased_byte_to_f32<0>(vw[0][w]), biased_byte_to_f32<0>(vw[1][w]));
          a[1] = pack_bf16(biased_byte_to_f32<1>(vw[0][w]), biased_byte_to_f32<1>(vw[1][w]));
          a[2] = pack_bf16(biased_byte_to_f32<0>(vw[2][w]), biased_byte_to_f32<0>(vw[3][w]));
          a[3] = pack_bf16(biased_byte_to_f32<1>(vw[2][w]), biased_byte_to_f32<1>(vw[3][w]));
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_bf16(o[mt][i2][nt], a, pb[mt][b][nt][0], pb[mt][b][nt][1]);
      }
    }
  };

  for (int i = 0; i < nloc; i += NB) {
#pragma unroll
    for (int k = 0; k < NB; ++k) issue(i + PA_STAGES - NB + k);
    cp_async_wait<PA_STAGES - NB>();
    __syncwarp();
    if (NB == 2 && i + 1 < nloc) {
      step(std::integral_constant<int, NB>{}, i);
    } else {
      step(std::integral_constant<int, 1>{}, i);  // one slice: M > 16, or a rank's last odd chunk
    }
    __syncwarp();  // every lane is done with the slots before they are refilled
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's partial: o^T in fragment order into its own ring (accumulator j of
  // lane L at j * 32 + L: the same element in every warp, no bank conflict), its
  // rows' m and l (summed over the quad) into the statistics
  float* const stats = reinterpret_cast<float*>(smem + L::STATS);
  {
    float* wp = reinterpret_cast<float*>(smem + warp * PA_STAGES * PA_STAGE);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i2 = 0; i2 < 8; ++i2)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) wp[(((mt * 8 + i2) * 2 + nt) * 4 + e) * 32 + lane] = o[mt][i2][nt][e];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float l = l_run[mt][hr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        if (t == 0) {
          stats[L::WM + warp * L::ROWS + 16 * mt + 8 * hr + g] = m_run[mt][hr];
          stats[L::WL + warp * L::ROWS + 16 * mt + 8 * hr + g] = l;
        }
      }
    }
  }
  __syncthreads();

  // the CTA's partial: per row the max over the warps and each warp's factor
  // exp2(m_w - max), once; then every element the warps' sum in warp order
  if (tid < L::ROWS) {
    const int r = tid;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) mx = fmaxf(mx, stats[L::WM + w * L::ROWS + r]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) {
      const float f = exp2f(stats[L::WM + w * L::ROWS + r] - mx);
      stats[L::WF + w * L::ROWS + r] = f;
      l = fmaf(stats[L::WL + w * L::ROWS + r], f, l);
    }
    stats[L::CM + r] = mx;
    stats[L::CL + r] = l;
  }
  __syncthreads();
  float* const cp = reinterpret_cast<float*>(smem + L::CTA);
  for (int idx = tid; idx < L::PART; idx += PA_THREADS) {
    const int r = frag_row(idx >> 5, idx & 31);
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w)
      acc = fmaf(reinterpret_cast<const float*>(smem + w * PA_STAGES * PA_STAGE)[idx],
                 stats[L::WF + w * L::ROWS + r], acc);
    cp[idx] = acc;
  }

  auto store_o = [&](int idx, float v) {
    const int r = frag_row(idx >> 5, idx & 31);
    if (r < M) o_out[(bh * M + r) * HD + frag_col(idx >> 5, idx & 31)] = v;
  };
  if (split == 1) {
    __syncthreads();
    for (int idx = tid; idx < L::PART; idx += PA_THREADS) store_o(idx, cp[idx]);
    if (tid < M) {
      m_out[bh * M + tid] = stats[L::CM + tid] * LN2;  // back to the natural-log domain
      l_out[bh * M + tid] = stats[L::CL + tid];
    }
    return;
  }

  // the CTAs' partials in rank order through distributed shared memory: every rank
  // reads the ranks' row statistics and makes the factors; rank r then writes its
  // slice of o from all ranks' values (loaded first: one round trip through the cluster)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (tid < split * L::ROWS) {
    const int j = tid / L::ROWS, r = tid % L::ROWS;
    const float* rs = cluster.map_shared_rank(stats, j);
    stats[L::RM + j * L::ROWS + r] = rs[L::CM + r];
    stats[L::RL + j * L::ROWS + r] = rs[L::CL + r];
  }
  __syncthreads();
  if (tid < L::ROWS) {
    const int r = tid;
    float mx = NEG;
    for (int j = 0; j < split; ++j) mx = fmaxf(mx, stats[L::RM + j * L::ROWS + r]);
    float l = 0.f;
    for (int j = 0; j < split; ++j) {
      const float f = exp2f(stats[L::RM + j * L::ROWS + r] - mx);
      stats[L::RF + j * L::ROWS + r] = f;
      l = fmaf(stats[L::RL + j * L::ROWS + r], f, l);
    }
    if (rank == 0 && r < M) {
      m_out[bh * M + r] = mx * LN2;
      l_out[bh * M + r] = l;
    }
  }
  __syncthreads();
  const float* part[PA_MAX_SPLIT];
#pragma unroll
  for (int j = 0; j < PA_MAX_SPLIT; ++j) part[j] = cluster.map_shared_rank(cp, j < split ? j : 0);
  for (int idx = rank * PA_THREADS + tid; idx < L::PART; idx += split * PA_THREADS) {
    const int r = frag_row(idx >> 5, idx & 31);
    float v[PA_MAX_SPLIT];
#pragma unroll
    for (int j = 0; j < PA_MAX_SPLIT; ++j) v[j] = j < split ? part[j][idx] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < PA_MAX_SPLIT; ++j)
      if (j < split) acc = fmaf(v[j], stats[L::RF + j * L::ROWS + r], acc);
    store_o(idx, acc);
  }
  cluster.sync();  // keep the partials alive until every rank has read them
}

// clusters of `split` CTAs of the kernel for M query rows that the card can hold
// at once (cudaOccupancyMaxActiveClusters); 0 on an error
template <int MT>
static int max_clusters(int split) {
  static bool sized = false;
  if (!sized) {
    if (cudaFuncSetAttribute(prompt_attn_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             PaSmem<MT>::BYTES) != cudaSuccess)
      return 0;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, 1, 1);
  cfg.blockDim = dim3(PA_THREADS);
  cfg.dynamicSmemBytes = PaSmem<MT>::BYTES;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, prompt_attn_mma_kernel<MT>, &cfg) == cudaSuccess ? n : 0;
}

template <int MT>
static cudaError_t run_mma(const __nv_bfloat16* q, const int8_t* k8, const float* ks,
                           const int8_t* v8, const float* vs, const int* mask, float* o, float* m,
                           float* l, int B0, int Hkv, int M, int Sp, int split,
                           cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        prompt_attn_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, PaSmem<MT>::BYTES);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, Hkv, B0);
  cfg.blockDim = dim3(PA_THREADS);
  cfg.dynamicSmemBytes = PaSmem<MT>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, prompt_attn_mma_kernel<MT>, q, k8, ks, v8, vs,
                                           mask, o, m, l, M, Sp);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace mimic_q

// dtype: 0 = float32 (the scalar chunk kernel and its merge; work: fp32
// [Sp / 128 * B0 * Hkv * M * 130]), 1 = bfloat16 (the tensor-core kernel; work is
// not used; split: CTAs per (batch row, kv head), 1-8, at most Sp / 128).
extern "C" int mimic_prompt_attn_int8(const void* q, const void* k8, const void* ks,
                                      const void* v8, const void* vs, const void* mask,
                                      void* work, void* o, void* m, void* l, int B0, int Hkv,
                                      int M, int Sp, int dtype, int split, void* stream) {
  using namespace mimic_q;
  if (Sp <= 0 || Sp % BKEY != 0 || M <= 0 || M > MMAX || B0 <= 0 || Hkv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* k = static_cast<const int8_t*>(k8);
  const int8_t* v = static_cast<const int8_t*>(v8);
  const float* ksc = static_cast<const float*>(ks);
  const float* vsc = static_cast<const float*>(vs);
  const int* mk = static_cast<const int*>(mask);
  float* op = static_cast<float*>(o);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  cudaError_t e;
  if (dtype == 0) {
    e = run_scalar(static_cast<const float*>(q), k, ksc, v, vsc, mk, static_cast<float*>(work), op,
                   mp, lp, B0, Hkv, M, Sp, st);
  } else if (dtype == 1) {
    if (split < 1 || split > PA_MAX_SPLIT || split > Sp / BKEY)
      return static_cast<int>(cudaErrorInvalidValue);
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
    e = M <= 16 ? run_mma<1>(qb, k, ksc, v, vsc, mk, op, mp, lp, B0, Hkv, M, Sp, split, st)
                : run_mma<2>(qb, k, ksc, v, vsc, mk, op, mp, lp, B0, Hkv, M, Sp, split, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// clusters of `split` CTAs (1-8) of the bf16 kernel for M query rows that fit on the
// card at once; 0 on an error (the wrapper's plan keeps a call within one wave)
extern "C" int mimic_prompt_attn_max_clusters(int split, int M) {
  using namespace mimic_q;
  if (split < 1 || split > PA_MAX_SPLIT || M < 1 || M > MMAX) return 0;
  return M <= 16 ? max_clusters<1>(split) : max_clusters<2>(split);
}
