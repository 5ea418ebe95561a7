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
//
// What bounds it on the H100.  A decode step reads 2 * Sp * 128 int8 bytes per
// (batch row, kv head) and does 2 * M multiply-adds per byte on the fp32 cores;
// at call B (B0 2, Hkv 8, Sp 4096) that is 16.8 MB per layer.
//
// Design.  One CTA per (batch row, kv head) gives 16-32 CTAs at the serving
// shapes, too few for 132 SMs, so the prompt is split into 128-key chunks
// (flash-decoding): one CTA per (chunk, kv head, batch row) computes the
// chunk's scores, its softmax (max and sum by warp shuffles) and its P.V in
// shared memory, and writes a partial (o, m, l); a second kernel merges the
// chunks' partials in chunk order into the one partial of the contract, so
// runs repeat bit for bit.  Keys sit in shared memory with a 132-byte row stride
// (33 words): the 32 lanes of a warp read 32 different keys' words in 32 banks.

#include "int8_common.cuh"

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

template <typename T>
static cudaError_t run(const void* q, const int8_t* k8, const float* ks, const int8_t* v8,
                       const float* vs, const int* mask, float* work, int B0, int Hkv, int M,
                       int Sp, cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(PromptSmem));
  cudaError_t e = cudaFuncSetAttribute(prompt_attn_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(Sp / BKEY, Hkv, B0);
  prompt_attn_kernel<T><<<grid, NT, bytes, stream>>>(static_cast<const T*>(q), k8, ks, v8, vs,
                                                      mask, work, M, Sp);
  return cudaGetLastError();
}

}  // namespace mimic_q

// dtype: 0 = float32, 1 = bfloat16.  work: fp32 [Sp / 128 * B0 * Hkv * M * 130].
extern "C" int mimic_prompt_attn_int8(const void* q, const void* k8, const void* ks,
                                      const void* v8, const void* vs, const void* mask,
                                      void* work, void* o, void* m, void* l, int B0, int Hkv,
                                      int M, int Sp, int dtype, void* stream) {
  using namespace mimic_q;
  if (Sp <= 0 || Sp % BKEY != 0 || M <= 0 || M > MMAX || B0 <= 0 || Hkv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* k = static_cast<const int8_t*>(k8);
  const int8_t* v = static_cast<const int8_t*>(v8);
  const float* ksc = static_cast<const float*>(ks);
  const float* vsc = static_cast<const float*>(vs);
  const int* mk = static_cast<const int*>(mask);
  float* ws = static_cast<float*>(work);
  cudaError_t e;
  if (dtype == 0) {
    e = run<float>(q, k, ksc, v, vsc, mk, ws, B0, Hkv, M, Sp, st);
  } else if (dtype == 1) {
    e = run<__nv_bfloat16>(q, k, ksc, v, vsc, mk, ws, B0, Hkv, M, Sp, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = B0 * Hkv * M;
  prompt_attn_merge<<<rows, HD, 0, st>>>(ws, static_cast<float*>(o), static_cast<float*>(m),
                                         static_cast<float*>(l), rows, Sp / BKEY);
  return static_cast<int>(cudaGetLastError());
}
