// The decode-M int8-weight product on the tensor cores, for bf16 activations
// (int8_matmul.cu, fused_mlp_int8.cu).  fp32 activations keep the scalar
// kernels of int8_common.cuh.
//
// What bounds it on the H100.  At decode M (1-16 rows) a product streams its
// int8 weights once and does 2 M operations per byte: 24-48 per byte at M 12-16,
// far below the tensor cores' ~295 per byte, so HBM's 3.35 TB/s bounds it.  The
// scalar kernel did not reach that: every byte went through an int-to-float
// conversion (16 per clock per SM) and M fp32 FMAs, one 8 KB tile was in flight
// per CTA, and the partial sums went through device memory and a second launch.
//
// Design.
//   - Roles swapped for mma.sync.m16n8k16 (bf16 x bf16 -> fp32): the weights are
//     the 16-row A operand (16 output columns n), the activations the n8 B
//     operand (8 rows m; MT = 1 or 2 operands for M up to 8 or 16).  Both k and n
//     may be permuted freely inside one mma as long as A and B agree, so a lane
//     takes its A fragment straight from the [K, N] byte layout: rows
//     k0 + 4 tig + r (r = 0..3) and 8 consecutive columns n0 + 8 gid + j.  mma
//     row gid is column 8 gid + 2i and row gid + 8 column 8 gid + 2i + 1 of
//     instance i (0..3); k index 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 is row
//     4 tig + 0, 1, 2, 3, so B's two registers are the four consecutive
//     activations x[m][k0 + 4 tig .. + 3]: one 8-byte load.  No transpose, no
//     repacked copy of the weights.
//   - int8 -> bf16 without a conversion instruction: the byte, its sign bit
//     flipped (x ^ 0x80 = x + 128), becomes the low mantissa byte of the fp32
//     2^23 (one prmt), and subtracting 2^23 + 128 leaves x exactly (one fp32
//     add); an integer of at most 8 significant bits is exact in bf16, so the
//     upper halves of two such floats are the packed bf16 pair (one prmt).
//     Every int8 x bf16 product and every partial sum is then what the fp32
//     accumulator holds in the scalar kernel; only the order of the sum differs.
//   - A CTA of 8 warps owns 128 weight columns and a range of K.  Its weight
//     tiles [64 k x 128 n] and activation tiles [16 m x 64 k] stream into a ring
//     of TC_STAGES stages of shared memory with 16-byte cp.async.cg (56 KB of
//     weights in flight per CTA, two CTAs per SM at <= 128 registers), rows
//     beyond the range zero-filled.  Warp w takes columns 64 (w & 1) + [0, 64)
//     and rows 16 (w >> 1) + [0, 16) of each tile.  16-byte chunks of a weight
//     row sit at chunk ^ 2 ((k >> 2) & 3) and activation rows are padded to 160
//     bytes, so the fragment loads (ld.shared.v2) and the cp.async stores are
//     free of bank conflicts.  The conversion costs about 2.75 instructions a
//     weight byte, so the SM needs many warps in flight: 16 per SM here.
//   - Split K without device memory: the CTAs that share a column tile form a
//     thread-block cluster along grid y (ksplit of 1, 2, 4 or 8, chosen by the
//     wrapper's plan so that the grid fills the SMs).  Each CTA adds its four
//     k quarters' sums in order in shared memory; then CTA r of the cluster
//     adds, for its 128 / ksplit columns, the sums of ranks 0..ksplit-1 in rank
//     order through distributed shared memory and runs the epilogue.  No
//     atomics, no second launch, the same bits on every run.
//   - The fused MLP's down product is a programmatic dependent launch: its CTAs
//     start streaming their first weight tiles while the gate/up product ends,
//     and wait for h only before reading it.
//   - Epilogues: out = sum * scale[n] (fp32 or bf16), or the SwiGLU of the fused
//     MLP, whose column tile holds 64 gate and the 64 matching up columns.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mimic_q {

constexpr int TC_THREADS = 256;                     // 8 warps: 2 (column halves) x 4 (k quarters)
constexpr int TC_BN = 128;                          // weight columns per CTA
constexpr int TC_KT = 64;                           // weight rows per stage
constexpr int TC_STAGES = 8;
constexpr int TC_MB = 16;                           // activation rows per CTA (two n8 operands)
constexpr int TC_XLD = TC_KT * 2 + 32;              // bytes of an activation row in a stage
constexpr int TC_W_STAGE = TC_KT * TC_BN;           // 8 KB
constexpr int TC_STAGE = TC_W_STAGE + TC_MB * TC_XLD;
constexpr int TC_SMEM = TC_STAGES * TC_STAGE;       // 84 KB
constexpr int TC_MAX_SPLIT = 8;                     // portable cluster size

// epilogues
constexpr int EPI_SCALE = 0;   // out[m][n] = sum * scale[n], fp32 or bf16
constexpr int EPI_SWIGLU = 1;  // h[m][f] = bf16(silu(g * sg) * (u * su))

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte j of u (an int8 with its sign bit flipped) as the exact fp32 value of the
// int8: 2^23 + u - (2^23 + 128).  The prmt puts u under the exponent of 2^23.
template <int J>
__device__ __forceinline__ float biased_byte_to_f32(uint32_t u) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | J)) - 8388736.0f;
}

// bf16 pair {lo, hi} of two exact small-integer floats: their upper halves
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// A fragment of instance I from the four weight rows r (two words: columns 0-3,
// 4-7 of the lane's eight, sign bits already flipped): a0 = (column 2I; rows 0,
// 1), a1 = (column 2I + 1; rows 0, 1), a2, a3 = the same on rows 2, 3.
template <int I>
__device__ __forceinline__ void a_fragment(const uint32_t (&w)[4][2], uint32_t (&a)[4]) {
  constexpr int S = I >> 1, B = (I & 1) * 2;
  a[0] = pack_bf16(biased_byte_to_f32<B>(w[0][S]), biased_byte_to_f32<B>(w[1][S]));
  a[1] = pack_bf16(biased_byte_to_f32<B + 1>(w[0][S]), biased_byte_to_f32<B + 1>(w[1][S]));
  a[2] = pack_bf16(biased_byte_to_f32<B>(w[2][S]), biased_byte_to_f32<B>(w[3][S]));
  a[3] = pack_bf16(biased_byte_to_f32<B + 1>(w[2][S]), biased_byte_to_f32<B + 1>(w[3][S]));
}

// Column of weight chunk c (16 bytes) of the CTA's tile: the tile's own 128
// columns, or for the fused MLP's gate|up weight 64 gate columns then the 64 up
// columns that pair with them.
template <int EPI>
__device__ __forceinline__ int tile_column(int tile, int c, int F) {
  if (EPI == EPI_SWIGLU) return c < 4 ? tile * 64 + 16 * c : F + tile * 64 + 16 * (c - 4);
  return tile * TC_BN + 16 * c;
}

// The product of the CTA (blockIdx.x: column tile; .y: K range and cluster rank;
// .z: block of 16 activation rows).  x [M, ldx] bf16 (ldx % 8 == 0, columns K..ldx
// zero), w [K, ldw] int8; see the top of the file for the rest.
template <int MT, int EPI>
__device__ __forceinline__ void int8_mma_body(const __nv_bfloat16* __restrict__ x, int ldx,
                                              const int8_t* __restrict__ w, int ldw,
                                              const float* __restrict__ scale, void* out,
                                              int M, int K, int N, int F, int kchunk,
                                              int out_dtype) {
  extern __shared__ __align__(16) uint8_t smem[];
  namespace cg = cooperative_groups;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nh = warp & 1, kq = warp >> 1;
  const int tile = blockIdx.x, ksplit = gridDim.y, m0 = blockIdx.z * TC_MB;
  const int k_begin = blockIdx.y * kchunk, k_end = min(K, k_begin + kchunk);
  const int ntiles = k_begin < k_end ? (k_end - k_begin + TC_KT - 1) / TC_KT : 0;
  const uint32_t smem0 = smem_u32(smem);

  // this thread's cp.async chunks: two of the weight tile, one of the
  // activations (threads 0-127)
  constexpr int W_LOADS = TC_W_STAGE / 16 / TC_THREADS;
  const int wcol = tile_column<EPI>(tile, tid & 7, F);
  const int xm = (tid >> 3) & 15, xk = (tid & 7) * 8;

  auto load_weights = [&](int t) {
    const uint32_t st = smem0 + (t % TC_STAGES) * TC_STAGE;
    const int k0 = k_begin + t * TC_KT;
#pragma unroll
    for (int e = 0; e < W_LOADS; ++e) {
      const int i = tid + TC_THREADS * e, row = i >> 3, c = i & 7, k = k0 + row;
      const bool ok = k < k_end && wcol < N;
      const int8_t* src = ok ? w + static_cast<size_t>(k) * ldw + wcol : w;
      cp_async16(st + row * TC_BN + ((c ^ (((row >> 2) & 3) << 1)) << 4), src, ok);
    }
  };
  auto load_x = [&](int t) {
    const uint32_t st = smem0 + (t % TC_STAGES) * TC_STAGE;
    const int k0 = k_begin + t * TC_KT;
    if (tid < TC_MB * 8) {
      const bool ok = m0 + xm < M && k0 + xk < k_end;
      const __nv_bfloat16* src = ok ? x + static_cast<size_t>(m0 + xm) * ldx + k0 + xk : x;
      cp_async16(st + TC_W_STAGE + xm * TC_XLD + xk * 2, src, ok);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][i][e] = 0.f;

  // The first stages' weights do not depend on an earlier kernel, the
  // activations may (the fused MLP's h): under programmatic dependent launch
  // this kernel starts while the one before it finishes, streams its first
  // weight tiles, and waits for that kernel's results only before reading x
  // (griddepcontrol.wait returns at once without such a dependency).  Group s
  // holds x of stage s; group 0 also all the weights issued here.
  // Each CTA lets the kernel after it launch as soon as it has started.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s)
    if (s < ntiles) load_weights(s);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < ntiles) load_x(s);
    cp_async_commit();
  }
  // the lane's fragment addresses inside a stage (see the top of the file)
  const int wchunk = ((nh * 4 + (gid >> 1)) ^ (tig << 1)) * 16 + (gid & 1) * 8;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + TC_STAGES - 1 < ntiles) {
      load_weights(t + TC_STAGES - 1);
      load_x(t + TC_STAGES - 1);
    }
    cp_async_commit();
    const uint32_t st = smem0 + (t % TC_STAGES) * TC_STAGE;
    {
      const int kb = kq * 16 + 4 * tig;  // this lane's first row
      uint32_t wr[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint2 v = lds64(st + (kb + r) * TC_BN + wchunk);
        wr[r][0] = v.x ^ 0x80808080u;
        wr[r][1] = v.y ^ 0x80808080u;
      }
      uint2 xb[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        xb[mt] = lds64(st + TC_W_STAGE + (mt * 8 + gid) * TC_XLD + kb * 2);
      uint32_t a[4];
      a_fragment<0>(wr, a);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][0], a, xb[mt].x, xb[mt].y);
      a_fragment<1>(wr, a);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][1], a, xb[mt].x, xb[mt].y);
      a_fragment<2>(wr, a);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][2], a, xb[mt].x, xb[mt].y);
      a_fragment<3>(wr, a);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][3], a, xb[mt].x, xb[mt].y);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes red[4][TC_MB][TC_BN]

  // each k quarter's sums in its own slice of red.  c0, c1 / c2, c3 of
  // instance i: column 8 gid + 2i / + 1 of the warp's half, rows 2 tig and
  // 2 tig + 1 of operand mt.
  float* red = reinterpret_cast<float*>(smem);
  constexpr int ROWS = MT * 8, SLICE = TC_MB * TC_BN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = nh * 64 + 8 * gid + 2 * i, m = mt * 8 + 2 * tig;
      float* r = red + kq * SLICE + m * TC_BN + n;
      *reinterpret_cast<float2*>(r) = make_float2(acc[mt][i][0], acc[mt][i][2]);
      *reinterpret_cast<float2*>(r + TC_BN) = make_float2(acc[mt][i][1], acc[mt][i][3]);
    }
  __syncthreads();
  // the CTA's sum, its k quarters in order, into slice 0
  for (int i = tid; i < ROWS * TC_BN; i += TC_THREADS)
    red[i] = ((red[i] + red[SLICE + i]) + red[2 * SLICE + i]) + red[3 * SLICE + i];

  // rank r of the cluster: its slice of the columns, the ranks' sums in rank
  // order (all loaded first: one round trip through the cluster, not ksplit)
  cg::cluster_group cluster = cg::this_cluster();
  if (ksplit > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  const int rank = blockIdx.y;
  const float* part[TC_MAX_SPLIT];
#pragma unroll
  for (int q = 0; q < TC_MAX_SPLIT; ++q)
    part[q] = ksplit == 1 ? red : cluster.map_shared_rank(red, q < ksplit ? q : 0);
  auto total = [&](int m, int n) {
    float v[TC_MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < TC_MAX_SPLIT; ++q) v[q] = q < ksplit ? part[q][m * TC_BN + n] : 0.f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < TC_MAX_SPLIT; ++q)
      if (q < ksplit) s += v[q];
    return s;
  };
  if (EPI == EPI_SWIGLU) {
    // h[m][f] for f of this tile's 64 gate columns; up is column 64 + f
    const int per = 64 / ksplit;
    __nv_bfloat16* h = static_cast<__nv_bfloat16*>(out);
    for (int i = tid; i < ROWS * per; i += TC_THREADS) {
      const int m = i / per, f = rank * per + i % per, fg = tile * 64 + f;
      if (m0 + m >= M) continue;
      const float g = total(m, f) * scale[fg];
      const float u = total(m, 64 + f) * scale[F + fg];
      h[static_cast<size_t>(m0 + m) * F + fg] = __float2bfloat16(g / (1.f + expf(-g)) * u);
    }
  } else {
    const int per = TC_BN / ksplit;
    for (int i = tid; i < ROWS * per; i += TC_THREADS) {
      const int m = i / per, c = rank * per + i % per, n = tile * TC_BN + c;
      if (m0 + m >= M || n >= N) continue;
      const float v = total(m, c) * scale[n];
      const size_t o = static_cast<size_t>(m0 + m) * N + n;
      if (out_dtype == 0) {
        static_cast<float*>(out)[o] = v;
      } else {
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
      }
    }
  }
  if (ksplit > 1) cluster.sync();  // keep red alive until every rank has read it
}

// Launch KERNEL (a __global__ wrapper of int8_mma_body) on grid (tiles, ksplit,
// row blocks) with clusters of (1, ksplit, 1); ``dependent``: as a programmatic
// dependent launch, overlapping the end of the kernel before it on the stream.
template <auto Kernel, typename... Args>
static cudaError_t launch_mma(int tiles, int ksplit, int M, bool dependent, cudaStream_t stream,
                              Args... args) {
  if (ksplit < 1 || ksplit > TC_MAX_SPLIT || (ksplit & (ksplit - 1)) != 0)
    return cudaErrorInvalidValue;
  static bool sized = false;  // one flag per kernel
  cudaError_t e;
  if (!sized) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, ksplit, (M + TC_MB - 1) / TC_MB);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = TC_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ksplit;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the K range of one rank: whole 64-row tiles, the last rank takes the rest
static inline int mma_kchunk(int K, int ksplit) {
  const int ktiles = (K + TC_KT - 1) / TC_KT;
  return (ktiles + ksplit - 1) / ksplit * TC_KT;
}

}  // namespace mimic_q
