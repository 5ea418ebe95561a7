// w8a8_matmul — int8 x int8 matmul at prefill M with a two-scale epilogue:
//   out[m][n] = (float(sum_k x8[m][k] * w8[k][n]) * s_x[m]) * s_w[n].
//
// Replaces the Pallas kernels mimic_tpu/ops/quant.py::_w8a8_kernel (pallas_call
// at quant.py:442, w8a8_matmul) and ::_w8a8_kernel_stacked (quant.py:494,
// w8a8_matmul_stacked).  A layer of a contiguous [L, K, N] stack is a pointer
// offset, applied by the wrapper (mimic_tpu_torch/ops/quant.py), so one kernel
// serves both sites.
//
// Contract: x8 [M, K] int8 row-major, xs [M] fp32, w8 [K, N] int8 row-major (N
// contiguous, as the JAX tree stores it), sw [N] fp32; out [M, N] fp32 or bf16.
// K and N are multiples of 16; M is any positive number (the ragged last row
// tile is masked here, nothing is padded).  The sum is exact in int32
// (127 * 127 * K < 2^31 for K < 133,152) and both scales multiply it once, in
// the order (acc * s_x) * s_w, so the result has no summation-order freedom: it
// equals the plain version bit for bit.
//
// What bounds it on the H100.  At the prefill shapes (M = 2048, K = 4096,
// N = 4096-28672) the product does 2*M*K*N = 69-481 G integer operations on
// 25-117 MB of weights and 8 MB of activations plus the output: 35-243 us at
// the tensor cores' 1,979 TOP/s against 15-77 us at 3.35 TB/s.  Operations
// bound it at every shape of the path, so the work belongs on the integer
// tensor cores.
//
// Design.  The TPU kernel's sequential K grid axis with a VMEM accumulator
// becomes a loop inside the block.  A CTA of 256 threads (8 warps as 2 x 4)
// owns a 128 x 256 output tile and walks K in tiles of 64; each warp owns
// 64 x 64 of it as 4 x 8 tiles of mma.sync.m16n8k32 (s8 x s8 -> s32), 128
// int32 accumulators per thread, fragments read with ldmatrix.  The s8 mma
// wants, for B, four consecutive k of one column n in one register, but the
// weights are stored with N contiguous and ldmatrix.trans moves 16-bit
// elements, not bytes.  So the weight tile is transposed on its way into
// shared memory: a thread loads a 4 (k) x 16 (n) byte block as four 16-byte
// words, transposes its four 4 x 4 sub-blocks in registers with six
// __byte_perm each, and stores sixteen words along k into Bs[n][k].  The
// 16-byte chunks of a Bs row are swizzled by the row index and each lane
// rotates the order of its stores, which makes both the transposed stores and
// the ldmatrix reads free of bank conflicts without padding (the activation
// tile pads its rows to 80 bytes instead).  Two stages of shared memory: while
// the tensor cores work on one, the next tile goes from registers into the
// other, slice by slice between the mma instructions (a warp issues the scalar
// work in the slots the tensor-core instructions leave free), and the tile
// after that starts its way from global memory into the registers.  Measured
// steps on the way here, on one H100 at M 2048 K 4096 N 28672: a 128 x 128
// tile with 4-byte weight loads and one stage, 1.55 ms; this tile with 4-byte
// loads, 1.40 ms; 16-byte loads, 1.23 ms; the stores interleaved, 1.10 ms; the
// mma loop alone, with nothing loaded, 0.63 ms.  No cp.async / TMA ring and no
// wgmma yet; PERF.md has its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mimic_w8a8 {

constexpr int NT = 256;             // threads per CTA: 8 warps as 2 (m) x 4 (n)
constexpr int BM = 128;             // output rows per CTA
constexpr int BN = 256;             // output columns per CTA
constexpr int WARPS_N = BN / 64;
constexpr int A_LOADS = BM * 4 / NT;
constexpr int BK = 64;              // contraction bytes per staged tile
constexpr int LDA = BK + 16;        // padded row of the activation tile, bytes
constexpr int WM = 64, WN = 64;     // warp tile
constexpr int MT = WM / 16;         // m16 tiles per warp
constexpr int NTL = WN / 8;         // n8 tiles per warp
constexpr int A_STAGE = BM * LDA;   // bytes of one activation stage
constexpr int B_STAGE = BN * BK;    // bytes of one weight stage (rows of 64 bytes, 16-byte chunks swizzled)
constexpr int SMEM_BYTES = 2 * (A_STAGE + B_STAGE);

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&d)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(addr));
}

// r[i] holds bytes (k = i, n = 0..3); on return r[j] holds (n = j, k = 0..3)
__device__ __forceinline__ void transpose4x4(uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // k0n0 k1n0 k0n1 k1n1
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);  // k2n0 k3n0 k2n1 k3n1
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // k0n2 k1n2 k0n3 k1n3
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);  // k2n2 k3n2 k2n3 k3n3
  r[0] = __byte_perm(t0, t1, 0x5410);
  r[1] = __byte_perm(t0, t1, 0x7632);
  r[2] = __byte_perm(t2, t3, 0x5410);
  r[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void swap_if(bool c, uint32_t& a, uint32_t& b) {
  const uint32_t x = c ? b : a, y = c ? a : b;
  a = x;
  b = y;
}

__device__ __forceinline__ void store2(float* out, size_t i, float v0, float v1) {
  *reinterpret_cast<float2*>(out + i) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* out, size_t i, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) =
      __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
}

template <typename OutT>
__global__ void __launch_bounds__(NT, 1)
    w8a8_matmul_kernel(const int8_t* __restrict__ x8, const float* __restrict__ xs,
                       const int8_t* __restrict__ w, const float* __restrict__ sw,
                       OutT* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const As = smem;                 // [2][BM][LDA]: As[m][k]
  uint8_t* const Bs = smem + 2 * A_STAGE;   // [2][BN][BK]: Bs[n][k], the weight tile transposed
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;

  int acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // weights: the tile is 16 k-groups (4 rows each) x 16 column groups of 16
  // bytes, one 4 (k) x 16 (n) block per thread, loaded as four 16-byte rows.
  // A warp covers 8 column groups (128 contiguous bytes of a weight row, one
  // whole line) x 4 k-groups.
  const int n16 = (warp & 1) * 8 + (lane & 7);  // column group of this thread, 0..15
  const int kg = (warp >> 1) * 4 + (lane >> 3); // k-group of this thread, 0..15
  const int jr = lane & 3;                       // rotation of the store order, see slice
  const bool sr = lane & 4;
  int4 areg[A_LOADS];
  uint32_t wreg[4][4];  // [k row][4-byte word s]; after the transposes [column j][block s]

  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < A_LOADS; ++e) {
      const int i = tid + NT * e, row = i >> 2, c = i & 3;
      const int m = m0 + row, k = k0 + c * 16;
      areg[e] = (m < M && k < K)
                    ? __ldg(reinterpret_cast<const int4*>(x8 + static_cast<size_t>(m) * K + k))
                    : make_int4(0, 0, 0, 0);
    }
    const int n = n0 + n16 * 16;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + kg * 4 + r;
      const int4 v = (k < K && n < N)
                         ? __ldg(reinterpret_cast<const int4*>(w + static_cast<size_t>(k) * N + n))
                         : make_int4(0, 0, 0, 0);
      wreg[r][0] = v.x, wreg[r][1] = v.y, wreg[r][2] = v.z, wreg[r][3] = v.w;
    }
  };

  // Registers -> shared memory, in eight slices that the mma loop below takes
  // one at a time, so that this scalar work fills the issue slots between the
  // tensor-core instructions.  Word s of the four loaded rows is a 4 (k) x 4
  // (n) byte block; transposed in place, wreg[j][s] holds column n16*16 + s*4 +
  // j.  Row n of Bs keeps its four 16-byte chunks at chunk ^ ((n >> 1) & 3).  A
  // thread stores its sixteen words in the order s = e ^ sr, j = p ^ jr: at each
  // step the 32 lanes of a warp hit 32 different banks (row parity x 4 chunk
  // positions x 4 k-groups), and the ldmatrix reads stay conflict-free.
  auto slice = [&](int q, int stage, int k_next) {
    uint8_t* const as = As + stage * A_STAGE;
    uint8_t* const bs = Bs + stage * B_STAGE;
    if (q == 0) {
#pragma unroll
      for (int e = 0; e < A_LOADS; ++e) {
        const int i = tid + NT * e;
        *reinterpret_cast<int4*>(as + (i >> 2) * LDA + (i & 3) * 16) = areg[e];
      }
    }
    if (q == 0 || q == 1) {
#pragma unroll
      for (int s = 2 * q; s < 2 * q + 2; ++s) {
        uint32_t blk[4] = {wreg[0][s], wreg[1][s], wreg[2][s], wreg[3][s]};
        transpose4x4(blk);
#pragma unroll
        for (int j = 0; j < 4; ++j) wreg[j][s] = blk[j];
      }
    }
    if (q == 2) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        swap_if(sr, wreg[j][0], wreg[j][1]);
        swap_if(sr, wreg[j][2], wreg[j][3]);
      }
    }
    if (q >= 3 && q <= 6) {
      const int e = q - 3;
      swap_if(jr & 1, wreg[0][e], wreg[1][e]);
      swap_if(jr & 1, wreg[2][e], wreg[3][e]);
      swap_if(jr & 2, wreg[0][e], wreg[2][e]);
      swap_if(jr & 2, wreg[1][e], wreg[3][e]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int row = n16 * 16 + (e ^ static_cast<int>(sr)) * 4 + (p ^ jr);
        const int word = kg ^ (((row >> 1) & 3) << 2);
        *reinterpret_cast<uint32_t*>(bs + row * BK + word * 4) = wreg[p][e];
      }
    }
    if (q == 7) fetch(k_next);  // the registers are free again
  };

  // mma on one stage; meanwhile the tile after it goes from the registers into
  // the other stage and the tile after that starts its way into the registers
  auto compute = [&](int stage, int k_next) {
    const uint32_t as_u = static_cast<uint32_t>(__cvta_generic_to_shared(As + stage * A_STAGE));
    const uint32_t bs_u = static_cast<uint32_t>(__cvta_generic_to_shared(Bs + stage * B_STAGE));
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {  // 32 contraction bytes each
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // matrices: (rows 0-7, k lo), (rows 8-15, k lo), (rows 0-7, k hi), (rows 8-15, k hi)
        const int row = wm + i * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int chunk = kb * 2 + (lane >> 4);
        ldmatrix_x4(a[i], as_u + row * LDA + chunk * 16);
      }
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        uint32_t b[2];
        const int row = wn + j * 8 + (lane & 7);
        const int chunk = (kb * 2 + ((lane >> 3) & 1)) ^ ((row >> 1) & 3);
        ldmatrix_x2(b, bs_u + row * BK + chunk * 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b);
        if (kb == 0) slice(j, stage ^ 1, k_next);
      }
    }
  };

  // Beyond the last tile fetch() loads nothing and gives zeros, and the slices
  // write them into the stage that nobody reads any more: the loop needs no
  // branch, so the compiler can interleave the two instruction streams.
  const int tiles = (K + BK - 1) / BK;
  fetch(0);
#pragma unroll
  for (int q = 0; q < 8; ++q) slice(q, 0, BK);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    compute(t & 1, (t + 2) * BK);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + gid + 8 * h;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const int n = n0 + wn + j * 8 + tig * 2;
        if (n >= N) continue;  // N is even, so n + 1 < N too
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), sx), sw[n]);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sx), sw[n + 1]);
        store2(out, static_cast<size_t>(m) * N + n, v0, v1);
      }
    }
  }
}

template <typename OutT>
int launch(const int8_t* x8, const float* xs, const int8_t* w, const float* sw, void* out,
           int M, int K, int N, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(w8a8_matmul_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  w8a8_matmul_kernel<OutT><<<grid, NT, SMEM_BYTES, st>>>(x8, xs, w, sw, static_cast<OutT*>(out),
                                                          M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mimic_w8a8

// out_dtype: 0 = float32, 1 = bfloat16.  x8 [M, K], xs [M], w [K, N], sw [N].
extern "C" int mimic_w8a8_matmul(const void* x8, const void* xs, const void* w, const void* sw,
                                 void* out, int M, int K, int N, int out_dtype, void* stream) {
  using namespace mimic_w8a8;
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x8);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* xsp = static_cast<const float*>(xs);
  const float* swp = static_cast<const float*>(sw);
  if (out_dtype == 0) return launch<float>(xp, xsp, wp, swp, out, M, K, N, st);
  if (out_dtype == 1) return launch<__nv_bfloat16>(xp, xsp, wp, swp, out, M, K, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
