// w8a8_matmul — int8 x int8 matmul at prefill M with a two-scale epilogue:
//   out[m][n] = (float(sum_k x8[m][k] * w8[k][n]) * s_x[m]) * s_w[n].
//
// Replaces the Pallas kernels mimic_tpu/ops/quant.py::_w8a8_kernel (pallas_call
// at quant.py:442, w8a8_matmul) and ::_w8a8_kernel_stacked (quant.py:494,
// w8a8_matmul_stacked).  A layer of a contiguous [L, K, N] stack is a pointer
// offset, applied by the wrapper (mimic_tpu_torch/ops/quant.py), so one kernel
// serves both sites.  The rows come from quantize_rows.cu.
//
// Contract: x8 [M, K] int8 row-major, xs [M] fp32, w8 [K, N] int8 row-major (N
// contiguous, as the JAX tree stores it), sw [N] fp32; out [M, N] fp32 or bf16.
// K and N are multiples of 16, x8 and w8 start 16-byte aligned; M is any
// positive number (rows and columns beyond the arrays arrive as zeros and are
// not stored; nothing is padded or copied).  The sum is exact in int32
// (127 * 127 * K < 2^31 for K < 133,152) and both scales multiply it once, in
// the order (acc * s_x) * s_w, so the result has no summation-order freedom: it
// equals the plain version bit for bit.
//
// What bounds it on the H100.  At the prefill shapes (M = 2048, K = 4096,
// N = 4096-28672) the product does 2*M*K*N = 69-481 G integer operations on
// 25-117 MB of weights and 8 MB of activations plus the output: 35-243 us at
// the tensor cores' 1,979 TOP/s against 15-77 us at 3.35 TB/s.  Operations
// bound it at every shape of the path, so the work belongs on the integer
// tensor cores at their full rate, which only wgmma reaches.
//
// Design (Hopper: wgmma .s8 + TMA + mbarrier, warp-specialised).
//  * The trap: wgmma takes 8-bit operands from shared memory only K-major (the
//    transpose bits exist for 16-bit types alone), and the weights are stored
//    with N contiguous.  So the roles are swapped: the CTA computes out^T =
//    W^T . x^T.  The activations x8 [M, K] are the K-major B operand (n = 256
//    activation rows), read by wgmma straight from the TMA-written 128-byte
//    swizzled tile; the weights are the REGISTER A operand (m = 64 weight
//    columns per warpgroup), which has no layout rule in shared memory at all.
//  * The A fragment from the raw [k][n] tile.  A warp's 16 A rows are 16 weight
//    columns, one 16-byte chunk of a 128-byte tile row.  Rows of A may be any
//    16 columns as long as the epilogue knows which: row g is column 2g and row
//    g + 8 column 2g + 1, so a lane holds a column pair.  One
//    ldmatrix.x4.trans reads the k32 step: the tile's bytes taken as b16 pairs
//    of columns, four 8 x 8 matrices whose 8 rows are k values picked so that
//    lane (g, t) receives (k, 2g), (k, 2g + 1), (k + 1, 2g), (k + 1, 2g + 1) for
//    the four k = 4t .. 4t + 3 it needs, in two of its registers, and the same
//    for k + 16 in the other two; two prmt per register give a0..a3.  Matrix
//    h (0, 1) of the low half holds rows k = 4(j >> 1) + (j & 1) +
//    2 (((j >> 2) & 1) ^ h), j = 0..7: the 8 rows of every matrix have distinct
//    k mod 8, so under the TMA's 128-byte swizzle (chunk ^ (k & 7)) each 8-lane
//    phase reads 8 different chunks: no bank conflicts, no copy of the weights.
//  * A CTA is two consumer warpgroups (128 weight columns: 64 each, m64n256k32,
//    128 int32 accumulators per thread) and one producer warp whose lane 0
//    issues two TMA boxes per 128-byte k tile (x8: 256 rows x 128 bytes; w8:
//    128 k x 128 columns) into a ring of STAGES slots of 48 KB, with full /
//    empty mbarriers as in attn_mma.cuh (waits trap after 60 s of
//    %globaltimer).  A warpgroup builds a k32 step's A fragment while the
//    step before it runs (two register sets, refilled after wait_group 1),
//    waits for the tile's last wgmma and frees the slot; the other warpgroup's
//    wgmmas keep the tensor cores busy meanwhile.  No wgmma sits under a branch.
//  * Grid: activation row tiles fastest, so the CTAs resident together share
//    their weight tiles through L2 and the weights are read from HBM once.
//  * Epilogue straight from the accumulators: a lane holds columns n, n + 1 of
//    rows m, m + 1 per n8 atom; the 8 lanes of a row cover 16 consecutive
//    columns (32 or 64 contiguous bytes, whole sectors).
//
// Shared memory 194 KB, one CTA of 288 threads (about 170 registers each) per SM;
// PERF.md has its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"  // mbarriers, TMA, the encoder look-up and the wgmma wrappers

namespace mimic_w8a8 {

namespace mma = mimic::mma;
namespace wg = mimic::wg;

constexpr int NWG = 2;                     // consumer warpgroups
constexpr int THREADS = 128 * NWG + 32;    // and one producer warp
// Registers: the card allocates a CTA's registers for whole warpgroups, so 288
// threads cost what 384 do and a thread gets at most 168 (65536 / 384, rounded
// down to 8).  128 accumulators leave 40: a tile's four A fragments (16
// registers) held at once did not fit (ptxas serialized every wgmma, C7512, at
// 168; at 170 registers the launch was refused), two (8 registers) do.
constexpr int BW = 64 * NWG;               // weight columns per CTA
constexpr int BX = 256;                    // activation rows per CTA (the wgmma's n)
constexpr int BK = 128;                    // contraction bytes per stage (four k32 steps)
constexpr int STAGES = 4;
constexpr int X_BYTES = BX * BK;           // 32 KB
constexpr int W_BYTES = BK * BW;           // 16 KB
constexpr int SLOT_BYTES = X_BYTES + W_BYTES;
constexpr int SMEM_BYTES = 1024 + STAGES * SLOT_BYTES + 2 * STAGES * 8;  // 1024: alignment slack
static_assert(SLOT_BYTES % 1024 == 0 && X_BYTES % 1024 == 0, "128-byte swizzle wants 1 KB alignment");

struct Maps {
  CUtensorMap x, w;
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void store2(float* out, size_t i, float v0, float v1) {
  *reinterpret_cast<float2*>(out + i) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* out, size_t i, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) =
      __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
}

// k of row j (0..7) of ldmatrix matrix `mat` (0..3) in a k32 step: matrices 0, 1
// hold k 0..15, matrices 2, 3 k 16..31; lane (g, t) receives rows 2t, 2t + 1
__host__ __device__ constexpr int frag_k(int mat, int j) {
  return 16 * (mat >> 1) + 4 * (j >> 1) + (j & 1) + 2 * (((j >> 2) & 1) ^ (mat & 1));
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    w8a8_wgmma_kernel(const float* __restrict__ xs, const float* __restrict__ sw,
                      OutT* __restrict__ out, int M, int N, int ntiles,
                      const __grid_constant__ Maps maps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * SLOT_BYTES;
  auto full_bar = [&](int slot) { return bars + slot * 8; };
  auto empty_bar = [&](int slot) { return bars + (STAGES + slot) * 8; };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BX, n0 = blockIdx.y * BW;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mma::mbar_init(full_bar(s), 1);
      mma::mbar_init(empty_bar(s), NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last one: from here the roles run on barriers only

  if (warp == NWG * 4) {
    // ---- the producer warp: lane 0 keeps the ring full ----
    if (lane == 0) {
      int slot = 0, phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        mma::mbar_wait(empty_bar(slot), phase ^ 1);  // passes at once on the first round
        const uint32_t sx = base + slot * SLOT_BYTES;
        mma::mbar_expect_tx(full_bar(slot), SLOT_BYTES);
        mma::tma_load_2d(sx, &maps.x, full_bar(slot), t * BK, m0);
        mma::tma_load_2d(sx + X_BYTES, &maps.w, full_bar(slot), n0, t * BK);
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  const int wgi = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int chunk = wgi * 4 + wq;  // this warp's 16 weight columns in the 128-byte tile row
  const int krow = frag_k(lane >> 3, lane & 7);
  const uint32_t a_off = krow * 128 + ((chunk ^ (krow & 7)) << 4);
  // lanes t < 2 find k = 4t, 4t + 1 in matrix 0 (2) and 4t + 2, 4t + 3 in matrix 1
  // (3); lanes t >= 2 the other way round
  const uint32_t sel_lo = t4 < 2 ? 0x6420u : 0x2064u;  // column 2g: bytes 0, 2 of each pair
  const uint32_t sel_hi = t4 < 2 ? 0x7531u : 0x3175u;  // column 2g + 1: bytes 1, 3

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  // the A fragment of k32 step s of the tile at sw_tile (see the top of the file)
  auto fragment = [&](uint32_t (&a)[4], uint32_t sw_tile, int s) {
    uint32_t r[4];
    ldsm_x4_trans(r, sw_tile + s * 32 * 128 + a_off);
    a[0] = __byte_perm(r[0], r[1], sel_lo);  // row g,     k 4t..4t+3
    a[1] = __byte_perm(r[0], r[1], sel_hi);  // row g + 8, k 4t..4t+3
    a[2] = __byte_perm(r[2], r[3], sel_lo);  // row g,     k 16 + 4t..
    a[3] = __byte_perm(r[2], r[3], sel_hi);  // row g + 8, k 16 + 4t..
  };
  auto product = [&](const uint32_t (&a)[4], uint32_t sx, int s) {
    wg::fence();
    wg::wgmma_rs_s8_n256(acc, a, wg::make_desc(sx + s * 32, 16, 1024, wg::SW_128), 1);
    wg::commit();
  };

  // per tile: steps 0 and 1 in flight, then each fragment register set is
  // refilled for step s + 2 once the wgmma that read it has completed
  int slot = 0, phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    mma::mbar_wait(full_bar(slot), phase);
    const uint32_t sx = base + slot * SLOT_BYTES, sw_tile = sx + X_BYTES;
    uint32_t a0[4], a1[4];
    fragment(a0, sw_tile, 0);
    fragment(a1, sw_tile, 1);
    product(a0, sx, 0);
    product(a1, sx, 1);
    wg::wait<1>();
    fragment(a0, sw_tile, 2);
    product(a0, sx, 2);
    wg::wait<1>();
    fragment(a1, sw_tile, 3);
    product(a1, sx, 3);
    wg::wait<0>();
    if (lane == 0) mma::mbar_arrive(empty_bar(slot));
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  }

  // acc[4 j + e]: A row 16 wq + g + 8 (e >> 1) = weight column n (+ 1), activation
  // row 8 j + 2 t + (e & 1)
  const int n = n0 + 64 * wgi + 16 * wq + 2 * g;
  if (n >= N) return;  // N is even, so n + 1 < N too
  const float s0 = sw[n], s1 = sw[n + 1];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t4 + e;
      if (m < M) {
        const float sx = xs[m];
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]), sx), s0);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 + e]), sx), s1);
        store2(out, static_cast<size_t>(m) * N + n, v0, v1);
      }
    }
  }
}

// an int8 [rows, cols] row-major array cut into boxes of 128 columns x box_rows rows,
// 128-byte swizzled; boxes beyond the array arrive as zeros
inline bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  mma::EncodeTiled encode = mma::encode_tiled();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
int launch(const int8_t* x8, const float* xs, const int8_t* w, const float* sw, void* out, int M,
           int K, int N, cudaStream_t st) {
  static_assert(BK == 128, "the box is one 128-byte swizzle row wide");
  Maps maps = {};
  if (!make_map(&maps.x, x8, M, K, BX) || !make_map(&maps.w, w, K, N, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BX - 1) / BX, (N + BW - 1) / BW);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_wgmma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  w8a8_wgmma_kernel<OutT><<<grid, THREADS, SMEM_BYTES, st>>>(
      xs, sw, static_cast<OutT*>(out), M, N, (K + BK - 1) / BK, maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mimic_w8a8

// out_dtype: 0 = float32, 1 = bfloat16.  x8 [M, K], xs [M], w [K, N], sw [N].
extern "C" int mimic_w8a8_matmul(const void* x8, const void* xs, const void* w, const void* sw,
                                 void* out, int M, int K, int N, int out_dtype, void* stream) {
  using namespace mimic_w8a8;
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x8) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
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
