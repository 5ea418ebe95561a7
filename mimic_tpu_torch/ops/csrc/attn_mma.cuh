// The tensor-core core of the two bf16 attention forward kernels (flash_fwd.cu,
// onepass_fwd.cu).  Contract: attn_common.cuh.  fp32 inputs keep the scalar
// kernels of those files; only __nv_bfloat16 comes here.
//
// What bounds the forward on the H100.  At the main path's shapes the work is
// operations, not bytes (ViT rows B1 H16 T=S=4992 D72: 85 G operations on 46 MB;
// prefill B1 H32/8 T=S=4096 D128 with lse_u: 198 G on 85 MB), so both products
// belong on the tensor cores at their full rate (wgmma), and whatever else a
// key tile costs -- loads, barriers, the softmax's exponentials -- has to run
// beside them and not between them.
//
// What bounds D72 (SigLIP's and MoonViT's towers: the ViT row above, and the cells'
// calls of 18 and 32 such images).  A score costs 2 (80 + 72) operations of
// products (Q.K^T padded to 80 by the k16 step): 121 G for a 4992^2 x 16-head
// call, ~0.12 ms at 989 TFLOP/s.  Its exponential costs the special-function unit
// about as much (399 M ex2 at 16 a clock an SM, ~0.10 ms), and the fp32 scaling,
// max and sums ~0.06 ms more; each warpgroup runs them one after another, and
// only the other warpgroups' drift overlaps them.  Forms that overlap them within
// the CTA (one CTA an SM, setmaxnreg, warpgroups taking turns on named barriers,
// the next tile's Q.K^T or the last tile's P.V in flight under the softmax, 64- or
// 128-key tiles) measured no faster than this one at any tower call and slower at
// most, the B1 ViT row by a quarter (scripts/attn_fwd_tiling_sweep.py, PERF.md);
// with two score tiles live they spilled even at 240 registers.  What D72 does
// save is the keys no row attends: a landscape image's padded tail patches (up to
// ~1700 of 4992 keys at the cells' image sizes) end its sweep early, below.
//
// Design (Hopper: wgmma + TMA + mbarrier, warp-specialised).
//  * Two forms of CTA (CfgT).  At D72 and D128 a CTA is two consumer warpgroups
//    (128 query rows) and one producer warp.  At D64 and D80, the CLIP towers'
//    short rows (384 and 640 keys), it is one warpgroup of 64 rows whose thread 0
//    issues the loads, so that four (D80) or five (D64) CTAs share an SM: each
//    CTA's prologue (barrier init, Q's load from device memory), per-tile chain
//    (Q.K^T, wait, softmax, P.V, wait) and epilogue then run beside the other
//    CTAs' products instead of leaving the SM idle (measured on the H100: the
//    two-warpgroup form at one CTA per SM took 0.32 ms at idefics-9b's D80 rows,
//    this one 0.18; PERF.md).  Each warpgroup walks the key axis in tiles of
//    BN keys (64 at D64, D72 and D80; 128 at D128, where the longer tile took 6-10 %
//    off by halving the per-tile costs); all warpgroups of a CTA share the K/V tiles.
//  * Products.  S = Q.K^T is wgmma m64nBNk16 with both operands read from shared
//    memory; the fp32 accumulator fragment (per warp, the C layout of
//    mma.m16n8k16 tiled along N) is turned into probabilities in registers, and
//    those registers ARE the A operand of O += P.V (wgmma with a register A
//    operand: two n8 score atoms make one k16 step), so P never touches shared
//    memory.  V is the transposed (MN-major) B operand: its rows stay as they
//    lie in device memory, d contiguous.
//  * Shared-memory layout.  Q, K and V stay bf16.  A row is cut into 64-column
//    blocks stored [row][128 B] with the 128-byte swizzle (TMA writes it, wgmma
//    reads it, no bank conflicts, no padding).  D = 128 is two blocks, D = 64 (the
//    CLIP ViT-L tower of llava-1.5) one block with no tail.  D = 72
//    (SigLIP) and D = 80 (CLIP ViT-H) are one block and a tail of 8 or 16
//    columns: for Q.K^T the tail of Q and K is a [row][32 B] tile with the
//    32-byte swizzle holding columns 64..79, which one more k16 step consumes --
//    at D = 72 TMA fills columns 72..79 with zeros because they lie outside the
//    tensor, at D = 80 all 16 are real; for P.V the tail of V is one [row][16 B]
//    tile (no swizzle) per 8 columns, each consumed by an n8 wgmma beside the
//    n64 one (one at D = 72, two at D = 80: the 16-column tail of the output is
//    two n8 atoms, each read through the descriptor convention checked at
//    D = 72; at D = 80 nothing is zero-filled).  The descriptor
//    conventions (which offset is which, per layout) are written down in
//    attn_wgmma_ops.cuh; each was checked on the card against a host product.
//  * Loads.  The producer warp's lane 0 issues one TMA box per tile and block
//    (cp.async.bulk.tensor.4d over the [B, rows, heads, D] array: batch and head
//    are coordinates, rows beyond T or S arrive as zeros) into a ring of STAGES
//    slots (3 at D72, 2 of the longer tiles at D128).  full[slot] / empty[slot] mbarriers carry the hand-over: the
//    producer waits for empty, arms full with the slot's byte count and issues;
//    a consumer warp waits for full, and arrives on empty after the last wgmma
//    that reads the slot has been waited for.  There is no __syncthreads in the
//    loop, so the warpgroups drift apart and one's softmax runs under the
//    other's products.  The first form of this kernel loaded with 16-byte
//    cp.async from the computing warps: they stalled on the load pipe and the
//    loads' time added to the products' instead of hiding under it.  The
//    one-warpgroup form has no empty barriers: after a tile, a __syncthreads
//    (the warpgroup is the CTA) and thread 0 refills the slot with the tile
//    STAGES ahead (2 slots: a third cost a CTA per SM and measured slower).
//    Its products and softmax do not overlap within the warpgroup; the other
//    CTAs on the SM fill those gaps.  Issuing the refill under the tile's Q.K^T
//    or from all four warps, or loading the first tiles before the key mask is
//    read, measured no faster (PERF.md).
//  * One sweep, online softmax in registers and in the log2 domain: the fp32
//    accumulator is multiplied by scale * log2(e) (q is never pre-scaled: a bf16
//    operand cannot carry 1/sqrt(D)), p = ex2(x - m), row max by two quad
//    shuffles, row sums kept per thread and reduced over the quad once at the
//    end; lse = (m + log2 l) * ln 2.  p is rounded to bf16 for P.V while its
//    row sum is taken in fp32, as the plain version does.
//  * lse_u costs no second exponential on attendable pairs: their p, already
//    computed against the masked max m, is rescaled per row by ex2(m - mu);
//    only masked pairs take an exponential of their own.
//  * Masks come as two 32-bit ballots per tile (each lane reads two key_mask
//    words, one tile ahead).  A tile with every key attendable and no causal
//    boundary inside the warp's 16 rows takes a path with no per-element tests;
//    otherwise the attendable columns of a row are one AND of the ballot with a
//    causal prefix mask, tested bit by bit.
//  * Which tiles cost what.  A tile that is wholly masked or wholly above the
//    warpgroup's causal diagonal contributes p = 0 to every row that already has
//    a real running max, so its P.V (and, without lse_u, its Q.K^T) is dropped
//    for the warpgroup -- unless one of its rows still sits at NEG (a row with
//    no attendable key so far), where p = exp(NEG - NEG) = 1 on masked keys:
//    then the warpgroup does the whole tile, which keeps such rows the mean of
//    v over all S keys, equal to the plain version.  With lse_u the raw scores
//    of every key < S are folded into (mu, lu) whatever is dropped.
//    skip_tiles (flash_fwd without need_unmasked) additionally ends the sweep
//    at the CTA's causal diagonal and passes over wholly masked tiles without
//    looking at their rows (a row with no attendable key then gets the mean
//    over the visited tiles: the documented difference of flash_fwd).
//    In the one-warpgroup form and at D72 (ENDS_AT_LAST_KEY), without lse_u, the
//    CTA also reads its batch's key mask once: tiles past the last attendable key
//    are dead for every row, and where each row would drop them anyway
//    (skip_tiles, or every row of the CTA has an attendable key: the batch has one
//    and, causal, its first lies at or before the CTA's first row) the sweep ends
//    there and they are never loaded (the ViT's padded keys: idefics-9b's 257 of
//    384 end it after 5 of 6 tiles).  At D72 the consumer warps read the mask
//    together while Q and the first tile load, and hand the end to the producer
//    warp through an mbarrier.
//  * Causal CTAs are scheduled heaviest first (blockIdx.x reversed).
//  * Latent attention (Kimi-VL's MLA): q and k heads 192 wide, v heads 128, the
//    same body with the widths apart (CfgQV): Q.K^T runs three 64-column blocks
//    (twelve k16 steps), P.V and the output two, and V is never padded to 192.
//    Its tiling is D128's (two warpgroups, 128-key tiles, two slots: 209 KB,
//    one CTA per SM, the same registers: the score tile and the 128-wide output
//    are the same size).  Its kernel has a name of its own,
//    mla_attn_fwd_mma_kernel, so that a trace tells its time apart.
//
// Registers per consumer thread: 4 * D/8 output accumulators (64 at D128, 40 at
// D80, 36 at D72, 32 at D64) and BN / 2 for the score tile, which become the BN / 4
// of P.  D72 runs two CTAs of 288 threads per SM (96 registers, 80 KB of shared
// memory each); D128 one (168 registers, 162 KB).  D80 runs four CTAs of 128
// threads (capped at 128 registers: 112 without lse_u, 127 with, no spills; 53 KB
// each) and D64 five (96 registers, no spills; 42 KB).  At
// 96 registers D80's wgmmas are serialized by ptxas (C7512, seen when the
// two-warpgroup form was capped for two CTAs; chip_smoke.py fails the build on
// that line), so five CTAs are not an option there.  The warpgroup's vote over
// its rows uses the CTA's own barrier in this form: with the named barrier of
// warpgroup_all ptxas reserved 16 barriers a CTA, which held D64 to four CTAs
// per SM.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is looked up at run time

#include "attn_common.cuh"
#include "attn_wgmma_ops.cuh"

namespace mimic {
namespace mma {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float HALF_NEG = 0.5f * NEG;  // a running max below this has seen no real score

// The tiling of one instantiation: query / key heads DQK_ wide and value heads DV_,
// NWG_ consumer warpgroups per CTA, STAGES_ slots in the K/V ring, MINB_ CTAs per SM
// that the registers are capped for.  NWG_ = 1 is the short-row form (SHORT): the
// warpgroup is the whole CTA and its thread 0 issues the loads; with NWG_ = 2 a
// producer warp does.
template <int DQK_, int DV_, int NWG_, int STAGES_, int MINB_>
struct CfgQV {
  static constexpr int DQK = DQK_, DV = DV_;
  static_assert((DQK == DV && (DQK == 64 || DQK == 72 || DQK == 80 || DQK == 128)) ||
                    (DQK == 192 && DV == 128),
                "one to three 64-column blocks, a tail of 8 (D72) or 16 (D80) columns, "
                "and q / k wider than v only at 192 / 128");
  static_assert(NWG_ == 1 || NWG_ == 2, "one or two consumer warpgroups");
  static constexpr int NWG = NWG_;  // warpgroups per CTA, 64 query rows each
  static constexpr bool SHORT = NWG == 1;
  // the producer-warp form ends its sweep at the batch's last attendable key (the
  // one-warpgroup form always does): at D72, the vision towers' padded patches
  static constexpr bool ENDS_AT_LAST_KEY = !SHORT && DQK == 72;
  static constexpr int BM = 64 * NWG;
  static constexpr int BN = DQK <= 80 ? 64 : 128;  // keys per tile
  static_assert(BN == 64 || BN == 128, "the score tile is one wgmma of n = BN");
  static constexpr int NW = BN / 32;  // 32-bit words of a tile's key mask
  static constexpr int THREADS = 128 * NWG + (SHORT ? 0 : 32);
  static constexpr int NBLK = DQK / 64;       // 64-column blocks of a q / k row (128-byte swizzle)
  static constexpr int VBLK = DV / 64;        // and of a v row
  static constexpr bool TAIL = DQK % 64 != 0; // D = 72: columns 64..71; D = 80: 64..79
  static constexpr int VT = (DV % 64) / 8;    // 8-column tail tiles of V (1 at D72, 2 at D80)
  static constexpr int NATOMS = DV / 8;       // n8 atoms of the output
  static constexpr int STAGES = STAGES_;      // slots of the K/V ring
  static constexpr int MINB = MINB_;
  // shared tiles, each 1024-byte aligned: 64-column blocks [rows][128 B]; the tail
  // of Q and K as [rows][32 B] (columns 64..79; at D72 72..79 are zero), of V as
  // VT tiles [rows][16 B]
  static constexpr int Q_MAIN = NBLK * BM * 128;
  static constexpr int Q_BYTES = Q_MAIN + (TAIL ? BM * 32 : 0);
  static constexpr int K_MAIN = NBLK * BN * 128;
  static constexpr int K_BYTES = K_MAIN + (TAIL ? BN * 32 : 0);
  static constexpr int V_MAIN = VBLK * BN * 128;
  static constexpr int V_BYTES = V_MAIN + VT * BN * 16;
  static constexpr int SLOT_BYTES = K_BYTES + V_BYTES;
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0 && SLOT_BYTES % 1024 == 0, "alignment");
  // full[slot], empty[slot], Q's barrier; with ENDS_AT_LAST_KEY the sweep's-end
  // barrier and three words: the sweep's end and the batch's first and last keys
  static constexpr int BAR_BYTES = (2 * STAGES + 1) * 8 + (ENDS_AT_LAST_KEY ? 8 + 16 : 0);
  static constexpr int BYTES = 1024 + Q_BYTES + STAGES * SLOT_BYTES + BAR_BYTES;  // 1024: alignment slack
};

// one head width for q, k and v (every tower but latent attention's)
template <int D, int NWG_, int STAGES_, int MINB_>
struct CfgT : CfgQV<D, D, NWG_, STAGES_, MINB_> {};

// D72 and D128: two warpgroups and a producer warp, three and two slots, two and one
// CTAs per SM.  D64 and D80 (the CLIP towers' short rows): one warpgroup per CTA,
// two slots, five and four CTAs per SM (96 and 128 registers a thread)
template <int D>
using Cfg = CfgT<D, (D == 64 || D == 80) ? 1 : 2, D == 72 ? 3 : 2,
                 D == 64 ? 5 : D == 80 ? 4 : D == 72 ? 2 : 1>;
// latent attention: D128's tiling with 192-wide q / k rows (209 KB of shared memory)
using CfgMla = CfgQV<192, 128, 2, 2, 1>;

// the TMA descriptors of one launch: the 64-column blocks of q, k, v and, at D = 72
// and 80, their tails (v_tail is one 8-column tile, loaded once per tail tile)
struct TensorMaps {
  CUtensorMap q, k, v, q_tail, k_tail, v_tail;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival, and the barrier's phase also waits for `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_timer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;\n" : "=l"(t));
  return t;
}

// spin until the barrier's phase of the given parity has completed.  A barrier that
// has not completed after MBAR_TIMEOUT_NS of wall time (a fault in the pipeline:
// a whole launch takes milliseconds) traps instead of hanging the card; the clock
// is read once in 4096 polls, so the limit is a time and not a count of polls
constexpr uint64_t MBAR_TIMEOUT_NS = 60ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    int done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 4095u) == 0) {
      const uint64_t now = global_timer_ns();
      if (t0 == 0) t0 = now;
      if (now - t0 > MBAR_TIMEOUT_NS) __trap();
    }
  }
}

// one box of a [B, rows, heads, D] array -> shared memory, completing on a barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// one box of a 2-D array -> shared memory, completing on a barrier (w8a8_matmul.cu)
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// 2^x on the special-function unit; ex2(-inf) = 0, no NaN for finite or -inf x
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bits 0..n set (none for n < 0, all for n >= 31)
__device__ __forceinline__ uint32_t bits_up_to(int n) {
  return n < 0 ? 0u : (n >= 31 ? 0xffffffffu : (2u << n) - 1u);
}

// AND of a predicate over the 128 threads of a warpgroup (named barrier 1 + wg)
__device__ __forceinline__ bool warpgroup_all(int wg, bool pred) {
  int out;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 q, %2, 0;\nbar.red.and.pred p, %1, 128, q;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(out)
      : "r"(wg + 1), "r"(static_cast<int>(pred))
      : "memory");
  return out != 0;
}

// keep the compiler from moving reads or writes of a wgmma accumulator across this point
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// one k16 step of S = Q.K^T for a tile of BN keys
template <int BN>
__device__ __forceinline__ void score_step(float (&s)[BN / 2], uint64_t desc_q, uint64_t desc_k,
                                           int accumulate) {
  if constexpr (BN == 64) {
    wg::wgmma_ss_n64(s, desc_q, desc_k, accumulate);
  } else {
    wg::wgmma_ss_n128(s, desc_q, desc_k, accumulate);
  }
}

// the body of both kernels below.  UNM: also carry the unmasked (max, sum) pair for
// lse_u; C: the tiling and head widths
template <bool UNM, class C>
__device__ __forceinline__ void attn_fwd_body(const AttnArgs& a, int skip_tiles,
                                              const TensorMaps& maps) {
  constexpr int BM = C::BM, BN = C::BN, NW = C::NW;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled tiles want 1024-byte alignment
  const uint32_t sQ = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::Q_BYTES;
  const uint32_t bars = sKV + C::STAGES * C::SLOT_BYTES;
  // barriers: full[slot] (the slot's K and V have landed), empty[slot] (every consumer
  // warp is done with them), and one for Q
  auto full_bar = [&](int slot) { return bars + slot * 8; };
  auto empty_bar = [&](int slot) { return bars + (C::STAGES + slot) * 8; };
  const uint32_t q_bar = bars + 2 * C::STAGES * 8;
  // with ENDS_AT_LAST_KEY (and no lse_u) the producer learns the sweep's end: a
  // barrier after Q's, then three words, the end and the batch's first and last keys
  constexpr bool ENDS = C::ENDS_AT_LAST_KEY && !UNM;
  auto end_bar = [&]() { return q_bar + 8; };
  auto words = [&]() {
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
    return reinterpret_cast<int*>(smem_raw + (q_bar + 16 - base));
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wgi = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const uint32_t full = 0xffffffffu;

  int ntiles = (a.S + BN - 1) / BN;
  if (skip_tiles && a.causal) ntiles = min(ntiles, (q0 + BM - 1) / BN + 1);

  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), C::NWG * 4);
    }
    mbar_init(q_bar, 1);
    if constexpr (ENDS) {
      mbar_init(end_bar(), 1);
      words()[1] = 0x7fffffff;
      words()[2] = -1;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // with a producer warp the last one: from here its roles run on barriers only

  // TMA: the CTA's rows of Q, and key tile `it` into ring slot `slot`
  auto load_q = [&]() {
    mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
    for (int blk = 0; blk < C::NBLK; ++blk)
      tma_load(sQ + blk * BM * 128, &maps.q, q_bar, blk * 64, h, q0, b);
    if (C::TAIL) tma_load(sQ + C::Q_MAIN, &maps.q_tail, q_bar, C::NBLK * 64, h, q0, b);
  };
  auto load_kv = [&](int it, int slot) {
    const uint32_t bar = full_bar(slot), sK = sKV + slot * C::SLOT_BYTES, sV = sK + C::K_BYTES;
    mbar_expect_tx(bar, C::SLOT_BYTES);
#pragma unroll
    for (int blk = 0; blk < C::NBLK; ++blk)
      tma_load(sK + blk * BN * 128, &maps.k, bar, blk * 64, hk, it * BN, b);
#pragma unroll
    for (int blk = 0; blk < C::VBLK; ++blk)
      tma_load(sV + blk * BN * 128, &maps.v, bar, blk * 64, hk, it * BN, b);
    if (C::TAIL) {
      tma_load(sK + C::K_MAIN, &maps.k_tail, bar, C::NBLK * 64, hk, it * BN, b);
#pragma unroll
      for (int vt = 0; vt < C::VT; ++vt)
        tma_load(sV + C::V_MAIN + vt * BN * 16, &maps.v_tail, bar, C::NBLK * 64 + 8 * vt, hk,
                 it * BN, b);
    }
  };
  const int32_t* km = a.key_mask + static_cast<size_t>(b) * a.S;

  if constexpr (C::SHORT) {
    // ---- one warpgroup, its thread 0 the producer: Q, then the first STAGES tiles ----
    if (tid == 0) load_q();
    // Keys past the batch's last attendable one are dead for every row.  A row
    // that already has a real max drops such a tile unseen, and so does
    // skip_tiles: then (without lse_u) the sweep ends at the last attendable key,
    // and those tiles are never loaded.  Every row has a real max there unless it
    // has no attendable key at all (none in the batch; causal rows before the first).
    if constexpr (!UNM) {
      int lo = 0x7fffffff, hi = -1;
      for (int s = lane; s < a.S; s += 32)
        if (km[s] != 0) {
          lo = min(lo, s);
          hi = s;
        }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (skip_tiles || (hi >= 0 && (!a.causal || lo <= q0)))
        ntiles = min(ntiles, hi < 0 ? 0 : hi / BN + 1);
    }
    if (tid == 0)
      for (int it = 0; it < min(C::STAGES, ntiles); ++it) load_kv(it, it);
  } else if (warp == C::NWG * 4) {
    // ---- the producer warp: one lane keeps the ring of K/V tiles full through TMA ----
    if (lane == 0) {
      load_q();
      if constexpr (ENDS) {
        // the first tile goes out before the sweep's end is known: every sweep has one
        load_kv(0, 0);
        mbar_wait(end_bar(), 0);
        ntiles = *reinterpret_cast<volatile int*>(words());
      }
      int slot = ENDS ? 1 : 0, phase = 0;
      for (int it = ENDS ? 1 : 0; it < ntiles; ++it) {
        mbar_wait(empty_bar(slot), phase ^ 1);  // passes at once on the first round
        load_kv(it, slot);
        if (++slot == C::STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  if constexpr (ENDS) {
    // As in the one-warpgroup form: without lse_u, where every row would drop the
    // tiles past the batch's last attendable key, the sweep ends there.  The
    // consumer warps read the mask together (named barrier 3: 1 and 2 are
    // warpgroup_all's) and hand the end to the producer warp.
    int lo = 0x7fffffff, hi = -1;
#pragma unroll 4
    for (int s = tid; s < a.S; s += C::NWG * 128)
      if (km[s] != 0) {
        lo = min(lo, s);
        hi = s;
      }
    lo = __reduce_min_sync(full, lo);
    hi = __reduce_max_sync(full, hi);
    int* const w = words();
    if (lane == 0) {
      atomicMin(w + 1, lo);
      atomicMax(w + 2, hi);
    }
    asm volatile("bar.sync 3, %0;\n" ::"n"(C::NWG * 128) : "memory");
    lo = *reinterpret_cast<volatile int*>(w + 1);
    hi = *reinterpret_cast<volatile int*>(w + 2);
    // at least the tile already on its way: with no attendable key at all it is
    // dead under skip_tiles, and passed over
    if (skip_tiles || (hi >= 0 && (!a.causal || lo <= q0)))
      ntiles = min(ntiles, max(hi, 0) / BN + 1);
    if (tid == 0) {
      *reinterpret_cast<volatile int*>(w) = ntiles;
      mbar_arrive(end_bar());
    }
  }
  auto mask_at = [&](int s) -> bool { return s < a.S && km[s] != 0; };
  bool mk[NW];  // this lane's keys of the next tile
#pragma unroll
  for (int w = 0; w < NW; ++w) mk[w] = mask_at(32 * w + lane);

  // this thread's rows are row0 and row0 + 8 (elements [j][2 r + e] of s and o, r = 0, 1);
  // sums are per-thread partials
  float o[C::NATOMS][4];
#pragma unroll
  for (int j = 0; j < C::NATOMS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, mu[2] = {NEG, NEG}, lu[2] = {0.f, 0.f};
  const int grow0 = q0 + wgi * 64;   // the warpgroup's first row
  const int wrow0 = q0 + warp * 16;  // the warp's first row
  const int row0 = wrow0 + g;
  const float c = a.scale * LOG2E;
  // the warpgroup's 64 rows of Q: per 64-column block, and the tail
  const uint32_t sQw = sQ + wgi * 64 * 128, sQt = sQ + C::Q_MAIN + wgi * 64 * 32;

  mbar_wait(q_bar, 0);
  int slot = 0, phase = 0;
  for (int it = 0; it < ntiles;
       ++it, phase ^= (slot + 1 == C::STAGES), slot = (slot + 1 == C::STAGES ? 0 : slot + 1)) {
    const int k0 = it * BN;
    if constexpr (C::SHORT) {
      // the warpgroup is the CTA: once every warp is done with the last tile's slot,
      // thread 0 refills it with the tile STAGES ahead of that one
      if (it > 0) {
        __syncthreads();
        if (tid == 0 && it - 1 + C::STAGES < ntiles)
          load_kv(it - 1 + C::STAGES, slot == 0 ? C::STAGES - 1 : slot - 1);
      }
    }
    // hand the slot back to the producer warp: every path out of this iteration takes it
    auto release = [&]() {
      if constexpr (!C::SHORT) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar(slot));
      }
    };
    mbar_wait(full_bar(slot), phase);
    // bit i of bits[w]: key k0 + 32 w + i is attendable by the key mask
    uint32_t bits[NW], any_bits = 0u, all_bits = full;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      bits[w] = __ballot_sync(full, mk[w]);
      any_bits |= bits[w];
      all_bits &= bits[w];
      if (it + 1 < ntiles) mk[w] = mask_at(k0 + BN + 32 * w + lane);
    }

    // wgmma is issued by a whole warpgroup: what decides whether the products
    // run is uniform over its 64 rows
    const bool above = a.causal && k0 > grow0 + 63;  // wholly above the warpgroup's rows
    const bool dead = above || any_bits == 0u;      // no attendable pair for the warpgroup
    bool do_pv = true;
    if (dead) {
      if (skip_tiles) {
        release();
        continue;
      }
      const bool settled = m[0] > HALF_NEG && m[1] > HALF_NEG;
      // one warpgroup: the CTA's own barrier, so ptxas reserves no named barriers
      if constexpr (C::SHORT)
        do_pv = __syncthreads_and(settled) == 0;
      else
        do_pv = !warpgroup_all(wgi, settled);
      if (!UNM && !do_pv) {
        release();
        continue;
      }
    }

    // ---- S = Q.K^T (raw): both operands from shared memory ----
    const uint32_t sK = sKV + slot * C::SLOT_BYTES, sV = sK + C::K_BYTES;
    float s[BN / 8][4];
    {
      float(&sf)[BN / 2] = reinterpret_cast<float(&)[BN / 2]>(s);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < C::NBLK * 4; ++ks)
        score_step<BN>(
            sf, wg::make_desc(sQw + (ks / 4) * BM * 128 + (ks % 4) * 32, 16, 1024, wg::SW_128),
            wg::make_desc(sK + (ks / 4) * BN * 128 + (ks % 4) * 32, 16, 1024, wg::SW_128), ks > 0);
      if constexpr (C::TAIL)
        wg::wgmma_ss_n64(sf, wg::make_desc(sQt, 16, 256, wg::SW_32),
                         wg::make_desc(sK + C::K_MAIN, 16, 256, wg::SW_32), 1);
      wg::commit();
      wg::wait<0>();
      reg_fence(sf);
    }

    // ---- softmax bookkeeping; s becomes p ----
    // element s[j][2 r + e] is row row0 + 8 r, key k0 + 8 j + 2 t4 + e
    if (k0 + BN > a.S) {  // the ragged last tile: keys at or beyond S never count (scale > 0)
      const int s_lim = a.S - k0 - 2 * t4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + (e & 1) >= s_lim) s[j][e] = -INFINITY;
    }
    if (!do_pv) {
      // only lse_u wants this tile (UNM): fold the raw scores into (mu, lu)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e0 = 2 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          s[j][e0] *= c;
          s[j][e0 + 1] *= c;
          mx = fmaxf(mx, fmaxf(s[j][e0], s[j][e0 + 1]));
        }
        const float mu_new = fmaxf(mu[r], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          sum += ex2(s[j][e0] - mu_new) + ex2(s[j][e0 + 1] - mu_new);
        lu[r] = lu[r] * ex2(mu[r] - mu_new) + sum;
        mu[r] = mu_new;
      }
      release();
      continue;
    }
    const bool clean = all_bits == full && !(a.causal && k0 + BN - 1 > wrow0);
    if (clean) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e0 = 2 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          s[j][e0] *= c;
          s[j][e0 + 1] *= c;
          mx = fmaxf(mx, fmaxf(s[j][e0], s[j][e0 + 1]));
        }
        mx = quad_max(mx);
        const float m_new = fmaxf(m[r], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          s[j][e0] = ex2(s[j][e0] - m_new);
          s[j][e0 + 1] = ex2(s[j][e0 + 1] - m_new);
          sum += s[j][e0] + s[j][e0 + 1];
        }
        const float alpha = ex2(m[r] - m_new);
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
        if (UNM) {
          const float mu_new = fmaxf(mu[r], mx);
          lu[r] = lu[r] * ex2(mu[r] - mu_new) + sum * ex2(m_new - mu_new);
          mu[r] = mu_new;
        }
#pragma unroll
        for (int j = 0; j < C::NATOMS; ++j) {
          o[j][e0] *= alpha;
          o[j][e0 + 1] *= alpha;
        }
      }
    } else {
      // bit 8 (j & 3) + e of word j / 4, shifted by the lane's 2 t4: this thread's column 8 j + e
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e0 = 2 * r;
        uint32_t att_bits[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          att_bits[w] = bits[w] >> (2 * t4);
          // causal: column 8 j + e is attendable iff <= row - k0 - 2 t4
          if (a.causal) att_bits[w] &= bits_up_to(row0 + 8 * r - k0 - 2 * t4 - 32 * w);
        }
        // a masked key < S scores NEG (one beyond S stays -inf): a row's max is at
        // least NEG, because every tile holds a key < S
        float mx = -INFINITY, mxu = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool att = (att_bits[j / 4] >> (8 * (j & 3) + e)) & 1u;
            const float x = s[j][e0 + e] * c;
            const float xm = att ? x : fminf(x, NEG);
            mx = fmaxf(mx, xm);
            if (UNM) mxu = fmaxf(mxu, x);
            s[j][e0 + e] = UNM ? x : xm;
          }
        const float m_new = fmaxf(m[r], quad_max(mx));
        float sum = 0.f;
        if (UNM) {
          const float mu_new = fmaxf(mu[r], quad_max(mxu));
          const float p_masked = m_new > HALF_NEG ? 0.f : 1.f;  // exp(NEG - m_new)
          float sum_att = 0.f, sum_u = 0.f;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool att = (att_bits[j / 4] >> (8 * (j & 3) + e)) & 1u;
              const float x = s[j][e0 + e];
              // one exponential per pair: against m for an attendable one (rescaled
              // to mu below), against mu for a masked one
              const float ex = ex2(x - (att ? m_new : mu_new));
              const float p = att ? ex : (x == -INFINITY ? 0.f : p_masked);
              sum_att += att ? ex : 0.f;
              sum_u += att ? 0.f : ex;
              sum += p;
              s[j][e0 + e] = p;
            }
          lu[r] = lu[r] * ex2(mu[r] - mu_new) + sum_att * ex2(m_new - mu_new) + sum_u;
          mu[r] = mu_new;
        } else {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              s[j][e0 + e] = ex2(s[j][e0 + e] - m_new);  // masked: ex2(NEG - m) is 0, or 1
              sum += s[j][e0 + e];
            }
        }
        const float alpha = ex2(m[r] - m_new);
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < C::NATOMS; ++j) {
          o[j][e0] *= alpha;
          o[j][e0 + 1] *= alpha;
        }
      }
    }

    // ---- O += P.V: P from registers, V from shared memory with d contiguous ----
    {
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        pa[ks][0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
        pa[ks][1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
        pa[ks][2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
        pa[ks][3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      }
      float(&of)[C::NATOMS * 4] = reinterpret_cast<float(&)[C::NATOMS * 4]>(o);
      reg_fence(of);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        // 16 keys down the 128-byte rows; the second 64-column block is BN * 128 further
        const uint64_t dv = wg::make_desc(sV + ks * 16 * 128, BN * 128, 1024, wg::SW_128);
        if constexpr (C::DV == 128) {
          wg::wgmma_rs_n128(of, pa[ks], dv, 1);
        } else {
          wg::wgmma_rs_n64(reinterpret_cast<float(&)[32]>(o), pa[ks], dv, 1);
#pragma unroll
          for (int vt = 0; vt < C::VT; ++vt)
            wg::wgmma_rs_n8(o[8 + vt], pa[ks],
                            wg::make_desc(sV + C::V_MAIN + vt * BN * 16 + ks * 16 * 16, 128, 128),
                            1);
        }
      }
      wg::commit();
      wg::wait<0>();
      reg_fence(of);
    }
    release();
  }

  // ---- out, lse, lse_u ----
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    const float l_safe = fmaxf(quad_sum(l[r]), 1e-30f);
    const float lu_safe = fmaxf(quad_sum(lu[r]), 1e-30f);
    if (t >= a.T) continue;
    const float inv = 1.f / l_safe;
    const size_t row = (static_cast<size_t>(b) * a.T + t) * a.H + h;
    uint32_t* orow = reinterpret_cast<uint32_t*>(og + row * C::DV);
#pragma unroll
    for (int j = 0; j < C::NATOMS; ++j)
      orow[4 * j + t4] = pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (t4 == 0) {
      // a row with no attendable key: NEG + log(l) is NEG in fp32
      const float lse = m[r] > HALF_NEG ? (m[r] + log2f(l_safe)) * LN2 : NEG;
      a.lse[row] = lse;
      a.lse_u[row] = UNM ? (mu[r] + log2f(lu_safe)) * LN2 : lse;
    }
  }
}

template <int D, bool UNM, class C = Cfg<D>>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
    attn_fwd_mma_kernel(AttnArgs a, int skip_tiles, const __grid_constant__ TensorMaps maps) {
  attn_fwd_body<UNM, C>(a, skip_tiles, maps);
}

// latent attention's heads (q / k 192, v 128), under a name of its own
template <bool UNM, class C = CfgMla>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
    mla_attn_fwd_mma_kernel(AttnArgs a, int skip_tiles, const __grid_constant__ TensorMaps maps) {
  attn_fwd_body<UNM, C>(a, skip_tiles, maps);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (nothing links libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a TMA descriptor of columns [.., .. + cols) x `rows` rows of one (batch, head) of a
// bf16 [B, L, heads, D] array; rows and columns outside it arrive as zeros
inline bool make_map(CUtensorMap* map, const void* base, int B, int L, int heads, int D, int cols,
                     int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(L) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the TMA descriptors and the launch of one instantiation `kernel` of tiling C
template <class C, class Kernel>
cudaError_t launch_kernel(Kernel kernel, const AttnArgs& a, int skip_tiles, cudaStream_t stream) {
  constexpr int DQK = C::DQK, DV = C::DV;
  TensorMaps maps = {};
  bool ok = make_map(&maps.q, a.q, a.B, a.T, a.H, DQK, 64, C::BM, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&maps.k, a.k, a.B, a.S, a.Hkv, DQK, 64, C::BN, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&maps.v, a.v, a.B, a.S, a.Hkv, DV, 64, C::BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (C::TAIL)
    ok = ok &&
         make_map(&maps.q_tail, a.q, a.B, a.T, a.H, DQK, 16, C::BM, CU_TENSOR_MAP_SWIZZLE_32B) &&
         make_map(&maps.k_tail, a.k, a.B, a.S, a.Hkv, DQK, 16, C::BN, CU_TENSOR_MAP_SWIZZLE_32B) &&
         make_map(&maps.v_tail, a.v, a.B, a.S, a.Hkv, DV, 8, C::BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  // the short-row form counts on MINB CTAs sharing an SM's shared memory
  if (e == cudaSuccess && C::SHORT)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + C::BM - 1) / C::BM, a.H, a.B);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(a, skip_tiles, maps);
  return cudaGetLastError();
}

template <int D, bool UNM, class C = Cfg<D>>
cudaError_t launch_one(const AttnArgs& a, int skip_tiles, cudaStream_t stream) {
  return launch_kernel<C>(attn_fwd_mma_kernel<D, UNM, C>, a, skip_tiles, stream);
}

// the bf16 forward for head widths (D, Dv) 64, 72, 80, 128 (Dv = D) and 192 / 128;
// other widths -> cudaErrorInvalidValue
inline cudaError_t launch_bf16(int D, int Dv, const AttnArgs& a, int skip_tiles,
                               cudaStream_t stream) {
  if (D == 192 && Dv == 128)
    return a.need_unmasked
               ? launch_kernel<CfgMla>(mla_attn_fwd_mma_kernel<true>, a, skip_tiles, stream)
               : launch_kernel<CfgMla>(mla_attn_fwd_mma_kernel<false>, a, skip_tiles, stream);
  if (Dv != D) return cudaErrorInvalidValue;
  if (D == 64)
    return a.need_unmasked ? launch_one<64, true>(a, skip_tiles, stream)
                           : launch_one<64, false>(a, skip_tiles, stream);
  if (D == 72)
    return a.need_unmasked ? launch_one<72, true>(a, skip_tiles, stream)
                           : launch_one<72, false>(a, skip_tiles, stream);
  if (D == 80)
    return a.need_unmasked ? launch_one<80, true>(a, skip_tiles, stream)
                           : launch_one<80, false>(a, skip_tiles, stream);
  if (D == 128)
    return a.need_unmasked ? launch_one<128, true>(a, skip_tiles, stream)
                           : launch_one<128, false>(a, skip_tiles, stream);
  return cudaErrorInvalidValue;
}

}  // namespace mma
}  // namespace mimic
