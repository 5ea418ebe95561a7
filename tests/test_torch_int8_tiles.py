"""The tensor-core int8 kernels' register arithmetic, tile maps and plans, on the CPU.

``csrc/int8_mma.cuh`` runs only on a card (tests/test_torch_kernels.py holds
it to its plain version there).  What it does bit by bit and on the host side
is modelled here, with the constants of the CUDA source:

- the int8 → bf16 conversion in registers (the byte, its sign bit flipped,
  permuted under the exponent of 2^23, one fp32 subtraction, the upper half
  kept) for all 256 byte values: bit-equal to float(int8) in bf16;
- the fragment map: which weight bytes and which activations a lane hands to
  ``mma.sync.m16n8k16``, simulated through the PTX fragment layouts over a
  whole warp: the products equal x @ W exactly;
- the swizzled stage: what the cp.async chunks write is what the fragment
  loads read, and each half-warp's 8-byte loads hit 32 distinct banks;
- ``mma_plan`` for every M in 1..255 at idefics2-8b's decode shapes and a
  ragged N (the lm head's 32128 stored / 32003 real columns);
- ``int8_matmul_tiled_plain`` / ``fused_mlp_tiled_plain`` (the kernels' split-K
  order) against ``int8_matmul_plain`` / ``fused_mlp_plain`` and the Pallas
  kernels in interpret mode, as tests/test_torch_quant.py runs them: fp32,
  1e-5 of max |reference| (summation order only).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.ops import quant as jq
from mimic_tpu_torch.ops import quant as tq

TOL_FP32 = 1e-5

# csrc/int8_mma.cuh
TC_BN, TC_KT, TC_XLD = 128, 64, 64 * 2 + 32
MAGIC, BIAS = 0x4B000000, np.float32(8388736.0)  # 2^23 and 2^23 + 128


def prmt(a: int, b: int, sel: int) -> int:
    """``__byte_perm(a, b, sel)``: byte i of the result is byte (sel >> 4i) & 7
    of the eight bytes of b:a (the selectors used here never set bit 3)."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def f32(bits: int) -> np.float32:
    return np.array([bits], np.uint32).view(np.float32)[0]


def bits32(x: np.float32) -> int:
    return int(np.array([x], np.float32).view(np.uint32)[0])


def biased_byte_to_f32(u: int, j: int) -> np.float32:
    """``biased_byte_to_f32<J>``: byte j of u under the exponent of 2^23, less 2^23 + 128."""
    return np.float32(f32(prmt(u, MAGIC, 0x7440 | j)) - BIAS)


def pack_bf16(lo: np.float32, hi: np.float32) -> int:
    return prmt(bits32(lo), bits32(hi), 0x7632)


def bf16_bits(values) -> np.ndarray:
    return torch.tensor(np.asarray(values, np.float32)).to(torch.bfloat16).view(torch.int16).numpy().view(
        np.uint16)


def test_int8_to_bf16_in_registers_is_exact_for_every_byte():
    stored = np.arange(256, dtype=np.uint32)           # the byte as it sits in memory
    value = stored.astype(np.uint8).view(np.int8)       # the int8 it holds
    got = []
    for b in stored:
        word = (int(b) * 0x01010101) ^ 0x80808080       # four copies, sign bits flipped
        f = [biased_byte_to_f32(word, j) for j in range(4)]
        assert all(x == f[0] for x in f)
        assert f[0] == np.float32(value[b])             # exact in fp32
        pair = pack_bf16(f[0], f[1])
        got += [pair & 0xFFFF, pair >> 16]
    want = np.repeat(bf16_bits(value.astype(np.float32)), 2)
    np.testing.assert_array_equal(np.array(got, np.uint16), want)


# ---------------------------------------------------------------------------
# fragments: the kernel's maps against the PTX layouts of mma.m16n8k16
# ---------------------------------------------------------------------------


def a_fragment(w_rows, inst):
    """``a_fragment<I>``: the lane's four A registers from its four weight
    rows (two little-endian words each: columns 0-3 and 4-7, sign bits flipped)."""
    s, b = inst >> 1, (inst & 1) * 2
    conv = lambda r, j: biased_byte_to_f32(w_rows[r][s], j)
    return [pack_bf16(conv(0, b), conv(1, b)), pack_bf16(conv(0, b + 1), conv(1, b + 1)),
            pack_bf16(conv(2, b), conv(3, b)), pack_bf16(conv(2, b + 1), conv(3, b + 1))]


def bf16_value(bits: int) -> float:
    return float(f32(bits << 16))


def test_fragment_maps_give_the_product_through_the_ptx_layouts():
    """One warp's k step (16 weight rows x 64 columns of its half, 16 activation
    rows): each lane builds its fragments as the kernel does, the PTX layouts
    place them in the m16n8k16 operands, the products land where the kernel's
    epilogue stores them, and the sum is x @ W exactly."""
    rng = np.random.default_rng(0)
    W = rng.integers(-127, 128, size=(16, 64)).astype(np.int8)
    X = rng.integers(-50, 50, size=(16, 16)).astype(np.float32) / 8  # exact in bf16
    xb = bf16_bits(X)
    out = np.zeros((16, 64))
    for mt in range(2):
        for inst in range(4):
            A, B = np.full((16, 16), np.nan), np.full((16, 8), np.nan)
            rows_of, ms_of = {}, {}
            for lane in range(32):
                gid, tig = lane >> 2, lane & 3
                words = [[int.from_bytes(W[4 * tig + r, 8 * gid + 4 * s:8 * gid + 4 * s + 4]
                                         .tobytes(), "little") ^ 0x80808080 for s in range(2)]
                         for r in range(4)]
                a = a_fragment(words, inst)
                # the PTX A layout: register j, half h → row gid + 8 (j & 1), k 2 tig + h + 8 (j >> 1)
                for j in range(4):
                    for h in range(2):
                        A[gid + 8 * (j & 1), 2 * tig + h + 8 * (j >> 1)] = bf16_value(
                            (a[j] >> (16 * h)) & 0xFFFF)
                # B: x[m][4 tig .. + 3] as two words; register j, half h → k 2 tig + h + 8 j, column gid
                m = mt * 8 + gid
                for j in range(2):
                    for h in range(2):
                        B[2 * tig + h + 8 * j, gid] = bf16_value(int(xb[m, 4 * tig + 2 * j + h]))
                # the kernel's view of the same operands: mma row → weight column,
                # mma k → weight row, B column → activation row
                for rho in (gid, gid + 8):
                    rows_of[rho] = 8 * gid + 2 * inst + rho // 8
                ms_of[gid] = m
            assert not np.isnan(A).any() and not np.isnan(B).any()
            # one weight row per mma k, the same on both operands: k index κ is row
            # 4 (κ % 8 // 2) + 2 (κ // 8) + κ % 2
            kappa = np.arange(16)
            real_k = 4 * (kappa % 8 // 2) + 2 * (kappa // 8) + kappa % 2
            np.testing.assert_array_equal(
                A, W[real_k][:, [rows_of[r] for r in range(16)]].T.astype(np.float64))
            np.testing.assert_array_equal(B, X[[ms_of[g] for g in range(8)]][:, real_k].T)
            D = A @ B  # [16 columns, 8 rows of x]
            # the PTX C layout and the kernel's stores: c0, c1 / c2, c3 of lane (gid,
            # tig) are rows 2 tig, 2 tig + 1 at column 8 gid + 2I / + 1
            for lane in range(32):
                gid, tig = lane >> 2, lane & 3
                for j in range(4):
                    rho, nu = gid + 8 * (j >> 1), 2 * tig + (j & 1)
                    n = 8 * gid + 2 * inst + (j >> 1)
                    out[mt * 8 + nu, n] += D[rho, nu]
    np.testing.assert_array_equal(out, X.astype(np.float64) @ W.astype(np.float64))


def test_swizzled_stage_round_trip_and_bank_conflicts():
    rng = np.random.default_rng(1)
    tile = rng.integers(0, 256, size=(TC_KT, TC_BN), dtype=np.uint8)
    stage = np.zeros(TC_KT * TC_BN, np.uint8)
    for i in range(TC_KT * TC_BN // 16):  # the cp.async chunks
        row, c = i >> 3, i & 7
        pos = row * TC_BN + ((c ^ (((row >> 2) & 3) << 1)) << 4)
        stage[pos:pos + 16] = tile[row, 16 * c:16 * c + 16]
        # eight consecutive threads store one row: 128 distinct bytes, all banks
    for warp in range(4):
        nh, kh = warp & 1, warp >> 1
        for ks in range(2):
            for r in range(4):
                words = []
                for lane in range(32):
                    gid, tig = lane >> 2, lane & 3
                    kb = kh * 32 + ks * 16 + 4 * tig
                    wchunk = ((nh * 4 + (gid >> 1)) ^ (tig << 1)) * 16 + (gid & 1) * 8
                    addr = (kb + r) * TC_BN + wchunk
                    col = nh * 64 + 8 * gid
                    np.testing.assert_array_equal(stage[addr:addr + 8], tile[kb + r, col:col + 8])
                    words.append({addr // 4 % 32, addr // 4 % 32 + 1})
                for half in (words[:16], words[16:]):
                    assert len(set().union(*half)) == 32  # conflict-free
    for mt in range(2):  # the activation rows, padded to TC_XLD bytes
        for kb0 in range(0, TC_KT, 16):
            words = []
            for lane in range(32):
                gid, tig = lane >> 2, lane & 3
                addr = (mt * 8 + gid) * TC_XLD + (kb0 + 4 * tig) * 2
                words.append({addr // 4 % 32, addr // 4 % 32 + 1})
            for half in (words[:16], words[16:]):
                assert len(set().union(*half)) == 32


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# idefics2-8b at decode: (K, column tiles) of q/k/v, o, lm head (32128 stored
# columns of 32003), the MLP's gate|up (64 gate + 64 up columns a tile) and down
PRODUCTS = {"qkv": (4096, 48), "o": (4096, 32), "lm head": (4096, 251), "gate/up": (4096, 224),
            "down": (14336, 32)}


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_plan_for_every_decode_m(name):
    K, tiles = PRODUCTS[name]
    ktiles = -(-K // tq.MMA_BLOCK_K)
    for M in range(1, 256):
        ks = tq.mma_plan(M, K, tiles, 132)
        assert ks in tq.MMA_SPLITS and ks <= ktiles
        chunk = -(-ktiles // ks) * tq.MMA_BLOCK_K
        assert (ks - 1) * chunk < K <= ks * chunk  # every rank has rows, together all of K
        assert tiles * ks <= 2**31 - 1 and -(-M // tq.MMA_ROWS) <= 65535
        # every CTA keeps MMA_MIN_TILES weight tiles; no smaller such split gives
        # the SMs 1.6 CTAs each; this one does, or no larger one may be taken
        ctas = lambda s: tiles * -(-M // tq.MMA_ROWS) * s
        keeps = [s for s in tq.MMA_SPLITS if -(-ktiles // s) >= tq.MMA_MIN_TILES]
        assert ks in keeps
        assert all(5 * ctas(s) < 8 * 132 for s in keeps if s < ks)
        assert 5 * ctas(ks) >= 8 * 132 or ks == keeps[-1]
    # the splits the docstring names, at call A's M 12 and call B's M 6
    want = {"qkv": 4, "o": 4, "lm head": 1, "gate/up": 1, "down": 8}[name]
    assert tq.mma_plan(12, K, tiles, 132) == tq.mma_plan(6, K, tiles, 132) == want


def test_plan_at_ragged_shapes():
    assert -(-32128 // tq.MMA_BLOCK_N) == 251  # the lm head's stored columns, whole tiles
    for K in (1, 63, 64, 65, 200, 1100, 4100, 8192):
        for M in (1, 12, 17, 255):
            ks = tq.mma_plan(M, K, 3, 132)
            assert ks == 1 or -(-(-(-K // tq.MMA_BLOCK_K)) // ks) >= tq.MMA_MIN_TILES
    assert tq.mma_plan(12, 64, 1, 132) == 1
    assert tq.mma_plan(4, 8192, 1, 132) == 8  # the cuda tests' largest cluster


# ---------------------------------------------------------------------------
# the kernels' summation order against the plain versions and the Pallas kernels
# ---------------------------------------------------------------------------


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _matmul_case(M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q = jq.quantize_weight(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32)))
    pallas = np.asarray(jq.int8_matmul(jnp.asarray(x), q["q8"], q["scale"], block_m=16,
                                       block_n=128, block_k=128, interpret=True))
    return x, np.asarray(q["q8"]), np.asarray(q["scale"]), pallas


@pytest.mark.parametrize("ksplit", tq.MMA_SPLITS)
@pytest.mark.parametrize("M,K,N", [(12, 512, 256), (16, 640, 128)])
def test_int8_matmul_tiled_plain_matches_plain_and_pallas(M, K, N, ksplit):
    x, q8, scale, pallas = _matmul_case(M, K, N)
    got = tq.int8_matmul_tiled_plain(_t(x), _t(q8), _t(scale), ksplit).numpy()
    plain = tq.int8_matmul_plain(_t(x), _t(q8), _t(scale)).numpy()
    assert _rel_err(got, plain) <= TOL_FP32
    assert _rel_err(got, pallas) <= TOL_FP32


def test_int8_matmul_tiled_plain_at_a_ragged_k():
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(6, 200)).astype(np.float32))
    q = tq.quantize_weight(_t(rng.normal(size=(200, 256)).astype(np.float32)))
    plain = tq.int8_matmul_plain(x, q["q8"], q["scale"])
    for ks in (1, 2, 4):  # 200 rows: four 64-row tiles, the last partial
        got = tq.int8_matmul_tiled_plain(x, q["q8"], q["scale"], ks)
        assert _rel_err(got.numpy(), plain.numpy()) <= TOL_FP32


@pytest.mark.parametrize("ks_gu,ks_down", [(1, 1), (4, 8), (8, 2)])
def test_fused_mlp_tiled_plain_matches_plain_and_pallas(ks_gu, ks_down):
    L, M, D, F, layer = 2, 12, 512, 512, 1
    rng = np.random.default_rng(20)
    x = rng.normal(size=(M, D)).astype(np.float32)
    qgu = jq.quantize_weight(jnp.asarray(rng.normal(size=(L, D, 2 * F)).astype(np.float32)))
    qd = jq.quantize_weight(jnp.asarray(rng.normal(size=(L, F, D)).astype(np.float32) / np.sqrt(F)))
    pallas = np.asarray(jq.fused_mlp_stacked(jnp.asarray(x), qgu["q8"], qgu["scale"], qd["q8"],
                                             qd["scale"], jnp.int32(layer), block_f=256,
                                             interpret=True))
    args = [_t(np.asarray(a)[layer]) for a in (qgu["q8"], qgu["scale"], qd["q8"], qd["scale"])]
    got = tq.fused_mlp_tiled_plain(_t(x), *args, ks_gu, ks_down).numpy()
    assert _rel_err(got, tq.fused_mlp_plain(_t(x), *args).numpy()) <= TOL_FP32
    assert _rel_err(got, pallas) <= TOL_FP32
