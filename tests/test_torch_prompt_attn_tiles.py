"""The bf16 prompt-attention kernel's split, merges and fragment maps, on the CPU.

``csrc/prompt_attn_int8.cu`` runs only on a card (tests/test_torch_kernels.py
holds it to its plain version there).  Here:

- ``prompt_attention_int8_tiled_plain`` (the kernel's algorithm step by step:
  ranks over 128-key chunks, warps over 16-key slices of each chunk, taken in
  pairs of chunks at M <= 16 (``prompt_steps``), an online softmax per warp,
  the warps' and then the ranks' partials merged in order) against
  ``prompt_attention_int8_plain`` in fp32 at 1e-5 of max |reference| (m 1e-5
  absolute), for every split the plan picks at Sp 512-4096 and every split a
  prompt allows, M 1-32, all-masked leading chunks and rows with no key; and
  against the JAX Pallas kernel in interpret mode, as
  tests/test_torch_decode_attention.py runs it (fp32 1e-5, bf16 1e-2 and m 1e-3);
- ``prompt_split``: all clusters resident at once, at least one chunk per CTA,
  the fewest chunks per CTA;
- ``frag_row`` / ``frag_col``: the fragment order the partials are kept and
  merged in covers each (query row, d) of the CTA's o once;
- one warp's 16-key block through the PTX layouts of ``mma.m16n8k16`` with the
  kernel's maps (q's A fragments, the key bytes as B, the score accumulators as
  p^T, v's bytes as the A operand of o^T, the running max's shuffles): the
  products equal q . k^T and p . v; and the swizzled k and v tiles read by
  16-byte loads hit 32 distinct banks per 8-lane phase.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.ops import decode_attention as jda
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.ops import decode_attention as tda

TOL_FP32 = 1e-5
TOL_BF16 = 1e-2
TOL_M_BF16 = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one thread each, not a pool that every op must wake
    (under a loaded CPU the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMS = 132  # NVIDIA H100 SXM


def one_per_sm(split):
    """Clusters of ``split`` CTAs resident at once with one CTA per SM and no GPC limit."""
    return SMS // split


def _inputs(B0, Hkv, M, Sp, pads, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    kv = [torch.from_numpy(rng.normal(size=(1, B0, Sp, Hkv, 128)).astype(np.float32))
          for _ in range(2)]
    pk, pv = tda.quantize_prompt_kv(*kv)
    qf = torch.from_numpy((rng.normal(size=(B0, Hkv, M, 128)) / np.sqrt(128)).astype(np.float32))
    mask = np.ones((B0, Sp), np.int32)
    for b, p in enumerate(pads):
        mask[b, :p] = 0
    return (qf.to(dtype), pk["q8"][0], pk["scale"][0], pv["q8"][0], pv["scale"][0],
            torch.from_numpy(mask))


def _close(got, want, tol, m_tol):
    o, m, l = got
    wo, wm, wl = want
    for a in got:
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
    assert (m - wm).abs().max().item() <= m_tol
    assert (o - wo).abs().max().item() <= tol * wo.abs().max().item()
    assert (l - wl).abs().max().item() <= tol * wl.abs().max().item()


# (B0, Hkv, Sp): the serving calls (call A: B0 4, Sp 512; call B: B0 2, Sp 4096)
# and the prompt lengths between, each at the split the plan picks on 132 SMs
PLANNED = [(4, 8, 512), (2, 8, 1024), (2, 8, 2048), (2, 8, 4096), (1, 8, 4096), (4, 8, 1024),
           (8, 8, 512), (1, 1, 512)]


@pytest.mark.parametrize("B0,Hkv,Sp", PLANNED, ids=[f"B0{b}-H{h}-Sp{s}" for b, h, s in PLANNED])
def test_plan_fills_one_wave_with_a_chunk_per_cta(B0, Hkv, Sp):
    n = Sp // tda.KEY_BLOCK
    split = tda.prompt_split(B0, Hkv, Sp, one_per_sm)
    assert split in tda.PROMPT_SPLITS and split <= n
    assert split == 1 or B0 * Hkv <= one_per_sm(split)
    fits = [s for s in tda.PROMPT_SPLITS if s <= n and B0 * Hkv <= one_per_sm(s)]
    # the fewest chunks per CTA, and no smaller split gives as few
    assert all(-(-n // s) >= -(-n // split) for s in fits)
    assert all(-(-n // s) > -(-n // split) for s in fits if s < split)
    assert tda.prompt_split(2, 8, 4096, one_per_sm) == 8 and tda.prompt_split(4, 8, 512, one_per_sm) == 4
    # the clusters an NVIDIA H100 80GB HBM3 holds at once (cudaOccupancyMaxActiveClusters,
    # chip_smoke.py --int8-only): call B takes 6 (7 and 8 would need two waves), call A 2
    h100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}.get
    assert tda.prompt_split(2, 8, 4096, h100) == 6 and tda.prompt_split(4, 8, 512, h100) == 2


@pytest.mark.parametrize("B0,Hkv,Sp", PLANNED, ids=[f"B0{b}-H{h}-Sp{s}" for b, h, s in PLANNED])
def test_tiled_plain_at_the_planned_split_matches_plain(B0, Hkv, Sp):
    """M 12 (4 beams x 3 groups), the first rows' leading chunks all masked."""
    B0c, Hc = min(B0, 2), min(Hkv, 2)  # the split is the plan's; the arithmetic needs few rows
    split = tda.prompt_split(B0, Hkv, Sp, one_per_sm)
    pads = [300, 0][:B0c]
    args = _inputs(B0c, Hc, 12, Sp, pads, seed=Sp)
    _close(tda.prompt_attention_int8_tiled_plain(*args, split),
           tda.prompt_attention_int8_plain(*args), TOL_FP32, TOL_FP32)


CASES = [
    # M, Sp, split, pads (per batch row)
    (1, 512, 4, (0,)),
    (12, 512, 1, (130, 0)),        # a fully masked first chunk
    (16, 512, 2, (384, 5)),        # three masked chunks, then a real one
    (17, 1024, 8, (0, 1024)),      # a row with no attendable key: the mean over all keys
    (32, 1024, 4, (700, 33)),
    (24, 2048, 8, (1500, 0)),
    (32, 4096, 8, (3000, 250)),
    (5, 384, 2, (200, 0)),         # 3 chunks over 2 ranks: ranks of 1 and 2 chunks
    (12, 640, 4, (0, 129)),        # 5 chunks over 4 ranks
    (12, 4096, 6, (0, 250)),       # call B's split on an H100: ranks of 5 and 6 chunks
    (12, 4096, 7, (0, 250)),       # ranks of 4 and 5 chunks
    (9, 768, 3, (0, 300)),         # 6 chunks over 3 ranks
]


def test_steps_pair_chunks_up_to_one_m16_tile():
    assert tda.prompt_steps(0, 5, 12) == [(0, 1), (2, 3), (4,)]
    assert tda.prompt_steps(3, 7, 16) == [(3, 4), (5, 6)]
    assert tda.prompt_steps(3, 6, 17) == [(3,), (4,), (5,)]
    assert tda.prompt_steps(2, 3, 1) == [(2,)]


@pytest.mark.parametrize("M,Sp,split,pads", CASES, ids=[f"M{c[0]}-Sp{c[1]}-s{c[2]}" for c in CASES])
def test_tiled_plain_matches_plain(M, Sp, split, pads):
    args = _inputs(len(pads), 2, M, Sp, pads, seed=M * Sp)
    want = tda.prompt_attention_int8_plain(*args)
    got = tda.prompt_attention_int8_tiled_plain(*args, split)
    _close(got, want, TOL_FP32, TOL_FP32)
    if Sp in pads:  # no attendable key: m = NEG, every p = 1, l = Sp
        b = pads.index(Sp)
        assert (got[1][b] == tda.NEG * tda.LN2).all() and (got[2][b] == Sp).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [1, 2])
def test_tiled_plain_matches_pallas_interpret(split, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    B0, Kb, Hkv, G, D, Sp = 2, 3, 2, 2, 128, 384
    rng = np.random.default_rng(7)
    pk, pv = (jnp.asarray(rng.normal(size=(1, B0, Sp, Hkv, D)).astype(np.float32)) for _ in range(2))
    qg = jnp.asarray((rng.normal(size=(B0 * Kb, 1, Hkv, G, D)) / np.sqrt(D)).astype(np.float32))
    qg = qg.astype(jdt)
    mask = np.ones((B0, Sp), np.int32)
    mask[0, :130] = 0  # a fully masked first block
    mask[1, :7] = 0
    jk, jv = jda.quantize_prompt_kv(pk, pv)
    want = jda.prompt_attention_int8(qg, dict(jk, layer=jnp.int32(0)), dict(jv, layer=jnp.int32(0)),
                                     jnp.asarray(mask), block_k=128, interpret=True)
    tk = {k: torch.from_numpy(np.array(v)) for k, v in jk.items()}
    tv = {k: torch.from_numpy(np.array(v)) for k, v in jv.items()}
    qf = tda._fold(to_torch(np.asarray(qg), "cpu"), B0).contiguous()
    got = tda.prompt_attention_int8_tiled_plain(qf, tk["q8"][0], tk["scale"][0], tv["q8"][0],
                                                tv["scale"][0], torch.from_numpy(mask), split)
    got = [tda._unfold(t, B0 * Kb, G) for t in got]
    want = [torch.from_numpy(np.array(w)) for w in want]
    tol, m_tol = (TOL_FP32, TOL_FP32) if dtype == "float32" else (TOL_BF16, TOL_M_BF16)
    _close(got, want, tol, m_tol)


# ---------------------------------------------------------------------------
# one warp's 16-key block through the mma.m16n8k16 layouts
# ---------------------------------------------------------------------------


def score_key(T: int, n: int) -> int:
    """``score_key``: key of column n of score tile T within the warp's 16 keys."""
    return 4 * (n >> 1) + 2 * T + (n & 1)


def k_swizzle(r: int, c: int) -> int:
    return c ^ ((r & 1) << 2)


def v_swizzle(r: int, c: int) -> int:
    return c ^ (((r >> 2) & 3) << 1)


def stage(tile: np.ndarray, swz) -> np.ndarray:
    """A [16][128] byte tile as the cp.async ring holds it (16-byte chunk c of row r
    at chunk swz(r, c))."""
    out = np.zeros(16 * 128, np.uint8)
    for r in range(16):
        for c in range(8):
            p = r * 128 + (swz(r, c) << 4)
            out[p:p + 16] = tile[r, 16 * c:16 * c + 16]
    return out


def mma(A_regs, B_regs):
    """``mma.m16n8k16`` through the PTX layouts: A regs per lane [a0..a3] as
    (value pairs), B regs [b0, b1]; returns the 16 x 8 product."""
    A = np.full((16, 16), np.nan)
    B = np.full((16, 8), np.nan)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(4):
            for h in range(2):
                A[g + 8 * (j & 1), 2 * t + h + 8 * (j >> 1)] = A_regs[lane][j][h]
        for j in range(2):
            for h in range(2):
                B[2 * t + h + 8 * j, g] = B_regs[lane][j][h]
    assert not np.isnan(A).any() and not np.isnan(B).any()
    return A @ B


@pytest.mark.parametrize("seed", range(3))
def test_block_fragment_maps_give_the_products(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-9, 10, size=(16, 128)).astype(np.float64) / 4   # exact, any dtype
    k8 = rng.integers(-127, 128, size=(16, 128)).astype(np.int8)
    v8 = rng.integers(-127, 128, size=(16, 128)).astype(np.int8)
    ks, kv_ = stage(k8.view(np.uint8), k_swizzle), stage(v8.view(np.uint8), v_swizzle)
    byte = lambda st, addr: int(st[addr:addr + 1].view(np.int8)[0])

    # scores, tile T, summed over the eight k16 steps
    S = np.zeros((16, 16))  # [query][key]
    for T in range(2):
        acc = np.zeros((16, 8))
        for c in range(8):
            A_regs, B_regs = [], []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                d0 = 64 * (c >> 2) + 16 * t + 4 * (c & 3)
                A_regs.append([(q[g, d0], q[g, d0 + 1]), (q[g + 8, d0], q[g + 8, d0 + 1]),
                               (q[g, d0 + 2], q[g, d0 + 3]), (q[g + 8, d0 + 2], q[g + 8, d0 + 3])])
                r = score_key(T, g)
                base = r * 128 + (k_swizzle(r, 4 * (c >> 2) + t) << 4) + 4 * (c & 3)
                w = [byte(ks, base + i) for i in range(4)]
                B_regs.append([(w[0], w[1]), (w[2], w[3])])
            acc += mma(A_regs, B_regs)
        for n in range(8):
            S[:, score_key(T, n)] = acc[:, n]
    np.testing.assert_array_equal(S, q @ k8.astype(np.float64).T)

    # o^T += v^T . p^T with p the score accumulators as they stand (any values)
    P = rng.integers(-5, 6, size=(16, 16)).astype(np.float64)  # [query][key]
    OT = np.zeros((128, 16))
    for i2 in range(8):
        for nt in range(2):
            A_regs, B_regs = [], []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                rows = []
                for r in range(4):
                    row = 4 * t + r
                    base = row * 128 + (v_swizzle(row, g) << 4)
                    rows.append([byte(kv_, base + i) for i in range(16)])
                b = 2 * i2  # byte of d = 16 g + 2 i2 within the lane's 16
                A_regs.append([(rows[0][b], rows[1][b]), (rows[0][b + 1], rows[1][b + 1]),
                               (rows[2][b], rows[3][b]), (rows[2][b + 1], rows[3][b + 1])])
                # tile T's accumulator pair (e = 0, 1) of row 8 nt + g: keys 4t + 2T + e
                qrow = 8 * nt + g
                B_regs.append([(P[qrow, 4 * t], P[qrow, 4 * t + 1]),
                               (P[qrow, 4 * t + 2], P[qrow, 4 * t + 3])])
            D = mma(A_regs, B_regs)  # [A row][query 8 nt + n]
            for g in range(8):
                OT[16 * g + 2 * i2, 8 * nt:8 * nt + 8] += D[g]
                OT[16 * g + 2 * i2 + 1, 8 * nt:8 * nt + 8] += D[g + 8]
    np.testing.assert_array_equal(OT, (P @ v8.astype(np.float64)).T)

    # the rescale's shuffles: o^T column 8 nt + 2t + e takes the factor of query row
    # 8 nt + 2t + e, held (as alpha[nt]) by the lanes with g = 2t + e, e.g. lane 8t + 4e
    for lane in range(32):
        t = lane & 3
        for e in range(2):
            src = 8 * t + 4 * e
            assert src >> 2 == 2 * t + e


def test_swizzled_key_and_value_loads_hit_32_banks():
    """Per 8-lane phase of the 16-byte loads: k rows score_key(T, g) at chunk
    4 hh + t, v rows 4t + r at chunk g."""
    for phase in range(4):
        lanes = range(8 * phase, 8 * phase + 8)
        for T in range(2):
            for hh in range(2):
                banks = set()
                for lane in lanes:
                    g, t = lane >> 2, lane & 3
                    r = score_key(T, g)
                    start = (r * 128 + (k_swizzle(r, 4 * hh + t) << 4)) // 4
                    banks.update((start + w) % 32 for w in range(4))
                assert len(banks) == 32
        for r4 in range(4):
            banks = set()
            for lane in lanes:
                g, t = lane >> 2, lane & 3
                row = 4 * t + r4
                start = (row * 128 + (v_swizzle(row, g) << 4)) // 4
                banks.update((start + w) % 32 for w in range(4))
            assert len(banks) == 32


def frag_row(j: int, lane: int) -> int:
    """``frag_row``: query row of o^T accumulator j ([mt][i2][nt][e]) of a lane."""
    return 16 * (j >> 6) + 8 * ((j >> 2) & 1) + 2 * (lane & 3) + (j & 1)


def frag_col(j: int, lane: int) -> int:
    return 16 * (lane >> 2) + 2 * ((j >> 3) & 7) + ((j >> 1) & 1)


@pytest.mark.parametrize("MT", [1, 2])
def test_fragment_order_covers_the_partial_once(MT):
    seen = np.zeros((16 * MT, 128), np.int32)
    for j in range(64 * MT):
        mt, i2, nt, e = j >> 6, (j >> 3) & 7, (j >> 2) & 1, j & 3
        assert j == ((mt * 8 + i2) * 2 + nt) * 4 + e
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            r, d = frag_row(j, lane), frag_col(j, lane)
            # the o^T accumulator layout: c0 / c1 query 8 nt + 2t (+1), c2 / c3 the same at d + 1
            assert r == 16 * mt + 8 * nt + 2 * t + (e & 1) and d == 16 * g + 2 * i2 + (e >> 1)
            seen[r, d] += 1
    assert (seen == 1).all()
