"""The W8A8 kernels' register arithmetic, tile maps and schedule, on the CPU.

``csrc/w8a8_matmul.cu`` and ``csrc/quantize_rows.cu`` run only on a card
(tests/test_torch_kernels.py holds them to their plain versions there).  What
they do byte by byte is modelled here, with the constants of the CUDA sources:

- the weights' A fragment: ``ldmatrix.x4.trans`` over the TMA's 128-byte
  swizzled ``[k][n]`` tile at the rows ``frag_k`` picks, then two ``prmt`` per
  register, for every byte position of every warp's chunk and k32 step: each
  lane holds the four k of its column pair that ``wgmma``'s register A
  fragment wants;
- the whole CTA simulated: both warpgroups' fragments placed by the PTX A
  layout, the activation tile read through the K-major 128-byte-swizzle
  descriptor, the int32 products, the epilogue's (column, row) map and the two
  scales: equal to ``w8a8_matmul_plain`` bit for bit, also for K 80 (a tile
  past the end of K arrives as zeros);
- the ldmatrix phases: 8 lanes of a phase read 8 distinct 16-byte chunks, 32
  banks;
- the grid and the epilogue cover each output element exactly once at every
  shape of ``chip_smoke.py``'s phase 9 and of the ``cuda`` tests;
- a model of ``quantize_rows.cu``'s per-row steps (|x| max, the fp32 multiply by
  1/127, the IEEE division, rint half to even) equal to ``quantize_rows`` and to
  the jitted JAX function bit for bit: zero rows, ties at .5, rows where eager
  JAX differs, fp32 and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.ops import quant as jq
from mimic_tpu_torch.ops import quant as tq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one thread each, not a pool that every op must wake
    (under a loaded CPU the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# csrc/w8a8_matmul.cu
NWG, BW, BX, BK = 2, 128, 256, 128


def frag_k(mat: int, j: int) -> int:
    """``frag_k``: the k (0..31 within a k32 step) of row j of ldmatrix matrix ``mat``."""
    return 16 * (mat >> 1) + 4 * (j >> 1) + (j & 1) + 2 * (((j >> 2) & 1) ^ (mat & 1))


def prmt(a: int, b: int, sel: int) -> int:
    """``__byte_perm(a, b, sel)`` for selectors without bit 3 set."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def swizzled(tile: np.ndarray) -> np.ndarray:
    """A [rows][128] byte tile as TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B:
    16-byte chunk c of row r at chunk c ^ (r & 7)."""
    rows = tile.shape[0]
    out = np.zeros(rows * 128, np.uint8)
    for r in range(rows):
        for c in range(8):
            p = r * 128 + ((c ^ (r & 7)) << 4)
            out[p:p + 16] = tile[r, 16 * c:16 * c + 16]
    return out


def ldsm_x4_trans(smem: np.ndarray, addrs):
    """``ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16``: lanes 8i .. 8i + 7 give
    the row addresses of matrix i; lane L receives, in register i, the b16
    elements (row 2 (L % 4), column L / 4) and (row 2 (L % 4) + 1, column L / 4)."""
    regs = []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        r = []
        for i in range(4):
            lo = addrs[8 * i + 2 * t] + 2 * g
            hi = addrs[8 * i + 2 * t + 1] + 2 * g
            b = bytes(smem[lo:lo + 2]) + bytes(smem[hi:hi + 2])
            r.append(int.from_bytes(b, "little"))
        regs.append(r)
    return regs


def a_fragments(w_smem: np.ndarray, chunk: int, s: int):
    """The kernel's A fragment of k32 step ``s`` for the warp of ``chunk``: per
    lane [a0, a1, a2, a3]."""
    addrs = []
    for lane in range(32):
        krow = frag_k(lane >> 3, lane & 7)
        addrs.append(s * 32 * 128 + krow * 128 + ((chunk ^ (krow & 7)) << 4))
    regs = ldsm_x4_trans(w_smem, addrs)
    out = []
    for lane in range(32):
        t = lane & 3
        sel_lo, sel_hi = (0x6420, 0x7531) if t < 2 else (0x2064, 0x3175)
        r = regs[lane]
        out.append([prmt(r[0], r[1], sel_lo), prmt(r[0], r[1], sel_hi),
                    prmt(r[2], r[3], sel_lo), prmt(r[2], r[3], sel_hi)])
    return out


def word_bytes(w: int) -> np.ndarray:
    return np.frombuffer(w.to_bytes(4, "little"), np.int8)


@pytest.mark.parametrize("chunk", range(8))
def test_weight_fragment_holds_the_column_pair_and_k_quads(chunk):
    """Every byte of every lane's A registers, every k32 step: a0 / a1 are
    columns 2g / 2g + 1 of the warp's chunk at k 4t .. 4t + 3, a2 / a3 the same
    at k 16 + 4t .. (the register A fragment of wgmma .s8)."""
    rng = np.random.default_rng(chunk)
    tile = rng.integers(0, 256, size=(BK, 128), dtype=np.uint8)
    smem = swizzled(tile)
    for s in range(BK // 32):
        frags = a_fragments(smem, chunk, s)
        for lane, a in enumerate(frags):
            g, t = lane >> 2, lane & 3
            n = 16 * chunk + 2 * g
            for reg, (col, k0) in enumerate(((n, 4 * t), (n + 1, 4 * t), (n, 16 + 4 * t),
                                             (n + 1, 16 + 4 * t))):
                want = tile[32 * s + k0:32 * s + k0 + 4, col].view(np.int8)
                np.testing.assert_array_equal(word_bytes(a[reg]), want)


@pytest.mark.parametrize("chunk", range(8))
def test_ldmatrix_phases_read_distinct_chunks(chunk):
    """Each 8-lane phase of the fragment's ldmatrix reads 8 rows whose k differ
    mod 8, so under the 128-byte swizzle they sit in 8 distinct 16-byte chunk
    positions: all 32 banks, no conflict."""
    for s in range(BK // 32):
        for mat in range(4):
            rows = [frag_k(mat, j) + 32 * s for j in range(8)]
            assert len({r % 8 for r in rows}) == 8
            banks = set()
            for r in rows:
                start = (r * 128 + ((chunk ^ (r & 7)) << 4)) // 4
                banks.update((start + w) % 32 for w in range(4))
            assert len(banks) == 32
    # the rows of the four matrices are the k32 step, once each
    assert sorted(frag_k(m, j) for m in range(4) for j in range(8)) == list(range(32))


def simulate_cta(x8: np.ndarray, w8: np.ndarray, xs, sw, m0: int, n0: int):
    """One CTA of w8a8_wgmma_kernel: TMA boxes (zeros beyond the arrays), both
    warpgroups' fragments through the PTX layouts, B through the K-major
    swizzled descriptor, int32 sums, the epilogue's stores.  Returns {(m, n): value}."""
    M, K = x8.shape
    N = w8.shape[1]
    ntiles = -(-K // BK)
    acc = np.zeros((NWG, 64, BX), np.int64)
    for tile in range(ntiles):
        k0 = tile * BK
        xt = np.zeros((BX, BK), np.int8)
        wt = np.zeros((BK, BW), np.int8)
        xr = x8[m0:m0 + BX, k0:k0 + BK]
        xt[:xr.shape[0], :xr.shape[1]] = xr
        wr = w8[k0:k0 + BK, n0:n0 + BW]
        wt[:wr.shape[0], :wr.shape[1]] = wr
        x_smem, w_smem = swizzled(xt.view(np.uint8)), swizzled(wt.view(np.uint8))
        for s in range(BK // 32):
            # B: row nn (activation row) of the k32 step through the descriptor
            # (start 32 s bytes in, 8-row groups 1024 bytes apart, 128-byte swizzle)
            B = np.zeros((32, BX), np.int64)
            for nn in range(BX):
                row = x_smem[nn * 128:(nn + 1) * 128]
                for kk in range(32):
                    byte = 32 * s + kk
                    B[kk, nn] = row[(((byte >> 4) ^ (nn & 7)) << 4) + (byte & 15)].view(np.int8)
            for wgi in range(NWG):
                A = np.full((64, 32), 1 << 20, np.int64)
                for wq in range(4):
                    for lane, a in enumerate(a_fragments(w_smem, 4 * wgi + wq, s)):
                        g, t = lane >> 2, lane & 3
                        for reg in range(4):
                            row = 16 * wq + g + 8 * (reg & 1)
                            k = 4 * t + 16 * (reg >> 1)
                            A[row, k:k + 4] = word_bytes(a[reg])
                assert (np.abs(A) <= 128).all()
                acc[wgi] += A @ B
    out = {}
    for wgi in range(NWG):
        for wq in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                n = n0 + 64 * wgi + 16 * wq + 2 * g
                if n >= N:
                    continue
                for j in range(32):
                    for e in range(2):
                        m = m0 + 8 * j + 2 * t + e
                        if m >= M:
                            continue
                        for dn in range(2):
                            a = acc[wgi, 16 * wq + g + 8 * dn, 8 * j + 2 * t + e]
                            assert abs(a) < 2**31
                            v = (np.float32(a) * np.float32(xs[m])) * np.float32(sw[n + dn])
                            out[(m, n + dn)] = np.float32(v)
    return out


@pytest.mark.parametrize("M,K,N,m0,n0", [
    (256, 128, 128, 0, 0),     # one whole tile
    (300, 256, 256, 256, 128), # the ragged last row tile, the second column tile, two k tiles
    (257, 80, 144, 0, 128),    # K below one tile (zeros past K), N past the columns
], ids=["whole", "ragged-rows", "k80"])
def test_cta_product_equals_plain_bit_for_bit(M, K, N, m0, n0):
    rng = np.random.default_rng(M + K)
    x8 = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    w8 = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    x8[0, :] = 127
    w8[:, 0] = -127  # extreme sums
    xs = rng.uniform(1e-3, 1e-1, size=M).astype(np.float32)
    sw = rng.uniform(1e-4, 1e-2, size=N).astype(np.float32)
    got = simulate_cta(x8, w8, xs, sw, m0, n0)
    want = tq.w8a8_matmul_plain(torch.from_numpy(x8), torch.from_numpy(xs), torch.from_numpy(w8),
                                torch.from_numpy(sw), torch.float32).numpy()
    rows = range(m0, min(M, m0 + BX))
    cols = range(n0, min(N, n0 + BW))
    assert set(got) == {(m, n) for m in rows for n in cols}
    for (m, n), v in got.items():
        assert v.view(np.uint32) == want[m, n].view(np.uint32), (m, n)


# chip_smoke.py phase 9 and the cuda tests of tests/test_torch_kernels.py
SHAPES = [
    (2048, 4096, 6144), (2048, 4096, 4096), (2048, 4096, 28672), (2048, 14336, 4096),
    (1000, 4096, 6144), (300, 256, 384), (257, 80, 144),
    (128, 64, 128), (256, 256, 384), (1000, 512, 640), (300, 1024, 4096),
    (1, 4096, 4096), (255, 4096, 6144), (480, 4096, 6144),
]


def test_epilogue_map_is_a_bijection_onto_the_cta_tile():
    """The 256 consumer threads' (j, e, column pair) stores cover the CTA's 256
    rows x 128 columns once each."""
    seen = np.zeros((BX, BW), np.int32)
    for wgi in range(NWG):
        for wq in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                n = 64 * wgi + 16 * wq + 2 * g
                for j in range(32):
                    for e in range(2):
                        seen[8 * j + 2 * t + e, n:n + 2] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("M,K,N", SHAPES, ids=[f"M{m}-K{k}-N{n}" for m, k, n in SHAPES])
def test_grid_covers_every_output_once(M, K, N):
    """grid (ceil(M / 256), ceil(N / 128)), activation row tiles fastest; each
    CTA's tile masked to the array: every element once, the K axis in
    ceil(K / 128) tiles whose last one reads zeros past K."""
    gx, gy = -(-M // BX), -(-N // BW)
    assert gy <= 65535
    rows = np.zeros(M, np.int32)
    cols = np.zeros(N, np.int32)
    for bx in range(gx):
        rows[bx * BX:min(M, (bx + 1) * BX)] += 1
    for by in range(gy):
        cols[by * BW:min(N, (by + 1) * BW)] += 1
    assert (rows == 1).all() and (cols == 1).all()
    ntiles = -(-K // BK)
    assert ntiles * BK >= K > (ntiles - 1) * BK
    assert K % 16 == 0 and N % 16 == 0 and K < 133152  # the int32 sum cannot overflow
    # consecutive CTAs share a weight column tile: a wave of 132 reads each column tile
    # of its rows' band from HBM once
    assert gx * gy == -(-M // BX) * -(-N // BW)


# ---------------------------------------------------------------------------
# quantize_rows.cu
# ---------------------------------------------------------------------------

INV_127 = np.float32(1.0 / 127.0)


def quantize_rows_model(x: np.ndarray):
    """The kernel's steps on fp32 rows: amax by fmaxf over |x|, s = fmaxf(amax,
    1e-8f) * INV_127 in fp32, q = rintf(x / s) with an IEEE division, clamped."""
    x = x.astype(np.float32)
    amax = np.zeros(x.shape[:-1], np.float32)
    for k in range(x.shape[-1]):  # the order of a max is immaterial, done as fmaxf
        amax = np.fmax(amax, np.abs(x[..., k]))
    s = (np.fmax(amax, np.float32(1e-8)) * INV_127).astype(np.float32)
    q = np.rint(x / s[..., None]).astype(np.float32)  # numpy: IEEE fp32 division, half to even
    return np.clip(q, -127, 127).astype(np.int8), s


def _with_ties(rng, K):
    """Rows holding values that divide by their row's scale to exactly k + 0.5."""
    x = rng.normal(size=(64, K)).astype(np.float32) * 5
    _, s = quantize_rows_model(x)
    ties = 0
    for i in range(x.shape[0]):
        for j, k in enumerate(range(-60, 60, 7)):
            v = np.float32((k + 0.5) * s[i])
            if np.float32(v / s[i]) == np.float32(k + 0.5) and abs(v) < np.abs(x[i]).max():
                x[i, 1 + j] = v
                ties += 1
    assert ties > 100
    return x


def _eager_differs(rng, K):
    """Rows whose scale differs between amax * fp32(1/127) (jitted) and amax /
    127 (eager JAX)."""
    rows = []
    while len(rows) < 32:
        x = rng.normal(size=(256, K)).astype(np.float32) * rng.uniform(0.1, 9, size=(256, 1)).astype(
            np.float32)
        amax = np.abs(x).max(axis=-1)
        differ = (amax * INV_127).astype(np.float32) != (amax / np.float32(127)).astype(np.float32)
        rows += list(x[differ])
    return np.stack(rows[:32])


def _rows(kind, dtype, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = _with_ties(rng, 96)
    elif kind == "eager-differs":
        x = _eager_differs(rng, 80)
    elif kind == "zero-rows":
        x = rng.normal(size=(16, 4096)).astype(np.float32)
        x[[0, 5, 15]] = 0
        x[3] = 1e-12  # a row below the 1e-8 floor
    else:
        K = int(kind[1:])
        x = (rng.normal(size=(8, K)) * rng.uniform(0.01, 30, size=(8, 1))).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ties", "eager-differs", "zero-rows", "K80", "K4096", "K14336"])
def test_quantize_rows_kernel_model_matches_plain_and_jitted_jax(kind, dtype):
    x = _rows(kind, dtype, {"ties": 1, "eager-differs": 2, "zero-rows": 3}.get(kind, 4))
    q8, s = quantize_rows_model(x)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    p8, ps = tq.quantize_rows(tx)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    j8, js = jax.jit(jq.quantize_rows)(jx)
    np.testing.assert_array_equal(q8, p8.numpy())
    np.testing.assert_array_equal(q8, np.asarray(j8))
    np.testing.assert_array_equal(s.view(np.uint32), ps.numpy().view(np.uint32))
    np.testing.assert_array_equal(s.view(np.uint32), np.asarray(js).view(np.uint32))
    if kind == "eager-differs":
        _, es = jq.quantize_rows(jx)  # op by op: a true division by 127
        assert (np.asarray(es).view(np.uint32) != s.view(np.uint32)).any()
    if kind == "ties":
        quot = x / s[:, None]
        assert (quot == np.round(quot) + 0.5).any() or (np.abs(quot - np.trunc(quot)) == 0.5).any()
