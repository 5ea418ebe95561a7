"""The bf16 attention backward kernels' algorithm, tile by tile, on the CPU.

``flash_attention_backward_tiled_plain`` (mimic_tpu_torch/ops/flash_backward.py)
is what ``csrc/attn_bwd_mma.cuh`` computes at its own granularity: dq CTAs of
64 query rows over key tiles of 64, dkv CTAs of 64 keys over (GQA head, query
tile of 32) items split over cluster ranks and summed in rank order, the tiles
passed over without need_unmasked, the scale folded into the exponent and
applied to dq and dk at the end, and p and ds rounded to bf16 before the second
products.  The kernels run only
on a card (tests/test_torch_kernels.py); here their algorithm is held

- with rounding off, in fp32, to ``flash_attention_backward_plain``, 1e-5 of
  the largest reference entry (summation order);
- in fp32 to the JAX package's backward (``_diff_bwd_jnp``, the pullback
  ``flash_attention_diff`` takes on the CPU), 1e-5 as tests/test_torch_flash_backward.py;
- with rounding on and bf16 inputs, at 64-aligned shapes, to the Pallas backward
  kernels it replaces in interpret mode (which round p and ds the same way):
  both outputs are fp32 sums rounded once to bf16, so they may differ by one
  bf16 step at the largest value (2^-7 of it), plus the rare ds or p element
  that rounds the other way;

and the cluster plan and the visiting rules are checked on their own.
"""

import functools
import importlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.ops.flash_backward import flash_attention_backward as pallas_backward
from mimic_tpu_torch.ops import flash_attention as tfa
from mimic_tpu_torch.ops import flash_backward as tfb

jfa = importlib.import_module("mimic_tpu.ops.flash_attention")  # the package re-exports a function of that name

ATOL = 1e-5          # fp32, relative to the largest reference entry
PALLAS_BF16 = 2.0 ** -7  # one bf16 step at the largest value
PLAIN_BF16 = 1e-2    # chip_smoke.py's TOL_BWD_BF16: bf16 operands against the fp32-carrying plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiled version runs many small ops: one thread each, not a pool that
    every op must wake (under a loaded CPU the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = {"t64": (64, 64), "t128": (128, 128), "t256": (256, 256), "ragged-200": (200, 200)}
MASKS = ("left-pad-130", "interior-tile", "all-ones", "empty-row")
HEADS = {"gqa-4-1": (4, 1), "mha-1-1": (1, 1)}


def _mask(kind, B, S):
    km = np.ones((B, S), np.int32)
    if kind == "left-pad-130":
        km[0, :min(130, S - 2)] = 0  # whole padded key tiles; causal rows below see no key
    elif kind == "interior-tile":
        km[:, 64:128] = 0            # one whole key tile (none at S = 64: a partial span)
        km[1, 3:9] = 0
    elif kind == "empty-row":
        km[1] = 0                    # no attendable key anywhere in batch row 1
        km[0, :5] = 0
    return km


@functools.lru_cache(maxsize=None)
def _case(shape, mask, heads, causal, need_unmasked, lse_grads, dtype="float32"):
    """numpy inputs, bf16-representable when dtype is bfloat16, and the saved
    forward from the plain version on them."""
    T, S = SHAPES[shape]
    H, Hkv = HEADS[heads]
    B = 2
    rng = np.random.default_rng(zlib.crc32(f"{shape}/{mask}/{heads}".encode()))
    dt = getattr(torch, dtype)
    q, g_out = (torch.from_numpy(rng.normal(size=(B, T, H, 128)).astype(np.float32)).to(dt)
                for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, Hkv, 128)).astype(np.float32)).to(dt)
            for _ in range(2))
    km = torch.from_numpy(_mask(mask, B, S))
    out, lse, lse_u = tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked)
    g_lse, g_lse_u = ((torch.from_numpy(rng.normal(size=(B, T, H)).astype(np.float32))
                       if lse_grads else torch.zeros(B, T, H)) for _ in range(2))
    return (q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u)


def _close(got, want, rtol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max() + 1e-30,
                               err_msg=name)


def _f32(x):
    return x.float().numpy()


# every shape, mask, causal flag, need_unmasked and head layout with g_lse and
# g_lse_u drawn; g_lse = g_lse_u = 0 at GQA 4/1 on the three larger shapes
PLAIN_CASES = [
    pytest.param(shape, mask, causal, unm, heads, grads,
                 id=f"{shape}-{mask}-{'causal' if causal else 'noncausal'}-"
                    f"{'lse_u' if unm else 'no-lse_u'}-{heads}-{'lse-grads' if grads else 'no-lse-grads'}")
    for shape in SHAPES for mask in MASKS for causal in (True, False) for unm in (True, False)
    for heads in HEADS for grads in (True, False)
    if grads or (heads == "gqa-4-1" and shape != "t64")
]


@pytest.mark.parametrize("shape,mask,causal,need_unmasked,heads,lse_grads", PLAIN_CASES)
def test_tiled_backward_matches_plain_fp32(shape, mask, causal, need_unmasked, heads, lse_grads):
    args = _case(shape, mask, heads, causal, need_unmasked, lse_grads)
    got = tfb.flash_attention_backward_tiled_plain(*args, causal=causal,
                                                   need_unmasked=need_unmasked)
    want = tfb.flash_attention_backward_plain(*args, causal=causal, need_unmasked=need_unmasked)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(_f32(a), _f32(b), ATOL, name)


@pytest.mark.parametrize("need_unmasked", [True, False], ids=["lse_u", "no-lse_u"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("shape,mask", [("t256", "left-pad-130"), ("ragged-200", "interior-tile"),
                                        ("t128", "empty-row")])
def test_tiled_backward_matches_jax_fp32(shape, mask, causal, need_unmasked):
    args = _case(shape, mask, "gqa-4-1", causal, need_unmasked, True)
    j = [jnp.asarray(x.numpy()) for x in args]
    want = jfa._diff_bwd_jnp(causal, None, 64, 64, need_unmasked, True, tuple(j[:7]),
                             tuple(j[7:]))[:3]
    got = tfb.flash_attention_backward_tiled_plain(*args, causal=causal,
                                                   need_unmasked=need_unmasked)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(_f32(a), b, ATOL, name)


@pytest.mark.parametrize("need_unmasked", [True, False], ids=["lse_u", "no-lse_u"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("shape,mask", [("t128", "left-pad-130"), ("t256", "interior-tile")])
def test_tiled_backward_matches_pallas_bf16(shape, mask, causal, need_unmasked):
    """bf16 inputs, p and ds rounded to bf16 on both sides."""
    args = _case(shape, mask, "gqa-4-1", causal, need_unmasked, True, "bfloat16")
    got = tfb.flash_attention_backward_tiled_plain(*args, causal=causal,
                                                   need_unmasked=need_unmasked)
    assert all(x.dtype == torch.bfloat16 for x in got)
    q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u = (
        jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16 if x.dtype == torch.bfloat16 else None)
        if x.is_floating_point() else jnp.asarray(x.numpy()) for x in args)
    want = pallas_backward(q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u, causal=causal,
                           block_q=64, block_k=64, need_unmasked=need_unmasked, interpret=True)
    plain = tfb.flash_attention_backward_plain(*args, causal=causal, need_unmasked=need_unmasked)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, plain):
        _close(_f32(a), np.asarray(b.astype(jnp.float32)), PALLAS_BF16, name)
        _close(_f32(a), _f32(c), PLAIN_BF16, name + " against plain")


@pytest.mark.parametrize("split", [2, 4, 8])
@pytest.mark.parametrize("shape", ["t256", "ragged-200"])
def test_cluster_split_sums_in_rank_order(shape, split):
    """Any split gives the unsplit sum up to fp32 order (rank partials added in
    rank order), and the same bits twice."""
    args = _case(shape, "left-pad-130", "gqa-4-1", True, True, True)
    one = tfb.flash_attention_backward_tiled_plain(*args, split=1)
    got = tfb.flash_attention_backward_tiled_plain(*args, split=split)
    again = tfb.flash_attention_backward_tiled_plain(*args, split=split)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, one, again):
        assert torch.equal(a, c), name
        _close(_f32(a), _f32(b), 1e-6, name)


# (B, T, S, H, Hkv) -> split on 132 SMs
SPLIT_PLANS = {
    "shift-pass": ((2, 256, 256, 32, 8), 4),
    "shift-pass-B1": ((1, 256, 256, 32, 8), 8),
    "bwd-2048": ((1, 2048, 2048, 32, 8), 1),
    "record-2048-B2": ((2, 2048, 2048, 32, 8), 1),
    "ragged-1000": ((2, 1000, 1000, 32, 8), 1),
    "padded-512": ((2, 512, 512, 32, 8), 2),
    "no-lse_u-512": ((2, 512, 512, 32, 8), 2),
    "tiny-mha": ((1, 32, 64, 1, 1), 1),
}


@pytest.mark.parametrize("case", list(SPLIT_PLANS))
def test_dkv_split_plan(case):
    (B, T, S, H, Hkv), want = SPLIT_PLANS[case]
    split = tfb.dkv_split(B, T, S, H, Hkv, 132)
    assert split == want
    tiles = -(-S // tfb.TILE_DKV_KEYS) * Hkv * B
    items = (H // Hkv) * -(-T // tfb.TILE_DKV_ROWS)
    assert split & (split - 1) == 0 and 1 <= split <= tfb.MAX_SPLIT and split <= max(items, 1)
    # the smallest split that fills the SMs, unless the items or the cluster run out
    assert tiles * split >= 132 or split == tfb.MAX_SPLIT or 2 * split > items
    assert split == 1 or tiles * (split // 2) < 132


def test_dkv_split_over_many_shapes():
    for B in (1, 2, 4):
        for T in (17, 64, 256, 640, 2048):
            for H, Hkv in ((32, 8), (4, 1), (8, 8)):
                for sms in (1, 16, 132):
                    s = tfb.dkv_split(B, T, T, H, Hkv, sms)
                    items = (H // Hkv) * -(-T // tfb.TILE_DKV_ROWS)
                    assert s in (1, 2, 4, 8) and (s == 1 or 2 * (s // 2) <= items)


def _visits(shape, mask, causal, need_unmasked, heads="gqa-4-1"):
    args = _case(shape, mask, heads, causal, need_unmasked, True)
    visits = {}
    tfb.flash_attention_backward_tiled_plain(*args, causal=causal, need_unmasked=need_unmasked,
                                             visits=visits)
    return visits


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("mask", ["left-pad-130", "empty-row"])
def test_need_unmasked_visits_every_tile(mask, causal):
    """Tiles above the diagonal and wholly padded ones carry g_lse_u p_u."""
    T, S = SHAPES["t256"]
    H, Hkv = HEADS["gqa-4-1"]
    v = _visits("t256", mask, causal, True)
    assert v["dq_tiles"] == 2 * H * (T // tfb.TILE_DQ_ROWS) * (S // tfb.TILE_DQ_KEYS)
    assert v["dkv_items"] == 2 * Hkv * (S // tfb.TILE_DKV_KEYS) * (H // Hkv) * (T // tfb.TILE_DKV_ROWS)


@pytest.mark.parametrize("mask", ["left-pad-130", "all-ones", "empty-row"])
def test_without_need_unmasked_tiles_that_add_nothing_are_skipped(mask):
    T, S = SHAPES["t256"]
    H, Hkv = HEADS["gqa-4-1"]
    causal_v = _visits("t256", mask, True, False)
    full_v = _visits("t256", mask, False, False)
    # causal: only the tiles at or below the CTA's diagonal
    n_q, n_k = T // tfb.TILE_DQ_ROWS, S // tfb.TILE_DQ_KEYS
    below = sum(min(n_k, (q0 + tfb.TILE_DQ_ROWS - 1) // tfb.TILE_DQ_KEYS + 1)
                for q0 in range(0, T, tfb.TILE_DQ_ROWS))
    assert causal_v["dq_tiles"] < full_v["dq_tiles"] <= 2 * H * n_q * n_k
    assert causal_v["dkv_items"] < full_v["dkv_items"]
    # key tiles without an attendable key are passed over
    km = _mask(mask, 2, S)
    live = sum(int(km[b, k0:k0 + tfb.TILE_DQ_KEYS].any()) for b in range(2)
               for k0 in range(0, S, tfb.TILE_DQ_KEYS))
    assert full_v["dq_tiles"] == H * n_q * live
    if mask == "all-ones":
        assert causal_v["dq_tiles"] == 2 * H * below


@pytest.mark.parametrize("lse_grads", [True, False], ids=["lse-grads", "no-lse-grads"])
def test_rows_without_keys_keep_only_their_p_u_terms(lse_grads):
    """Batch row 1 has no attendable key: p = 0 there (dv is exactly 0 and dq
    carries only g_lse_u p_u), in the tiled version as in the plain one."""
    args = _case("t128", "empty-row", "gqa-4-1", True, True, lse_grads)
    for fn in (tfb.flash_attention_backward_tiled_plain, tfb.flash_attention_backward_plain):
        dq, dk, dv = fn(*args)
        assert torch.equal(dv[1], torch.zeros_like(dv[1]))
        assert bool((dq[1] != 0).any()) == lse_grads
        assert bool((dk[1] != 0).any()) == lse_grads
    without = tfb.flash_attention_backward_tiled_plain(*args, need_unmasked=False)
    assert torch.equal(without[0][1], torch.zeros_like(without[0][1]))
