"""The bf16 attention forward kernel's algorithm, tile by tile, on the CPU.

``attention_tiled_plain`` (mimic_tpu_torch/ops/flash_attention.py) is what
``csrc/attn_mma.cuh`` computes at its own granularity: CTAs of 128 query rows
(64 at head dims 64 and 80), warpgroups of 64 rows that decide together, key
tiles of 64 (head dims 64, 72 and 80) or 128 (head dim 128), scores scaled
after the product, an online softmax in the log2 domain, bf16-rounded p with
fp32 row sums, and the two tile-visiting rules (``onepass_fwd``: every tile is
looked at; ``flash_fwd`` without ``need_unmasked``: the sweep ends at the
causal diagonal and wholly masked tiles are passed over).  The kernel itself
runs only on a card (tests/test_torch_kernels.py); here its algorithm is held,
in fp32, to

- ``attention_plain``, 1e-5, and
- the JAX package's ``_sdpa_fallback`` (what ``flash_attention`` takes on the
  CPU for these shapes) and, at aligned shapes, its two Pallas kernels in
  interpret mode, as tests/test_flash_attention.py runs them:

``lse_unmasked`` on every row whatever is skipped, ``out`` and ``lse`` on rows
with an attendable key, and ``out`` on every row where every key is looked at;
rows without an attendable key are finite everywhere.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu_torch.ops import flash_attention as tfa
from test_torch_kernels import _t, _valid_rows

jfa = importlib.import_module("mimic_tpu.ops.flash_attention")

ATOL = 1e-5  # fp32: summation order, and ln against log2 arithmetic
JAX_OUT_ATOL = 2e-5  # as tests/test_torch_attention.py holds the plain version to JAX

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiled version runs many small ops: one thread each, not a pool that
    every op must wake (under a loaded CPU the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = {"aligned": (256, 256), "ragged": (200, 200), "ragged-t100-s200": (100, 200),
          "t128-s320": (128, 320)}
MASKS = ("left-padded", "interior-zero-tiles", "all-ones")


def _mask(kind, B, S):
    km = np.ones((B, S), np.int32)
    if kind == "left-padded":
        km[0, :70] = 0  # the first whole key tile and a part of the second
        km[1, :5] = 0
    elif kind == "interior-zero-tiles":
        km[:, 64:192] = 0  # two whole key tiles
        km[0, 10:13] = 0
    return km


@functools.lru_cache(maxsize=None)
def _inputs(shape, mask, D):
    T, S = SHAPES[shape]
    rng = np.random.default_rng(1000 * T + S + D + MASKS.index(mask))
    # two query heads on one kv head: GQA at the least work per case
    q = rng.normal(size=(2, T, 2, D)).astype(np.float32)
    k, v = (rng.normal(size=(2, S, 1, D)).astype(np.float32) for _ in range(2))
    return q, k, v, _mask(mask, 2, S)


_jax_sdpa = jax.jit(jfa._sdpa_fallback, static_argnums=(4, 5, 6))


@functools.lru_cache(maxsize=None)
def _references_all_masks(shape, D, causal):
    """Both references for every mask of MASKS, as one batch of 2 * len(MASKS)
    rows, with lse_unmasked: one compiled JAX call per shape and causal flag
    (its compilation is most of a case's cost).  out and lse do not depend on
    need_unmasked."""
    q, k, v, km = (np.concatenate(x) for x in zip(*(_inputs(shape, m, D) for m in MASKS)))
    plain = tfa.attention_plain(_t(q), _t(k), _t(v), _t(km), causal=causal)
    jax_ref = _jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
                        causal, None, True)
    return [x.numpy() for x in plain], [np.asarray(x) for x in jax_ref]


def _references(shape, mask, D, causal, need_unmasked):
    """(plain, JAX) for one mask; without need_unmasked lse_unmasked is lse."""
    i = MASKS.index(mask)
    out = []
    for ref in _references_all_masks(shape, D, causal):
        o, lse, lse_u = (x[2 * i:2 * i + 2] for x in ref)
        out.append([o, lse, lse_u if need_unmasked else lse])
    return out


def _check(got, want, km, causal, need_unmasked, every_key, out_atol):
    out, lse, lse_u = (x.numpy() for x in got)
    T = out.shape[1]
    valid = _valid_rows(km, T, causal)
    assert np.isfinite(out).all() and np.isfinite(lse).all() and np.isfinite(lse_u).all()
    rows = np.ones_like(valid) if every_key else valid
    np.testing.assert_allclose(out[rows], want[0][rows], atol=out_atol, rtol=0)
    np.testing.assert_allclose(lse[valid], want[1][valid], atol=ATOL, rtol=0)
    if need_unmasked:  # over every key < S, whatever the masks and the skipping
        np.testing.assert_allclose(lse_u, want[2], atol=ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(lse_u, lse)


@pytest.mark.parametrize("D", [72, 128])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("need_unmasked", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel", ["onepass_fwd", "flash_fwd"])
def test_tiled_algorithm_matches_plain_and_jax(kernel, causal, need_unmasked, mask, shape, D):
    q, k, v, km = _inputs(shape, mask, D)
    skip_tiles = kernel == "flash_fwd" and not need_unmasked
    got = tfa.attention_tiled_plain(_t(q), _t(k), _t(v), _t(km), causal=causal,
                                    need_unmasked=need_unmasked, skip_tiles=skip_tiles)
    plain, jax_ref = _references(shape, mask, D, causal, need_unmasked)
    _check(got, plain, km, causal, need_unmasked, not skip_tiles, ATOL)
    _check(got, jax_ref, km, causal, need_unmasked, not skip_tiles, JAX_OUT_ATOL)


@pytest.mark.parametrize("shape", ["aligned", "ragged"])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("need_unmasked", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel", ["onepass_fwd", "flash_fwd"])
def test_tiled_algorithm_at_latent_attention_widths(kernel, causal, need_unmasked, mask, shape):
    """q / k heads 192 wide and v heads 128 (Kimi-VL's MLA), the kernel's
    128-row CTAs and 128-key tiles, against the plain version (the JAX package
    has no such heads): out 128 wide, scores scaled by 1/sqrt(192)."""
    q, _, _, km = _inputs(shape, mask, 192)
    _, k, v, _ = _inputs(shape, mask, 128)
    k = np.concatenate([k, k[..., :64] * 0.5], -1)  # 192-wide keys
    assert tfa.TILE_BLOCK_M[192] == 128 and tfa.TILE_BLOCK_N[192] == 128
    skip_tiles = kernel == "flash_fwd" and not need_unmasked
    got = tfa.attention_tiled_plain(_t(q), _t(k), _t(v), _t(km), causal=causal,
                                    need_unmasked=need_unmasked, skip_tiles=skip_tiles)
    assert got[0].shape[-1] == 128
    want = tfa.attention_plain(_t(q), _t(k), _t(v), _t(km), causal=causal,
                               need_unmasked=need_unmasked)
    _check(got, [x.numpy() for x in want], km, causal, need_unmasked, not skip_tiles, ATOL)


@pytest.mark.parametrize("D", [72, 128])
@pytest.mark.parametrize("need_unmasked", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel", ["onepass_fwd", "flash_fwd"])
def test_tiled_algorithm_matches_jax_pallas_kernels(kernel, causal, need_unmasked, D):
    """Against the Pallas kernel each CUDA kernel replaces, in interpret mode."""
    q, k, v, km = _inputs("aligned", "left-padded", D)
    args = [jnp.asarray(x) for x in (q, k, v, km)]
    if kernel == "onepass_fwd":
        ref = jfa.onepass_attention(*args, causal=causal, need_unmasked=need_unmasked,
                                    interpret=True)
    else:
        ref = jfa.flash_attention(*args, causal=causal, need_unmasked=need_unmasked,
                                  block_q=64, block_k=64, interpret=True)
    skip_tiles = kernel == "flash_fwd" and not need_unmasked
    got = tfa.attention_tiled_plain(_t(q), _t(k), _t(v), _t(km), causal=causal,
                                    need_unmasked=need_unmasked, skip_tiles=skip_tiles)
    # the JAX online kernel averages only the blocks it visited on rows with no
    # attendable key, under either flag: compare its out on the other rows
    _check(got, [np.asarray(x) for x in ref], km, causal, need_unmasked,
           kernel == "onepass_fwd", JAX_OUT_ATOL)


# The CLIP towers' rows and the edges of their one-warpgroup tiling (64 query rows a
# CTA, the sweep ended at the batch's last attendable key when every row may drop
# the tiles past it): the tower's own rows; T not a multiple of 64 with a batch
# left-padded past its first key tile; keys only inside the second and third
# tiles, so leading and trailing tiles are wholly masked and causal rows before
# the first key have none, beside a batch with no attendable key at all
CLIP_CASES = ("tower", "ragged-rows", "masked-ends")


def _clip_inputs(case, B, T, S, Hkv, D, live, seed):
    rng = np.random.default_rng(seed)
    if case == "ragged-rows":
        T = 200
    q = rng.normal(size=(B, T, 2, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    km = np.zeros((B, S), np.int32)
    km[:, :live] = 1
    if case == "ragged-rows":
        km[-1, :70] = 0
    elif case == "masked-ends":
        km[:] = 0
        km[0, 100:150] = 1  # batch 1 (or the second half of the rows) has no key
        if B == 1:
            q = np.concatenate([q, q[:, ::-1]])
            k, v = (np.concatenate([x, x[:, ::-1]]) for x in (k, v))
            km = np.concatenate([km, np.zeros_like(km)])
    return q, k, v, km


def _check_clip_case(kernel, causal, need_unmasked, q, k, v, km):
    """The tiled version against the plain version and JAX's fallback, and against
    the Pallas kernel its CUDA kernel replaces, in interpret mode."""
    skip_tiles = kernel == "flash_fwd" and not need_unmasked
    got = tfa.attention_tiled_plain(_t(q), _t(k), _t(v), _t(km), causal=causal,
                                    need_unmasked=need_unmasked, skip_tiles=skip_tiles)
    plain = [x.numpy() for x in tfa.attention_plain(_t(q), _t(k), _t(v), _t(km), causal=causal,
                                                     need_unmasked=need_unmasked)]
    args = [jnp.asarray(x) for x in (q, k, v, km)]
    jax_ref = [np.asarray(x) for x in _jax_sdpa(*args, causal, None, need_unmasked)]
    if kernel == "onepass_fwd":
        pallas = jfa.onepass_attention(*args, causal=causal, need_unmasked=need_unmasked,
                                       interpret=True)
    else:
        pallas = jfa.flash_attention(*args, causal=causal, need_unmasked=need_unmasked,
                                     block_q=64, block_k=64, interpret=True)
    pallas = [np.asarray(x) for x in pallas]
    if not need_unmasked:
        jax_ref[2] = jax_ref[1]
        pallas[2] = pallas[1]
    _check(got, plain, km, causal, need_unmasked, not skip_tiles, ATOL)
    _check(got, jax_ref, km, causal, need_unmasked, not skip_tiles, JAX_OUT_ATOL)
    # the JAX online kernel averages only the blocks it visited on rows with no
    # attendable key, under either flag: its out is compared on the other rows
    _check(got, pallas, km, causal, need_unmasked, kernel == "onepass_fwd", JAX_OUT_ATOL)


@pytest.mark.parametrize("case", CLIP_CASES)
@pytest.mark.parametrize("need_unmasked", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel", ["onepass_fwd", "flash_fwd"])
def test_tiled_algorithm_at_clip_head_dim(kernel, causal, need_unmasked, case):
    """Head dim 80 (the idefics-9b CLIP tower: 16 columns past the 64-column
    block, none of them zero-filled) at the tower's own rows: the class token and
    256 patches of a 224 px image, padded to 384 keys, the pad keys masked; and
    the tiling's edges (CLIP_CASES)."""
    q, k, v, km = _clip_inputs(case, 2, 384, 384, 2, 80, 257, 80)
    _check_clip_case(kernel, causal, need_unmasked, q, k, v, km)


@pytest.mark.parametrize("case", CLIP_CASES)
@pytest.mark.parametrize("need_unmasked", [True, False])
@pytest.mark.parametrize("kernel", ["onepass_fwd", "flash_fwd"])
def test_tiled_algorithm_at_clip_l_head_dim(kernel, need_unmasked, case):
    """Head dim 64 (the llava-1.5 CLIP ViT-L tower: one 64-column block, no
    tail) at the tower's own rows: the class token and 576 patches of a 336 px
    image, padded to 640 keys, the pad keys masked; non-causal, as the tower runs;
    and the tiling's edges (CLIP_CASES)."""
    q, k, v, km = _clip_inputs(case, 1, 640, 640, 2, 64, 577, 64)
    _check_clip_case(kernel, False, need_unmasked, q, k, v, km)


@pytest.mark.parametrize("case", CLIP_CASES)
@pytest.mark.parametrize("need_unmasked", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel", ["onepass_fwd", "flash_fwd"])
def test_tiled_algorithm_at_d72_tower_rows(kernel, causal, need_unmasked, case):
    """Head dim 72 (two warpgroups of 64 rows a CTA, 64-key tiles, the sweep ended at
    the batch's last attendable key, as at 64 and 80): keys live up to 200 of 384,
    so the last two key tiles hold none and the sweep ends before them; and the
    tiling's edges (CLIP_CASES)."""
    assert (tfa.TILE_BLOCK_M[72], tfa.TILE_BLOCK_N[72]) == (128, 64)
    assert 72 in tfa.TILE_SWEEP_ENDS_AT_LAST_KEY
    q, k, v, km = _clip_inputs(case, 2, 384, 384, 2, 72, 200, 72)
    _check_clip_case(kernel, causal, need_unmasked, q, k, v, km)


def test_rows_without_keys_follow_each_kernels_rule():
    q, k, v, km = _inputs("aligned", "left-padded", 72)
    args = [_t(x) for x in (q, k, v, km)]
    every = tfa.attention_tiled_plain(*args, causal=True, need_unmasked=False)[0]
    skipping = tfa.attention_tiled_plain(*args, causal=True, need_unmasked=False,
                                         skip_tiles=True)[0]
    # batch 0, row 3: its keys 0..3 are padding
    np.testing.assert_allclose(every[0, 3, 0].numpy(), v[0, :, 0].mean(0), atol=1e-5)
    assert torch.isfinite(skipping).all()
    assert (skipping[0, 3] - every[0, 3]).abs().max() > 1e-3  # the visited tiles only
    valid = torch.from_numpy(_valid_rows(km, 256, True).copy())
    assert (skipping[valid] - every[valid]).abs().max() <= 1e-6
