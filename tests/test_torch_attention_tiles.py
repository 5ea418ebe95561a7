"""The bf16 attention forward kernel's algorithm, tile by tile, on the CPU.

``attention_tiled_plain`` (mimic_tpu_torch/ops/flash_attention.py) is what
``csrc/attn_mma.cuh`` computes at its own granularity: CTAs of 128 query rows,
warpgroups of 64 rows that decide together, key tiles of 64 (head dims 72 and
80) or 128 (head dim 128), scores scaled
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


@pytest.mark.parametrize("need_unmasked", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel", ["onepass_fwd", "flash_fwd"])
def test_tiled_algorithm_at_clip_head_dim(kernel, causal, need_unmasked):
    """Head dim 80 (the idefics-9b CLIP tower: 16 columns past the 64-column
    block, none of them zero-filled) at the tower's own rows: the class token and
    256 patches of a 224 px image, padded to 384 keys, the pad keys masked."""
    rng = np.random.default_rng(80)
    q = rng.normal(size=(2, 384, 2, 80)).astype(np.float32)
    k, v = (rng.normal(size=(2, 384, 2, 80)).astype(np.float32) for _ in range(2))
    km = np.zeros((2, 384), np.int32)
    km[:, :257] = 1
    skip_tiles = kernel == "flash_fwd" and not need_unmasked
    got = tfa.attention_tiled_plain(_t(q), _t(k), _t(v), _t(km), causal=causal,
                                    need_unmasked=need_unmasked, skip_tiles=skip_tiles)
    plain = [x.numpy() for x in tfa.attention_plain(_t(q), _t(k), _t(v), _t(km), causal=causal,
                                                     need_unmasked=need_unmasked)]
    jax_ref = [np.asarray(x) for x in _jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                jnp.asarray(km), causal, None, need_unmasked)]
    if not need_unmasked:
        jax_ref[2] = jax_ref[1]
    _check(got, plain, km, causal, need_unmasked, not skip_tiles, ATOL)
    _check(got, jax_ref, km, causal, need_unmasked, not skip_tiles, JAX_OUT_ATOL)


@pytest.mark.parametrize("need_unmasked", [True, False])
@pytest.mark.parametrize("kernel", ["onepass_fwd", "flash_fwd"])
def test_tiled_algorithm_at_clip_l_head_dim(kernel, need_unmasked):
    """Head dim 64 (the llava-1.5 CLIP ViT-L tower: one 64-column block, no
    tail) at the tower's own rows: the class token and 576 patches of a 336 px
    image, padded to 640 keys, the pad keys masked; non-causal, as the tower runs."""
    rng = np.random.default_rng(64)
    q, k, v = (rng.normal(size=(1, 640, 2, 64)).astype(np.float32) for _ in range(3))
    km = np.zeros((1, 640), np.int32)
    km[:, :577] = 1
    skip_tiles = kernel == "flash_fwd" and not need_unmasked
    got = tfa.attention_tiled_plain(_t(q), _t(k), _t(v), _t(km), causal=False,
                                    need_unmasked=need_unmasked, skip_tiles=skip_tiles)
    plain = [x.numpy() for x in tfa.attention_plain(_t(q), _t(k), _t(v), _t(km), causal=False,
                                                     need_unmasked=need_unmasked)]
    jax_ref = [np.asarray(x) for x in _jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                jnp.asarray(km), False, None, need_unmasked)]
    if not need_unmasked:
        jax_ref[2] = jax_ref[1]
    _check(got, plain, km, False, need_unmasked, not skip_tiles, ATOL)
    _check(got, jax_ref, km, False, need_unmasked, not skip_tiles, JAX_OUT_ATOL)


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
