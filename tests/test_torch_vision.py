"""mimic_tpu_torch.models.vision / lvlm (image side) against the JAX package, fp32.

Parameters come from the JAX initialisers through the bridge; inputs from a
numpy seed.  Tolerance: atol 1e-4 (fp32 through a few layers of matmuls).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models import vision as jv
from mimic_tpu.models.config import get_model_config
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models import vision as tv

ATOL = 1e-4


def _vcfg():
    # 70 px / patch 14 → a 5×5 grid, so a 3×4 valid region exercises the
    # bucketed positions, the key mask and the 25 → 128 padding of the flash path
    return dataclasses.replace(get_model_config("tiny-idefics2").vision, image_size=70)


def _patch_mask(B=2, n=5):
    pm = np.zeros((B, n, n), np.int32)
    pm[0, :3, :4] = 1
    pm[1] = 1
    return pm


def _to_t(tree):
    return to_torch(jax.tree.map(np.asarray, tree), device="cpu")


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=atol, rtol=1e-4)


def test_patchify():
    x = np.random.default_rng(0).normal(size=(2, 28, 42, 3)).astype(np.float32)
    np.testing.assert_array_equal(tv.patchify(torch.from_numpy(x), 14).numpy(),
                                  np.asarray(jv.patchify(jnp.asarray(x), 14)))


@pytest.mark.parametrize("region", [(5, 5), (3, 4), (1, 2), (5, 1)])
def test_bucket_position_ids(region):
    pm = np.zeros((1, 5, 5), np.int32)
    pm[0, : region[0], : region[1]] = 1
    np.testing.assert_array_equal(
        tv.bucket_position_ids(torch.from_numpy(pm)).numpy(),
        np.asarray(jv.bucket_position_ids(jnp.asarray(pm))),
    )


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
@pytest.mark.parametrize("masked", [True, False])
def test_vit_forward(attn_impl, masked):
    cfg = _vcfg()
    params = jv.init_vit_params(cfg, jax.random.PRNGKey(0))
    px = np.random.default_rng(1).normal(size=(2, 70, 70, 3)).astype(np.float32)
    pm = _patch_mask() if masked else None
    ref = jv.vit_forward(params, cfg, jnp.asarray(px),
                         patch_mask=None if pm is None else jnp.asarray(pm))
    got = tv.vit_forward(_to_t(params), cfg, torch.from_numpy(px),
                         patch_mask=None if pm is None else torch.from_numpy(pm),
                         attn_impl=attn_impl)
    assert got.shape == ref.shape == (2, 25, cfg.hidden_size)
    _close(got, ref)


@pytest.mark.parametrize("masked", [True, False])
def test_perceiver_forward(masked):
    mcfg = get_model_config("tiny-idefics2")
    params = jv.init_perceiver_params(
        mcfg.perceiver, mcfg.vision.hidden_size, mcfg.text.hidden_size,
        jax.random.PRNGKey(2), project_first=True,
    )
    feats = np.random.default_rng(3).normal(size=(2, 25, mcfg.vision.hidden_size)).astype(np.float32)
    cm = _patch_mask().reshape(2, -1) if masked else None
    ref = jv.perceiver_forward(params, mcfg.perceiver, jnp.asarray(feats), norm_eps=1e-5,
                               context_mask=None if cm is None else jnp.asarray(cm))
    got = tv.perceiver_forward(_to_t(params), mcfg.perceiver, torch.from_numpy(feats),
                               norm_eps=1e-5,
                               context_mask=None if cm is None else torch.from_numpy(cm))
    _close(got, ref)


def test_encode_images_and_splice():
    mcfg = get_model_config("tiny-idefics2")
    mcfg = mcfg.replace(vision=_vcfg())
    params = jlvlm.init_lvlm_params(mcfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    px = rng.normal(size=(2, 1, 70, 70, 3)).astype(np.float32)
    pm = _patch_mask()[:, None]
    ref = jlvlm.encode_images(params, mcfg, jnp.asarray(px), jnp.asarray(pm))
    params_t = _to_t(params)
    got = tlvlm.encode_images(params_t, mcfg, torch.from_numpy(px), torch.from_numpy(pm),
                              attn_impl="flash")
    assert got.shape == ref.shape == (2, mcfg.image_seq_len, mcfg.text.hidden_size)
    _close(got, ref)

    ids = np.array([[7, 99, 8, 99, 99, 9, 99, 1], [99, 99, 99, 99, 3, 3, 3, 3]])
    emb = rng.normal(size=(2, 8, mcfg.text.hidden_size)).astype(np.float32)
    np.testing.assert_array_equal(
        tlvlm.splice_image_embeds(torch.from_numpy(emb), got, torch.from_numpy(ids), 99).numpy(),
        np.asarray(jlvlm.splice_image_embeds(jnp.asarray(emb), jnp.asarray(got.numpy()),
                                             jnp.asarray(ids), 99)),
    )
