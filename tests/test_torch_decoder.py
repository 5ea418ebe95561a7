"""mimic_tpu_torch.models.decoder against the JAX package, fp32, with a MimIC shift.

``tiny_text(head_dim=128)`` with a 128-token left-padded prompt, so that
``select_attn_path`` picks ``"flash"`` on both sides: JAX runs its flash path
(its plain-XLA branch at this size), the port its attention wrapper (the
plain version on the CPU).  Covered: cache-empty prefill and one cached decode
step, ``logz2`` masked and unmasked.  Tolerance: atol/rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import get_preset
from mimic_tpu.models import decoder as jd
from mimic_tpu.models.config import tiny_text
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import decoder as td
from torch.distributed.device_mesh import init_device_mesh
from torch_dist import one_rank_group

B, T, NEW = 2, 128, 4
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run many small ops: one thread each, not a pool that every
    op must wake (beside the other test workers the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_text("idefics2", head_dim=128).text
    params = jd.init_decoder_params(cfg, jax.random.PRNGKey(0))
    enc_cfg, _ = get_preset("mimic")
    shift = init_shift_params(enc_cfg, cfg, jax.random.PRNGKey(1))
    # a shift large enough that log Z2 visibly moves the outputs
    shift["attn_v"] = shift["attn_v"] * 500.0
    rng = np.random.default_rng(2)
    embeds = rng.normal(size=(B, T, cfg.hidden_size)).astype(np.float32)
    step_embeds = rng.normal(size=(B, 1, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[0, :20] = 0  # left padding: rows with no attendable key in prefill
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return cfg, np_tree(params), np_tree(shift), embeds, step_embeds, mask


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("logz2", ["unmasked", "masked"])
@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_prefill_and_decode_step_match_jax(setup, logz2, attn_impl):
    cfg, params, shift, embeds, step_embeds, mask = setup
    total = T + NEW
    j = jnp.asarray

    # --- JAX: cache-empty prefill, then one cached decode step
    jd.ATTN_PATH_LOG.clear()
    cache_j = jd.init_kv_cache(cfg, B, total)
    out_j = jd.decoder_forward(
        params, cfg, j(embeds), jd.make_causal_mask(j(mask)), jd.positions_from_mask(j(mask)),
        shift=shift, kv_cache=cache_j, key_mask=j(mask), cache_empty=True,
        attn_impl=attn_impl, logz2=logz2,
    )
    mask_full = np.concatenate([mask, np.zeros((B, NEW), np.int32)], axis=1)
    mask_full[:, T] = 1
    pos1 = mask.sum(-1)[:, None]
    step_j = jd.decoder_forward(
        params, cfg, j(step_embeds), None, j(pos1), shift=shift,
        kv_cache=out_j.kv_cache, key_mask=j(mask_full), logz2=logz2,
    )
    jax_paths = list(jd.ATTN_PATH_LOG)

    # --- port
    td.ATTN_PATH_LOG.clear()
    params_t, shift_t = to_torch(params, "cpu"), to_torch(shift, "cpu")
    mask_t = torch.from_numpy(mask)
    cache_t = td.init_kv_cache(cfg, B, total, "cpu")
    out_t = td.decoder_forward(
        params_t, cfg, torch.from_numpy(embeds), td.make_causal_mask(mask_t),
        td.positions_from_mask(mask_t), shift=shift_t, kv_cache=cache_t, key_mask=mask_t,
        cache_empty=True, attn_impl=attn_impl, logz2=logz2,
    )
    assert out_t.kv_cache["length"] == T
    _close(out_t.hidden, out_j.hidden)
    _close(out_t.kv_cache["k"][:, :, :T], out_j.kv_cache["k"][:, :, :T])
    _close(out_t.kv_cache["v"][:, :, :T], out_j.kv_cache["v"][:, :, :T])
    step_t = td.decoder_forward(
        params_t, cfg, torch.from_numpy(step_embeds), None, torch.from_numpy(pos1),
        shift=shift_t, kv_cache=out_t.kv_cache, key_mask=torch.from_numpy(mask_full),
        logz2=logz2,
    )
    assert step_t.kv_cache["length"] == T + 1
    _close(step_t.hidden, step_j.hidden)
    _close(step_t.kv_cache["k"][:, :, : T + 1], step_j.kv_cache["k"][:, :, : T + 1])
    assert td.ATTN_PATH_LOG == jax_paths == [attn_impl, "cached"]


def test_logz2_choice_changes_output(setup):
    cfg, params, shift, embeds, _, mask = setup
    params_t, shift_t = to_torch(params, "cpu"), to_torch(shift, "cpu")
    mask_t = torch.from_numpy(mask)
    outs = [
        td.decoder_forward(
            params_t, cfg, torch.from_numpy(embeds), td.make_causal_mask(mask_t),
            td.positions_from_mask(mask_t), shift=shift_t, key_mask=mask_t,
            attn_impl="flash", logz2=logz2,
        ).hidden
        for logz2 in ("masked", "unmasked")
    ]
    assert not torch.allclose(outs[0], outs[1], atol=1e-4)


def test_select_attn_path():
    cfg = tiny_text("idefics2", head_dim=128).text
    small = tiny_text("idefics2").text
    kw = dict(cacheless=True, has_key_mask=True)
    assert td.select_attn_path(cfg, "flash", 128, **kw) == "flash"
    assert td.select_attn_path(cfg, "flash", 100, **kw) == "xla"
    assert td.select_attn_path(small, "flash", 128, **kw) == "xla"
    assert td.select_attn_path(cfg, "xla", 128, **kw) == "xla"
    assert td.select_attn_path(cfg, "flash", 128, cacheless=False, has_key_mask=True) == "cached"
    for args in [(cfg, "flash", 128), (small, "flash", 100), (cfg, "xla", 256)]:
        assert td.select_attn_path(*args, **kw) == jd.select_attn_path(*args, **kw)


def test_masks_and_positions():
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 0, 1]], np.int32)
    np.testing.assert_array_equal(td.positions_from_mask(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jd.positions_from_mask(jnp.asarray(mask))))
    np.testing.assert_array_equal(td.make_causal_mask(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jd.make_causal_mask(jnp.asarray(mask))))
    np.testing.assert_array_equal(
        td.make_causal_mask(torch.from_numpy(mask), sliding_window=2).numpy(),
        np.asarray(jd.make_causal_mask(jnp.asarray(mask), sliding_window=2)))


@pytest.mark.parametrize("kwarg", [{"ring_min_len": 128}], ids=["ring_mesh"])
def test_unported_features_raise(setup, kwarg, tmp_path):
    """Ring attention is ported (a one-rank ring here; the multi-rank ring is
    tests/test_torch_ring_attention.py): the cacheless prefill with the shift
    rides the ring and matches JAX's; with gradients recorded, the gradients
    of the embeddings and the shift through the ring's backward equal those
    of the kernels' path (the name is kept from when the ring's backward
    raised); ``select_attn_path`` takes JAX's ring conditions."""
    cfg, params, shift, embeds, _, mask = setup
    j = jnp.asarray
    # the kernels' contract (a row with no attendable key is the mean of v over
    # all keys), which the ring keeps
    want = jd.decoder_forward(params, cfg, j(embeds), None, jd.positions_from_mask(j(mask)),
                              shift=shift, key_mask=j(mask), attn_impl="flash")
    mask_t = torch.from_numpy(mask)
    args = (to_torch(params, "cpu"), cfg, torch.from_numpy(embeds), None,
            td.positions_from_mask(mask_t))
    kw = dict(key_mask=mask_t, shift=to_torch(shift, "cpu"), attn_impl="ring", **kwarg)
    with one_rank_group(tmp_path):
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("sp",))
        td.ATTN_PATH_LOG.clear()
        with torch.no_grad():
            got = td.decoder_forward(*args, ring_mesh=mesh, **kw)
        assert td.ATTN_PATH_LOG == ["ring"]
        _close(got.hidden, want.hidden)
        # with gradients: the ring's backward (one diagonal block) against the
        # kernels' path, on the embeddings and the shift
        grads = {}
        for impl, extra in (("ring", dict(ring_mesh=mesh)), ("flash", {})):
            embeds_g = args[2].clone().requires_grad_()
            sh = {k: v.clone().requires_grad_() for k, v in kw["shift"].items()}
            td.ATTN_PATH_LOG.clear()
            h = td.decoder_forward(args[0], cfg, embeds_g, *args[3:],
                                   **dict(kw, shift=sh, attn_impl=impl), **extra).hidden
            assert td.ATTN_PATH_LOG == [impl]
            grads[impl] = torch.autograd.grad(h.square().sum(), [embeds_g, *sh.values()])
        for a, b in zip(grads["ring"], grads["flash"]):
            assert a.abs().max() > 0
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        path = lambda T, **k: td.select_attn_path(  # noqa: E731
            cfg, "ring", T, cacheless=True, has_key_mask=True, ring_mesh=mesh, **k)
        assert path(128, ring_min_len=128) == "ring"
        assert path(128, ring_min_len=256) == "xla"   # shorter than ring_min_len
        assert path(128, on_card=True) == "ring"      # 128-aligned chunk, head dim 128
        assert path(64, on_card=True) == "xla"        # the kernels' chunk alignment
        # on the card a pass that stays on one rank takes the kernels
        assert path(128, ring_min_len=256, on_card=True) == "flash"
    assert td.select_attn_path(cfg, "ring", 128, cacheless=True, has_key_mask=True) == \
        jd.select_attn_path(cfg, "ring", 128, cacheless=True, has_key_mask=True) == "xla"
    assert td.select_attn_path(cfg, "ring", 128, cacheless=False, has_key_mask=True) == "cached"
    assert td.select_attn_path(cfg, "ring", 128, cacheless=True, has_key_mask=True,
                               on_card=True) == "flash"


@pytest.mark.parametrize("feature", ["remat", "adapters", "prefix_flash_len"])
def test_ported_features(setup, feature):
    """remat: the same hidden states and shift gradients (1e-6) as without;
    adapters: B = 0 changes nothing (peft's convention), B != 0 does;
    prefix_flash_len: without a cache there is no prefix to merge, so the
    forward and its logged path are those without it (as in JAX)."""
    cfg, params, shift, embeds, _, mask = setup
    params_t, mask_t = to_torch(params, "cpu"), torch.from_numpy(mask)

    def run(**kw):
        sh = {k: v.clone().requires_grad_(True) for k, v in to_torch(shift, "cpu").items()}
        td.ATTN_PATH_LOG.clear()
        h = td.decoder_forward(params_t, cfg, torch.from_numpy(embeds), td.make_causal_mask(mask_t),
                               td.positions_from_mask(mask_t), shift=sh, key_mask=mask_t,
                               attn_impl="flash", **kw).hidden
        grads = torch.autograd.grad(h.square().sum(), list(sh.values()))
        return h.detach(), grads, list(td.ATTN_PATH_LOG)

    h0, g0, paths0 = run()
    if feature == "remat":
        h1, g1, paths1 = run(remat=True)
    elif feature == "adapters":
        L, D, r = cfg.num_layers, cfg.hidden_size, 4
        zero_b = {"q_a": torch.ones(L, D, r), "q_b": torch.zeros(L, r, cfg.num_heads * cfg.head_size)}
        h1, g1, paths1 = run(adapters=zero_b)
        moved = {"q_a": zero_b["q_a"], "q_b": torch.full_like(zero_b["q_b"], 0.01)}
        assert (run(adapters=moved)[0] - h0).abs().max() > 1e-3
    else:
        h1, g1, paths1 = run(prefix_flash_len=4)
    assert paths1 == paths0 == ["flash"]
    torch.testing.assert_close(h1, h0, rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
