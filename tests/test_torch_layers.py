"""mimic_tpu_torch.models.layers and shift.functional against the JAX package (fp32).

Inputs are drawn from a numpy seed and fed to both sides; tolerances are fp32
summation-order bounds (atol 1e-5 unless stated)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.models import layers as jl
from mimic_tpu.shift import functional as jf
from mimic_tpu_torch.models import layers as tl
from mimic_tpu_torch.shift import functional as tf

ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 16), _rand(rng, 16)
    _close(tl.rms_norm(_t(x), _t(w), 1e-5), jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm(with_bias):
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 2, 5, 16), _rand(rng, 16), _rand(rng, 16)
    bias_t, bias_j = (_t(b), jnp.asarray(b)) if with_bias else (None, None)
    _close(tl.layer_norm(_t(x), _t(w), bias_t, 1e-6),
           jl.layer_norm(jnp.asarray(x), jnp.asarray(w), bias_j, 1e-6))


@pytest.mark.parametrize("head_dim", [16, 128])
def test_rope_cos_sin_and_apply(head_dim):
    rng = np.random.default_rng(2)
    pos = np.array([[0, 0, 0, 1, 2, 3], [0, 1, 2, 3, 4, 5]], np.int32)
    cos_t, sin_t = tl.rope_cos_sin(_t(pos), head_dim, 10000.0)
    cos_j, sin_j = jl.rope_cos_sin(jnp.asarray(pos), head_dim, 10000.0)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    q, k = _rand(rng, 2, 6, 4, head_dim), _rand(rng, 2, 6, 2, head_dim)
    qt, kt = tl.apply_rope(_t(q), _t(k), cos_t, sin_t)
    qj, kj = jl.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j)
    _close(qt, qj)
    _close(kt, kj)


@pytest.mark.parametrize("groups", [1, 4])
def test_repeat_kv(groups):
    x = _rand(np.random.default_rng(3), 2, 5, 2, 8)
    np.testing.assert_array_equal(
        tl.repeat_kv(_t(x), groups).numpy(), np.asarray(jl.repeat_kv(jnp.asarray(x), groups))
    )


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_with_lse(masked):
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 2, 6, 4, 16), _rand(rng, 2, 9, 4, 16), _rand(rng, 2, 9, 4, 16)
    mask = None
    if masked:
        m = np.tril(np.ones((6, 9), bool), k=3)[None, None] & (rng.random((2, 1, 1, 9)) > 0.3)
        m[0, 0, 2] = False  # one row with no attendable key: finite, uniform mean of v
        mask = m
    out_t, lse_t = tl.sdpa_with_lse(_t(q), _t(k), _t(v), None if mask is None else _t(mask))
    out_j, lse_j = jl.sdpa_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    None if mask is None else jnp.asarray(mask))
    assert torch.isfinite(out_t).all()
    _close(out_t, out_j)
    # lse of a row with no key sits at NEG_INF + log(S); compare with rtol there
    _close(lse_t, lse_j, atol=1e-5, rtol=1e-6)


def test_unmasked_lse():
    rng = np.random.default_rng(5)
    q, k = _rand(rng, 2, 6, 4, 16), _rand(rng, 2, 9, 4, 16)
    _close(tl.unmasked_lse(_t(q), _t(k)), jl.unmasked_lse(jnp.asarray(q), jnp.asarray(k)))


def test_swiglu_mlp():
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 5, 16)
    g, u, d = _rand(rng, 16, 32, scale=0.2), _rand(rng, 16, 32, scale=0.2), _rand(rng, 32, 16, scale=0.2)
    _close(tl.swiglu_mlp(_t(x), _t(g), _t(u), _t(d)),
           jl.swiglu_mlp(jnp.asarray(x), jnp.asarray(g), jnp.asarray(u), jnp.asarray(d)))


@pytest.mark.parametrize("kind", ["gelu_tanh", "gelu", "quick_gelu"])
def test_gelu_act(kind):
    x = _rand(np.random.default_rng(7), 3, 40, scale=3.0)
    _close(tl.gelu_act(_t(x), kind), jl.gelu_act(jnp.asarray(x), kind))


def _cached_inputs(rng, B0, beams, T, S_gen, Sp, H=4, Hkv=2, D=16):
    B = B0 * beams
    q = _rand(rng, B, T, H, D)
    k_new, v_new = _rand(rng, B, T, Hkv, D), _rand(rng, B, T, Hkv, D)
    cache_k, cache_v = _rand(rng, B, S_gen, Hkv, D), _rand(rng, B, S_gen, Hkv, D)
    prompt_k, prompt_v = _rand(rng, B0, Sp, Hkv, D), _rand(rng, B0, Sp, Hkv, D)
    prompt_mask = np.ones((B0, Sp), np.int32)
    prompt_mask[0, :3] = 0        # left padding
    prompt_mask[-1, Sp // 2] = 0  # an interior pad
    key_mask = np.ones((B, S_gen), np.int32)
    key_mask_new = np.ones((B, T), np.int32)
    return (q, k_new, v_new, cache_k, cache_v, key_mask, key_mask_new,
            prompt_k, prompt_v, prompt_mask)


@pytest.mark.parametrize("need_unmasked", [True, False])
@pytest.mark.parametrize("written", [0, 3])
def test_cached_attention_beam_shared_prompt(need_unmasked, written):
    rng = np.random.default_rng(8 + written)
    B0, beams, T, S_gen, Sp = 2, 3, 1, 5, 12
    (q, k_new, v_new, ck, cv, km, kmn, pk, pv, pm) = _cached_inputs(rng, B0, beams, T, S_gen, Sp)
    cache_len = Sp + written
    out_t = tl.cached_attention(
        _t(q), _t(k_new), _t(v_new), _t(ck), _t(cv), cache_len, _t(km), _t(kmn),
        prompt_k=_t(pk), prompt_v=_t(pv), prompt_mask=_t(pm), need_unmasked=need_unmasked,
    )
    j = jnp.asarray
    out_j = jl.cached_attention(
        j(q), j(k_new), j(v_new), j(ck), j(cv), j(cache_len), j(km), j(kmn),
        prompt_k=j(pk), prompt_v=j(pv), prompt_mask=j(pm), need_unmasked=need_unmasked,
    )
    for a, b in zip(out_t, out_j):
        _close(a, b)


def test_cached_attention_plain_cache_multi_token():
    rng = np.random.default_rng(11)
    B, T, S, H, Hkv, D = 2, 3, 8, 4, 2, 16
    q = _rand(rng, B, T, H, D)
    k_new, v_new = _rand(rng, B, T, Hkv, D), _rand(rng, B, T, Hkv, D)
    ck, cv = _rand(rng, B, S, Hkv, D), _rand(rng, B, S, Hkv, D)
    km = np.ones((B, S), np.int32)
    km[1, :2] = 0
    kmn = np.ones((B, T), np.int32)
    out_t = tl.cached_attention(_t(q), _t(k_new), _t(v_new), _t(ck), _t(cv), 5, _t(km), _t(kmn))
    j = jnp.asarray
    out_j = jl.cached_attention(j(q), j(k_new), j(v_new), j(ck), j(cv), j(5), j(km), j(kmn))
    for a, b in zip(out_t, out_j):
        _close(a, b)


def test_cached_attention_int8_prompt_not_ported():
    rng = np.random.default_rng(12)
    (q, k_new, v_new, ck, cv, km, kmn, pk, pv, pm) = _cached_inputs(rng, 1, 2, 1, 4, 8)
    with pytest.raises(NotImplementedError):
        tl.cached_attention(_t(q), _t(k_new), _t(v_new), _t(ck), _t(cv), 8, _t(km), _t(kmn),
                            prompt_k={"q8": _t(pk)}, prompt_v={"q8": _t(pv)},
                            prompt_mask=_t(pm))


# ---------------------------------------------------------------------------
# shift math
# ---------------------------------------------------------------------------


def _layer_shift(rng, multi, learnable, H=4, Dh=16):
    ls = {"attn_v": _rand(rng, H, Dh) if multi else _rand(rng, H * Dh)}
    if learnable:
        ls["attn_logz1_w"] = _rand(rng, H, Dh, scale=0.1) if multi else _rand(rng, H * Dh, scale=0.1)
        ls["attn_logz1_b"] = _rand(rng, H) if multi else _rand(rng, 1)
    return ls


@pytest.mark.parametrize("multi", [True, False])
@pytest.mark.parametrize("learnable", [True, False])
def test_attn_shift(multi, learnable):
    rng = np.random.default_rng(13)
    ls = _layer_shift(rng, multi, learnable)
    q, log_z2, attn = _rand(rng, 2, 5, 4, 16), _rand(rng, 2, 5, 4), _rand(rng, 2, 5, 4, 16)
    ls_t = {k: _t(v) for k, v in ls.items()}
    ls_j = {k: jnp.asarray(v) for k, v in ls.items()}
    _close(tf.attn_shift_delta(ls_t, _t(q), _t(log_z2), multi),
           jf.attn_shift_delta(ls_j, jnp.asarray(q), jnp.asarray(log_z2), multi))
    _close(tf.apply_attn_shift(ls_t, _t(q), _t(log_z2), _t(attn), multi),
           jf.apply_attn_shift(ls_j, jnp.asarray(q), jnp.asarray(log_z2), jnp.asarray(attn), multi))
    assert tf.attn_shift_delta({}, _t(q), _t(log_z2), multi) is None


@pytest.mark.parametrize("with_shift", [True, False])
def test_output_shift(with_shift):
    rng = np.random.default_rng(14)
    h, s, sc = _rand(rng, 2, 5, 16), _rand(rng, 16), np.float32(0.7)
    if with_shift:
        _close(tf.norm_preserving_shift(_t(h), _t(s), torch.tensor(sc)),
               jf.norm_preserving_shift(jnp.asarray(h), jnp.asarray(s), jnp.asarray(sc)))
        _close(tf.apply_output_shift(_t(h), _t(s), None),
               jf.apply_output_shift(jnp.asarray(h), jnp.asarray(s), None))
    else:
        assert tf.apply_output_shift(_t(h), None, None) is not None
        np.testing.assert_array_equal(tf.apply_output_shift(_t(h), None, None).numpy(), h)
