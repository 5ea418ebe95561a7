"""mimic_tpu_torch.ops.decode_attention and the int8-prompt branch of
``cached_attention`` against the JAX package.

- ``quantize_prompt_kv``: the same ``q8`` bytes and fp32 ``scale`` bits as
  ``mimic_tpu.ops.decode_attention``, in fp32 and bf16, and with the prompt
  region zero-padded to a multiple of 128 as beam search pads it.
- ``prompt_attention_int8``'s plain version (what a CPU tensor runs) against
  the JAX Pallas kernel in interpret mode, over several 128-key blocks with
  left-padded rows and a fully masked first block: fp32 ``o``/``l`` within
  1e-5 of max |reference| and ``m`` within 1e-5 absolute; bf16 ``o``/``l``
  within 1e-2 (``p·vscale`` is rounded to bf16 against the block's running max
  in JAX, against the row's max here) and ``m`` within 1e-3.
- ``cached_attention`` with a quantized prompt against JAX's (its Pallas
  kernel in interpret mode), fp32 within 1e-5, and the same rejection of
  ``need_unmasked``.
- One ``decoder_forward`` decode step over a quantized prompt cache against
  JAX's, fp32 within 1e-5, with the path logged once per call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.models import decoder as jd
from mimic_tpu.models import layers as jlayers
from mimic_tpu.models.config import tiny_text
from mimic_tpu.ops import decode_attention as jda
from mimic_tpu_torch.bridge import to_numpy, to_torch
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import layers as tlayers
from mimic_tpu_torch.ops import decode_attention as tda

TOL_FP32 = 1e-5
TOL_BF16 = 1e-2
TOL_M_BF16 = 1e-3
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _kv(shape, seed, jdt=jnp.float32):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jdt) for _ in range(2)]


def _same_bytes(jax_handle, torch_handle):
    want = np_tree(jax_handle)
    got = to_numpy(torch_handle)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k].view(np.uint8), np.ascontiguousarray(want[k]).view(np.uint8)), k


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Sp,padded", [(256, 0), (200, 256)], ids=["aligned", "padded-to-128"])
def test_quantize_prompt_kv_bytes_match_jax(Sp, padded, dtype):
    jdt, _ = DTYPES[dtype]
    pk, pv = _kv((3, 2, Sp, 2, 128), Sp, jdt)
    pk = pk.at[1, 0, 5].set(0)  # an all-zero key row: scale 1
    if padded:
        pad = ((0, 0), (0, 0), (0, padded - Sp), (0, 0), (0, 0))
        want = jda.quantize_prompt_kv(jnp.pad(pk, pad), jnp.pad(pv, pad))
    else:
        want = jda.quantize_prompt_kv(pk, pv)
    got = tda.quantize_prompt_kv(to_torch(np.asarray(pk), "cpu"), to_torch(np.asarray(pv), "cpu"),
                                 padded_len=padded)
    for w, g in zip(want, got):
        _same_bytes(w, g)
    assert tda.prompt_kv_len(got[0]) == jda.prompt_kv_len(want[0]) == max(Sp, padded)
    assert (got[0]["scale"][1, 0, :, 5] == 1.0).all()


def test_prompt_kv_len_and_is_quantized_kv():
    stacked, layer = torch.zeros(2, 1, 7, 2, 4), torch.zeros(1, 7, 2, 4)
    q = {"q8": torch.zeros(2, 1, 2, 7, 4, dtype=torch.int8), "scale": torch.ones(2, 1, 2, 7)}
    assert tda.prompt_kv_len(stacked) == tda.prompt_kv_len(layer) == tda.prompt_kv_len(q) == 7
    assert tda.is_quantized_kv(q) and not tda.is_quantized_kv(stacked)
    assert jda.prompt_kv_len(jnp.zeros((2, 1, 7, 2, 4))) == 7


def _mask(B0, Sp, pads):
    m = np.ones((B0, Sp), np.int32)
    for b, p in enumerate(pads):
        m[b, :p] = 0
    return m


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pads", [(32, 0), (130, 7)], ids=["left-padded", "masked-first-block"])
def test_prompt_attention_plain_matches_pallas(pads, dtype):
    jdt, tdt = DTYPES[dtype]
    B0, Kb, Hkv, G, D, Sp, L = 2, 3, 2, 2, 128, 384, 3
    pk, pv = _kv((L, B0, Sp, Hkv, D), 1)
    qg = _kv((B0 * Kb, 1, Hkv, G, D), 2)[0] / np.sqrt(D)
    qg = qg.astype(jdt)
    mask = _mask(B0, Sp, pads)
    jk, jv = jda.quantize_prompt_kv(pk, pv)
    layer = 1
    want = jda.prompt_attention_int8(qg, dict(jk, layer=jnp.int32(layer)),
                                     dict(jv, layer=jnp.int32(layer)), jnp.asarray(mask),
                                     block_k=128, interpret=True)
    tk, tv = to_torch(np_tree(jk), "cpu"), to_torch(np_tree(jv), "cpu")
    tda.reset_launch_counts()
    got = tda.prompt_attention_int8(to_torch(np.asarray(qg), "cpu"), dict(tk, layer=layer),
                                    dict(tv, layer=layer), _t(mask))
    assert tda.LAUNCHES == {"prompt_attn_int8": 0}
    names = ("o", "m", "l")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert torch.isfinite(g).all(), name
    o, m, l = (g.numpy() for g in got)
    wo, wm, wl = (np.asarray(w) for w in want)
    tol = TOL_FP32 if dtype == "float32" else TOL_BF16
    assert np.abs(m - wm).max() <= (TOL_FP32 if dtype == "float32" else TOL_M_BF16)
    assert np.abs(o - wo).max() <= tol * np.abs(wo).max()
    assert np.abs(l - wl).max() <= tol * np.abs(wl).max()


def _cached_inputs(seed=1):
    B0, Kb, Hkv, G, D, Sp, Sgen, L = 2, 3, 2, 2, 128, 256, 8, 3
    B, H = B0 * Kb, Hkv * G
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    pk, pv = r(L, B0, Sp, Hkv, D), r(L, B0, Sp, Hkv, D)
    q, k_new, v_new = r(B, 1, H, D), r(B, 1, Hkv, D), r(B, 1, Hkv, D)
    gen_k, gen_v = r(B, Sgen, Hkv, D), r(B, Sgen, Hkv, D)
    key_mask_gen = np.ones((B, Sgen), np.int32)
    key_mask_gen[1, 2] = 0
    return dict(pk=pk, pv=pv, q=q, k_new=k_new, v_new=v_new, gen_k=gen_k, gen_v=gen_v,
                cache_len=Sp + 3, key_mask_gen=key_mask_gen,
                key_mask_new=np.ones((B, 1), np.int32), pmask=_mask(B0, Sp, (16, 0)))


def test_cached_attention_quantized_prompt_matches_jax():
    c = _cached_inputs()
    layer = 1
    jk, jv = jda.quantize_prompt_kv(jnp.asarray(c["pk"]), jnp.asarray(c["pv"]))
    j = jnp.asarray
    want = jlayers.cached_attention(
        j(c["q"]), j(c["k_new"]), j(c["v_new"]), j(c["gen_k"]), j(c["gen_v"]),
        jnp.int32(c["cache_len"]), j(c["key_mask_gen"]), j(c["key_mask_new"]),
        prompt_k=dict(jk, layer=jnp.int32(layer)), prompt_v=dict(jv, layer=jnp.int32(layer)),
        prompt_mask=j(c["pmask"]), need_unmasked=False,
    )
    tk, tv = tda.quantize_prompt_kv(_t(c["pk"]), _t(c["pv"]))
    got = tlayers.cached_attention(
        _t(c["q"]), _t(c["k_new"]), _t(c["v_new"]), _t(c["gen_k"]), _t(c["gen_v"]),
        c["cache_len"], _t(c["key_mask_gen"]), _t(c["key_mask_new"]),
        prompt_k=dict(tk, layer=layer), prompt_v=dict(tv, layer=layer),
        prompt_mask=_t(c["pmask"]), need_unmasked=False,
    )
    for name, g, w in zip(("out", "lse", "lse_u"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_FP32, atol=TOL_FP32,
                                   err_msg=name)
    # both log-normalizers are the masked one, as in JAX
    assert torch.equal(got[1], got[2])


def test_quantized_prompt_rejects_need_unmasked_like_jax():
    c = _cached_inputs(2)
    jk, jv = jda.quantize_prompt_kv(jnp.asarray(c["pk"]), jnp.asarray(c["pv"]))
    tk, tv = tda.quantize_prompt_kv(_t(c["pk"]), _t(c["pv"]))
    args = ("q", "k_new", "v_new", "gen_k", "gen_v")
    with pytest.raises(NotImplementedError):
        jlayers.cached_attention(
            *(jnp.asarray(c[a]) for a in args), jnp.int32(c["cache_len"]),
            jnp.asarray(c["key_mask_gen"]), jnp.asarray(c["key_mask_new"]),
            prompt_k=dict(jk, layer=jnp.int32(0)), prompt_v=dict(jv, layer=jnp.int32(0)),
            prompt_mask=jnp.asarray(c["pmask"]), need_unmasked=True,
        )
    with pytest.raises(NotImplementedError):
        tlayers.cached_attention(
            *(_t(c[a]) for a in args), c["cache_len"], _t(c["key_mask_gen"]),
            _t(c["key_mask_new"]), prompt_k=dict(tk, layer=0), prompt_v=dict(tv, layer=0),
            prompt_mask=_t(c["pmask"]), need_unmasked=True,
        )


def test_decode_step_over_a_quantized_prompt_cache_matches_jax():
    """Prefill a 128-token left-padded prompt, keep its KV as the beam-shared
    int8 prompt region (beam 2), then one decode step on both sides."""
    cfg = tiny_text("idefics2", head_dim=128).text
    B0, K, T, NEW = 2, 2, 128, 3
    B = B0 * K
    params = np_tree(jd.init_decoder_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    embeds = rng.normal(size=(B0, T, cfg.hidden_size)).astype(np.float32)
    step = rng.normal(size=(B, 1, cfg.hidden_size)).astype(np.float32)
    mask = _mask(B0, T, (20, 0))
    j = jnp.asarray
    cache = jd.init_kv_cache(cfg, B0, T)
    pre = jd.decoder_forward(params, cfg, j(embeds), jd.make_causal_mask(j(mask)),
                             jd.positions_from_mask(j(mask)), kv_cache=cache, key_mask=j(mask),
                             cache_empty=True)
    prompt_k, prompt_v = np.asarray(pre.kv_cache["k"]), np.asarray(pre.kv_cache["v"])
    gen_shape = (cfg.num_layers, B, NEW, cfg.num_kv_heads, cfg.head_size)
    mask_full = np.repeat(np.concatenate([mask, np.zeros((B0, NEW), np.int32)], 1), K, axis=0)
    mask_full[:, T] = 1
    pos = np.repeat(mask.sum(-1), K)[:, None]

    jk, jv = jda.quantize_prompt_kv(j(prompt_k), j(prompt_v))
    jd.ATTN_PATH_LOG.clear()
    want = jd.decoder_forward(
        params, cfg, j(step), None, j(pos),
        kv_cache={"prompt_k": jk, "prompt_v": jv, "k": jnp.zeros(gen_shape),
                  "v": jnp.zeros(gen_shape), "length": jnp.int32(T)},
        key_mask=j(mask_full),
    )
    jax_paths = list(jd.ATTN_PATH_LOG)

    tk, tv = tda.quantize_prompt_kv(_t(prompt_k), _t(prompt_v))
    td.ATTN_PATH_LOG.clear()
    got = td.decoder_forward(
        to_torch(params, "cpu"), cfg, _t(step), None, _t(pos),
        kv_cache={"prompt_k": tk, "prompt_v": tv, "k": torch.zeros(gen_shape),
                  "v": torch.zeros(gen_shape), "length": T},
        key_mask=_t(mask_full),
    )
    assert td.ATTN_PATH_LOG == jax_paths == ["cached", "quant_kv"]
    assert got.kv_cache["length"] == T + 1 and got.kv_cache["prompt_k"] is tk
    np.testing.assert_allclose(got.hidden.numpy(), np.asarray(want.hidden),
                               rtol=TOL_FP32, atol=TOL_FP32)
    np.testing.assert_allclose(got.kv_cache["k"][:, :, :1].numpy(),
                               np.asarray(want.kv_cache["k"][:, :, :1]), rtol=TOL_FP32,
                               atol=TOL_FP32)
