"""The text-only towers and the decoder options they bring, in mimic_tpu_torch
against the JAX package (fp32, CPU) and HF.

The options: Qwen2's q/k/v biases, self-attention qk-norms (RMS norms per head
after RoPE, the JAX package's order; no shipped config sets them) and
Mistral's sliding window.  Parameters come from the JAX initialisers through
``bridge.to_torch``, the biases and norm weights drawn at random (they start
at zero and one).  Held here, within 1e-5 relative unless stated:

- ``decoder_forward`` with each option: the cache-empty prefill (plain path;
  the flash path at head dim 128 for the biases and the qk-norms; with the
  window narrower than T the prefill takes the plain path, as in JAX), then
  three cached decode steps through ``cached_attention``;
- ``cached_attention`` with a window narrower than the timeline, with and
  without a beam-shared prompt region; the int8 prompt KV under a window
  raises, as in JAX;
- greedy and beam-3 tokens of the text family (a qwen2-like tower, a
  mistral-like one with a window narrower than the prompt) identical to
  JAX's, and the runner's strings identical to the JAX runner's;
- ``build_model``'s parameter check on every named model, the untied lm
  heads included;
- ``convert_text`` on tiny HF ``Qwen2ForCausalLM`` and ``MistralForCausalLM``
  (the latter with a window narrower than T, built as
  ``tests/test_hf_parity.py`` builds them): logits within 2e-4 of HF's, also
  step by step through the cached decode under the window.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import get_preset
from mimic_tpu.models import decoder as jd
from mimic_tpu.models import generate as jg
from mimic_tpu.models import layers as jl
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import tiny_text
from mimic_tpu.models.runner import LVLMRunner as JaxRunner
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import convert as tconvert
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import factory as tfactory
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import layers as tl
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models.config import ModelConfig, TextConfig, get_model_config
from mimic_tpu_torch.models.runner import LVLMRunner

TOL = 1e-5
TOL_HF = 2e-4
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run many small ops: one thread each, not a pool that every
    op must wake (beside the other test workers the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _randomize(decoder, seed=9):
    """The biases (zero at init) and qk-norm weights (one) drawn at random."""
    rng = np.random.default_rng(seed)
    layers = decoder["layers"]
    for name, scale, base in (("q_bias", 0.1, 0.0), ("k_bias", 0.1, 0.0), ("v_bias", 0.1, 0.0),
                              ("q_ln", 0.3, 1.0), ("k_ln", 0.3, 1.0)):
        if name in layers:
            layers[name] = (base + scale * rng.normal(size=layers[name].shape)).astype(np.float32)
    return decoder


# option → (TextConfig overrides, prefill length, attention path of the prefill)
OPTIONS = {
    "bias": ({"attn_bias": True}, 12, "xla"),
    "bias-flash": ({"attn_bias": True, "head_dim": 128}, 128, "flash"),
    "qk-norm": ({"qk_layernorm": True}, 12, "xla"),
    "qk-norm-flash": ({"qk_layernorm": True, "head_dim": 128}, 128, "flash"),
    "window": ({"sliding_window": 5}, 12, "xla"),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_decoder_prefill_and_decode_steps_match_jax(option):
    """A MimIC shift (log Z2 unmasked), left padding; the prefill, then three
    cached decode steps, each feeding the next."""
    kw, T, prefill_path = OPTIONS[option]
    cfg = tiny_text("idefics2", **kw).text
    params = _randomize(jax.tree.map(np.asarray, jd.init_decoder_params(cfg, jax.random.PRNGKey(0))))
    shift = jax.tree.map(np.asarray, init_shift_params(get_preset("mimic")[0], cfg,
                                                       jax.random.PRNGKey(1)))
    shift["attn_v"] = shift["attn_v"] * 100.0  # so that log Z2 moves the outputs
    B, total = 2, T + STEPS
    rng = np.random.default_rng(2)
    embeds = rng.normal(size=(B, T, cfg.hidden_size)).astype(np.float32)
    steps = rng.normal(size=(STEPS, B, 1, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[0, :3] = 0
    j, t = jnp.asarray, torch.from_numpy
    params_t, shift_t = to_torch(params, "cpu"), to_torch(shift, "cpu")
    attn_impl = "flash" if prefill_path == "flash" else "xla"

    jd.ATTN_PATH_LOG.clear()
    out_j = jd.decoder_forward(
        params, cfg, j(embeds), jd.make_causal_mask(j(mask), cfg.sliding_window),
        jd.positions_from_mask(j(mask)), shift=shift, kv_cache=jd.init_kv_cache(cfg, B, total),
        key_mask=j(mask), cache_empty=True, attn_impl=attn_impl)
    td.ATTN_PATH_LOG.clear()
    out_t = td.decoder_forward(
        params_t, cfg, t(embeds), td.make_causal_mask(t(mask), cfg.sliding_window),
        td.positions_from_mask(t(mask)), shift=shift_t,
        kv_cache=td.init_kv_cache(cfg, B, total, "cpu"), key_mask=t(mask), cache_empty=True,
        attn_impl=attn_impl)
    _close(out_t.hidden, out_j.hidden)
    cache_j, cache_t = out_j.kv_cache, out_t.kv_cache
    for i in range(STEPS):
        full = np.concatenate([mask, np.ones((B, i + 1), np.int32),
                               np.zeros((B, STEPS - i - 1), np.int32)], axis=1)
        pos = (mask.sum(-1) + i)[:, None]
        step_j = jd.decoder_forward(params, cfg, j(steps[i]), None, j(pos), shift=shift,
                                    kv_cache=cache_j, key_mask=j(full))
        step_t = td.decoder_forward(params_t, cfg, t(steps[i]), None, t(pos), shift=shift_t,
                                    kv_cache=cache_t, key_mask=t(full))
        _close(step_t.hidden, step_j.hidden)
        cache_j, cache_t = step_j.kv_cache, step_t.kv_cache
    assert td.ATTN_PATH_LOG == [prefill_path] + ["cached"] * STEPS
    assert jd.ATTN_PATH_LOG[0] == prefill_path
    # the option is seen: without it the outputs move
    plain_cfg = dataclasses.replace(cfg, attn_bias=False, qk_layernorm=False, sliding_window=None)
    plain_t = dict(params_t, layers={k: v for k, v in params_t["layers"].items()
                                     if k not in ("q_bias", "k_bias", "v_bias")})
    bare = td.decoder_forward(plain_t, plain_cfg, t(embeds),
                              td.make_causal_mask(t(mask)), td.positions_from_mask(t(mask)),
                              shift=shift_t, key_mask=t(mask), attn_impl=attn_impl)
    assert not torch.allclose(bare.hidden, out_t.hidden, atol=1e-3)


@pytest.mark.parametrize("prompt", [False, True], ids=["cache-only", "beam-shared-prompt"])
@pytest.mark.parametrize("T", [1, 3])
def test_cached_attention_window_matches_jax(prompt, T):
    """A window of 6 over a timeline of 8 prompt slots (left padding and an
    interior pad) and 4 written generated slots: the prompt's first slots
    fall out of the window."""
    rng = np.random.default_rng(20 + T)
    B0, beams, Sp, S_gen, Hkv, G, D, W = 2, 3, 8, 6, 2, 2, 16, 6
    B = B0 * beams
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, k_new, v_new = r(B, T, Hkv * G, D), r(B, T, Hkv, D), r(B, T, Hkv, D)
    ck, cv = r(B, S_gen, Hkv, D), r(B, S_gen, Hkv, D)
    pk, pv = r(B0, Sp, Hkv, D), r(B0, Sp, Hkv, D)
    pm = np.ones((B0, Sp), np.int32)
    pm[0, :2] = 0
    pm[1, 5] = 0
    kmn = np.ones((B, T), np.int32)
    written = 4
    if prompt:
        km, cache_len = np.ones((B, S_gen), np.int32), Sp + written
        extra = dict(prompt_k=pk, prompt_v=pv, prompt_mask=pm)
    else:
        km, cache_len = np.repeat(pm, beams, 0)[:, :S_gen], written + 2
        extra = {}
    j, t = jnp.asarray, torch.from_numpy
    want = jl.cached_attention(j(q), j(k_new), j(v_new), j(ck), j(cv), j(cache_len), j(km),
                               j(kmn), window=W, **{k: j(v) for k, v in extra.items()})
    got = tl.cached_attention(t(q), t(k_new), t(v_new), t(ck), t(cv), cache_len, t(km),
                              t(kmn), window=W, **{k: t(v) for k, v in extra.items()})
    for a, b in zip(got, want):
        _close(a, b)
    wide = tl.cached_attention(t(q), t(k_new), t(v_new), t(ck), t(cv), cache_len, t(km), t(kmn),
                               **{k: t(v) for k, v in extra.items()})
    assert not torch.allclose(wide[0], got[0], atol=1e-4)  # the window bites
    torch.testing.assert_close(wide[2], got[2])  # lse_u ignores every mask


def test_cached_attention_int8_prompt_under_a_window_raises():
    """As in JAX (``layers.py:175-179``): the int8 prompt KV is plain causal decode."""
    rng = np.random.default_rng(12)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    ones = lambda *s: torch.ones(s, dtype=torch.int32)  # noqa: E731
    with pytest.raises(NotImplementedError, match="sliding window"):
        tl.cached_attention(t(3, 1, 4, 16), t(3, 1, 2, 16), t(3, 1, 2, 16), t(3, 2, 2, 16),
                            t(3, 2, 2, 16), 9, ones(3, 2), ones(3, 1),
                            prompt_k={"q8": t(1, 8, 2, 16)}, prompt_v={"q8": t(1, 8, 2, 16)},
                            prompt_mask=ones(1, 8), window=4, need_unmasked=False)


# ---------------------------------------------------------------------------
# the text family end to end
# ---------------------------------------------------------------------------


TOWERS = {"qwen2-like": {"attn_bias": True, "num_heads": 7, "num_kv_heads": 1, "head_dim": 16,
                         "hidden_size": 112},
          "mistral-like": {"sliding_window": 6}}
PROMPTS = ["a short one", "a longer prompt of text, left padded"]


def _text_setup(tower):
    tk = SimpleTokenizer(padding_side="left")
    cfg = tiny_text("text", **TOWERS[tower])
    cfg = cfg.replace(pad_token_id=tk.pad_token_id, bos_token_id=tk.bos_token_id,
                      eos_token_id=tk.eos_token_id,
                      text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))
    params = jax.tree.map(np.asarray, jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(0)))
    _randomize(params["lm"]["decoder"])
    return tk, cfg, params


@pytest.mark.parametrize("tower", list(TOWERS))
def test_text_family_tokens_match_jax(tower):
    """Greedy and beam-3 tokens on a prompt wider than the window, identical
    to JAX's; then the runners' strings (the ChatML template's family)."""
    tk, cfg, params = _text_setup(tower)
    assert cfg.vision is None
    tparams = to_torch(params, "cpu")
    ids, am = tk.pad_batch([tk.encode(p) for p in PROMPTS])
    assert cfg.text.sliding_window is None or ids.shape[1] > cfg.text.sliding_window
    jb = jlvlm.LVLMBatch(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(am))
    tb = tlvlm.LVLMBatch(input_ids=torch.from_numpy(ids).long(),
                         attention_mask=torch.from_numpy(am))
    special = (tk.eos_token_id, tk.pad_token_id)
    want = jg.greedy_generate(params, cfg, jb, 5, *special)
    got = tg.greedy_generate(tparams, cfg, tb, 5, *special)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    want = jg.beam_generate(params, cfg, jb, 5, 3, *special)
    got = tg.beam_generate(tparams, cfg, tb, 5, 3, *special)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.scores, want.scores)

    runner = LVLMRunner(cfg, tparams, SimpleTokenizer(padding_side="left"), device="cpu",
                        pad_multiple=16)
    jrunner = JaxRunner(cfg, jax.tree.map(jnp.asarray, params),
                        SimpleTokenizer(padding_side="left"), pad_multiple=16)
    assert runner.template == jrunner.template == "llava-interleave"
    assert (runner.generate(None, PROMPTS, num_beams=3, max_new_tokens=4)
            == jrunner.generate(None, PROMPTS, num_beams=3, max_new_tokens=4))


@pytest.mark.parametrize("name", ["llava-interleave-7b", "llava-1.5-7b", "mistral-7b", "qwen2-7b",
                                  "idefics-9b"])
def test_build_model_checks_every_named_model(name):
    """``check_params`` accepts each model's own tree (made on the meta device:
    nothing is allocated) with its untied lm head, and names a missing leaf."""
    cfg = get_model_config(name)
    tree = tlvlm.init_lvlm_params(cfg, None, torch.device("meta"))
    tfactory.check_params(tree, cfg)
    lm = tree["lm"]
    assert tuple(lm["lm_head"].shape) == (cfg.text.hidden_size, cfg.text.vocab_size)
    del lm["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        tfactory.check_params(tree, cfg)


# ---------------------------------------------------------------------------
# HF parity
# ---------------------------------------------------------------------------


def hf_text(kind, window=None):
    """A tiny HF ``Qwen2ForCausalLM`` (G = 7, biases) or ``MistralForCausalLM``
    (with ``window``) and the port's config for it."""
    torch.manual_seed(0)
    common = dict(vocab_size=128, intermediate_size=128, num_hidden_layers=2,
                  attn_implementation="eager", tie_word_embeddings=False)
    if kind == "qwen2":
        from transformers.models.qwen2 import Qwen2Config, Qwen2ForCausalLM

        model = Qwen2ForCausalLM(Qwen2Config(hidden_size=112, num_attention_heads=7,
                                             num_key_value_heads=1, rms_norm_eps=1e-6, **common))
    else:
        from transformers.models.mistral import MistralConfig, MistralForCausalLM

        model = MistralForCausalLM(MistralConfig(hidden_size=64, num_attention_heads=4,
                                                 num_key_value_heads=2, rms_norm_eps=1e-5,
                                                 sliding_window=window, **common))
    hc = model.config
    cfg = ModelConfig(
        name="parity", family="text",
        text=TextConfig(vocab_size=128, hidden_size=hc.hidden_size, num_layers=2,
                        num_heads=hc.num_attention_heads, num_kv_heads=hc.num_key_value_heads,
                        intermediate_size=128, norm_eps=hc.rms_norm_eps,
                        attn_bias=kind == "qwen2", sliding_window=window),
        image_token_id=-1, pad_token_id=0,
    )
    return model.eval().float(), cfg


@pytest.mark.parametrize("kind,window", [("qwen2", None), ("mistral", 4)],
                         ids=["qwen2", "mistral-window"])
def test_converted_text_tower_matches_hf(kind, window):
    """The prefill's logits at every position, then (under the window) the
    cached decode, one token at a time, against HF's logits of the whole
    sequence at those positions."""
    model, cfg = hf_text(kind, window)
    params = tconvert.convert_text(model.state_dict(), cfg)
    B, T, NEW = 2, 12, 4
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 120, size=(B, T + NEW)).astype(np.int64)
    attn = np.ones((B, T + NEW), np.int64)
    with torch.no_grad():
        hf = model(input_ids=torch.tensor(ids), attention_mask=torch.tensor(attn)).logits.numpy()
    ids_t = torch.from_numpy(ids)
    batch = tlvlm.LVLMBatch(input_ids=ids_t[:, :T], attention_mask=torch.ones(B, T, dtype=torch.int32))
    cache = td.init_kv_cache(cfg.text, B, T + NEW, "cpu")
    out = tlvlm.lvlm_forward(params, cfg, batch, kv_cache=cache, kv_total_len=T + NEW,
                             cache_empty=True)
    np.testing.assert_allclose(out.logits.numpy(), hf[:, :T], rtol=TOL_HF, atol=TOL_HF)
    cache = out.decoder.kv_cache
    for i in range(NEW):
        step = tlvlm.LVLMBatch(input_ids=ids_t[:, T + i:T + i + 1],
                               attention_mask=torch.ones(B, T + i + 1, dtype=torch.int32))
        out = tlvlm.lvlm_forward(params, cfg, step, kv_cache=cache, kv_total_len=T + NEW)
        np.testing.assert_allclose(out.logits[:, 0].numpy(), hf[:, T + i], rtol=TOL_HF,
                                   atol=TOL_HF)
        cache = out.decoder.kv_cache
    if window is not None:  # the window bites at this length
        full, _ = hf_text(kind, None)
        with torch.no_grad():
            wide = full(input_ids=torch.tensor(ids), attention_mask=torch.tensor(attn)).logits
        assert not np.allclose(wide.numpy()[:, T:], hf[:, T:], atol=1e-3)
