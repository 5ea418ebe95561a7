"""Sampling (``do_sample=True``) in mimic_tpu_torch against the JAX package.

The two packages draw from different random streams, so tokens are compared
with JAX's own Gumbel noise handed to the port: JAX's ``categorical`` is the
argmax of the processed logits plus ``gumbel(key, shape)``, its keys follow
``k0, rng = split(rng)`` and then one split per step, and the port draws
through ``models/generate.py::gumbel``, which the test replaces by a replay of
that schedule.  A spy on ``jax.random.categorical`` (through
``jax.debug.callback``, on a fresh ``jit`` of ``sample_generate``) records the
keys and the processed logits JAX drew from; the port's ``process_logits`` is
held to them at every step within 1e-5, ``NEG`` in the same places, and the
tokens and scores must agree.  Tiny idefics2 in fp32, parameters from the JAX
initialisers through the bridge.  The cases of ``tests/test_lvlm_generate.py``
(``TestSampleGenerate``) follow, on the port's function and on its runner.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.models import generate as jg
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models.runner import LVLMRunner

TOL = 1e-5
TEXTS = ["Image:<image> Question: color? Answer:", "Image:<image> Question: count? Answer:"]
STATIC = ("cfg", "max_new_tokens", "eos_token_id", "pad_token_id", "temperature", "top_k",
          "top_p", "logz2", "attn_impl")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run many small ops: one thread each, not a pool that every
    op must wake (beside the other test workers the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images():
    rng = np.random.default_rng(0)
    return [[rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8)] for _ in range(2)]


@pytest.fixture(scope="module")
def setup():
    tk = SimpleTokenizer(padding_side="left")
    cfg = get_model_config("tiny-idefics2").replace(
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
    )
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))
    params = jax.tree.map(np.asarray, jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(0)))
    enc = LVLMProcessor(cfg, tk)(_images(), TEXTS)
    jb = jlvlm.LVLMBatch(
        input_ids=jnp.asarray(enc["input_ids"]), attention_mask=jnp.asarray(enc["attention_mask"]),
        pixel_values=jnp.asarray(enc["pixel_values"]), pixel_mask=jnp.asarray(enc["pixel_mask"]),
        patch_mask=jnp.asarray(enc["patch_mask"]),
    )
    tb = tlvlm.LVLMBatch(
        input_ids=torch.from_numpy(enc["input_ids"]).long(),
        attention_mask=torch.from_numpy(enc["attention_mask"]),
        pixel_values=torch.from_numpy(enc["pixel_values"]),
        patch_mask=torch.from_numpy(enc["patch_mask"]),
    )
    return cfg, tk, params, to_torch(params, "cpu"), jb, tb


def _jax_keys(seed, steps):
    """The keys JAX's sample_generate draws with: k0, then one split per step."""
    k0, rng = jax.random.split(jax.random.PRNGKey(seed))
    keys = [k0]
    for _ in range(steps):
        key, rng = jax.random.split(rng)
        keys.append(key)
    return keys


PROCESSING = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=5),
    "top_p": dict(top_p=0.8),
    "top_k_top_p": dict(top_k=5, top_p=0.8),
    "temperature_top_p": dict(temperature=1.5, top_p=0.7),
    "all": dict(temperature=0.7, top_k=5, top_p=0.8),
}


@pytest.mark.parametrize("name", list(PROCESSING))
def test_injected_noise_gives_jax_tokens_and_processed_logits(setup, name, monkeypatch):
    cfg, tk, params, tparams, jb, tb = setup
    kw, steps, seed = PROCESSING[name], 4, 11
    drawn = []  # (key, processed logits) of every JAX draw, in order
    orig = jax.random.categorical

    def spy(key, x, axis=-1, **k):
        jax.debug.callback(lambda a, b: drawn.append((np.asarray(a), np.asarray(b))), key, x,
                           ordered=True)
        return orig(key, x, axis=axis, **k)

    monkeypatch.setattr(jax.random, "categorical", spy)
    fresh = jax.jit(jg.sample_generate.__wrapped__, static_argnames=STATIC)
    ref = fresh(params, cfg, jb, steps, tk.eos_token_id, tk.pad_token_id,
                rng=jax.random.PRNGKey(seed), **kw)
    jax.effects_barrier()
    monkeypatch.setattr(jax.random, "categorical", orig)

    keys = _jax_keys(seed, steps)
    assert len(drawn) == steps + 1
    assert all(np.array_equal(np.asarray(k), d) for k, (d, _) in zip(keys, drawn))
    noise = [torch.from_numpy(np.array(jax.random.gumbel(k, x.shape, jnp.float32)))
             for k, (_, x) in zip(keys, drawn)]
    processed = []
    orig_process = tg.process_logits

    def process_spy(*a):
        processed.append(orig_process(*a))
        return processed[-1]

    monkeypatch.setattr(tg, "gumbel", lambda generator, shape: noise[len(processed) - 1])
    monkeypatch.setattr(tg, "process_logits", process_spy)
    got = tg.sample_generate(tparams, cfg, tb, steps, tk.eos_token_id, tk.pad_token_id,
                             generator=torch.Generator().manual_seed(0), **kw)
    assert len(processed) == steps + 1
    for (_, want), mine in zip(drawn, processed):
        assert np.array_equal(mine.numpy() == tg.NEG, want == jg.NEG)
        np.testing.assert_allclose(mine.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=TOL, atol=TOL)
    if name != "temperature":
        assert (processed[0] == tg.NEG).any()  # the filter took something out


def _sample(setup, steps, seed, **kw):
    cfg, tk, _, tparams, _, tb = setup
    return tg.sample_generate(tparams, cfg, tb, steps, tk.eos_token_id, tk.pad_token_id,
                              generator=torch.Generator().manual_seed(seed), **kw)


def _greedy(setup, steps):
    cfg, tk, _, tparams, _, tb = setup
    return tg.greedy_generate(tparams, cfg, tb, steps, tk.eos_token_id, tk.pad_token_id)


@pytest.mark.parametrize("kw", [dict(temperature=1e-4), dict(top_k=1)], ids=["temp", "top_k_1"])
def test_degenerate_sampling_is_greedy(setup, kw):
    want = _greedy(setup, 5).tokens
    for seed in (0, 7):
        assert torch.equal(_sample(setup, 5, seed, **kw).tokens, want)


def test_seeded_and_varied(setup):
    a = _sample(setup, 8, 1, temperature=2.0)
    b = _sample(setup, 8, 1, temperature=2.0)
    c = _sample(setup, 8, 2, temperature=2.0)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.scores, b.scores)
    assert not torch.equal(a.tokens, c.tokens)
    assert (a.scores <= 0.0).all()  # a sum of log-probabilities


def test_top_p_restricts_support(setup):
    """A near-deterministic distribution: top_p keeps only its head, so every
    seed samples the greedy tokens."""
    want = _greedy(setup, 5).tokens
    for seed in (0, 3):
        assert torch.equal(_sample(setup, 5, seed, temperature=0.005, top_p=0.5).tokens, want)


def test_process_logits_filters():
    x = torch.tensor([[2.0, 1.0, 1.0, 0.5, -1.0, 3.0]])
    kept = tg.process_logits(x, 1.0, 3, 1.0) > tg.NEG
    assert kept.tolist() == [[True, True, True, False, False, True]]  # ties with the k-th stay
    # probabilities 0.58, 0.21, ...: the head alone holds more than 0.5
    assert (tg.process_logits(x, 1.0, 0, 0.5) > tg.NEG).tolist() == [[False] * 5 + [True]]
    assert torch.equal(tg.process_logits(x, 2.0, 0, 1.0), x / 2.0)


def test_gumbel_noise():
    g = tg.gumbel(torch.Generator().manual_seed(0), (4000, 50))
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.01  # the Euler-Mascheroni constant
    assert torch.equal(g, tg.gumbel(torch.Generator().manual_seed(0), (4000, 50)))


def test_runner_do_sample(setup):
    cfg, tk, params, tparams, _, _ = setup
    runner = LVLMRunner(cfg, tparams, SimpleTokenizer(), device="cpu")
    greedy = runner.generate(_images(), TEXTS, max_new_tokens=5)
    assert runner.generate(_images(), TEXTS, max_new_tokens=5, do_sample=True, top_k=1,
                           seed=4) == greedy
    assert runner.generate(_images(), TEXTS, max_new_tokens=5, do_sample=True,
                           temperature=1e-4) == greedy
    kw = dict(max_new_tokens=8, do_sample=True, temperature=2.0, top_k=50, top_p=0.95)
    first = runner.generate(_images(), TEXTS, seed=1, **kw)
    assert runner.generate(_images(), TEXTS, seed=1, **kw) == first
    # the runner seeds its generator with ``seed`` and hands the options through
    want = _sample(setup, 8, 1, temperature=2.0, top_k=50, top_p=0.95).tokens
    assert first == [runner.tokenizer.decode(r, skip_special_tokens=True) for r in want.numpy()]
