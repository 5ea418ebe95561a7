"""Prefix tuning in mimic_tpu_torch against mimic_tpu, fp32 on the CPU.

The semantics oracle of ``tests/test_prefix_tuning.py``, on the port: a
prefix whose k/v are the model's own post-RoPE KV of a token block ``a`` makes
``forward(b | prefix)`` equal ``forward(a ++ b)`` at b's rows (2e-4), and
greedy generation the same tokens.  Against the JAX package, with its
parameters and prefix carried across by the bridge (tiny idefics2):

- ``prefix_forward_args``: the same mask, positions and cache, and a gradient
  that reaches the prefix leaves;
- the prefix-merge prefill (``prefix_flash_len``, ``"+prefix"`` logged) equals
  the cached path (2e-4), on the plain and ``"flash"`` paths;
- ``make_train_step`` with the ``prefix-tuning`` preset: 3 steps, metrics
  rtol 1e-5, trees 1e-5 in norm per leaf, with 2 KV heads and with one (the
  step's cache is made from the trainable prefix: with one KV head a cache
  append in place breaks its backward);
- greedy and beam-3 tokens with a prefix, and sampling with a prefix and LoRA
  adapters at once (JAX's Gumbel noise handed to the port), identical to JAX's;
- the int8 prompt KV of a prefixed prompt (Sp = P + T, not a multiple of 128)
  holds JAX's bytes; the runner and the eval gate with a prefix only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import PrefixConfig, get_preset
from mimic_tpu.models import generate as jg
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.runner import LVLMRunner as JaxRunner
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.ops import decode_attention as jda
from mimic_tpu.shift.lora import init_lora_params
from mimic_tpu.shift.prefix import init_prefix_params, prefix_forward_args
from mimic_tpu.train import TrainCollator, TrainState, build_optimizer, make_train_step
from mimic_tpu.train.step import _to_device_batch
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.ops import decode_attention as tda
from mimic_tpu_torch.pipeline import evaluate as tevaluate
from mimic_tpu_torch.shift import prefix as tprefix
from mimic_tpu_torch.train import optim as to
from mimic_tpu_torch.train import step as ts
from test_eval_e2e import synthetic_vqa_splits
from test_torch_lora import jax_params
from test_torch_sampling import _jax_keys
from test_torch_train_step import _cfg, _check_metrics, _opt_kwargs, port_enc
from test_train_step import string_batch

TOL = 1e-5
ORACLE_TOL = 2e-4
P = 4
STEPS = 3
TEXTS = ["Image:<image> Question: color? Answer:", "Image:<image> Question: count? Answer:"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(flash=False):
    tk = SimpleTokenizer(padding_side="left")
    cfg = _cfg(flash, tk)
    params = jax_params(cfg)
    prefix = jax.tree.map(np.asarray, init_prefix_params(
        PrefixConfig(num_virtual_tokens=P), cfg.text, jax.random.PRNGKey(7)))
    return cfg, tk, params, prefix


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


def _text_batch(ids, mask):
    return (jlvlm.LVLMBatch(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask)),
            tlvlm.LVLMBatch(input_ids=torch.from_numpy(ids).long(),
                            attention_mask=torch.from_numpy(mask)))


def _ids(rng, B, T, vocab):
    return rng.integers(4, vocab, size=(B, T)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# parameters and prefix_forward_args
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 16, 32])
def test_init_prefix_params(n):
    text = get_model_config("tiny-idefics2").text
    tree = tprefix.init_prefix_params(tconfig.PrefixConfig(num_virtual_tokens=n), text,
                                      torch.Generator().manual_seed(0), "cpu")
    want = init_prefix_params(PrefixConfig(num_virtual_tokens=n), text, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in tree.items()} == jax.tree.map(np.shape, want)
    flat = torch.cat([v.flatten() for v in tree.values()])
    assert all(v.dtype == torch.float32 for v in tree.values())
    assert abs(flat.std().item() - 1.0) < 0.1 and abs(flat.mean().item()) < 0.1
    assert tprefix.prefix_len(tree) == n and tprefix.prefix_len(None) == 0


# (batch, prompt length, left padding per row, decode slots reserved)
ARG_SHAPES = [(2, 6, (2, 0), 3), (1, 5, (0,), 0), (3, 8, (0, 4, 1), 5), (2, 1, (0, 0), 7),
              (4, 3, (1, 2, 0, 0), 0), (2, 16, (8, 3), 2)]


@pytest.mark.parametrize("B,T,pads,extra", ARG_SHAPES)
def test_prefix_forward_args_match_jax_and_carry_gradient(tiny, B, T, pads, extra):
    cfg, _, _, prefix = tiny
    mask = np.ones((B, T), np.int32)
    for row, pad in enumerate(pads):
        mask[row, :pad] = 0
    jb, tb = _text_batch(_ids(np.random.default_rng(0), B, T, 100), mask)
    jb2, jpos, jcache, jtotal = prefix_forward_args(prefix, jb, jnp.float32, extra_len=extra)
    live = {k: v.requires_grad_(True) for k, v in to_torch(prefix, "cpu").items()}
    tb2, tpos, tcache, ttotal = tprefix.prefix_forward_args(live, tb, torch.float32,
                                                           extra_len=extra)
    assert ttotal == jtotal == P + T + extra and tcache["length"] == int(jcache["length"]) == P
    np.testing.assert_array_equal(tb2.attention_mask.numpy(), np.asarray(jb2.attention_mask))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for k in ("k", "v"):
        np.testing.assert_array_equal(tcache[k].detach().numpy(), np.asarray(jcache[k]))
    (tcache["k"].sum() + 2 * tcache["v"].sum()).backward()
    assert torch.equal(live["k"].grad, torch.full_like(live["k"], float(B)))  # B rows each
    assert torch.equal(live["v"].grad, torch.full_like(live["v"], 2.0 * B))


# ---------------------------------------------------------------------------
# the oracle and the prefix-merge prefill
# ---------------------------------------------------------------------------


def _kv_of_block(cfg, params, ids):
    """Post-RoPE per-layer KV [L, P, Hkv, Dh] of a block at positions 0..P-1."""
    B, n = ids.shape
    cache = td.init_kv_cache(cfg.text, B, n, "cpu")
    out = tlvlm.lvlm_forward(
        params, cfg, tlvlm.LVLMBatch(input_ids=ids, attention_mask=torch.ones(B, n, dtype=torch.int32)),
        kv_cache=cache, kv_total_len=n, cache_empty=True)
    c = out.decoder.kv_cache
    return {"k": c["k"][:, 0], "v": c["v"][:, 0]}


def test_prefix_equals_concat_forward_and_generation(tiny):
    cfg, tk, params, _ = tiny
    params_t = to_torch(params, "cpu")
    rng = np.random.default_rng(0)
    T = 12
    a = torch.from_numpy(_ids(rng, 1, P, 120)).long()
    b = torch.from_numpy(_ids(rng, 2, T, 120)).long()
    with torch.no_grad():
        prefix = _kv_of_block(cfg, params_t, a)
        batch_b = tlvlm.LVLMBatch(input_ids=b, attention_mask=torch.ones(2, T, dtype=torch.int32))
        qb, pos, cache, total = tprefix.prefix_forward_args(prefix, batch_b, torch.float32)
        got = tlvlm.lvlm_forward(params_t, cfg, qb, position_ids=pos, kv_cache=cache,
                                 kv_total_len=total).logits
        ab = torch.cat([a.expand(2, P), b], dim=1)
        full = tlvlm.LVLMBatch(input_ids=ab, attention_mask=torch.ones(2, P + T, dtype=torch.int32))
        want = tlvlm.lvlm_forward(params_t, cfg, full).logits[:, P:]
    _close(got, want.numpy(), ORACLE_TOL)
    kw = dict(max_new_tokens=5, eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id)
    with_prefix = tg.greedy_generate(params_t, cfg, batch_b, prefix=prefix, **kw)
    concat = tg.greedy_generate(params_t, cfg, full, **kw)
    assert torch.equal(with_prefix.tokens, concat.tokens)


@pytest.mark.parametrize("flash", [False, True], ids=["xla", "flash"])
def test_prefix_merge_matches_cached_attention(flash):
    cfg, _, params, prefix = _tiny(flash)
    params_t, prefix_t = to_torch(params, "cpu"), to_torch(prefix, "cpu")
    B, T = 2, 128 if flash else 12
    mask = np.ones((B, T), np.int32)
    mask[0, :3] = 0  # left padding meets the merge's mask slice
    _, tb = _text_batch(_ids(np.random.default_rng(0), B, T, 120), mask)
    pb, pos, cache, total = tprefix.prefix_forward_args(prefix_t, tb, torch.float32, extra_len=3)
    logits, paths = {}, {}
    for flag in (0, P):
        td.ATTN_PATH_LOG.clear()
        with torch.no_grad():
            out = tlvlm.lvlm_forward(
                params_t, cfg, pb, position_ids=pos,
                kv_cache={k: (v.clone() if torch.is_tensor(v) else v) for k, v in cache.items()},
                kv_total_len=total, prefix_flash_len=flag, attn_impl="flash" if flash else "xla")
        logits[flag], paths[flag] = out.logits, list(td.ATTN_PATH_LOG)
        assert out.decoder.kv_cache["length"] == P + T
    assert paths == {0: ["cached"], P: [("flash" if flash else "xla") + "+prefix"]}
    _close(logits[P], logits[0].numpy(), ORACLE_TOL)
    # and the cached path against JAX's on the same prefix
    jb, _ = _text_batch(tb.input_ids.numpy().astype(np.int32), mask)
    jpb, jpos, jcache, jtotal = prefix_forward_args(prefix, jb, jnp.float32, extra_len=3)
    forward = jax.jit(jlvlm.lvlm_forward,
                      static_argnames=("cfg", "kv_total_len", "prefix_flash_len", "attn_impl"))
    want = forward(params, cfg, jpb, position_ids=jpos, kv_cache=jcache, kv_total_len=jtotal,
                   prefix_flash_len=P, attn_impl="flash" if flash else "xla").logits
    _close(logits[P], want, TOL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_heads", [2, 1], ids=["gqa", "one-kv-head"])
def test_prefix_train_steps_match_jax(kv_heads):
    """With one KV head ``torch.einsum`` saves a view of the cache for the
    backward pass (no permute to copy it), so a cache append in place after
    the layer raises in ``backward``; the decoder appends out of place
    whenever gradients are recorded."""
    tk = SimpleTokenizer(padding_side="right")
    cfg = _cfg(False, tk)
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, num_kv_heads=kv_heads))
    enc, peft = get_preset("prefix-tuning")
    frozen = jax_params(cfg)
    trainable = {"prefix": jax.tree.map(np.asarray, init_prefix_params(
        PrefixConfig(num_virtual_tokens=P), cfg.text, jax.random.PRNGKey(3)))}
    collator = TrainCollator(LVLMProcessor(cfg, tk), enc.strategy(), num_image_in_query=1)
    tb = collator(string_batch())
    common = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight)
    tx_j = build_optimizer(trainable, **_opt_kwargs(peft))
    step_j = make_train_step(cfg, enc, tx_j, donate=False, **common)
    state_j = TrainState(trainable, tx_j.init(trainable), jnp.zeros((), jnp.int32))
    tree = to_torch(trainable, "cpu")
    tx_t = to.build_optimizer(tree, **_opt_kwargs(peft))
    step_t = ts.make_train_step(cfg, port_enc(enc), tx_t, **common)
    state_t = ts.TrainState(tree, tx_t.init(tree), 0)
    frozen_t = to_torch(frozen, "cpu")
    batch_j, batch_t = _to_device_batch(tb), ts.to_device_batch(tb, "cpu")
    td.ATTN_PATH_LOG.clear()
    for _ in range(STEPS):
        state_j, m_j = step_j(state_j, frozen, batch_j)
        state_t, m_t = step_t(state_t, frozen_t, batch_t)
        _check_metrics(m_t, m_j)
    assert td.ATTN_PATH_LOG == ["cached"] * STEPS  # the plain cached path, as in JAX
    for k, w in state_j.trainable["prefix"].items():
        w, g = np.asarray(w), state_t.trainable["prefix"][k].numpy()
        assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w), k
        assert not np.array_equal(g, trainable["prefix"][k])  # the prefix moved


# ---------------------------------------------------------------------------
# generation, the int8 prompt KV, the runner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gen_setup(tiny):
    cfg, tk, params, prefix = tiny
    rng = np.random.default_rng(0)
    images = [[rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8)] for _ in range(2)]
    enc = LVLMProcessor(cfg, tk)(images, TEXTS)
    jb = jlvlm.LVLMBatch(
        input_ids=jnp.asarray(enc["input_ids"]), attention_mask=jnp.asarray(enc["attention_mask"]),
        pixel_values=jnp.asarray(enc["pixel_values"]), pixel_mask=jnp.asarray(enc["pixel_mask"]),
        patch_mask=jnp.asarray(enc["patch_mask"]))
    tb = tlvlm.LVLMBatch(
        input_ids=torch.from_numpy(enc["input_ids"]).long(),
        attention_mask=torch.from_numpy(enc["attention_mask"]),
        pixel_values=torch.from_numpy(enc["pixel_values"]),
        patch_mask=torch.from_numpy(enc["patch_mask"]))
    return cfg, tk, params, prefix, jb, tb, images


@pytest.mark.parametrize("beams", [1, 3], ids=["greedy", "beam3"])
def test_generation_with_prefix_matches_jax(gen_setup, beams):
    cfg, tk, params, prefix, jb, tb, _ = gen_setup
    common = dict(max_new_tokens=6, eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id)
    params_t, prefix_t = to_torch(params, "cpu"), to_torch(prefix, "cpu")
    td.ATTN_PATH_LOG.clear()
    if beams == 1:
        want = jg.greedy_generate(params, cfg, jb, prefix=prefix, **common)
        got = tg.greedy_generate(params_t, cfg, tb, prefix=prefix_t, **common)
        plain = tg.greedy_generate(params_t, cfg, tb, **common)
    else:
        want = jg.beam_generate(params, cfg, jb, num_beams=3, prefix=prefix, **common)
        got = tg.beam_generate(params_t, cfg, tb, num_beams=3, prefix=prefix_t, **common)
        plain = tg.beam_generate(params_t, cfg, tb, num_beams=3, **common)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4,
                                   atol=1e-4)
    assert td.ATTN_PATH_LOG[0] == "xla+prefix"
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert not torch.equal(got.tokens, plain.tokens)  # the prefix steered the tokens


STATIC = ("cfg", "max_new_tokens", "eos_token_id", "pad_token_id", "temperature", "top_k",
          "top_p", "logz2", "attn_impl")


def test_sampling_with_prefix_and_adapters_matches_jax(gen_setup, monkeypatch):
    cfg, tk, params, prefix, jb, tb, _ = gen_setup
    _, peft = get_preset("lora")
    lora = jax.tree.map(np.asarray, init_lora_params(peft.lora, cfg.text, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(6)
    lora = {k: v + 0.5 * rng.standard_normal(v.shape).astype(np.float32) if k.endswith("_b")
            else v for k, v in lora.items()}
    steps, seed, kw = 5, 11, dict(temperature=0.7, top_k=5)
    common = dict(eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id,
                  lora_scaling=peft.lora.scaling(), **kw)
    want = jg.sample_generate(params, cfg, jb, steps, rng=jax.random.PRNGKey(seed),
                              adapters=lora, prefix=prefix, **common)
    V = cfg.text.vocab_size
    noise = [torch.from_numpy(np.array(jax.random.gumbel(k, (2, V), jnp.float32)))
             for k in _jax_keys(seed, steps)]
    drawn = []

    def replay(generator, shape):
        drawn.append(shape)
        return noise[len(drawn) - 1]

    monkeypatch.setattr(tg, "gumbel", replay)
    got = tg.sample_generate(to_torch(params, "cpu"), cfg, tb, steps,
                             generator=torch.Generator().manual_seed(0),
                             adapters=to_torch(lora, "cpu"), prefix=to_torch(prefix, "cpu"),
                             **common)
    assert len(drawn) == steps + 1
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-4)


def test_int8_prompt_kv_of_a_prefixed_prompt_holds_jax_bytes():
    """Sp = P + T = 132 slots pad to 256: ``padded_len`` gives the bytes of JAX's
    zero-padded quantization without the copy."""
    rng = np.random.default_rng(1)
    pk, pv = (rng.standard_normal((2, 2, P + 128, 2, 128)).astype(np.float32) for _ in range(2))
    pad = ((0, 0), (0, 0), (0, 256 - (P + 128)), (0, 0), (0, 0))
    want = jda.quantize_prompt_kv(jnp.pad(jnp.asarray(pk), pad), jnp.pad(jnp.asarray(pv), pad))
    got = tda.quantize_prompt_kv(torch.from_numpy(pk), torch.from_numpy(pv), padded_len=256)
    for g, w in zip(got, want):
        assert g["q8"].shape == (2, 2, 2, 256, 128)
        np.testing.assert_array_equal(g["q8"].numpy(), np.asarray(w["q8"]))
        np.testing.assert_array_equal(g["scale"].numpy(), np.asarray(w["scale"]))


def test_runner_and_eval_gate_with_a_prefix_only(gen_setup, tmp_path):
    cfg, tk, params, prefix, _, _, images = gen_setup
    runner = LVLMRunner(cfg, to_torch(params, "cpu"), SimpleTokenizer(), device="cpu",
                        pad_multiple=32)
    jrunner = JaxRunner(cfg, params, SimpleTokenizer(), pad_multiple=32)
    runner.set_shift(None, prefix=to_torch(prefix, "cpu"))
    jrunner.set_shift(None, prefix=prefix)
    assert runner.adapters is None and runner.prefix["k"].shape[1] == P
    got = runner.generate(images, TEXTS, num_beams=3, max_new_tokens=5)
    assert got == jrunner.generate(images, TEXTS, num_beams=3, max_new_tokens=5)

    ecfg = tconfig.EvalConfig(model_name="tiny-idefics2", ckpt_path=str(tmp_path / "epoch-0"),
                              batch_size=2, iterations=1)
    ecfg.runname = "gate"
    ecfg.data.name, ecfg.data.num_query_samples, ecfg.data.num_shot = "vqav2", 2, 1
    out = tevaluate.run_eval(ecfg, runner, result_dir=str(tmp_path), splits=synthetic_vqa_splits())
    assert out is not None and "overall" in out[1]
    runner.set_shift(None)  # no trained parameters at all: still rejected
    ecfg.resume = False
    with pytest.raises(ValueError, match="trained parameters"):
        tevaluate.run_eval(ecfg, runner, result_dir=str(tmp_path), splits=synthetic_vqa_splits())
