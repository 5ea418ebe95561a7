"""The llava family in mimic_tpu_torch against the JAX package (fp32, CPU).

Two tiny configurations of the family: ``tiny-llava-interleave`` as a Qwen2
text tower with q/k/v biases at seven query heads per KV head (llava-interleave-7b
has 28 / 4), a SigLIP tower without its post-layernorm and the MLP projector;
and a tiny llava-1.5 (a LLaMA text tower, a CLIP tower whose class token is
dropped after it).  Parameters come from the JAX initialisers through
``bridge.to_torch``, with the biases drawn at random (they start at zero) and
the unused ``post_ln_*`` leaves away from the identity, so that skipping the
norm is what the comparison sees.  Held here, each against the JAX function it
ports, within 1e-5 relative unless stated:

- ``vit_forward`` without a post-layernorm (plain and flash paths), the CLIP
  tower with the class token dropped (``encode_images``), ``llava_project``;
- ``lvlm_forward`` on both configurations;
- greedy, beam-3 and sampled tokens (JAX's Gumbel noise handed to the port),
  identical;
- ``"int8"`` (the decode copy), ``"int8-memory"`` and ``"int8-w8a8"``: trees
  bit-identical to JAX's (the biases stay unquantized in the tree's dtype),
  beam-3 tokens identical;
- the ``mimic`` (plain and flash paths) and ``licv`` train steps, 3 steps:
  metrics and shift trees within 1e-5;
- the eval's vision-feature cache (records identical cached, uncached and in
  JAX) and the train loop's (the cached step against JAX's cached step);
- ``run_train`` / ``run_eval`` through the CLI on ``tiny-llava-interleave``:
  the copied trainer's llava window saves from epoch 5 on;
- ``convert_llava_interleave`` on tiny HF ``LlavaForConditionalGeneration``
  models (Qwen2 + SigLIP, LLaMA + CLIP) built from local configs: logits within
  2e-4 of HF's (the trees against the JAX converter's are in
  ``tests/test_torch_convert.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import DataConfig as JDataConfig
from mimic_tpu.config import EvalConfig as JEvalConfig
from mimic_tpu.config import get_preset
from mimic_tpu.models import generate as jg
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models import vision as jv
from mimic_tpu.models.config import tiny_text
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.runner import LVLMRunner as JaxRunner
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.ops.quant import quantize_lm_params as jax_quantize
from mimic_tpu.pipeline.evaluate import run_eval as jrun_eval
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu.train import TrainCollator, TrainState, build_optimizer, make_train_step
from mimic_tpu.train.step import _to_device_batch
from mimic_tpu.train.vision_cache import TrainVisionCache as JTrainVisionCache
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch.bridge import to_torch, tree_leaves
from mimic_tpu_torch.models import convert as tconvert
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models import vision as tv
from mimic_tpu_torch.models.config import ModelConfig, TextConfig, VisionConfig
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.ops.quant import quantize_lm_params
from mimic_tpu_torch.pipeline.evaluate import run_eval
from mimic_tpu_torch.train import optim as to
from mimic_tpu_torch.train import step as ts
from mimic_tpu_torch.train.vision_cache import TrainVisionCache
from test_eval_e2e import synthetic_vqa_splits
from test_torch_train_step import _check_metrics, _check_tree, _opt_kwargs, port_enc
from test_train_step import string_batch

TOL = 1e-5
TOL_HF = 2e-4
TEXTS = [
    "Image:<image> Question: a? Answer: b\nImage:<image> Question: c? Answer:",
    "A note first. Image:<image> Question: d? Answer: e\nImage:<image> Question: f? Answer:",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run many small ops: one thread each, not a pool that every
    op must wake (beside the other test workers the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(tk, kind="interleave", **text_kw):
    """tiny llava-interleave with G = 7 (7 query heads, one KV head, head dim 16
    unless given), or tiny llava-1.5 (MHA without biases, the CLIP tower)."""
    if kind == "interleave":
        text_kw = {"hidden_size": 112, "num_heads": 7, "num_kv_heads": 1, "head_dim": 16,
                   **text_kw}
    cfg = tiny_text("llava-interleave", **text_kw)
    if kind == "1.5":
        cfg = cfg.replace(
            name="tiny-llava-1.5",
            text=dataclasses.replace(cfg.text, attn_bias=False, num_kv_heads=cfg.text.num_heads,
                                     norm_eps=1e-5),
            vision=dataclasses.replace(cfg.vision, use_class_token=True,
                                       hidden_act="quick_gelu", norm_eps=1e-5))
    cfg = cfg.replace(image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
                      bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    return cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))


def _params(cfg):
    """JAX's initialisers, the zero-initialised biases drawn at random and the
    unused post-layernorm away from the identity."""
    params = jax.tree.map(np.asarray, jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(9)
    layers = params["lm"]["decoder"]["layers"]
    for name in ("q_bias", "k_bias", "v_bias"):
        if name in layers:
            layers[name] = (0.1 * rng.normal(size=layers[name].shape)).astype(np.float32)
    proj = params["projector"]
    for name in ("fc1_bias", "fc2_bias"):
        proj[name] = (0.05 * rng.normal(size=proj[name].shape)).astype(np.float32)
    params["vision"]["post_ln_w"] = np.full_like(params["vision"]["post_ln_w"], 3.0)
    params["vision"]["post_ln_b"] = np.full_like(params["vision"]["post_ln_b"], 0.5)
    return params


def _images(n=2):
    rng = np.random.default_rng(0)
    return [[rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8) for _ in range(2)]
            for _ in range(n)]


_SETUPS = {}


def setup_for(kind):
    if kind not in _SETUPS:
        tk = SimpleTokenizer(padding_side="left")
        cfg = _cfg(tk, kind)
        params = _params(cfg)
        enc = LVLMProcessor(cfg, tk)(_images(), TEXTS)
        _SETUPS[kind] = (cfg, tk, params, to_torch(params, "cpu"), enc)
    return _SETUPS[kind]


def _batches(enc):
    names = ("input_ids", "attention_mask", "pixel_values", "pixel_mask")
    jb = jlvlm.LVLMBatch(**{k: jnp.asarray(enc[k]) for k in names})
    tb = tlvlm.LVLMBatch(**{k: torch.from_numpy(enc[k]) for k in names})
    return jb, tb._replace(input_ids=tb.input_ids.long())


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


KINDS = ["interleave", "1.5"]


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_siglip_tower_without_post_layernorm_matches_jax(attn_impl):
    cfg, _, params, tparams, enc = setup_for("interleave")
    assert not cfg.vision.post_layernorm
    px = enc["pixel_values"].reshape((-1,) + enc["pixel_values"].shape[2:])
    want = jv.vit_forward(params["vision"], cfg.vision, jnp.asarray(px), attn_impl=attn_impl)
    got = tv.vit_forward(tparams["vision"], cfg.vision, torch.from_numpy(px), attn_impl=attn_impl)
    assert got.shape == (px.shape[0], cfg.vision.num_patches, cfg.vision.hidden_size)
    _close(got, want)
    normed = tv.vit_forward(tparams["vision"], dataclasses.replace(cfg.vision, post_layernorm=True),
                            torch.from_numpy(px), attn_impl=attn_impl)
    assert not torch.allclose(normed, got, atol=1e-2)  # the skipped norm would show


def test_clip_tower_drops_the_class_token():
    """llava-1.5: ``encode_images`` runs the CLIP tower (class token first),
    drops the class token and projects one token per patch."""
    cfg, _, params, tparams, enc = setup_for("1.5")
    px = enc["pixel_values"]
    want = jlvlm.encode_images(params, cfg, jnp.asarray(px))
    got = tlvlm.encode_images(tparams, cfg, torch.from_numpy(px))
    B, N = px.shape[:2]
    assert got.shape == (B, N * cfg.image_seq_len, cfg.text.hidden_size)
    assert cfg.vision.num_patches == cfg.image_seq_len + 1
    _close(got, want)


def test_patchify_drops_the_remainder_like_a_strided_conv():
    """llava-interleave-7b's SigLIP takes 384 px images in 14 px patches: the
    patch embedding is HF's stride-14 convolution, which reads 27 x 27 patches
    and drops the last 6 rows and columns.  The port does the same; the JAX
    package's ``patchify`` raises on it (ROADMAP.md, section C)."""
    from mimic_tpu_torch.models.convert import _conv_to_dense

    rng = np.random.default_rng(4)
    px = rng.normal(size=(2, 40, 47, 3)).astype(np.float32)
    w = rng.normal(size=(8, 3, 14, 14)).astype(np.float32)
    got = tv.patchify(torch.from_numpy(px), 14) @ _conv_to_dense(torch.from_numpy(w))
    conv = torch.nn.functional.conv2d(torch.from_numpy(px).permute(0, 3, 1, 2),
                                      torch.from_numpy(w), stride=14)
    assert got.shape == (2, 2 * 3, 8)
    _close(got, conv.flatten(2).transpose(1, 2).numpy(), tol=1e-4)
    with pytest.raises(TypeError):
        jv.patchify(jnp.asarray(px), 14)


def test_projector_matches_jax():
    cfg, _, params, tparams, _ = setup_for("interleave")
    feats = np.random.default_rng(1).normal(size=(3, 5, cfg.vision.hidden_size)).astype(np.float32)
    want = jv.llava_project(params["projector"], jnp.asarray(feats))
    got = tv.llava_project(tparams["projector"], torch.from_numpy(feats))
    _close(got, want)
    # the GELU is the exact one: tanh's approximation moves the output
    approx = torch.nn.functional.gelu(torch.from_numpy(feats) @ tparams["projector"]["fc1"]
                       + tparams["projector"]["fc1_bias"], approximate="tanh")
    exact = torch.nn.functional.gelu(torch.from_numpy(feats) @ tparams["projector"]["fc1"]
                      + tparams["projector"]["fc1_bias"])
    assert not torch.equal(approx, exact)


def test_init_matches_jax_tree_shapes():
    """The port's initialiser makes the JAX tree's keys and shapes (the
    projector, the biases, the tower's unused post-layernorm)."""
    for kind in KINDS:
        cfg, _, params, _, _ = setup_for(kind)
        got = tlvlm.init_lvlm_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
        flat_w = jax.tree_util.tree_flatten_with_path(params)[0]
        assert len(tree_leaves(got)) == len(flat_w)
        for path, leaf in flat_w:
            node = got
            for p in path:
                node = node[p.key]
            assert tuple(node.shape) == leaf.shape, path
        assert (not cfg.text.attn_bias) or torch.equal(
            got["lm"]["decoder"]["layers"]["q_bias"], torch.zeros_like(
                got["lm"]["decoder"]["layers"]["q_bias"]))


@pytest.mark.parametrize("kind", KINDS)
def test_lvlm_forward_matches_jax(kind):
    cfg, _, params, tparams, enc = setup_for(kind)
    jb, tb = _batches(enc)
    want = jlvlm.lvlm_forward(params, cfg, jb)
    got = tlvlm.lvlm_forward(tparams, cfg, tb)
    _close(got.logits, want.logits)
    # the images reach the logits
    other = dict(enc, pixel_values=enc["pixel_values"][::-1].copy())
    moved = tlvlm.lvlm_forward(tparams, cfg, _batches(other)[1])
    assert not torch.allclose(moved.logits, got.logits, atol=1e-4)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_greedy_and_beam_tokens_match_jax(kind):
    cfg, tk, params, tparams, enc = setup_for(kind)
    jb, tb = _batches(enc)
    ids = (tk.eos_token_id, tk.pad_token_id)
    want = jg.greedy_generate(params, cfg, jb, 5, *ids)
    got = tg.greedy_generate(tparams, cfg, tb, 5, *ids)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    want = jg.beam_generate(params, cfg, jb, 5, 3, *ids)
    got = tg.beam_generate(tparams, cfg, tb, 5, 3, *ids)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.scores, want.scores)


def test_sampled_tokens_match_jax(monkeypatch):
    """JAX's Gumbel noise handed to the port: the keys of ``k0, rng =
    split(rng)`` and one split per step."""
    cfg, tk, params, tparams, enc = setup_for("interleave")
    jb, tb = _batches(enc)
    steps, seed, kw = 4, 5, dict(temperature=0.7, top_k=5)
    want = jg.sample_generate(params, cfg, jb, steps, tk.eos_token_id, tk.pad_token_id,
                              rng=jax.random.PRNGKey(seed), **kw)
    k0, rng = jax.random.split(jax.random.PRNGKey(seed))
    keys = [k0]
    for _ in range(steps):
        key, rng = jax.random.split(rng)
        keys.append(key)
    V = cfg.text.vocab_size
    noise = iter(torch.from_numpy(np.array(jax.random.gumbel(k, (2, V), jnp.float32)))
                 for k in keys)
    monkeypatch.setattr(tg, "gumbel", lambda generator, shape: next(noise))
    got = tg.sample_generate(tparams, cfg, tb, steps, tk.eos_token_id, tk.pad_token_id,
                             generator=torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.scores, want.scores)


def _assert_tree_equals_jax(got_tree, want_tree):
    flat_w = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(tree_leaves(got_tree)) == len(flat_w)
    for path, leaf in flat_w:
        node = got_tree
        for p in path:
            node = node[p.key]
        assert node.dtype == to_torch(leaf, "cpu").dtype, path
        assert np.array_equal(node.numpy(), leaf), path


@pytest.mark.parametrize("mode", ["int8", "int8-memory", "int8-w8a8"])
def test_int8_trees_and_tokens_match_jax(mode):
    """The int8 trees bit-identical to JAX's: q/k/v fused into ``qkv_proj``,
    the biases kept apart in fp32; beam-3 tokens identical (``"int8"``: the
    fp32 tree prefills, the int8 copy decodes)."""
    cfg, tk, params, tparams, enc = setup_for("interleave")
    aq = mode == "int8-w8a8"
    want_tree = jax.tree.map(np.asarray, jax_quantize(params, act_quant=aq))
    got_tree = quantize_lm_params(tparams, act_quant=aq)
    _assert_tree_equals_jax(got_tree, want_tree)
    layers = got_tree["lm"]["decoder"]["layers"]
    assert "qkv_proj" in layers and ("a8" in layers["qkv_proj"]) == aq
    for name in ("q_bias", "k_bias", "v_bias"):
        assert layers[name].dtype == torch.float32 and torch.equal(
            layers[name], tparams["lm"]["decoder"]["layers"][name])
    jb, tb = _batches(enc)
    ids = (tk.eos_token_id, tk.pad_token_id)
    if mode == "int8":
        want = jg.beam_generate(params, cfg, jb, 4, 3, *ids, decode_params=want_tree)
        got = tg.beam_generate(tparams, cfg, tb, 4, 3, *ids, decode_params=got_tree)
    else:
        want = jg.beam_generate(want_tree, cfg, jb, 4, 3, *ids)
        got = tg.beam_generate(got_tree, cfg, tb, 4, 3, *ids)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_runner_template():
    cfg, tk, _, tparams, _ = setup_for("interleave")
    runner = LVLMRunner(cfg, tparams, tk, device="cpu")
    assert runner.template == "llava-interleave"


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


_TRAIN = {}


def _train_setup(flash):
    if flash not in _TRAIN:
        tk = SimpleTokenizer(padding_side="right")
        cfg = _cfg(tk, head_dim=128) if flash else _cfg(tk)
        _TRAIN[flash] = (cfg, tk, _params(cfg))
    return _TRAIN[flash]


@pytest.mark.parametrize("preset,flash", [("mimic", False), ("mimic", True), ("licv", False)],
                         ids=["mimic", "mimic-flash", "licv"])
def test_train_steps_match_jax(preset, flash):
    """3 steps of each package's make_train_step on the collator's llava batch."""
    cfg, tk, frozen = _train_setup(flash)
    enc, peft = get_preset(preset)
    shift = jax.tree.map(np.asarray, init_shift_params(enc, cfg.text, jax.random.PRNGKey(1)))
    trainable = {"shift": shift}
    collator = TrainCollator(LVLMProcessor(cfg, tk), enc.strategy(), num_image_in_query=1,
                             pad_multiple=128 if flash else 64)
    tb = collator(string_batch())
    attn_impl = "flash" if flash else "xla"
    common = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                  attn_impl=attn_impl)
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
    for _ in range(3):
        state_j, m_j = step_j(state_j, frozen, batch_j)
        state_t, m_t = step_t(state_t, frozen_t, batch_t)
        _check_metrics(m_t, m_j)
    assert set(td.ATTN_PATH_LOG) == {attn_impl}
    _check_tree(state_t.trainable, state_j.trainable)


# ---------------------------------------------------------------------------
# the vision-feature caches
# ---------------------------------------------------------------------------


def _eval_cfg(cls, data_cls, vision_cache):
    cfg = cls(model_name="tiny-llava-interleave", batch_size=2, iterations=2)
    cfg.vision_cache = vision_cache
    cfg.data = data_cls(name="vqav2", num_query_samples=4, num_shot=2, seed=3407)
    cfg.generation.num_beams = 1
    cfg.generation.max_new_tokens = 4
    return cfg


def test_eval_records_identical_cached_uncached_and_to_jax(tmp_path):
    """run_eval with 2 shots over 3 support items: demo images repeat, so the
    cache hits; the records are the uncached run's and the JAX harness's."""
    cfg, _, params, tparams, _ = setup_for("interleave")
    splits = synthetic_vqa_splits(n_train=3)
    runner = LVLMRunner(cfg, tparams, SimpleTokenizer(padding_side="left"), device="cpu",
                        pad_multiple=32)
    base = run_eval(_eval_cfg(tconfig.EvalConfig, tconfig.DataConfig, False), runner,
                    result_dir=str(tmp_path / "a"), splits=splits)
    assert runner.vision_cache is None
    cached = run_eval(_eval_cfg(tconfig.EvalConfig, tconfig.DataConfig, True), runner,
                      result_dir=str(tmp_path / "b"), splits=splits)
    cache = runner.vision_cache
    assert cached == base and cache.hits > 0 and cache.misses > 0
    jr = JaxRunner(cfg, jax.tree.map(jnp.asarray, params), SimpleTokenizer(padding_side="left"),
                   pad_multiple=32)
    want = jrun_eval(_eval_cfg(JEvalConfig, JDataConfig, True), jr,
                     result_dir=str(tmp_path / "j"), splits=splits)
    assert cached == want
    assert (cache.hits, cache.misses) == (jr.vision_cache.hits, jr.vision_cache.misses)


def test_train_cache_step_matches_jax():
    """The train loop's cache: the step on cached features against JAX's step
    on its own cached features, 2 steps, within 1e-5; a second draw of the
    same images only hits."""
    cfg, tk, frozen = _train_setup(False)
    enc, peft = get_preset("mimic")
    shift = jax.tree.map(np.asarray, init_shift_params(enc, cfg.text, jax.random.PRNGKey(1)))
    collate = lambda: TrainCollator(LVLMProcessor(cfg, tk), enc.strategy(),  # noqa: E731
                                    num_image_in_query=1, emit_image_keys=True)
    tb = collate()(string_batch())
    frozen_t = to_torch(frozen, "cpu")
    xform, jxform = TrainVisionCache(cfg, frozen_t), JTrainVisionCache(cfg, frozen)
    common = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight)
    tx_j = build_optimizer({"shift": shift}, **_opt_kwargs(peft))
    step_j = make_train_step(cfg, enc, tx_j, donate=False, **common)
    state_j = TrainState({"shift": shift}, tx_j.init({"shift": shift}), jnp.zeros((), jnp.int32))
    tree = to_torch({"shift": shift}, "cpu")
    tx_t = to.build_optimizer(tree, **_opt_kwargs(peft))
    step_t = ts.make_train_step(cfg, port_enc(enc), tx_t, **common)
    state_t = ts.TrainState(tree, tx_t.init(tree), 0)
    for _ in range(2):
        fb = xform(tb)
        assert "full_feats" in fb and not any("pixel" in k for k in fb)
        state_j, m_j = step_j(state_j, frozen, jxform(tb))
        state_t, m_t = step_t(state_t, frozen_t, fb)
        _check_metrics(m_t, m_j)
    _check_tree(state_t.trainable, state_j.trainable)
    misses = xform.cache.misses
    xform(collate()(string_batch()))
    assert xform.cache.misses == misses and xform.cache.hits > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["mimic", "licv"])
def test_cli_train_and_eval(preset, tmp_path):
    """``python -m mimic_tpu_torch train`` and ``eval`` on ``tiny-llava-interleave``
    (random weights, the CPU): the copied trainer's llava window saves from
    epoch 5 on (JAX ``trainer.py:53``), and the checkpoint evaluates."""
    from mimic_tpu_torch.pipeline import cli as tcli

    common = ["model_name=tiny-llava-interleave", f"preset={preset}", "dtype=float32",
              "device=cpu", "batch_size=2", "data.name=vqav2", "data.num_query_samples=4",
              "data.num_shot=1", f"result_dir={tmp_path}"]
    state = tcli._train(common + ["runname=lv", "epochs=6", "accumulate_grad_batches=1"],
                        splits=synthetic_vqa_splits())
    assert state.step == 12 and set(state.trainable) == {"shift"}
    run_dir = tmp_path / "ckpt" / "lv-tiny-llava-interleave-vqav2-4-1shot"
    assert sorted(p.name for p in run_dir.iterdir() if p.name.startswith("epoch")) == ["epoch-5"]
    records, metrics = tcli._eval(common + [f"ckpt_path={run_dir / 'epoch-5'}", "iterations=1"],
                                  splits=synthetic_vqa_splits())
    assert len(records) == 2 and "overall" in metrics


# ---------------------------------------------------------------------------
# HF parity
# ---------------------------------------------------------------------------


def hf_llava(kind):
    """A tiny HF ``LlavaForConditionalGeneration`` (as ``tests/test_hf_parity.py``
    builds it) and the port's config for it: ``"interleave"`` a Qwen2 text
    tower at G = 7 with a SigLIP tower, ``"1.5"`` LLaMA with a CLIP tower; the
    features leave the tower's second-to-last layer."""
    from transformers import LlavaConfig, LlavaForConditionalGeneration
    from transformers.models.clip import CLIPVisionConfig
    from transformers.models.llama import LlamaConfig
    from transformers.models.qwen2 import Qwen2Config
    from transformers.models.siglip import SiglipVisionConfig

    torch.manual_seed(0)
    vis = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
               num_attention_heads=2, image_size=28, patch_size=14)
    if kind == "interleave":
        text_hf = Qwen2Config(vocab_size=128, hidden_size=112, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=7, num_key_value_heads=1,
                              rms_norm_eps=1e-6, attn_implementation="eager")
        vision_hf = SiglipVisionConfig(hidden_act="gelu_pytorch_tanh", **vis)
        strategy = "full"
    else:
        text_hf = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                              rms_norm_eps=1e-5, attn_implementation="eager",
                              attention_bias=False)
        vision_hf = CLIPVisionConfig(hidden_act="quick_gelu", **vis)
        strategy = "default"
    cfg_hf = LlavaConfig(vision_config=vision_hf, text_config=text_hf, image_token_index=99,
                         vision_feature_layer=-2, vision_feature_select_strategy=strategy,
                         projector_hidden_act="gelu")
    cfg_hf._attn_implementation = "eager"
    model = LlavaForConditionalGeneration(cfg_hf).eval().float()
    clip = kind == "1.5"
    cfg = ModelConfig(
        name="parity", family="llava-interleave",
        text=TextConfig(vocab_size=128, hidden_size=text_hf.hidden_size, num_layers=2,
                        num_heads=text_hf.num_attention_heads,
                        num_kv_heads=text_hf.num_key_value_heads, intermediate_size=128,
                        norm_eps=text_hf.rms_norm_eps, attn_bias=not clip),
        vision=VisionConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                            image_size=28, patch_size=14, use_class_token=clip,
                            hidden_act="quick_gelu" if clip else "gelu_tanh",
                            norm_eps=1e-5 if clip else 1e-6, post_layernorm=False),
        image_token_id=99, pad_token_id=0, image_seq_len=4,
    )
    return model, cfg


@pytest.mark.parametrize("kind", KINDS)
def test_converted_llava_matches_hf(kind):
    model, cfg = hf_llava(kind)
    params = tconvert.convert_llava_interleave(model.state_dict(), cfg)
    B, T = 2, 12
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 90, size=(B, T)).astype(np.int64)
    ids[:, 2:6] = 99  # 4 image slots: (28 / 14)^2 patches (llava-1.5: the class token dropped)
    attn = np.ones((B, T), np.int64)
    pixels = rng.normal(size=(B, 3, 28, 28)).astype(np.float32)
    with torch.no_grad():
        hf = model(input_ids=torch.tensor(ids), attention_mask=torch.tensor(attn),
                   pixel_values=torch.tensor(pixels)).logits.numpy()
    batch = tlvlm.LVLMBatch(
        input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(attn),
        pixel_values=torch.from_numpy(pixels.transpose(0, 2, 3, 1)[:, None].copy()),
        pixel_mask=torch.ones(B, 1, dtype=torch.int32))
    ours = tlvlm.lvlm_forward(params, cfg, batch).logits.numpy()
    np.testing.assert_allclose(ours, hf, rtol=TOL_HF, atol=TOL_HF)
