"""The idefics1 family in mimic_tpu_torch against the JAX package (fp32, CPU).

``tiny-idefics1``: a CLIP-style tower (class token, pre-layernorm,
``quick_gelu``), the idefics1 perceiver resampler and a text tower with one
gated cross-attention layer before every two self layers.  Parameters come
from the JAX initialisers through ``bridge.to_torch`` (the cross-attention
gates opened, so that the images matter), batches from the shared processor
on seeded numpy images.  Held here, each against the JAX function it ports:

- ``vit_forward`` on the CLIP tower (plain and flash paths), the idefics1
  ``perceiver_forward`` with and without a context mask, ``decoder_forward``
  with cross layers (left padding, rows before the first image with an
  all-false cross mask: finite, as JAX's mean of v; per-layer captures across
  the groups), ``lvlm_forward`` with a ``pixel_mask`` that drops an image:
  1e-5 relative;
- greedy, beam-3 and sampled tokens (JAX's Gumbel noise handed to the port),
  identical; the image attention mask changes the logits;
- ``"int8-memory"`` / ``"int8-w8a8"``: quantized trees bit-identical to JAX's
  (cross layers unfused and weight-only), beam-3 tokens identical;
- the ``mimic`` and ``licv`` train steps on the collator's idefics1 batch, 5
  steps: metrics and shift trees within 1e-5 (``mimic`` also on the flash path
  at head dim 128);
- ``convert_idefics1`` on a tiny ``IdeficsForVisionText2Text`` built from a
  local config (decoupled extra rows included): the tree equals the JAX
  converter's, logits within 2e-4 of HF's;
- the few-shot ICL eval (``run_eval``): records identical to the JAX harness's;
- the runner's family template and its vision-cache refusal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import EvalConfig as JaxEvalConfig
from mimic_tpu.config import get_preset
from mimic_tpu.models import convert as jconvert
from mimic_tpu.models import decoder as jd
from mimic_tpu.models import generate as jg
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models import vision as jv
from mimic_tpu.models.config import get_model_config, tiny_text
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.runner import LVLMRunner as JaxRunner
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.ops.quant import quantize_lm_params as jax_quantize
from mimic_tpu.pipeline import evaluate as jevaluate
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu.train import TrainCollator, TrainState, build_optimizer, make_train_step
from mimic_tpu.train.step import _to_device_batch
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch.bridge import to_torch, tree_leaves
from mimic_tpu_torch.models import convert as tconvert
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models import vision as tv
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.ops.quant import quantize_lm_params
from mimic_tpu_torch.pipeline import evaluate as tevaluate
from mimic_tpu_torch.train import optim as to
from mimic_tpu_torch.train import step as ts
from test_eval_e2e import synthetic_vqa_splits
from test_torch_train_step import _check_metrics, _check_tree, _opt_kwargs, port_enc
from test_train_step import string_batch

TOL = 1e-5
TOL_HF = 2e-4
# a first row of plain text, so that its first tokens precede every image
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


def _cfg(tk, **text_kw):
    cfg = tiny_text("idefics1", **text_kw) if text_kw else get_model_config("tiny-idefics1")
    cfg = cfg.replace(image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
                      bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    return cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))


def _params(cfg):
    params = jlvlm.init_lvlm_params(cfg, jax.random.PRNGKey(0))
    cross = params["lm"]["decoder"]["cross"]
    # open the gates (zero at init) so that the images reach the logits
    cross["alpha_attn"] = jnp.full_like(cross["alpha_attn"], 0.5)
    cross["alpha_dense"] = jnp.full_like(cross["alpha_dense"], -0.3)
    return jax.tree.map(np.asarray, params)


def _images(n=2):
    rng = np.random.default_rng(0)
    return [[rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8) for _ in range(2)]
            for _ in range(n)]


@pytest.fixture(scope="module")
def setup():
    tk = SimpleTokenizer(padding_side="left")
    cfg = _cfg(tk)
    params = _params(cfg)
    enc = LVLMProcessor(cfg, tk)(_images(), TEXTS)
    return cfg, tk, params, to_torch(params, "cpu"), enc


def _batches(enc):
    names = ("input_ids", "attention_mask", "pixel_values", "pixel_mask", "image_attention_mask")
    jb = jlvlm.LVLMBatch(**{k: jnp.asarray(enc[k]) for k in names})
    tb = tlvlm.LVLMBatch(**{k: torch.from_numpy(enc[k]) for k in names})
    return jb, tb._replace(input_ids=tb.input_ids.long())


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_clip_tower_matches_jax(setup, attn_impl):
    cfg, _, params, tparams, enc = setup
    px = enc["pixel_values"].reshape((-1,) + enc["pixel_values"].shape[2:])
    want = jv.vit_forward(params["vision"], cfg.vision, jnp.asarray(px), attn_impl=attn_impl)
    got = tv.vit_forward(tparams["vision"], cfg.vision, torch.from_numpy(px), attn_impl=attn_impl)
    assert got.shape == (px.shape[0], 1 + cfg.vision.num_patches - 1, cfg.vision.hidden_size)
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "context-mask"])
def test_idefics1_perceiver_matches_jax(setup, masked):
    cfg, _, params, tparams, _ = setup
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(3, 5, cfg.vision.hidden_size)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 5), np.int32)
        mask[0, 3:] = 0
        mask[2, 1] = 0
    want = jv.perceiver_forward(params["perceiver"], cfg.perceiver, jnp.asarray(feats),
                                norm_eps=1e-5,
                                context_mask=None if mask is None else jnp.asarray(mask))
    got = tv.perceiver_forward(tparams["perceiver"], cfg.perceiver, torch.from_numpy(feats),
                               norm_eps=1e-5,
                               context_mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (3, cfg.perceiver.num_latents, cfg.vision.hidden_size)
    _close(got, want)


def test_decoder_with_gated_cross_attention_matches_jax(setup):
    """Left padding and rows before the first image (all-false cross-mask
    rows), a MimIC shift, captures of every self layer gathered at two rows."""
    cfg, _, params, tparams, _ = setup
    rng = np.random.default_rng(2)
    B, T, N, lat = 2, 12, 2, cfg.perceiver.num_latents
    embeds = rng.normal(size=(B, T, cfg.text.hidden_size)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, :3] = 0
    img_attn = np.zeros((B, T, N), np.int32)
    img_attn[0, 2:7, 0] = 1
    img_attn[0, 7:, 1] = 1
    img_attn[1, 8:, 0] = 1  # row 1: tokens 0..7 attend no image
    cross = rng.normal(size=(B, N * lat, cfg.text.cross_kv_dim)).astype(np.float32)
    cross_mask = np.repeat(img_attn.astype(bool), lat, axis=-1)[:, None]
    enc_cfg, _ = get_preset("mimic")
    shift = jax.tree.map(np.asarray, init_shift_params(enc_cfg, cfg.text, jax.random.PRNGKey(1)))
    idx = np.array([[4, 11], [1, 11]], np.int32)
    kw = dict(capture_attn=True, capture_ffn=True)
    want = jd.decoder_forward(
        params["lm"]["decoder"], cfg.text, jnp.asarray(embeds),
        jd.make_causal_mask(jnp.asarray(mask)), jd.positions_from_mask(jnp.asarray(mask)),
        shift=shift, key_mask=jnp.asarray(mask), cross_states=jnp.asarray(cross),
        cross_mask=jnp.asarray(cross_mask), capture_gather_idx=jnp.asarray(idx), **kw)
    mask_t = torch.from_numpy(mask)
    got = td.decoder_forward(
        tparams["lm"]["decoder"], cfg.text, torch.from_numpy(embeds),
        td.make_causal_mask(mask_t), td.positions_from_mask(mask_t),
        shift=to_torch(shift, "cpu"), key_mask=mask_t, cross_states=torch.from_numpy(cross),
        cross_mask=torch.from_numpy(cross_mask), capture_gather_idx=torch.from_numpy(idx), **kw)
    assert torch.isfinite(got.hidden).all()
    _close(got.hidden, want.hidden)
    assert got.attn_capture.shape == (cfg.text.num_layers, B, 2, cfg.text.hidden_size)
    _close(got.attn_capture, want.attn_capture)
    _close(got.ffn_capture, want.ffn_capture)
    # the cross layers ran: without the image states the output differs
    bare = td.decoder_forward(
        tparams["lm"]["decoder"], cfg.text, torch.from_numpy(embeds),
        td.make_causal_mask(mask_t), td.positions_from_mask(mask_t), key_mask=mask_t)
    assert not torch.allclose(bare.hidden, got.hidden, atol=1e-3)


def test_all_false_cross_rows_average_v(setup):
    """A row that attends no image: JAX's NEG-masked softmax gives every key
    the same weight (the mean of v), never NaN; so does the port."""
    cfg, _, params, tparams, _ = setup
    cp = {name: w[0] for name, w in params["lm"]["decoder"]["cross"].items()}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 3, cfg.text.hidden_size)).astype(np.float32)
    states = rng.normal(size=(1, 4, cfg.text.cross_kv_dim)).astype(np.float32)
    rows = np.zeros((1, 1, 3, 4), bool)
    rows[..., 2, 1:] = True  # rows 0 and 1 attend no image, row 2 three keys
    want = jd._cross_attention(cp, jnp.asarray(x), jnp.asarray(states), jnp.asarray(rows),
                               cfg.text)
    cross = tparams["lm"]["decoder"]["cross"]
    got = td._cross_attention({name: td._cross_view(w, 0) for name, w in cross.items()},
                              torch.from_numpy(x), torch.from_numpy(states),
                              torch.from_numpy(rows), cfg.text)
    assert torch.isfinite(got).all()
    _close(got, want)


def test_lvlm_forward_with_a_dropped_image_matches_jax(setup):
    cfg, _, params, tparams, enc = setup
    enc = dict(enc, pixel_mask=enc["pixel_mask"].copy())
    enc["pixel_mask"][1, 0] = 0  # row 1's first image is a padding slot
    jb, tb = _batches(enc)
    want = jlvlm.lvlm_forward(params, cfg, jb)
    got = tlvlm.lvlm_forward(tparams, cfg, tb)
    _close(got.logits, want.logits)
    full = tlvlm.lvlm_forward(tparams, cfg, _batches(setup[4])[1])
    assert not torch.allclose(full.logits[1], got.logits[1], atol=1e-4)
    torch.testing.assert_close(full.logits[0], got.logits[0])


def test_image_attention_mask_matters(setup):
    """Swapping which image each token attends changes the output (both packages)."""
    cfg, _, params, tparams, enc = setup
    jb, tb = _batches(enc)
    flip_j = jb._replace(image_attention_mask=jb.image_attention_mask[:, :, ::-1])
    flip_t = tb._replace(image_attention_mask=tb.image_attention_mask.flip(-1))
    a = tlvlm.lvlm_forward(tparams, cfg, tb).logits
    b = tlvlm.lvlm_forward(tparams, cfg, flip_t).logits
    assert not torch.allclose(a, b, atol=1e-6)
    _close(b, jlvlm.lvlm_forward(params, cfg, flip_j).logits)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


def test_greedy_and_beam_tokens_match_jax(setup):
    cfg, tk, params, tparams, enc = setup
    jb, tb = _batches(enc)
    ids = (tk.eos_token_id, tk.pad_token_id)
    want = jg.greedy_generate(params, cfg, jb, 5, *ids)
    got = tg.greedy_generate(tparams, cfg, tb, 5, *ids)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    want = jg.beam_generate(params, cfg, jb, 5, 3, *ids)
    got = tg.beam_generate(tparams, cfg, tb, 5, 3, *ids)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.scores, want.scores)


def test_sampled_tokens_match_jax(setup, monkeypatch):
    """JAX's Gumbel noise handed to the port (as tests/test_torch_sampling.py
    does): the keys of ``k0, rng = split(rng)`` and one split per step."""
    cfg, tk, params, tparams, enc = setup
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


@pytest.mark.parametrize("mode", ["int8-memory", "int8-w8a8"])
def test_int8_trees_and_tokens_match_jax(setup, mode):
    """The cross layers quantize unfused and weight-only (no ``a8``), the self
    layers fused; the trees are bit-identical to JAX's, the tokens identical."""
    cfg, tk, params, tparams, enc = setup
    aq = mode == "int8-w8a8"
    want_tree = jax.tree.map(np.asarray, jax_quantize(params, act_quant=aq))
    got_tree = quantize_lm_params(tparams, act_quant=aq)
    flat_w = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    flat_g = {tuple(str(getattr(p, "key", p)) for p in path): None for path, _ in flat_w}
    assert len(tree_leaves(got_tree)) == len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        node = got_tree
        for p in path:
            node = node[p.key]
        assert node.dtype == to_torch(leaf, "cpu").dtype, path
        assert np.array_equal(node.numpy(), leaf), path
    cross = got_tree["lm"]["decoder"]["cross"]
    assert "qkv_proj" not in cross and all("a8" not in cross[k] for k in ("q_proj", "k_proj"))
    assert ("a8" in got_tree["lm"]["decoder"]["layers"]["qkv_proj"]) == aq
    jb, tb = _batches(enc)
    ids = (tk.eos_token_id, tk.pad_token_id)
    want = jg.beam_generate(want_tree, cfg, jb, 4, 3, *ids)
    got = tg.beam_generate(got_tree, cfg, tb, 4, 3, *ids)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_runner_template_and_vision_cache(setup):
    cfg, tk, _, tparams, _ = setup
    runner = LVLMRunner(cfg, tparams, tk, device="cpu")
    assert runner.template == "idefics1"
    with pytest.raises(ValueError, match="cross-attention"):
        runner.enable_vision_cache()


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
    """5 steps of each package's make_train_step on the collator's idefics1
    batch (its ``query_img_attn`` / ``full_img_attn`` reach the cross layers)."""
    cfg, tk, frozen = _train_setup(flash)
    enc, peft = get_preset(preset)
    shift = jax.tree.map(np.asarray, init_shift_params(enc, cfg.text, jax.random.PRNGKey(1)))
    trainable = {"shift": shift}
    collator = TrainCollator(LVLMProcessor(cfg, tk), enc.strategy(), num_image_in_query=1,
                             pad_multiple=128 if flash else 64)
    tb = collator(string_batch())
    assert tb.query_img_attn is not None and tb.full_img_attn is not None
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
    for _ in range(5):
        state_j, m_j = step_j(state_j, frozen, batch_j)
        state_t, m_t = step_t(state_t, frozen_t, batch_t)
        _check_metrics(m_t, m_j)
    assert set(td.ATTN_PATH_LOG) == {attn_impl}
    _check_tree(state_t.trainable, state_j.trainable)


# ---------------------------------------------------------------------------
# the HF checkpoint converter
# ---------------------------------------------------------------------------


def _tiny_hf_idefics(extra_rows):
    from transformers.models.idefics.configuration_idefics import (
        IdeficsConfig, IdeficsPerceiverConfig, IdeficsVisionConfig,
    )
    from transformers.models.idefics.modeling_idefics import IdeficsForVisionText2Text

    torch.manual_seed(0)
    cfg_hf = IdeficsConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, rms_norm_eps=1e-6,
        cross_layer_interval=2, qk_layer_norms=True, use_resampler=True,
        tie_word_embeddings=False, additional_vocab_size=extra_rows,
        freeze_text_layers=False,
        vision_config=IdeficsVisionConfig(
            embed_dim=32, image_size=28, patch_size=14, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
        ),
        perceiver_config=IdeficsPerceiverConfig(
            resampler_n_latents=4, resampler_depth=2, resampler_n_heads=2,
            resampler_head_dim=16, qk_layer_norms_perceiver=True,
        ),
        attn_implementation="eager",
    )
    cfg_hf._attn_implementation = "eager"
    # the gates keep HF's zero init: with them open, HF zeroes the cross-attention
    # output of a token that attends no image, where both packages give it the
    # mean of v (ROADMAP.md, section C)
    return IdeficsForVisionText2Text(cfg_hf).eval().float()


def _parity_cfg(vocab):
    from mimic_tpu_torch.models.config import (
        ModelConfig, PerceiverConfig, TextConfig, VisionConfig,
    )

    return ModelConfig(
        name="parity", family="idefics1",
        text=TextConfig(vocab_size=vocab, hidden_size=64, num_layers=4, num_heads=4,
                        num_kv_heads=4, intermediate_size=128, norm_eps=1e-6,
                        cross_qk_layernorm=True, cross_attn_interval=2, cross_kv_dim=32),
        vision=VisionConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                            image_size=28, patch_size=14, use_class_token=True,
                            hidden_act="quick_gelu", norm_eps=1e-5),
        perceiver=PerceiverConfig(num_latents=4, num_layers=2, num_heads=2, head_dim=16,
                                  style="idefics1", qk_layernorm=True),
        image_token_id=-1, pad_token_id=0, image_seq_len=0,
    )


def _assert_same_tree(got, want, path=()):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], path + (k,))
        return
    want = to_torch(np.asarray(want), "cpu")
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got, want), path


def test_convert_idefics1_matches_jax_and_hf():
    model = _tiny_hf_idefics(extra_rows=3)
    sd = model.state_dict()
    assert "model.embed_tokens.additional_embedding.weight" in sd
    cfg = _parity_cfg(vocab=131)
    got = tconvert.convert_idefics1(sd, cfg)
    want = jconvert.convert_idefics1({k: v.numpy() for k, v in sd.items()}, cfg)
    _assert_same_tree(got, want)
    assert got["lm"]["embed"].shape == (131, 64) and got["lm"]["lm_head"].shape == (64, 131)

    B, T, N = 1, 10, 1
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 130, size=(B, T)).astype(np.int64)
    attn = np.ones((B, T), np.int64)
    pixels = rng.normal(size=(B, N, 3, 28, 28)).astype(np.float32)
    img_attn = np.zeros((B, T, N), np.int64)
    img_attn[:, 3:, 0] = 1  # tokens from position 3 attend image 0
    with torch.no_grad():
        hf = model(input_ids=torch.tensor(ids), attention_mask=torch.tensor(attn),
                   pixel_values=torch.tensor(pixels),
                   image_attention_mask=torch.tensor(img_attn)).logits.numpy()
    batch = tlvlm.LVLMBatch(
        input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(attn),
        pixel_values=torch.from_numpy(pixels.transpose(0, 1, 3, 4, 2).copy()),
        pixel_mask=torch.ones(B, N, dtype=torch.int32),
        image_attention_mask=torch.from_numpy(img_attn),
    )
    ours = tlvlm.lvlm_forward(got, cfg, batch).logits.numpy()
    np.testing.assert_allclose(ours, hf, rtol=TOL_HF, atol=TOL_HF)


# ---------------------------------------------------------------------------
# the few-shot ICL eval
# ---------------------------------------------------------------------------


def test_icl_eval_records_match_jax(setup, tmp_path):
    """run_eval in ICL mode (no checkpoint), 2 shots, beam 3: the port's
    records and metric are the JAX harness's, on runners with the same weights."""
    cfg, _, params, tparams, _ = setup
    results = {}
    for side, cfg_cls, ev, runner in (
            ("jax", JaxEvalConfig, jevaluate,
             JaxRunner(cfg, jax.tree.map(jnp.asarray, params),
                       SimpleTokenizer(padding_side="left"), pad_multiple=32)),
            ("torch", tconfig.EvalConfig, tevaluate,
             LVLMRunner(cfg, tparams, SimpleTokenizer(padding_side="left"), device="cpu",
                        pad_multiple=32))):
        ecfg = cfg_cls(model_name="tiny-idefics1", batch_size=2, iterations=2)
        ecfg.data.name, ecfg.data.num_query_samples, ecfg.data.num_shot = "vqav2", 4, 2
        results[side] = ev.run_eval(ecfg, runner, result_dir=str(tmp_path / side),
                                    splits=synthetic_vqa_splits())
    keys = ("question_id", "raw_output", "prediction", "answers")
    fields = {s: [{k: r[k] for k in keys} for r in results[s][0]] for s in results}
    assert len(fields["torch"]) == 4
    assert fields["torch"] == fields["jax"]
    assert results["torch"][1] == results["jax"][1]


@pytest.mark.parametrize("preset", ["licv", "mimic"])
def test_cli_train_and_eval(preset, tmp_path):
    """``python -m mimic_tpu_torch train`` and ``eval`` with ``model_name``
    ``tiny-idefics1`` on the CPU (random weights): config 3's ``licv`` and the
    ``mimic`` preset train, and the checkpoint evaluates."""
    from mimic_tpu_torch.pipeline import cli as tcli

    common = ["model_name=tiny-idefics1", f"preset={preset}", "dtype=float32", "device=cpu",
              "batch_size=2", "data.name=vqav2", "data.num_query_samples=4", "data.num_shot=1",
              f"result_dir={tmp_path}"]
    state = tcli._train(common + ["runname=i1", "epochs=1", "accumulate_grad_batches=1"],
                        splits=synthetic_vqa_splits())
    assert state.step == 2 and set(state.trainable) == {"shift"}
    ckpt = tmp_path / "ckpt" / "i1-tiny-idefics1-vqav2-4-1shot" / "epoch-0"
    records, metrics = tcli._eval(common + [f"ckpt_path={ckpt}", "iterations=1"],
                                  splits=synthetic_vqa_splits())
    assert len(records) == 2 and "overall" in metrics
