"""LoRA in mimic_tpu_torch against mimic_tpu, fp32 on the CPU.

A tiny idefics2 with JAX-initialised parameters and adapters carried across
by the bridge (B perturbed off zero wherever a forward is compared, so the
adapters change the output).  Checked:

- ``init_lora_params``: keys, shapes, dtype, B = 0, A inside ±√(6/d_in)
  (its draws differ from ``jax.random``'s by design);
- query-pass logits with live adapters on the plain and ``"flash"`` paths and
  over an int8 tree (the deltas after ``qdot`` and the fused q/k/v split):
  rtol = atol = 1e-5;
- ``merge_lora``: out of place, equal to JAX's merge, and the merged tree's
  logits equal the live adapters' within 2e-5 (JAX's own bound);
- ``make_train_step`` with the ``lora`` and ``mini_lora`` presets and no
  dropout: 3 steps, metrics rtol 1e-5, trees 1e-5 in norm per leaf;
- LoRA dropout 0.05: with JAX's masks handed to ``lora_dropout_keep`` the trees
  agree (1e-5); the port's own masks repeat under a seed and change with the
  step;
- greedy and beam-3 generation with live adapters: tokens identical to JAX's;
- the ``lora`` preset through ``run_pipeline`` (train, merge at load, eval):
  the runner keeps its pristine base and the eval records are JAX's own on
  the same checkpoint.

Each test runs on one torch thread, as ``test_torch_feature_cache.py`` does.
"""

import dataclasses
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import get_preset
from mimic_tpu.models import generate as jg
from mimic_tpu.models import lvlm as jlvlm
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.runner import LVLMRunner as JaxRunner
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.ops import quant as jq
from mimic_tpu.pipeline import runner as jpipeline
from mimic_tpu.shift.lora import init_lora_params, merge_lora as jax_merge_lora
from mimic_tpu.train import TrainCollator, TrainState, build_optimizer, make_train_step
from mimic_tpu.train.step import _query_lvlm_batch, _to_device_batch
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.ops import quant as tq
from mimic_tpu_torch.pipeline import runner as tpipeline
from mimic_tpu_torch.shift import lora as tlora
from mimic_tpu_torch.train import optim as to
from mimic_tpu_torch.train import step as ts
from test_eval_e2e import synthetic_vqa_splits
from test_torch_train_step import _cfg, _check_metrics, _opt_kwargs, port_enc
from test_train_step import string_batch

TOL = 1e-5
MERGE_TOL = 2e-5
STEPS = 3
# JAX's reference forward as one compiled program (its op-by-op dispatch
# compiles every op on first use and takes several times longer here)
jax_lvlm_forward = jax.jit(jlvlm.lvlm_forward, static_argnames=("cfg", "attn_impl"))


@functools.lru_cache(maxsize=None)
def jax_params(cfg):
    """JAX's initial parameters for ``cfg`` (key 0), as numpy, from one
    compiled program."""
    init = jax.jit(jlvlm.init_lvlm_params, static_argnums=0)
    return jax.tree.map(np.asarray, init(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_SETUPS = {}


def setup(preset: str, flash: bool):
    """Config, frozen tree, JAX's initial adapters (B = 0) and the collated batch."""
    key = (preset, flash)
    if key not in _SETUPS:
        tk = SimpleTokenizer(padding_side="right")
        cfg = _cfg(flash, tk)
        enc, peft = get_preset(preset)
        frozen = jax_params(cfg)
        lora = jax.tree.map(np.asarray, init_lora_params(peft.lora, cfg.text,
                                                         jax.random.PRNGKey(2)))
        collator = TrainCollator(LVLMProcessor(cfg, tk), enc.strategy(), num_image_in_query=1,
                                 pad_multiple=128 if flash else 64)
        _SETUPS[key] = (cfg, enc, peft, frozen, lora, collator(string_batch()))
    return _SETUPS[key]


def perturbed(lora, scale=0.05):
    """B off zero (at init the adapters change nothing)."""
    rng = np.random.default_rng(6)
    return {k: (v + scale * rng.standard_normal(v.shape).astype(np.float32)
                if k.endswith("_b") else v) for k, v in lora.items()}


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# parameters and the forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["lora", "mini_lora", ("q",), ("k_proj",), ("v",)])
def test_init_lora_params(preset):
    """The presets' targets and single targets, by short and by full name."""
    if isinstance(preset, tuple):
        peft = dataclasses.replace(tconfig.get_preset("lora")[1])
        peft.lora = tconfig.LoraConfig(target_modules=preset)
        jax_lora = dataclasses.replace(get_preset("lora")[1].lora, target_modules=preset)
    else:
        _, peft = tconfig.get_preset(preset)
        jax_lora = get_preset(preset)[1].lora
    text = get_model_config("tiny-idefics2").text
    tree = tlora.init_lora_params(peft.lora, text, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(np.shape, init_lora_params(jax_lora, text, jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in tree.items()} == want
    for k, v in tree.items():
        assert v.dtype == torch.float32
        if k.endswith("_b"):
            assert not v.any()
        else:
            bound = (6.0 / v.shape[1]) ** 0.5
            assert v.abs().max() <= bound and v.abs().max() > 0.9 * bound
    assert tlora.lora_scaling(peft.lora) == 2.0
    with pytest.raises(ValueError, match="Unsupported"):
        tlora.init_lora_params(tconfig.LoraConfig(target_modules=("up_proj",)), text,
                               torch.Generator(), "cpu")


@pytest.mark.parametrize("path", ["xla", "flash", "int8"])
def test_query_logits_with_adapters_match_jax(path):
    cfg, _, peft, frozen, lora, tb = setup("lora", path == "flash")
    lora = perturbed(lora)
    scaling = peft.lora.scaling()
    attn_impl = "flash" if path == "flash" else "xla"
    frozen_j, frozen_t = frozen, to_torch(frozen, "cpu")
    if path == "int8":
        frozen_j = jq.quantize_lm_params(frozen)
        frozen_t = tq.quantize_lm_params(frozen_t)
        assert "qkv_proj" in frozen_t["lm"]["decoder"]["layers"]
    want = jax_lvlm_forward(frozen_j, cfg, _query_lvlm_batch(_to_device_batch(tb)),
                            adapters=lora, lora_scaling=scaling, attn_impl=attn_impl).logits
    td.ATTN_PATH_LOG.clear()
    got = tlvlm.lvlm_forward(frozen_t, cfg, ts._query_lvlm_batch(ts.to_device_batch(tb, "cpu")),
                             adapters=to_torch(lora, "cpu"), lora_scaling=scaling,
                             attn_impl=attn_impl).logits
    assert td.ATTN_PATH_LOG == [attn_impl]
    _close(got, want)
    plain = tlvlm.lvlm_forward(frozen_t, cfg, ts._query_lvlm_batch(ts.to_device_batch(tb, "cpu")),
                               attn_impl=attn_impl).logits
    assert (got - plain).abs().max() > 1e-3  # the adapters took part


@pytest.mark.parametrize("targets", [("q_proj", "k_proj", "v_proj", "o_proj"), ("o_proj",),
                                     ("q_proj", "v_proj"), ("k",)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_jax_per_target_and_dtype(targets, dtype):
    """Only the targeted projections change, summed in fp32 and cast back to
    the weights' dtype (bf16: within one rounding step of JAX's)."""
    text = get_model_config("tiny-idefics2").text
    lora_cfg = dataclasses.replace(get_preset("lora")[1].lora, target_modules=targets)
    lora = perturbed(jax.tree.map(np.asarray, init_lora_params(lora_cfg, text,
                                                               jax.random.PRNGKey(3))), 0.1)
    L, D = text.num_layers, text.hidden_size
    q_out, kv_out = text.num_heads * text.head_size, text.num_kv_heads * text.head_size
    shapes = {"q_proj": (L, D, q_out), "k_proj": (L, D, kv_out), "v_proj": (L, D, kv_out),
              "o_proj": (L, q_out, D)}
    rng = np.random.default_rng(4)
    layers = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
    tree = {"lm": {"decoder": {"layers": layers}}}
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tree_j = jax.tree.map(lambda x: jnp.asarray(x, jdtype), tree)
    tree_t = jax.tree.map(lambda x: torch.from_numpy(x).to(getattr(torch, dtype)), tree)
    want = jax_merge_lora(tree_j, lora, 2.0)["lm"]["decoder"]["layers"]
    got = tlora.merge_lora(tree_t, to_torch(lora, "cpu"), 2.0)["lm"]["decoder"]["layers"]
    shorts = {t[0] for t in targets}
    for name, w in got.items():
        assert w.dtype == getattr(torch, dtype)
        if name[0] not in shorts:
            assert w is tree_t["lm"]["decoder"]["layers"][name]
            continue
        ref = np.asarray(jnp.asarray(want[name], jnp.float32))
        tol = 2e-5 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(w.float().numpy(), ref, rtol=tol, atol=tol)
        assert not torch.equal(w, tree_t["lm"]["decoder"]["layers"][name])


@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_lora_dropout_keep_mask(rate):
    gen = torch.Generator().manual_seed(0)
    keep = td.lora_dropout_keep(gen, 3, 1, (64, 512), rate)
    assert keep.dtype == torch.bool and keep.shape == (64, 512)
    assert abs(keep.float().mean().item() - (1.0 - rate)) < 0.01
    again = td.lora_dropout_keep(torch.Generator().manual_seed(0), 3, 1, (64, 512), rate)
    assert torch.equal(keep, again)
    assert not torch.equal(keep, td.lora_dropout_keep(gen, 3, 1, (64, 512), rate))


def test_merge_lora_matches_live_adapters_and_jax():
    cfg, _, peft, frozen, lora, tb = setup("lora", False)
    lora = perturbed(lora, 0.01)
    scaling = peft.lora.scaling()
    frozen_t, lora_t = to_torch(frozen, "cpu"), to_torch(lora, "cpu")
    before = {k: v.clone() for k, v in frozen_t["lm"]["decoder"]["layers"].items()}
    merged = tlora.merge_lora(frozen_t, lora_t, scaling)
    layers = frozen_t["lm"]["decoder"]["layers"]
    assert all(torch.equal(layers[k], v) for k, v in before.items())  # input untouched
    assert merged["lm"]["decoder"]["layers"]["gate_proj"] is layers["gate_proj"]
    want = jax_merge_lora(frozen, lora, scaling)["lm"]["decoder"]["layers"]
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        _close(merged["lm"]["decoder"]["layers"][name], want[name], MERGE_TOL)
    qb = ts._query_lvlm_batch(ts.to_device_batch(tb, "cpu"))
    live = tlvlm.lvlm_forward(frozen_t, cfg, qb, adapters=lora_t, lora_scaling=scaling).logits
    folded = tlvlm.lvlm_forward(merged, cfg, qb).logits
    _close(folded, live.numpy(), MERGE_TOL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _steps(preset, flash, lora, lora_dropout=0.0, steps=STEPS):
    """JAX's and the port's steps from the same initial adapters; returns the
    per-step metrics of both and both final trees."""
    cfg, enc, peft, frozen, _, tb = setup(preset, flash)
    trainable = {"lora": lora}
    common = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                  lora_scaling=peft.lora.scaling(), lora_dropout=lora_dropout,
                  attn_impl="flash" if flash else "xla")
    tx_j = build_optimizer(trainable, **_opt_kwargs(peft))
    step_j = make_train_step(cfg, enc, tx_j, donate=False, **common)
    state_j = TrainState(trainable, tx_j.init(trainable), jnp.zeros((), jnp.int32))
    tree = to_torch(trainable, "cpu")
    tx_t = to.build_optimizer(tree, **_opt_kwargs(peft))
    step_t = ts.make_train_step(cfg, port_enc(enc), tx_t, **common)
    state_t = ts.TrainState(tree, tx_t.init(tree), 0)
    frozen_t = to_torch(frozen, "cpu")
    batch_j, batch_t = _to_device_batch(tb), ts.to_device_batch(tb, "cpu")
    metrics = []
    for _ in range(steps):
        state_j, m_j = step_j(state_j, frozen, batch_j)
        state_t, m_t = step_t(state_t, frozen_t, batch_t)
        metrics.append((m_t, m_j))
    return metrics, state_t.trainable["lora"], state_j.trainable["lora"]


def _check_tree(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].detach().numpy()
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w), k


@pytest.mark.parametrize("preset,flash", [("lora", True), ("mini_lora", False)],
                         ids=["lora-flash", "mini_lora-xla"])
def test_lora_train_steps_match_jax(preset, flash):
    _, _, _, _, lora, _ = setup(preset, flash)
    td.ATTN_PATH_LOG.clear()
    metrics, got, want = _steps(preset, flash, lora)
    # Strategy.LM_LOSS: no record pass, one shift pass per step
    assert td.ATTN_PATH_LOG == ["flash" if flash else "xla"] * STEPS
    for m_t, m_j in metrics:
        _check_metrics(m_t, m_j)
    _check_tree(got, want)
    assert np.abs(np.asarray(want["o_b"])).max() > 0  # B moved off zero


def _jax_dropout_masks(cfg, shapes, rate, seed, steps):
    """The keep masks JAX's step draws: ``fold_in(PRNGKey(seed), step)`` split
    into L x 4 keys, ``bernoulli(key[l, slot], 1 - rate, shape)``."""
    L = cfg.text.num_layers
    masks = []
    for step in range(steps):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step), L * 4)
        keys = keys.reshape(L, 4, 2)
        masks.append({(l, s): torch.from_numpy(np.array(
            jax.random.bernoulli(keys[l, s], 1.0 - rate, shapes[s]))) for l in range(L)
            for s in range(4)})
    return masks


def test_lora_dropout_with_jax_masks_matches_jax(monkeypatch):
    cfg, _, _, _, lora, tb = setup("lora", False)
    rate, steps = 0.05, 3
    B, T = tb.query_ids.shape
    H = cfg.text.num_heads * cfg.text.head_size
    shapes = [(B, T, cfg.text.hidden_size)] * 3 + [(B, T, H)]
    masks = _jax_dropout_masks(cfg, shapes, rate, 0, steps)
    drawn = []

    def replay(generator, layer, slot, shape, rate_):
        assert tuple(shape) == shapes[slot] and rate_ == rate
        if (layer, slot) == (0, 0):
            drawn.append(0)  # a new step's first draw
        return masks[len(drawn) - 1][(layer, slot)]

    monkeypatch.setattr(td, "lora_dropout_keep", replay)
    metrics, got, want = _steps("lora", False, perturbed(lora), lora_dropout=rate, steps=steps)
    assert len(drawn) == steps
    for m_t, m_j in metrics:
        _check_metrics(m_t, m_j)
    _check_tree(got, want)


def test_lora_dropout_repeats_under_a_seed_and_changes_with_the_step():
    cfg, enc, peft, frozen, lora, tb = setup("lora", False)
    trainable = to_torch({"lora": perturbed(lora)}, "cpu")
    frozen_t, batch = to_torch(frozen, "cpu"), ts.to_device_batch(tb, "cpu")

    def losses(seed, rate=0.05):
        tx = to.build_optimizer(trainable, **dict(_opt_kwargs(peft), lr=0.0))
        step = ts.make_train_step(cfg, port_enc(enc), tx, ce_loss_weight=1.0,
                                  align_loss_weight=0.0, lora_scaling=peft.lora.scaling(),
                                  lora_dropout=rate, seed=seed)
        state = ts.TrainState(trainable, tx.init(trainable), 0)
        out = []
        for _ in range(2):
            state, m = step(state, frozen_t, batch)
            out.append(float(m["loss"]))
        return out

    first = losses(0)
    assert losses(0) == first  # the same seed: the same masks
    assert first[0] != first[1]  # the next step draws other masks (lr 0: nothing else moved)
    assert losses(1)[0] != first[0]
    no_drop = losses(0, rate=0.0)
    assert no_drop[0] == no_drop[1]


# ---------------------------------------------------------------------------
# generation and the eval pipeline
# ---------------------------------------------------------------------------


TEXTS = ["Image:<image> Question: color? Answer:", "Image:<image> Question: count? Answer:"]


@pytest.fixture(scope="module")
def gen_setup():
    cfg, _, peft, frozen, lora, _ = setup("lora", False)
    tk = SimpleTokenizer(padding_side="left")
    rng = np.random.default_rng(0)
    images = [[rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8)] for _ in range(2)]
    enc = LVLMProcessor(cfg, tk)(images, TEXTS)
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
    return cfg, tk, frozen, perturbed(lora, 0.5), peft.lora.scaling(), jb, tb


@pytest.mark.parametrize("beams", [1, 3], ids=["greedy", "beam3"])
def test_generation_with_adapters_matches_jax(gen_setup, beams):
    cfg, tk, frozen, lora, scaling, jb, tb = gen_setup
    common = dict(max_new_tokens=6, eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id,
                  lora_scaling=scaling)
    if beams == 1:
        want = jg.greedy_generate(frozen, cfg, jb, adapters=lora, **common)
        got = tg.greedy_generate(to_torch(frozen, "cpu"), cfg, tb, adapters=to_torch(lora, "cpu"),
                                 **common)
        plain = tg.greedy_generate(to_torch(frozen, "cpu"), cfg, tb, **common)
    else:
        want = jg.beam_generate(frozen, cfg, jb, num_beams=3, adapters=lora, **common)
        got = tg.beam_generate(to_torch(frozen, "cpu"), cfg, tb, num_beams=3,
                               adapters=to_torch(lora, "cpu"), **common)
        plain = tg.beam_generate(to_torch(frozen, "cpu"), cfg, tb, num_beams=3, **common)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert not torch.equal(got.tokens, plain.tokens)  # the adapters steered the tokens


def _tiny_runner(side):
    tk = SimpleTokenizer(padding_side="left")
    cfg = get_model_config("tiny-idefics2").replace(
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))
    params = jax_params(cfg)
    if side == "jax":
        return JaxRunner(cfg, params, tk, pad_multiple=32)
    return LVLMRunner(cfg, to_torch(params, "cpu"), tk, device="cpu", pad_multiple=32)


def _spec(module, preset):
    return module.PipelineSpec(
        runname="lorapipe", model_name="tiny-idefics2", preset=preset, datasets=["vqav2"],
        num_query_samples=[4], num_shots=[1],
        train_overrides={"epochs": 1, "batch_size": 2, "accumulate_grad_batches": 1},
        eval_overrides={"batch_size": 2, "iterations": 1},
    )


def test_run_pipeline_merges_lora_and_writes_jax_records(tmp_path):
    runner = _tiny_runner("torch")
    base = {k: v.clone() for k, v in runner.params["lm"]["decoder"]["layers"].items()}
    summary = tpipeline.run_pipeline(_spec(tpipeline, "lora"), result_dir=str(tmp_path / "t"),
                                     runner=runner, splits=synthetic_vqa_splits())
    assert len(summary["evaluated"]) == 1
    # after the task's eval the runner holds the base again
    assert not runner._lora_merged
    assert all(torch.equal(runner.params["lm"]["decoder"]["layers"][k], v) for k, v in base.items())
    tpipeline._load_ckpt_into_runner(_eval_cfg(tmp_path / "t"), runner)
    assert runner.adapters is None and runner._lora_merged
    layers = runner.params["lm"]["decoder"]["layers"]
    pristine = runner._unmerged_params["lm"]["decoder"]["layers"]
    assert all(torch.equal(pristine[k], v) for k, v in base.items())
    assert not torch.equal(layers["q_proj"], base["q_proj"])
    assert layers["gate_proj"] is pristine["gate_proj"]
    # loading the same checkpoint again merges onto the base, not onto the merge
    merged_q = layers["q_proj"].clone()
    tpipeline._load_ckpt_into_runner(_eval_cfg(tmp_path / "t"), runner)
    assert torch.equal(runner.params["lm"]["decoder"]["layers"]["q_proj"], merged_q)
    # live adapters (merge_lora=False) restore the base and carry the tree
    cfg = _eval_cfg(tmp_path / "t")
    cfg.merge_lora = False
    tpipeline._load_ckpt_into_runner(cfg, runner)
    assert torch.equal(runner.params["lm"]["decoder"]["layers"]["q_proj"], base["q_proj"])
    assert set(runner.adapters) == {f"{s}_{ab}" for s in "qkvo" for ab in "ab"}
    assert runner.lora_scaling == 2.0 and not runner._lora_merged

    # the JAX package evaluates a copy of the port's checkpoint
    shutil.copytree(tmp_path / "t" / "ckpt", tmp_path / "j" / "ckpt")
    spec = _spec(jpipeline, "lora")
    spec.do_train = False
    jrunner = _tiny_runner("jax")
    jpipeline.run_pipeline(spec, result_dir=str(tmp_path / "j"), runner=jrunner,
                           splits=synthetic_vqa_splits())
    records = {}
    for side in ("t", "j"):
        path = tmp_path / side / "record" / "lorapipe-tiny-idefics2-vqav2-4-1shot" / "epoch-0.json"
        records[side] = json.loads(path.read_text())
    keys = ("question_id", "raw_output", "prediction", "answers")
    assert ([{k: r[k] for k in keys} for r in records["t"]["records"]]
            == [{k: r[k] for k in keys} for r in records["j"]["records"]])
    assert records["t"]["eval_result"] == records["j"]["eval_result"]


def test_run_pipeline_trains_every_lora_task_on_the_base(tmp_path, monkeypatch):
    """A two-task lora grid on one runner: the second task trains on the
    unmerged base, not on the first task's merged adapters."""
    runner = _tiny_runner("torch")
    base = {k: v.clone() for k, v in runner.params["lm"]["decoder"]["layers"].items()}
    seen = []

    def run_train(*args, **kwargs):
        layers = runner.params["lm"]["decoder"]["layers"]
        seen.append(all(torch.equal(layers[k], v) for k, v in base.items()))
        return train(*args, **kwargs)

    train = tpipeline.run_train
    monkeypatch.setattr(tpipeline, "run_train", run_train)
    spec = _spec(tpipeline, "lora")
    spec.num_shots = [1, 2]
    spec.do_analyze = False
    summary = tpipeline.run_pipeline(spec, result_dir=str(tmp_path), runner=runner,
                                     splits=synthetic_vqa_splits())
    assert len(summary["evaluated"]) == 2 and seen == [True, True]


def _eval_cfg(result_dir):
    cfg = tconfig.EvalConfig(
        model_name="tiny-idefics2",
        ckpt_path=os.path.join(str(result_dir), "ckpt", "lorapipe-tiny-idefics2-vqav2-4-1shot",
                               "epoch-0"))
    cfg.encoder, cfg.peft = tconfig.get_preset("lora")
    return cfg
