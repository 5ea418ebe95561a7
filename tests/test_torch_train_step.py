"""The training slice as a whole: mimic_tpu_torch's dual-pass step against
``mimic_tpu.train`` in fp32 on the CPU.

A tiny idefics2 with JAX-initialised parameters and shift trees carried
across by the bridge, one collated string batch (``TrainCollator``, shared by
both packages), the same optimizer settings.  Checked: ``compute_loss`` and
its metrics at the initial point, and 5 steps of ``make_train_step`` (each
step's metrics and the final trainable tree) for the ``mimic`` and
``mimic_attn_mse`` presets (layer-wise MSE on FFN / attention captures), an
LM-loss-only shift and the KL strategy (``licv``: output shift, scale-lr
group), on the plain path and, for ``mimic``, on the ``"flash"`` path
(tiny_text head dim 128, batches padded to 128).

Tolerances: metrics rtol 1e-5; the KL term, a difference of two fp32
log-softmaxes of about 1e-3, atol 1e-7; the trainable tree after 5 steps
|port − JAX| / |JAX| ≤ 1e-5 per leaf (Adam divides each gradient element by
its own running RMS, so elementwise relative differences of near-zero
gradient entries are not meaningful; the norm is).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import EncoderConfig, config_to_dict, get_preset
from mimic_tpu.models.config import get_model_config, tiny_text
from mimic_tpu.models.lvlm import init_lvlm_params
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu.train import TrainCollator, TrainState, build_optimizer, make_train_step
from mimic_tpu.train.step import _to_device_batch
from mimic_tpu.train.step import compute_loss as jax_compute_loss
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.shift import params as tsp
from mimic_tpu_torch.train import optim as to
from mimic_tpu_torch.train import step as ts
from test_train_step import string_batch

RTOL = 1e-5
KL_ATOL = 1e-7
STEPS = 5


@pytest.fixture
def one_torch_thread():
    """Tiny models run many small ops: one thread, not a pool that every op
    must wake (beside the other test workers the pool's wake-ups dominate).
    Only for the cases that compare the port with itself: the cases held to
    JAX keep the default pool, whose summation order their bounds were set on."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _preset(name):
    if name == "lm_only":
        enc = EncoderConfig(model_strategy="Strategy.LM_LOSS")
        _, peft = get_preset("mimic")
        return enc, peft
    return get_preset(name)


def port_enc(enc):
    """The port's own ``EncoderConfig`` with ``enc``'s fields (the two packages
    keep separate flag classes, so each side gets its own)."""
    return tconfig.config_from_dict(tconfig.EncoderConfig, config_to_dict(enc))


def _cfg(flash: bool, tk):
    cfg = tiny_text("idefics2", head_dim=128) if flash else get_model_config("tiny-idefics2")
    cfg = cfg.replace(image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
                      bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    return cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))


_SETUPS = {}


def setup(preset: str, flash: bool):
    """Parameters, trainable tree and collated batch for one configuration."""
    key = (preset, flash)
    if key not in _SETUPS:
        tk = SimpleTokenizer(padding_side="right")
        cfg = _cfg(flash, tk)
        enc, peft = _preset(preset)
        frozen = jax.tree.map(np.asarray, init_lvlm_params(cfg, jax.random.PRNGKey(0)))
        shift = jax.tree.map(np.asarray, init_shift_params(enc, cfg.text, jax.random.PRNGKey(1)))
        collator = TrainCollator(LVLMProcessor(cfg, tk), enc.strategy(), num_image_in_query=1,
                                 pad_multiple=128 if flash else 64)
        tb = collator(string_batch())
        _SETUPS[key] = (cfg, enc, peft, frozen, {"shift": shift}, tb)
    return _SETUPS[key]


def _opt_kwargs(peft):
    return dict(lr=peft.lr, weight_decay=1e-3, warmup_steps=2, total_steps=20, grad_clip=1.0,
                scale_lr=peft.scale_lr)


def _check_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = float(got[k]), float(np.asarray(want[k]))
        if k == "logits_kl_loss":
            assert abs(g - w) <= KL_ATOL, (k, g, w)
        else:
            assert abs(g - w) <= RTOL * abs(w), (k, g, w)


def _check_tree(got, want):
    for k, w in want["shift"].items():
        w = np.asarray(w)
        g = got["shift"][k].detach().numpy()
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= RTOL * np.linalg.norm(w), k


CONFIGS = [("mimic", False), ("mimic", True), ("mimic_attn_mse", False), ("lm_only", False),
           ("licv", False), ("attn_shift_ffn_mse", False), ("attn_shift_ffn_mse", True)]
IDS = ["mimic", "mimic-flash", "mimic_attn_mse", "lm_only", "licv-kl", "attn_shift_ffn_mse",
       "attn_shift_ffn_mse-flash"]


@pytest.mark.parametrize("preset,flash", CONFIGS, ids=IDS)
def test_compute_loss_matches_jax(preset, flash):
    cfg, enc, peft, frozen, trainable, tb = setup(preset, flash)
    attn_impl = "flash" if flash else "xla"
    enc_t = port_enc(enc)
    kw = dict(cfg=cfg, rec_attn=tsp.needs_attn_capture(enc_t),
              rec_ffn=tsp.needs_ffn_capture(enc_t), mh=tsp.multi_head(enc_t),
              ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
              logz2="unmasked", attn_impl=attn_impl)
    loss_j, metrics_j = jax_compute_loss(trainable, frozen, _to_device_batch(tb),
                                         lora_scaling=1.0, strategy=enc.strategy(), **kw)
    td.ATTN_PATH_LOG.clear()
    loss_t, metrics_t = ts.compute_loss(to_torch(trainable, "cpu"), to_torch(frozen, "cpu"),
                                        ts.to_device_batch(tb, "cpu"),
                                        strategy=enc_t.strategy(), **kw)
    n_passes = 1 if preset == "lm_only" else 2
    assert td.ATTN_PATH_LOG == [attn_impl] * n_passes
    assert abs(float(loss_t) - float(loss_j)) <= RTOL * abs(float(loss_j))
    _check_metrics(metrics_t, metrics_j)


@pytest.mark.parametrize("preset,flash", CONFIGS, ids=IDS)
def test_train_steps_match_jax(preset, flash):
    cfg, enc, peft, frozen, trainable, tb = setup(preset, flash)
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
    for _ in range(STEPS):
        state_j, m_j = step_j(state_j, frozen, batch_j)
        state_t, m_t = step_t(state_t, frozen_t, batch_t)
        _check_metrics(m_t, m_j)
    assert state_t.step == int(state_j.step) == STEPS
    _check_tree(state_t.trainable, state_j.trainable)


def test_int8_tower_steps_match_jax():
    """The mimic step on an int8-quantized frozen tower (the tower of the 8B
    train benchmark; JAX gates it in tests/test_train_int8_tower.py): both
    packages quantize the same fp32 tree, then 3 steps, metrics and shift tree
    within the bounds above."""
    from mimic_tpu.ops.quant import quantize_lm_params as jax_quantize
    from mimic_tpu_torch.ops.quant import quantize_lm_params

    cfg, enc, peft, frozen, trainable, tb = setup("mimic", False)
    frozen_j = jax.tree.map(np.asarray, jax_quantize(frozen))
    frozen_t = quantize_lm_params(to_torch(frozen, "cpu"))
    assert "qkv_proj" in frozen_t["lm"]["decoder"]["layers"]
    common = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight)
    tx_j = build_optimizer(trainable, **_opt_kwargs(peft))
    step_j = make_train_step(cfg, enc, tx_j, donate=False, **common)
    state_j = TrainState(trainable, tx_j.init(trainable), jnp.zeros((), jnp.int32))
    tree = to_torch(trainable, "cpu")
    tx_t = to.build_optimizer(tree, **_opt_kwargs(peft))
    step_t = ts.make_train_step(cfg, port_enc(enc), tx_t, **common)
    state_t = ts.TrainState(tree, tx_t.init(tree), 0)
    batch_j, batch_t = _to_device_batch(tb), ts.to_device_batch(tb, "cpu")
    for _ in range(3):
        state_j, m_j = step_j(state_j, frozen_j, batch_j)
        state_t, m_t = step_t(state_t, frozen_t, batch_t)
        _check_metrics(m_t, m_j)
    _check_tree(state_t.trainable, state_j.trainable)


def test_gradient_accumulation_matches_jax():
    cfg, enc, peft, frozen, trainable, tb = setup("mimic", False)
    kw = dict(_opt_kwargs(peft), accumulate_steps=2)
    common = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight)
    tx_j = build_optimizer(trainable, **kw)
    step_j = make_train_step(cfg, enc, tx_j, donate=False, **common)
    state_j = TrainState(trainable, tx_j.init(trainable), jnp.zeros((), jnp.int32))
    tree = to_torch(trainable, "cpu")
    tx_t = to.build_optimizer(tree, **kw)
    step_t = ts.make_train_step(cfg, port_enc(enc), tx_t, **common)
    state_t = ts.TrainState(tree, tx_t.init(tree), 0)
    frozen_t = to_torch(frozen, "cpu")
    batch_j, batch_t = _to_device_batch(tb), ts.to_device_batch(tb, "cpu")
    for _ in range(4):
        state_j, m_j = step_j(state_j, frozen, batch_j)
        state_t, m_t = step_t(state_t, frozen_t, batch_t)
        _check_metrics(m_t, m_j)
    _check_tree(state_t.trainable, state_j.trainable)


def test_frozen_weights_stay_frozen_and_shift_moves():
    cfg, enc, peft, frozen, trainable, tb = setup("mimic", True)
    frozen_t = to_torch(frozen, "cpu")
    before = {k: v.clone() for k, v in frozen_t["lm"]["decoder"]["layers"].items()}
    tree = to_torch(trainable, "cpu")
    tx = to.build_optimizer(tree, **dict(_opt_kwargs(peft), warmup_steps=0))
    step = ts.make_train_step(cfg, port_enc(enc), tx, ce_loss_weight=0.5, align_loss_weight=1.0,
                              attn_impl="flash")
    state = ts.TrainState(tree, tx.init(tree), 0)
    state, m = step(state, frozen_t, ts.to_device_batch(tb, "cpu"))
    for k, v in frozen_t["lm"]["decoder"]["layers"].items():
        assert not v.requires_grad and torch.equal(v, before[k]), k
    assert all(not v.requires_grad for v in state.trainable["shift"].values())
    moved = [not torch.equal(state.trainable["shift"][k], tree["shift"][k]) for k in tree["shift"]]
    assert all(moved) and float(m["grad_norm"]) > 0


@pytest.mark.parametrize("kwargs", [{"attn_impl": "ring"}], ids=["ring"])
def test_unported_options_raise(kwargs):
    """Ring attention is ported: without ``ring_mesh`` the step raises JAX's
    ``ValueError`` (the ring step itself is tests/test_torch_ring_train.py)."""
    cfg, enc, peft, _, trainable, _ = setup("mimic", False)
    tx = to.build_optimizer(to_torch(trainable, "cpu"), **_opt_kwargs(peft))
    with pytest.raises(ValueError, match="ring_mesh"):
        ts.make_train_step(cfg, port_enc(enc), tx, ce_loss_weight=0.5, align_loss_weight=1.0, **kwargs)
    with pytest.raises(ValueError, match="ring_mesh"):
        make_train_step(cfg, enc, build_optimizer(trainable, **_opt_kwargs(peft)),
                        ce_loss_weight=0.5, align_loss_weight=1.0, **kwargs)


def _grads_of_one_step(preset, flash, trainable, **step_kw):
    """The raw gradients of one step (the optimizer records what it is given)."""
    cfg, enc, peft, frozen, _, tb = setup(preset, flash)
    tree = to_torch(trainable, "cpu")
    tx = to.build_optimizer(tree, **_opt_kwargs(peft))
    seen = []

    def update(grads, state, params):
        seen.append(grads)
        return tx.update(grads, state, params)

    step = ts.make_train_step(cfg, port_enc(enc), to.Optimizer(init=tx.init, update=update),
                              ce_loss_weight=peft.ce_loss_weight,
                              align_loss_weight=peft.align_loss_weight,
                              attn_impl="flash" if flash else "xla", **step_kw)
    _, metrics = step(ts.TrainState(tree, tx.init(tree), 0), to_torch(frozen, "cpu"),
                      ts.to_device_batch(tb, "cpu"))
    return metrics, to.flatten(seen[0])


def _lora_trainable(cfg):
    from mimic_tpu.shift.lora import init_lora_params

    _, peft = get_preset("lora")
    lora = init_lora_params(peft.lora, cfg.text, jax.random.PRNGKey(2))
    # B off zero, so that A's gradient is not zero
    return {"lora": {k: np.asarray(v + 0.05 if k.endswith("_b") else v) for k, v in lora.items()}}


@pytest.mark.parametrize("preset,flash", [("mimic", True), ("lora", False)],
                         ids=["mimic-flash", "lora"])
def test_shift_remat_gives_the_same_gradients(preset, flash, one_torch_thread):
    """``shift_remat`` recomputes each shift-pass layer in the backward pass:
    the same loss and gradients (1e-6) as the step without it."""
    cfg, _, _, _, shift, _ = setup("mimic", flash)
    trainable = shift if preset == "mimic" else _lora_trainable(cfg)
    want_m, want = _grads_of_one_step(preset, flash, trainable)
    got_m, got = _grads_of_one_step(preset, flash, trainable, shift_remat=True)
    assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]), rel=1e-6)
    assert set(got) == set(want)
    for p, g in got.items():
        torch.testing.assert_close(g, want[p], rtol=1e-6, atol=1e-6)
        assert g.abs().max() > 0, p


def test_lora_dropout_draws_masks_per_step(one_torch_thread):
    """``lora_dropout`` > 0: the step draws fresh masks each step from
    (seed, step); a step of the same state repeats its loss."""
    cfg = setup("mimic", False)[0]
    _, enc, peft, frozen, _, tb = setup("lora", False)
    trainable = to_torch(_lora_trainable(cfg), "cpu")
    tx = to.build_optimizer(trainable, **dict(_opt_kwargs(peft), lr=0.0))
    step = ts.make_train_step(cfg, port_enc(enc), tx, ce_loss_weight=1.0, align_loss_weight=0.0,
                              lora_scaling=2.0, lora_dropout=0.1, seed=3)
    state0 = ts.TrainState(trainable, tx.init(trainable), 0)
    frozen_t, batch = to_torch(frozen, "cpu"), ts.to_device_batch(tb, "cpu")
    state1, m0 = step(state0, frozen_t, batch)
    _, m1 = step(state1, frozen_t, batch)
    _, again = step(state0, frozen_t, batch)
    assert float(again["loss"]) == float(m0["loss"]) != float(m1["loss"])
