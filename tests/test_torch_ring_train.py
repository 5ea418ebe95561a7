"""Ring attention in the port's dual-pass MimIC step, the counterpart of
``tests/test_ring_train.py``.

The long-record batch of ``test_ring_train.py::_setup`` (40 demonstrations,
a record pass of more than 1056 tokens) stepped once by JAX on one device,
and by the port on four ``gloo`` processes as a (data 2 x sp 2) mesh with
``attn_impl="ring"``, ``ring_batch_axis="data"`` and ``ring_min_len=1024``:
the record pass rides the ring (``ATTN_PATH_LOG``), the short shift pass
stays on each rank, and the loss, every metric and the updated shift agree
within JAX's own bounds (2e-4, 5e-4, 2e-3).  With ``warmup_steps=1`` the
first step's learning rate is 0, so that step leaves the shift where it
was: a second step is held to JAX's second step too.

At JAX's default ``ring_min_len=0`` both passes ride the ring and the shift
pass's gradients run the ring's backward.  On a shorter batch (4
demonstrations: record T 320, shift T 64), for the ``mimic`` preset with
``logz2`` unmasked and masked, with ``shift_remat``, and for ``lora``:
every pass logs ``"ring"``; ``compute_loss``'s gradients, summed over
``data`` as the step sums them, agree with JAX's ``jax.grad`` of
``compute_loss`` on one device within 5e-4 of each leaf's norm; after two
steps the trainables agree with JAX's two steps within 2e-3 and are equal
on every rank.  Without a mesh the step raises JAX's ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mimic_tpu.config import LoraConfig, config_to_dict, get_preset
from mimic_tpu.shift.lora import init_lora_params
from mimic_tpu.train import TrainState, build_optimizer, make_train_step
from mimic_tpu.train.step import compute_loss as jax_compute_loss
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.shift import params as tsp
from mimic_tpu_torch.train import optim as to
from mimic_tpu_torch.train import step as ts
from test_ring_train import _setup
from torch_dist import run_world

OPT = dict(weight_decay=1e-3, warmup_steps=1, total_steps=10, grad_clip=1.0)
# the cases with both passes on the ring: (preset, logz2, shift_remat)
RING0 = {
    "mimic": ("mimic", "unmasked", False),
    "mimic-masked": ("mimic", "masked", False),
    "mimic-remat": ("mimic", "unmasked", True),
    "lora": ("lora", "unmasked", False),
}
LORA = LoraConfig(r=4, alpha=8, dropout=0.0)


def _ring0_case(preset, logz2, cfg, shift_tree):
    """(JAX's encoder config, the trainable tree, the kwargs of both
    packages' compute_loss and make_train_step, the optimizer's)."""
    enc, peft = get_preset(preset)
    scaling = 1.0
    tree = shift_tree
    if preset == "lora":
        tree = {"lora": jax.tree.map(np.asarray, init_lora_params(LORA, cfg.text,
                                                                  jax.random.PRNGKey(1)))}
        # B away from its zero init, so that A's path carries gradient too
        rng = np.random.default_rng(5)
        for name in tree["lora"]:
            if name.endswith("_b"):
                tree["lora"][name] = (0.05 * rng.normal(size=tree["lora"][name].shape)
                                      ).astype(np.float32)
        scaling = LORA.alpha / LORA.r
    common = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                  logz2=logz2, lora_scaling=scaling)
    return enc, tree, common, dict(OPT, lr=peft.lr)


def _ring0_reference(cfg, params, batch, shift_tree):
    """JAX on one device: each (preset, logz2)'s gradients of compute_loss
    and its trainables after two steps."""
    refs = {}
    for preset, logz2, _ in RING0.values():
        if (preset, logz2) in refs:
            continue
        enc, tree, common, opt = _ring0_case(preset, logz2, cfg, shift_tree)
        enc_t = tconfig.config_from_dict(tconfig.EncoderConfig, config_to_dict(enc))
        kw = dict(cfg=cfg, strategy=enc.strategy(), rec_attn=tsp.needs_attn_capture(enc_t),
                  rec_ffn=tsp.needs_ffn_capture(enc_t), mh=tsp.multi_head(enc_t), **common)
        grads = jax.jit(jax.grad(lambda tr: jax_compute_loss(tr, params, batch, **kw)[0]))(tree)
        tx = build_optimizer(tree, **opt)
        step = make_train_step(cfg, enc, tx, donate=False, **common)
        state = TrainState(tree, tx.init(tree), jnp.zeros((), jnp.int32))
        for _ in range(2):
            state, _ = step(state, params, batch)
        refs[preset, logz2] = (tree, enc, grads, state.trainable)
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory, eight_devices):
    cfg, params, enc, peft, tx, trainable, batch = _setup()
    batch0 = _setup(n_demos=4)[-1]
    refs = _ring0_reference(cfg, params, batch0, jax.tree.map(np.asarray, trainable))
    ring0 = {}
    for name, (preset, logz2, remat) in RING0.items():
        tree, enc0, *_ = refs[preset, logz2]
        _, _, common, opt = _ring0_case(preset, logz2, cfg, tree)
        ring0[name] = {"trainable": tree, "enc": config_to_dict(enc0), "opt": opt,
                       "common": dict(common, shift_remat=remat)}
    common = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight)
    step_ref = make_train_step(cfg, enc, tx, donate=False, **common)
    state0 = TrainState(trainable, tx.init(trainable), jnp.zeros((), jnp.int32))
    ref_state, ref_metrics = step_ref(state0, params, batch)
    ref_state2, _ = step_ref(ref_state, params, batch)
    spec = ("tiny-idefics2", dict(image_token_id=cfg.image_token_id, pad_token_id=cfg.pad_token_id,
                                  bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id),
            {"vocab_size": cfg.text.vocab_size})
    inputs = {
        "spec": spec, "params": jax.tree.map(np.asarray, params),
        "trainable": jax.tree.map(np.asarray, trainable),
        "batch": {k: np.asarray(v) for k, v in batch.items()},
        "enc": config_to_dict(enc), "common": common, "opt": dict(OPT, lr=peft.lr),
        "batch0": {k: np.asarray(v) for k, v in batch0.items()}, "ring0": ring0,
    }
    outs = run_world("torch_workers:ring_train_world", 4, tmp_path_factory.mktemp("ring_train"),
                     inputs)
    return batch, (ref_state, ref_state2), ref_metrics, outs, refs


def test_record_pass_rides_the_ring(world):
    batch, _, _, outs, _ = world
    assert batch["full_ids"].shape[1] >= 33 * 32  # a >32-shot record context
    assert batch["query_ids"].shape[1] < 1024     # the shift pass stays on one rank
    for out in outs:
        assert out["paths"] == ["ring", "xla"]


def test_ring_loss_and_update_parity(world):
    _, (ref_state, ref_state2), ref_metrics, outs, _ = world
    for out in outs:
        m = out["metrics"]
        np.testing.assert_allclose(m["loss"], float(ref_metrics["loss"]), rtol=2e-4, atol=1e-5)
        assert set(m) == set(ref_metrics)
        for key in ref_metrics:
            np.testing.assert_allclose(m[key], float(ref_metrics[key]), rtol=5e-4, atol=1e-5,
                                       err_msg=key)
        for name, want in ref_state.trainable["shift"].items():
            np.testing.assert_allclose(out["trainable"]["shift"][name], np.asarray(want),
                                       rtol=2e-3, atol=2e-5, err_msg=name)
        # the second step, the first with a learning rate above 0
        for name, want in ref_state2.trainable["shift"].items():
            assert not np.array_equal(np.asarray(want), ref_state.trainable["shift"][name])
            np.testing.assert_allclose(out["trainable2"]["shift"][name], np.asarray(want),
                                       rtol=2e-3, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("case", list(RING0))
def test_both_passes_on_the_ring(world, case):
    *_, outs, refs = world
    preset, logz2, _ = RING0[case]
    _, _, want_grads, want_tree = refs[preset, logz2]
    for out in outs:
        got = out["ring0"][case]
        assert got["paths"] == (["ring"] if preset == "lora" else ["ring", "ring"])
        for (kind, leaf), g in got["grads"].items():
            w = np.asarray(want_grads[kind][leaf])
            assert g.shape == w.shape and np.linalg.norm(w) > 0, leaf
            assert np.linalg.norm(g - w) <= 5e-4 * np.linalg.norm(w), leaf
        for m in got["metrics"]:
            assert all(np.isfinite(v) for v in m.values())
        for kind, leaves in want_tree.items():
            for leaf, w in leaves.items():
                np.testing.assert_allclose(got["trainable"][kind][leaf], np.asarray(w),
                                           rtol=2e-3, atol=2e-5, err_msg=leaf)
    # every rank of a ring (and of the data axis) holds the same trainables
    for out in outs[1:]:
        for kind, leaves in outs[0]["ring0"][case]["trainable"].items():
            for leaf, w in leaves.items():
                np.testing.assert_array_equal(out["ring0"][case]["trainable"][kind][leaf], w)


def test_ring_requires_mesh():
    cfg, params, enc, peft, tx, trainable, batch = _setup(n_demos=1)
    tree = to_torch(jax.tree.map(np.asarray, trainable), "cpu")
    enc_t = tconfig.config_from_dict(tconfig.EncoderConfig, config_to_dict(enc))
    with pytest.raises(ValueError, match="ring_mesh"):
        ts.make_train_step(cfg, enc_t, to.build_optimizer(tree, lr=peft.lr, **OPT),
                           ce_loss_weight=0.5, align_loss_weight=1.0, attn_impl="ring")
