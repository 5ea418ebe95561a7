"""Ring attention in the port's dual-pass MimIC step, the counterpart of
``tests/test_ring_train.py``.

The long-record batch of ``test_ring_train.py::_setup`` (40 demonstrations,
a record pass of more than 1056 tokens) stepped once by JAX on one device,
and by the port on four ``gloo`` processes as a (data 2 x sp 2) mesh with
``attn_impl="ring"``, ``ring_batch_axis="data"`` and ``ring_min_len=1024``:
the record pass rides the ring (``ATTN_PATH_LOG``), the short shift pass
stays on each rank, and the loss, every metric and the updated shift agree
within JAX's own bounds (2e-4, 5e-4, 2e-3).  Without a mesh the step raises
JAX's ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mimic_tpu.train import TrainState, make_train_step
from mimic_tpu.config import config_to_dict
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.train import optim as to
from mimic_tpu_torch.train import step as ts
from test_ring_train import _setup
from torch_dist import run_world

OPT = dict(weight_decay=1e-3, warmup_steps=1, total_steps=10, grad_clip=1.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory, eight_devices):
    cfg, params, enc, peft, tx, trainable, batch = _setup()
    common = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight)
    step_ref = make_train_step(cfg, enc, tx, donate=False, **common)
    state0 = TrainState(trainable, tx.init(trainable), jnp.zeros((), jnp.int32))
    ref_state, ref_metrics = step_ref(state0, params, batch)
    spec = ("tiny-idefics2", dict(image_token_id=cfg.image_token_id, pad_token_id=cfg.pad_token_id,
                                  bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id),
            {"vocab_size": cfg.text.vocab_size})
    inputs = {
        "spec": spec, "params": jax.tree.map(np.asarray, params),
        "trainable": jax.tree.map(np.asarray, trainable),
        "batch": {k: np.asarray(v) for k, v in batch.items()},
        "enc": config_to_dict(enc), "common": common, "opt": dict(OPT, lr=peft.lr),
    }
    outs = run_world("torch_workers:ring_train_world", 4, tmp_path_factory.mktemp("ring_train"),
                     inputs)
    return batch, ref_state, ref_metrics, outs


def test_record_pass_rides_the_ring(world):
    batch, *_, outs = world
    assert batch["full_ids"].shape[1] >= 33 * 32  # a >32-shot record context
    assert batch["query_ids"].shape[1] < 1024     # the shift pass stays on one rank
    for out in outs:
        assert out["paths"] == ["ring", "xla"]


def test_ring_loss_and_update_parity(world):
    _, ref_state, ref_metrics, outs = world
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


def test_ring_requires_mesh():
    cfg, params, enc, peft, tx, trainable, batch = _setup(n_demos=1)
    tree = to_torch(jax.tree.map(np.asarray, trainable), "cpu")
    enc_t = tconfig.config_from_dict(tconfig.EncoderConfig, config_to_dict(enc))
    with pytest.raises(ValueError, match="ring_mesh"):
        ts.make_train_step(cfg, enc_t, to.build_optimizer(tree, lr=peft.lr, **OPT),
                           ce_loss_weight=0.5, align_loss_weight=1.0, attn_impl="ring")
