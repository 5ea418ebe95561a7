"""mimic_tpu_torch.train.checkpoints against ``mimic_tpu.train.checkpoints``.

``encoder.msgpack`` must hold the same bytes as ``flax.serialization.to_bytes``
of the same tree (the port writes the msgpack subset by hand: the card's
machine has neither flax nor msgpack), a file written by either package must
load in the other, and the run-directory helpers must agree.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mimic_tpu.config import TrainConfig, get_preset
from mimic_tpu.models.config import get_model_config
from mimic_tpu.pipeline.train_entry import init_trainable
from mimic_tpu.train import checkpoints as jck
from mimic_tpu.train.trainer import make_save_when as jax_save_when
from mimic_tpu_torch.bridge import to_numpy, to_torch
from mimic_tpu_torch.train import checkpoints as tck
from mimic_tpu_torch.train.trainer import make_save_when


def _trainable(preset):
    """The preset's trainable tree as JAX's train entry makes it: a shift,
    LoRA adapters or a prefix."""
    enc, peft = get_preset(preset)
    cfg = TrainConfig(encoder=enc, peft=peft)
    text = get_model_config("tiny-idefics2").text
    return jax.tree.map(np.asarray, init_trainable(cfg, text, jax.random.PRNGKey(7)))


PRESETS = ["mimic", "mimic_attn_mse", "licv", "lora", "prefix-tuning"]


@pytest.mark.parametrize("preset", PRESETS)
def test_encoder_bytes_identical_to_flax(preset, tmp_path):
    tree = _trainable(preset)
    jck.save_trainable(str(tmp_path / "jax"), tree)
    tck.save_trainable(str(tmp_path / "torch"), to_torch(tree, "cpu"))
    want = (tmp_path / "jax" / "encoder.msgpack").read_bytes()
    assert (tmp_path / "torch" / "encoder.msgpack").read_bytes() == want
    assert tck.tree_to_bytes(tree) == serialization.to_bytes(tree)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_load(writer, tmp_path):
    tree = _trainable("mimic")
    if writer == "jax":
        jck.save_trainable(str(tmp_path), tree)
        got = tck.load_trainable(str(tmp_path), template=to_torch(tree, "cpu"))
        for k, v in tree["shift"].items():
            assert got["shift"][k].dtype == torch.float32
            np.testing.assert_array_equal(got["shift"][k].numpy(), v)
    else:
        tck.save_trainable(str(tmp_path), to_torch(tree, "cpu"))
        got = jck.load_trainable(str(tmp_path), tree)
        for k, v in tree["shift"].items():
            np.testing.assert_array_equal(np.asarray(got["shift"][k]), v)


@pytest.mark.parametrize("preset", ["lora", "mini_lora", "prefix-tuning"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lora_and_prefix_checkpoints_cross_load(writer, preset, tmp_path):
    tree = _trainable(preset)
    (kind,) = tree
    if writer == "jax":
        jck.save_trainable(str(tmp_path), tree)
        got = tck.load_trainable(str(tmp_path), template=to_torch(tree, "cpu"))
    else:
        tck.save_trainable(str(tmp_path), to_torch(tree, "cpu"))
        got = to_torch(jax.tree.map(np.asarray, jck.load_trainable(str(tmp_path), tree)), "cpu")
    assert set(got) == {kind} and set(got[kind]) == set(tree[kind])
    for k, v in tree[kind].items():
        assert got[kind][k].dtype == torch.float32
        np.testing.assert_array_equal(got[kind][k].numpy(), v)


def test_bf16_and_scalar_leaves_round_trip_with_flax(tmp_path):
    tree = {"a": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3),
            "b": {"s": np.ones((), np.float32), "i": np.arange(70000, dtype=np.int32)}}
    data = serialization.to_bytes(tree)
    assert tck.tree_to_bytes(tck.tree_from_bytes(data)) == data
    (tmp_path / "encoder.msgpack").write_bytes(data)
    got = tck.load_trainable(str(tmp_path))
    assert got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(got, bfloat16=jnp.bfloat16)["a"], tree["a"])
    # both packages' save_trainable write the keys sorted
    tck.save_trainable(str(tmp_path / "torch"), got)
    jck.save_trainable(str(tmp_path / "jax"), tree)
    assert (tmp_path / "torch" / "encoder.msgpack").read_bytes() == \
        (tmp_path / "jax" / "encoder.msgpack").read_bytes()


def test_template_mismatch_raises(tmp_path):
    tree = _trainable("mimic")
    tck.save_trainable(str(tmp_path), to_torch(tree, "cpu"))
    bad = to_torch(_trainable("licv"), "cpu")
    with pytest.raises(ValueError):
        tck.load_trainable(str(tmp_path), template=bad)


def test_run_dir_helpers_match_jax(tmp_path):
    run = str(tmp_path / "run")
    assert tck.existing_ckpt_epochs(run) == jck.existing_ckpt_epochs(run) == []
    for e in (0, 3, 11):
        os.makedirs(os.path.join(run, f"epoch-{e}"))
    os.makedirs(os.path.join(run, "epoch-x"))
    assert tck.existing_ckpt_epochs(run) == jck.existing_ckpt_epochs(run) == [0, 3, 11]
    for model, n, data in (("idefics2-8b-base", 50, "vqav2"), ("tiny-idefics2", 4, "coco")):
        for epochs in (4, 12, 15):
            assert tck.all_checkpoints_exist(run, epochs, make_save_when(model, n, data)) == \
                jck.all_checkpoints_exist(run, epochs, jax_save_when(model, n, data))
    cfg = {"runname": "x", "data": {"name": "vqav2"}, "lr": 5e-3, "t": (1, 2)}
    tck.save_run_config(str(tmp_path / "t"), cfg)
    jck.save_run_config(str(tmp_path / "j"), cfg)
    assert json.loads((tmp_path / "t" / "config.json").read_text()) == \
        json.loads((tmp_path / "j" / "config.json").read_text())
