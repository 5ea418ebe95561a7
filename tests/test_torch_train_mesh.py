"""Training on a (data 2 x model 2) mesh of four ``gloo`` processes, the
counterpart of ``tests/test_train_mesh.py``.

- ``run_train(..., use_mesh=True)`` on the synthetic VQA splits: every rank
  collates the global batch and keeps its rows; the logged per-step metrics
  and the trained tree equal the one-process run within 1e-5, rank 0 alone
  writes, and the JAX package loads its checkpoint.
- One step of each trainable kind with unequal answer-token counts on the
  two data ranks (a mean of per-rank means would be wrong): the MimIC shift
  (multi-head and the flat form, sliced to each rank's heads), LIVE's output
  shifts (on the replicated stream, not summed over ``model``), LoRA with
  dropout (B sliced, ``o``'s A sliced by rows) and a prefix (sliced to each
  rank's KV heads).  Every rank's metrics and updated trainables against
  JAX's single-device step on the same batch and trees, at the tolerances of
  ``tests/test_torch_train_step.py`` (metrics rtol 1e-5, the KL term atol
  1e-7, each leaf's error norm within 1e-5 of its norm).  LoRA's dropout
  masks come from torch's generator, so its reference is the port's step in
  one process, within 1e-5.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic_tpu.config import EncoderConfig, LoraConfig, PrefixConfig, get_preset
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.lvlm import init_lvlm_params
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.shift.lora import init_lora_params
from mimic_tpu.shift.params import init_shift_params
from mimic_tpu.shift.prefix import init_prefix_params
from mimic_tpu.train import TrainCollator, TrainState, build_optimizer, make_train_step
from mimic_tpu.train import checkpoints as jck
from mimic_tpu.train.step import _to_device_batch
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.models.tokenizer import SimpleTokenizer as PortTokenizer
from mimic_tpu_torch.pipeline.train_entry import run_train
from mimic_tpu_torch.train import optim as to
from mimic_tpu_torch.train import step as ts
from test_eval_e2e import synthetic_vqa_splits
from torch_dist import run_world

TOL = 1e-5
KL_ATOL = 1e-7
FLAT = EncoderConfig(
    kind="attn_approximator", model_strategy="Strategy.LM_LOSS | Strategy.LAYER_WISE_MSE",
    attn_strategy="ShiftStrategy.VECTOR_SHIFT | ShiftStrategy.LEARNABLE_SHIFT_SCALE",
    ffn_strategy="ShiftStrategy.RECORD_HIDDEN_STATES",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _string_batch():
    """Four rows; data rank 0 gets the two short answers, rank 1 the long ones."""
    rng = np.random.default_rng(0)
    img = lambda: rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8)  # noqa: E731
    answers = ["red", "two", "a small brown dog sitting on the grass", "three cats and a bird"]
    return {
        "prefix_texts": [f"Image:<image> Question: what is {i}? Answer: a cat\n" for i in range(4)],
        "query_texts": [f"Image:<image> Question: what is {i}? Answer:" for i in range(4)],
        "answers": answers,
        "images": [[img(), img()] for _ in range(4)],
    }


def _trainable(kind, text_cfg):
    key = jax.random.PRNGKey(1)
    if kind == "lora":
        tree = {"lora": init_lora_params(LoraConfig(r=4, alpha=8, dropout=0.1), text_cfg, key)}
        # B away from its zero init, so that A's path carries gradient too
        rng = np.random.default_rng(5)
        for name in tree["lora"]:
            if name.endswith("_b"):
                tree["lora"][name] = 0.05 * rng.normal(size=tree["lora"][name].shape)
    elif kind == "prefix":
        tree = {"prefix": init_prefix_params(PrefixConfig(num_virtual_tokens=4), text_cfg, key)}
    else:
        enc = FLAT if kind == "flat" else get_preset("licv" if kind == "licv" else "mimic")[0]
        tree = {"shift": init_shift_params(enc, text_cfg, key)}
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _enc_peft(kind):
    if kind == "flat":
        return FLAT, get_preset("mimic")[1]
    enc, peft = get_preset({"lora": "lora", "prefix": "prefix-tuning", "licv": "licv"}
                           .get(kind, "mimic"))
    if kind == "lora":
        peft.lora = LoraConfig(r=4, alpha=8, dropout=0.1)
    return enc, peft


def _train_cfg():
    enc, peft = get_preset("mimic")
    cfg = tconfig.TrainConfig(runname="meshtrain", model_name="tiny-idefics2",
                              encoder=tconfig.config_from_dict(tconfig.EncoderConfig,
                                                               tconfig.config_to_dict(enc)),
                              peft=tconfig.config_from_dict(tconfig.PeftConfig,
                                                            tconfig.config_to_dict(peft)),
                              epochs=4, batch_size=4, accumulate_grad_batches=1)
    cfg.data.name, cfg.data.num_query_samples, cfg.data.num_shot = "vqav2", 8, 1
    cfg.mesh.data_axis, cfg.mesh.model_axis = 2, 2
    return cfg


KINDS = ["mimic", "flat", "licv", "lora", "prefix"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tk = SimpleTokenizer(padding_side="right")
    cfg = get_model_config("tiny-idefics2").replace(
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))
    spec = ("tiny-idefics2", dict(image_token_id=cfg.image_token_id, pad_token_id=cfg.pad_token_id,
                                  bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id),
            {"vocab_size": cfg.text.vocab_size})
    params = jax.tree.map(np.asarray, init_lvlm_params(cfg, jax.random.PRNGKey(0)))
    steps = {}
    for kind in KINDS:
        enc, peft = _enc_peft(kind)
        collator = TrainCollator(LVLMProcessor(cfg, tk), enc.strategy(), num_image_in_query=1)
        tb = collator(_string_batch())
        steps[kind] = {
            "trainable": _trainable(kind, cfg.text), "enc": tconfig.config_to_dict(enc),
            "batch": {k: v for k, v in vars(tb).items()
                      if v is not None and not k.endswith("_image_keys")},
            "common": dict(ce_loss_weight=peft.ce_loss_weight,
                           align_loss_weight=peft.align_loss_weight,
                           lora_scaling=peft.lora.scaling() if peft.lora else 1.0,
                           lora_dropout=peft.lora.dropout if peft.lora else 0.0, seed=3),
            "opt": dict(lr=peft.lr, weight_decay=1e-3, warmup_steps=0, total_steps=10,
                        grad_clip=1.0, scale_lr=peft.scale_lr),
        }
    splits = synthetic_vqa_splits(n_train=16)
    run = {"cfg": tconfig.config_to_dict(_train_cfg()), "splits": splits}
    workdir = tmp_path_factory.mktemp("train_mesh")
    outs = run_world("torch_workers:train_mesh_world", 4, workdir,
                     {"spec": spec, "params": params, "steps": steps, "run": run})
    return cfg, params, steps, splits, workdir, outs


def _step_one_process(cfg, params, case):
    tree = to_torch(case["trainable"], "cpu")
    tx = to.build_optimizer(tree, **case["opt"])
    enc = tconfig.config_from_dict(tconfig.EncoderConfig, case["enc"])
    step = ts.make_train_step(cfg, enc, tx, **case["common"])
    batch = ts.to_device_batch(SimpleNamespace(**case["batch"]), "cpu")
    return step(ts.TrainState(tree, tx.init(tree), 0), to_torch(params, "cpu"), batch)


def _step_jax(params, kind, case, cfg):
    enc, _ = _enc_peft(kind)
    tree = case["trainable"]
    tx = build_optimizer(tree, **case["opt"])
    step = make_train_step(cfg, enc, tx, donate=False, **case["common"])
    state = TrainState(tree, tx.init(tree), jnp.zeros((), jnp.int32))
    return step(state, params, _to_device_batch(SimpleNamespace(**case["batch"])))


def _assert_close_to_jax(metrics, trainable, want_state, want_metrics):
    assert set(metrics) == set(want_metrics)
    for key, w in want_metrics.items():
        g, w = metrics[key], float(np.asarray(w))
        assert abs(g - w) <= (KL_ATOL if key == "logits_kl_loss" else TOL * abs(w)), (key, g, w)
    want = want_state.trainable
    assert set(trainable) == set(want)
    for group in want:
        for name, w in want[group].items():
            w = np.asarray(w)
            g = trainable[group][name]
            assert g.shape == w.shape
            assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w), f"{group}.{name}"


def _assert_trees_close(got, want):
    assert set(got) == set(want)
    for group in want:
        for name, w in want[group].items():
            np.testing.assert_allclose(got[group][name], w.detach().numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{group}.{name}")


@pytest.mark.parametrize("kind", KINDS)
def test_data_parallel_step_with_unequal_token_counts(world, kind):
    cfg, params, steps, *_, outs = world
    if kind == "lora":
        state, metrics = _step_one_process(cfg, params, steps[kind])
    else:
        state, metrics = _step_jax(params, kind, steps[kind], cfg)
    tokens = [outs[0]["steps"][kind]["tokens"], outs[2]["steps"][kind]["tokens"]]
    assert tokens[0] != tokens[1]
    for out in outs:
        got = out["steps"][kind]
        if kind != "lora":
            _assert_close_to_jax(got["metrics"], got["trainable"], state, metrics)
            continue
        assert set(got["metrics"]) == set(metrics)
        for key, want in metrics.items():
            np.testing.assert_allclose(got["metrics"][key], float(want), rtol=TOL, atol=TOL,
                                       err_msg=key)
        _assert_trees_close(got["trainable"], state.trainable)
        moved = [not np.array_equal(got["trainable"][g][n], steps[kind]["trainable"][g][n])
                 for g in steps[kind]["trainable"] for n in steps[kind]["trainable"][g]]
        assert all(moved)


def test_run_train_on_mesh_matches_one_process(world, tmp_path):
    cfg, params, _, splits, workdir, outs = world
    tk = PortTokenizer(padding_side="left")
    runner = LVLMRunner(cfg, to_torch(params, "cpu"), tk, device="cpu", pad_multiple=32)
    train_cfg = tconfig.config_from_dict(tconfig.TrainConfig, tconfig.config_to_dict(_train_cfg()))
    state = run_train(train_cfg, result_dir=str(tmp_path), runner=runner, splits=splits)
    assert state.step == 4 and all(o["run_step"] == 4 for o in outs)
    run_dir = lambda d: next((d / "ckpt").iterdir())  # noqa: E731
    rows = lambda d: [{k: v for k, v in json.loads(line).items() if k != "time"}  # noqa: E731
                      for line in (run_dir(d) / "metrics.jsonl").read_text().splitlines()]
    want, got = rows(tmp_path), rows(workdir / "mesh")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, atol=TOL, err_msg=key)
    for out in outs:
        _assert_trees_close(out["run_trainable"], state.trainable)
    # rank 0 wrote the run; the JAX package loads its checkpoint
    ckpt = run_dir(workdir / "mesh") / "epoch-3"
    template = {"shift": {k: v.numpy() for k, v in state.trainable["shift"].items()}}
    loaded = jck.load_trainable(str(ckpt), template)
    for name, value in outs[0]["run_trainable"]["shift"].items():
        np.testing.assert_array_equal(np.asarray(loaded["shift"][name]), value)
