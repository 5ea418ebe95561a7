"""mimic_tpu_torch.pipeline.train_entry: ``run_train`` end to end on a tiny
idefics2 with synthetic VQA splits, like ``tests/test_pipeline.py``'s train
stage, plus the trainer helpers against ``mimic_tpu.train.trainer`` and a
subprocess run of the whole train path with ``jax``, ``optax`` and ``flax``
unavailable.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from mimic_tpu.models.config import get_model_config, tiny_text
from mimic_tpu.models.lvlm import init_lvlm_params
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.pipeline import train_entry as jte
from mimic_tpu.train import checkpoints as jck
from mimic_tpu.train import trainer as jtrainer
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.config import TrainConfig, config_to_dict, get_preset
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.pipeline import train_entry as te
from mimic_tpu_torch.train import trainer as ttrainer
from test_eval_e2e import synthetic_vqa_splits

RUNNAME = "torchtrain-tiny-idefics2-vqav2-4-1shot"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run many small ops: one thread each, not a pool that every
    op must wake (beside the other test workers the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _runner(head_dim=None):
    tk = SimpleTokenizer(padding_side="left")
    cfg = tiny_text("idefics2", head_dim=head_dim) if head_dim else get_model_config("tiny-idefics2")
    cfg = cfg.replace(image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
                      bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))
    params = jax.tree.map(np.asarray, init_lvlm_params(cfg, jax.random.PRNGKey(0)))
    return LVLMRunner(cfg, to_torch(params, "cpu"), tk, device="cpu", pad_multiple=32)


def _train_cfg(**overrides):
    enc, peft = get_preset("mimic")
    cfg = TrainConfig(runname="torchtrain", model_name="tiny-idefics2", encoder=enc, peft=peft,
                      epochs=1, batch_size=2, accumulate_grad_batches=1)
    cfg.data.name, cfg.data.num_query_samples, cfg.data.num_shot = "vqav2", 4, 1
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def test_run_train_writes_checkpoint_and_config(tmp_path):
    cfg = _train_cfg()
    td.ATTN_PATH_LOG.clear()
    state = te.run_train(cfg, result_dir=str(tmp_path), runner=_runner(),
                         splits=synthetic_vqa_splits())
    run_dir = tmp_path / "ckpt" / RUNNAME
    assert (run_dir / "epoch-0" / "encoder.msgpack").exists()
    assert state.step == 2  # 4 queries, batch 2, one epoch
    assert set(td.ATTN_PATH_LOG) == {"xla"}  # "auto" on the CPU
    # the checkpoint loads in the JAX package and holds the trained tree
    loaded = jck.load_trainable(str(run_dir / "epoch-0"), jax.tree.map(
        lambda t: t.numpy(), state.trainable))
    for k, v in state.trainable["shift"].items():
        np.testing.assert_array_equal(np.asarray(loaded["shift"][k]), v.numpy())
    assert json.loads((run_dir / "config.json").read_text()) == \
        json.loads(json.dumps(config_to_dict(cfg), default=str))
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert rows and {"loss", "ce_loss", "ffn_mse_loss", "grad_norm", "lr"} <= set(rows[0])
    # resume: every scheduled checkpoint exists, so the run is skipped
    again = te.run_train(cfg, result_dir=str(tmp_path), runner=_runner(),
                         splits=synthetic_vqa_splits())
    assert again.step == 0


def test_flash_path_collates_to_128_aligned_batches(tmp_path):
    cfg = _train_cfg(attn_impl="flash")
    td.ATTN_PATH_LOG.clear()
    te.run_train(cfg, result_dir=str(tmp_path), runner=_runner(head_dim=128),
                 splits=synthetic_vqa_splits())
    # record and shift passes of both steps took the flash path: the collator
    # padded every pass to a multiple of 128 (its default of 64 would not)
    assert td.ATTN_PATH_LOG == ["flash"] * 4


def test_attn_impl_auto_and_trainables():
    assert te.resolve_attn_impl("auto", torch.device("cpu")) == "xla"
    assert te.resolve_attn_impl("auto", torch.device("cuda", 0)) == "flash"
    assert te.resolve_attn_impl("xla", torch.device("cuda", 0)) == "xla"
    text = get_model_config("tiny-idefics2").text
    # the trees' keys and shapes are JAX's init_trainable's
    for preset in ("lora", "mini_lora", "prefix-tuning"):
        enc, peft = get_preset(preset)
        cfg = TrainConfig(encoder=enc, peft=peft)
        tree = te.init_trainable(cfg, text, torch.Generator().manual_seed(0), "cpu")
        want = jax.tree.map(np.shape, jte.init_trainable(cfg, text, jax.random.PRNGKey(0)))
        assert jax.tree.map(lambda t: tuple(t.shape), tree) == want
    enc, peft = get_preset("lora")
    peft.lora = None
    with pytest.raises(ValueError, match="Nothing to train"):
        te.init_trainable(TrainConfig(encoder=enc, peft=peft), text, torch.Generator(), "cpu")
    tree = te.init_trainable(_train_cfg(), text, torch.Generator().manual_seed(0), "cpu")
    assert set(tree["shift"]) == {"attn_v", "attn_logz1_w", "attn_logz1_b"}


def test_epoch_schedule_matches_jax():
    for model in ("idefics-9b", "idefics2-8b-base", "llava-interleave-qwen-7b", "tiny-idefics2"):
        for n in (10, 99, 100, 150, 200, 300, 500, 800, 1500):
            assert ttrainer.get_max_epochs(model, n) == jtrainer.get_max_epochs(model, n)
            for data in ("vqav2", "coco"):
                mine = ttrainer.make_save_when(model, n, data)
                ref = jtrainer.make_save_when(model, n, data)
                assert [mine(e) for e in range(16)] == [ref(e) for e in range(16)]


def test_metric_logger_writes_jsonl(tmp_path):
    logger = ttrainer.MetricLogger(str(tmp_path))
    logger.log(2, {"loss": torch.tensor(1.5), "lr": 0.1})
    row = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert row["step"] == 2 and row["loss"] == 1.5 and row["lr"] == 0.1


def test_train_path_runs_without_jax_optax_flax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "optax", "flax", "msgpack"):
            sys.modules[name] = None  # any import of them now raises
        import numpy as np, torch
        from mimic_tpu_torch.models.factory import build_model
        from mimic_tpu_torch.pipeline.train_entry import run_train
        from mimic_tpu_torch.config import TrainConfig, get_preset
        from mimic_tpu_torch.train.checkpoints import load_trainable
        rng = np.random.default_rng(7)
        def item(i, split):
            return {{"question": f"what color is object {{i}}?",
                    "question_id": i if split == "train" else 1000 + i,
                    "question_type": "what color is", "answer_type": "other",
                    "answers": [{{"answer": "red", "answer_confidence": "yes", "answer_id": j}}
                                for j in range(10)],
                    "answer": "red", "image_id": i,
                    "image": rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8)}}
        splits = {{"train": [item(i, "train") for i in range(8)],
                  "validation": [item(i, "val") for i in range(6)]}}
        enc, peft = get_preset("mimic")
        cfg = TrainConfig(runname="nojax", model_name="tiny-idefics2", encoder=enc, peft=peft,
                          epochs=1, batch_size=2, accumulate_grad_batches=1, dtype="float32")
        cfg.data.name, cfg.data.num_query_samples, cfg.data.num_shot = "vqav2", 4, 1
        runner = build_model("tiny-idefics2", device="cpu", dtype=torch.float32, seed=0)
        state = run_train(cfg, result_dir={str(tmp_path)!r}, runner=runner, splits=splits)
        run_dir = {str(tmp_path)!r} + "/ckpt/nojax-tiny-idefics2-vqav2-4-1shot"
        tree = load_trainable(run_dir + "/epoch-0", template=state.trainable)
        assert all(torch.equal(tree["shift"][k], v) for k, v in state.trainable["shift"].items())
        loaded = [m for m in sys.modules if sys.modules[m] is not None]
        assert not any(m.split(".")[0] in ("jax", "optax", "flax", "msgpack") for m in loaded)
        # nothing of the JAX package was imported
        assert not any(m.split(".")[0] == "mimic_tpu" for m in loaded)
        print("ok", state.step)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok 2")
