"""mimic_tpu_torch.pipeline: train → eval → analyze on a tiny idefics2 with
synthetic VQA splits, against ``mimic_tpu``'s pipeline on the same weights
(``tests/test_pipeline.py`` is the model).  fp32 on the CPU on both sides.

- ``run_pipeline``: the port trains, evaluates and analyzes; the JAX package
  evaluates and analyzes a copy of the port's checkpoints: same run names, same
  record path, same records, metric and analysis.
- the CLI's eval entry with ``quant=int8-w8a8`` on the port's checkpoint
  against the JAX runner that loaded the same file.
- resume-skip, the two-rank part-file merge, the record helpers, the default
  device, the CLI's dispatch.
- one subprocess run of train → eval with ``mimic_tpu``, ``jax``, ``optax`` and
  ``flax`` all unimportable.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from mimic_tpu.config import EvalConfig as JaxEvalConfig
from mimic_tpu.config import get_preset as jax_get_preset
from mimic_tpu.models.config import get_model_config
from mimic_tpu.models.lvlm import init_lvlm_params
from mimic_tpu.models.runner import LVLMRunner as JaxRunner
from mimic_tpu.models.tokenizer import SimpleTokenizer
from mimic_tpu.pipeline.analyze import analyze as jax_analyze
from mimic_tpu.pipeline import evaluate as jevaluate
from mimic_tpu.pipeline import runner as jpipeline
from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch.bridge import to_torch
from mimic_tpu_torch.models.factory import build_model
from mimic_tpu_torch.models.runner import LVLMRunner
from mimic_tpu_torch.pipeline import analyze as tanalyze
from mimic_tpu_torch.pipeline import cli as tcli
from mimic_tpu_torch.pipeline import evaluate as tevaluate
from mimic_tpu_torch.pipeline import runner as tpipeline
from mimic_tpu_torch.pipeline import train_entry as ttrain
from test_eval_e2e import synthetic_vqa_splits

RUN = "pipe-tiny-idefics2-vqav2-4-1shot"
RECORD_KEYS = ("question_id", "raw_output", "prediction", "answers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run many small ops: one thread each, not a pool that every
    op must wake (beside the other test workers the pool's wake-ups dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny():
    tk = SimpleTokenizer(padding_side="left")
    cfg = get_model_config("tiny-idefics2").replace(
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id)
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))
    return cfg, init_lvlm_params(cfg, jax.random.PRNGKey(0))


def _jax_runner():
    cfg, params = _tiny()
    return JaxRunner(cfg, params, SimpleTokenizer(padding_side="left"), pad_multiple=32)


def _torch_runner():
    cfg, params = _tiny()
    return LVLMRunner(cfg, to_torch(jax.tree.map(np.asarray, params), "cpu"),
                      SimpleTokenizer(padding_side="left"), device="cpu", pad_multiple=32)


def _spec(module, runname="pipe", preset="mimic"):
    return module.PipelineSpec(
        runname=runname, model_name="tiny-idefics2", preset=preset, datasets=["vqav2"],
        num_query_samples=[4], num_shots=[1],
        train_overrides={"epochs": 1, "batch_size": 2, "accumulate_grad_batches": 1},
        eval_overrides={"batch_size": 2, "iterations": 1},
    )


def _fields(records):
    return [{k: r[k] for k in RECORD_KEYS} for r in records]


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """The port's pipeline (train, eval, analyze), then the JAX package's eval
    and analyze on a copy of the port's checkpoints: each package draws its
    initial shift from its own generator, so the trained trees are compared
    through one file (the train step itself is held to JAX's, from one initial
    tree, in ``test_torch_train_step.py``)."""
    dirs = {side: str(tmp_path_factory.mktemp(side)) for side in ("jax", "torch")}
    runners = {"jax": _jax_runner(), "torch": _torch_runner()}
    summaries = {"torch": tpipeline.run_pipeline(
        _spec(tpipeline), result_dir=dirs["torch"], runner=runners["torch"],
        splits=synthetic_vqa_splits())}
    shutil.copytree(os.path.join(dirs["torch"], "ckpt"), os.path.join(dirs["jax"], "ckpt"))
    spec = _spec(jpipeline)
    spec.do_train = False
    summaries["jax"] = jpipeline.run_pipeline(
        spec, result_dir=dirs["jax"], runner=runners["jax"], splits=synthetic_vqa_splits())
    return dirs, runners, summaries


# ---------------------------------------------------------------------------
# the whole pipeline against the JAX package's
# ---------------------------------------------------------------------------


def test_pipeline_trains_and_writes_what_the_jax_pipeline_reads(pipelines):
    dirs, runners, summaries = pipelines
    assert summaries["torch"]["trained"] == [RUN] and summaries["jax"]["trained"] == []
    run_dir = os.path.join(dirs["torch"], "ckpt", RUN)
    assert os.path.exists(os.path.join(run_dir, "epoch-0", "encoder.msgpack"))
    config = json.load(open(os.path.join(run_dir, "config.json")))
    assert config["runname"] == "pipe" and config["epochs"] == 1
    # both runners carry the checkpoint's shift, byte for byte
    shift_t, shift_j = runners["torch"].shift, runners["jax"].shift
    assert shift_t is not None and set(shift_t) == set(shift_j)
    for k, v in shift_t.items():
        assert np.array_equal(v.numpy(), np.asarray(shift_j[k]))
    # and training moved it away from its initial value
    enc, peft = tconfig.get_preset("mimic")
    cfg = tconfig.TrainConfig(model_name="tiny-idefics2", encoder=enc, peft=peft)
    init = ttrain.init_trainable(cfg, runners["torch"].cfg.text,
                                 torch.Generator().manual_seed(cfg.seed), "cpu")["shift"]
    assert set(init) == set(shift_t)
    assert any(v.shape == shift_t[k].shape and not torch.equal(v, shift_t[k])
               for k, v in init.items())


def test_pipeline_records_and_metric_equal_the_jax_pipeline(pipelines):
    dirs, _, summaries = pipelines
    rel = {side: [os.path.relpath(p, dirs[side]) for p in summaries[side]["evaluated"]]
           for side in dirs}
    assert rel["torch"] == rel["jax"] == [os.path.join("record", RUN, "epoch-0.json")]
    saved = {side: json.load(open(summaries[side]["evaluated"][0])) for side in dirs}
    assert "overall" in saved["torch"]["eval_result"]
    assert saved["torch"]["eval_result"] == saved["jax"]["eval_result"]
    assert len(saved["torch"]["records"]) == 2  # one iteration of batch 2
    assert _fields(saved["torch"]["records"]) == _fields(saved["jax"]["records"])
    # the stored configs: the training run's and the eval's, field for field
    assert saved["torch"]["train_config"] == saved["jax"]["train_config"]
    ours, theirs = saved["torch"]["eval_config"], saved["jax"]["eval_config"]
    ours["ckpt_path"], theirs["ckpt_path"] = (os.path.relpath(c["ckpt_path"], dirs[s])
                                              for c, s in ((ours, "torch"), (theirs, "jax")))
    assert ours == theirs


def test_pipeline_analyze_equals_the_jax_pipeline(pipelines):
    dirs, _, summaries = pipelines
    assert summaries["torch"]["analyzed"] == summaries["jax"]["analyzed"]
    top = summaries["torch"]["analyzed"][RUN]
    assert top and top[0][0] == "epoch-0"
    assert tanalyze.analyze("pipe", result_dir=dirs["torch"]) == \
        jax_analyze("pipe", result_dir=dirs["jax"])


def test_pipeline_resume_skips_everything(pipelines):
    dirs, runners, _ = pipelines
    again = tpipeline.run_pipeline(_spec(tpipeline), result_dir=dirs["torch"],
                                   runner=runners["torch"], splits=synthetic_vqa_splits())
    assert again["trained"] == [RUN] and again["evaluated"] == []


def test_port_checkpoint_evaluates_identically_in_the_jax_package(pipelines, tmp_path):
    """One file, two packages: the port's epoch checkpoint loaded by each side's
    ``_load_ckpt_into_runner`` gives the same shift bytes and the same records."""
    dirs, _, _ = pipelines
    ckpt = os.path.join(dirs["torch"], "ckpt", RUN, "epoch-0")
    results = {}
    for side, cfg_cls, preset, pipe, ev, runner in (
            ("jax", JaxEvalConfig, jax_get_preset, jpipeline, jevaluate, _jax_runner()),
            ("torch", tconfig.EvalConfig, tconfig.get_preset, tpipeline, tevaluate, _torch_runner())):
        cfg = cfg_cls(model_name="tiny-idefics2", ckpt_path=ckpt, batch_size=2, iterations=2)
        cfg.encoder, cfg.peft = preset("mimic")
        cfg.data.name, cfg.data.num_query_samples, cfg.data.num_shot = "vqav2", 4, 1
        pipe._load_ckpt_into_runner(cfg, runner)
        records, metrics = ev.run_eval(cfg, runner, result_dir=str(tmp_path / side),
                                       splits=synthetic_vqa_splits())
        results[side] = (runner.shift, records, metrics)
    for k, v in results["torch"][0].items():
        assert np.array_equal(v.numpy(), np.asarray(results["jax"][0][k]))
    assert len(results["torch"][1]) == 4
    assert _fields(results["torch"][1]) == _fields(results["jax"][1])
    assert results["torch"][2] == results["jax"][2]


# ---------------------------------------------------------------------------
# the CLI's eval entry with quant=int8-w8a8
# ---------------------------------------------------------------------------


def _eval_overrides(ckpt, result_dir, *extra):
    return ["model_name=tiny-idefics2", f"ckpt_path={ckpt}", "preset=mimic", "batch_size=2",
            "iterations=2", "data.name=vqav2", "data.num_query_samples=4", "data.num_shot=1",
            "device=cpu", f"result_dir={result_dir}", *extra]


def test_cli_eval_w8a8_matches_the_jax_runner(pipelines, tmp_path):
    dirs, _, _ = pipelines
    ckpt = os.path.join(dirs["torch"], "ckpt", RUN, "epoch-0")
    runner = _torch_runner()
    records, metrics = tcli._eval(_eval_overrides(ckpt, str(tmp_path / "t"), "quant=int8-w8a8"),
                                  splits=synthetic_vqa_splits(), runner=runner)
    # the checkpoint was loaded, then the tree quantized with its a8 markers
    assert runner.shift is not None
    layers = runner.params["lm"]["decoder"]["layers"]
    assert all("a8" in layers[k] for k in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"))
    path = tmp_path / "t" / "record" / RUN / "epoch-0.json"
    saved = json.loads(path.read_text())
    assert saved["eval_config"]["quant"] == "int8-w8a8" and saved["eval_result"] == metrics
    assert saved["train_config"]["runname"] == "pipe"

    # what mimic_tpu's CLI does (cli.py:39-59), on a runner with the same weights
    jr = _jax_runner()
    cfg = JaxEvalConfig(model_name="tiny-idefics2", ckpt_path=ckpt, batch_size=2, iterations=2,
                        quant="int8-w8a8")
    cfg.encoder, cfg.peft = jax_get_preset("mimic")
    cfg.data.name, cfg.data.num_query_samples, cfg.data.num_shot = "vqav2", 4, 1
    jpipeline._load_ckpt_into_runner(cfg, jr)
    jr.set_quant(cfg.quant)
    want_records, want_metrics = jevaluate.run_eval(cfg, jr, result_dir=str(tmp_path / "j"),
                                                    splits=synthetic_vqa_splits())
    assert jevaluate.record_path(cfg, "x") == tevaluate.record_path(cfg, "x")
    assert _fields(records) == _fields(want_records) and metrics == want_metrics


def test_cli_eval_resume_skips_and_icl_needs_no_checkpoint(pipelines, tmp_path):
    dirs, _, _ = pipelines
    ckpt = os.path.join(dirs["torch"], "ckpt", RUN, "epoch-0")
    runner = _torch_runner()
    args = _eval_overrides(ckpt, str(tmp_path))
    assert tcli._eval(args, splits=synthetic_vqa_splits(), runner=runner) is not None
    assert tcli._eval(args, splits=synthetic_vqa_splits(), runner=runner) is None
    assert tcli._eval(args + ["resume=false"], splits=synthetic_vqa_splits(),
                      runner=runner) is not None
    # ICL mode: no checkpoint, no shift; the record is named by the shot count
    icl = _torch_runner()
    out = tcli._eval([a for a in args if not a.startswith(("ckpt_path", "preset"))],
                     splits=synthetic_vqa_splits(), runner=icl)
    assert out is not None and icl.shift is None
    assert (tmp_path / "record" / "icl-tiny-idefics2-vqav2" / "1shot.json").exists()


def test_non_icl_eval_without_trained_parameters_raises(tmp_path):
    cfg = tconfig.EvalConfig(model_name="tiny-idefics2", ckpt_path=str(tmp_path / "r" / "epoch-0"))
    cfg.data.name, cfg.data.num_query_samples = "vqav2", 4
    with pytest.raises(ValueError, match="trained parameters"):
        tevaluate.run_eval(cfg, _torch_runner(), result_dir=str(tmp_path),
                           splits=synthetic_vqa_splits())


@pytest.mark.parametrize("preset", ["lora", "prefix-tuning"])
def test_lora_and_prefix_checkpoints_load(preset, tmp_path):
    """A LoRA checkpoint is merged into the weights (the base kept pristine,
    no live adapters); a prefix checkpoint reaches the runner as its prefix."""
    from mimic_tpu_torch.shift.lora import merge_lora
    from mimic_tpu_torch.train.checkpoints import save_trainable

    cfg = tconfig.EvalConfig(model_name="tiny-idefics2", ckpt_path=str(tmp_path / "r" / "epoch-0"))
    cfg.encoder, cfg.peft = tconfig.get_preset(preset)
    runner = _torch_runner()
    base = runner.params
    tree = ttrain.init_trainable(tpipeline._as_train_cfg(cfg), runner.cfg.text,
                                 torch.Generator().manual_seed(3), "cpu")
    if preset == "lora":
        tree["lora"] = {k: v + 0.01 if k.endswith("_b") else v for k, v in tree["lora"].items()}
    save_trainable(cfg.ckpt_path, tree)
    tpipeline._load_ckpt_into_runner(cfg, runner)
    if preset == "lora":
        want = merge_lora(base, tree["lora"], cfg.peft.lora.scaling())
        got = runner.params["lm"]["decoder"]["layers"]
        assert runner._lora_merged and runner.adapters is None and runner.prefix is None
        pristine = runner._unmerged_params["lm"]["decoder"]["layers"]
        assert all(v is base["lm"]["decoder"]["layers"][k] for k, v in pristine.items())
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            assert torch.equal(got[name], want["lm"]["decoder"]["layers"][name])
            assert not torch.equal(got[name], base["lm"]["decoder"]["layers"][name])
        # the eval quantizes the merged tree; the base stays for the next merge
        runner.set_quant("int8-memory")
        assert "qkv_proj" in runner.params["lm"]["decoder"]["layers"]
        assert all(v is base["lm"]["decoder"]["layers"][k] for k, v in pristine.items())
    else:
        assert runner.shift is None and runner.adapters is None and not runner._lora_merged
        assert all(torch.equal(runner.prefix[k], v) for k, v in tree["prefix"].items())
        assert runner.params["lm"]["decoder"]["layers"]["q_proj"] is \
            base["lm"]["decoder"]["layers"]["q_proj"]


@pytest.mark.parametrize("preset", ["lora", "mini_lora", "prefix-tuning"])
def test_cli_train_and_eval_with_peft_presets(preset, tmp_path):
    """``python -m mimic_tpu_torch train`` and ``eval`` with the preset on the
    CPU (``device=cpu``, tiny idefics2 with random weights)."""
    common = ["model_name=tiny-idefics2", f"preset={preset}", "dtype=float32", "device=cpu",
              "batch_size=2", "data.name=vqav2", "data.num_query_samples=4", "data.num_shot=1",
              f"result_dir={tmp_path}"]
    state = tcli._train(common + ["runname=peft", "epochs=1", "accumulate_grad_batches=1"],
                        splits=synthetic_vqa_splits())
    assert state.step == 2 and set(state.trainable) == ({"prefix"} if preset == "prefix-tuning"
                                                        else {"lora"})
    ckpt = tmp_path / "ckpt" / "peft-tiny-idefics2-vqav2-4-1shot" / "epoch-0"
    records, metrics = tcli._eval(common + [f"ckpt_path={ckpt}", "iterations=1"],
                                  splits=synthetic_vqa_splits())
    assert len(records) == 2 and "overall" in metrics


# ---------------------------------------------------------------------------
# the two-rank part-file merge
# ---------------------------------------------------------------------------


def test_two_rank_eval_merges_to_the_single_rank_record(tmp_path):
    def cfg():
        c = tconfig.EvalConfig(model_name="tiny-idefics2", batch_size=2, iterations=2)
        c.data.name, c.data.num_query_samples, c.data.num_shot = "vqav2", 4, 1
        c.generation.num_beams, c.generation.max_new_tokens = 1, 4
        return c

    runner = _torch_runner()
    single = tevaluate.run_eval(cfg(), runner, result_dir=str(tmp_path / "one"),
                                splits=synthetic_vqa_splits(), shard=(0, 1))
    # rank 1 writes its part and returns; rank 0 then finds both parts
    sharded = str(tmp_path / "two")
    assert tevaluate.run_eval(cfg(), runner, result_dir=sharded, splits=synthetic_vqa_splits(),
                              shard=(1, 2)) is None
    path = tevaluate.record_path(cfg(), sharded)
    assert os.path.exists(f"{path}.part-1-of-2") and not os.path.exists(path)
    merged = tevaluate.run_eval(cfg(), runner, result_dir=sharded, splits=synthetic_vqa_splits(),
                                shard=(0, 2), shard_merge_timeout=5.0)
    assert merged is not None and merged[1] == single[1]
    assert _fields(merged[0]) == _fields(single[0])
    saved = json.load(open(path))
    assert saved["eval_result"] == single[1] and len(saved["records"]) == 4
    assert not any(".part-" in f for f in os.listdir(os.path.dirname(path)))


def test_rank_zero_times_out_on_a_missing_part(tmp_path):
    c = tconfig.EvalConfig(model_name="tiny-idefics2", batch_size=2, iterations=1)
    c.data.name, c.data.num_query_samples, c.data.num_shot = "vqav2", 4, 0
    c.generation.num_beams, c.generation.max_new_tokens = 1, 2
    with pytest.raises(TimeoutError, match="part-1-of-2"):
        tevaluate.run_eval(c, _torch_runner(), result_dir=str(tmp_path),
                           splits=synthetic_vqa_splits(), shard=(0, 2), shard_merge_timeout=0.3)


def test_interleave_restores_query_order():
    assert tevaluate._interleave([[0, 2, 4], [1, 3]]) == [0, 1, 2, 3, 4]
    assert tevaluate._interleave([]) == [] and tevaluate._default_shard() == (0, 1)


# ---------------------------------------------------------------------------
# record helpers, the grid, the default device, the CLI's dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ckpt,shots,want", [
    (None, 8, "record/icl-tiny-idefics2-vqav2/8shot.json"),
    ("res/ckpt/run-a/epoch-3", 8, "record/run-a/epoch-3.json"),
])
def test_record_path_matches_jax(ckpt, shots, want):
    paths = []
    for cls, ev in ((tconfig.EvalConfig, tevaluate), (JaxEvalConfig, jevaluate)):
        cfg = cls(model_name="tiny-idefics2", ckpt_path=ckpt)
        cfg.data.name, cfg.data.num_shot = "vqav2", shots
        paths.append(ev.record_path(cfg, "out"))
    assert paths[0] == paths[1] == os.path.join("out", want)


def test_save_record_layout(tmp_path):
    path = str(tmp_path / "a" / "b.json")
    tevaluate.save_record(path, {"overall": 50.0}, [{"question_id": 1}], None, {"quant": None})
    assert json.load(open(path)) == {"eval_result": {"overall": 50.0},
                                     "records": [{"question_id": 1}],
                                     "train_config": None, "eval_config": {"quant": None}}


def test_task_grid_and_epoch_sort_match_jax():
    kw = dict(runname="x", model_name="m", datasets=["vqav2", "coco"],
              num_query_samples=[100], num_shots=[8, 16])
    grid = tpipeline.task_grid(tpipeline.PipelineSpec(**kw))
    assert grid == jpipeline.task_grid(jpipeline.PipelineSpec(**kw)) and len(grid) == 4
    names = ["epoch-10", "epoch-2", "epoch-1"]
    assert sorted(names, key=tanalyze.sort_runname_key) == ["epoch-1", "epoch-2", "epoch-10"]


def test_pipeline_shards_the_grid_across_processes(tmp_path):
    spec = _spec(tpipeline, runname="grid")
    spec.do_train = spec.do_eval = spec.do_analyze = False
    spec.num_shots = [1, 2, 4]
    assert tpipeline.run_pipeline(spec, result_dir=str(tmp_path), process_index=1,
                                  process_count=2) == {"trained": [], "evaluated": [], "analyzed": {}}


@pytest.mark.parametrize("entry", ["build_model", "run_train", "run_pipeline", "cli-train",
                                   "cli-eval", "cli-pipeline"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry, tmp_path):
    """``device=None`` is ``"cuda"``: on a machine without a card every entry
    point raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the error of the default device on a machine without a card")
    enc, peft = tconfig.get_preset("mimic")
    cfg = tconfig.TrainConfig(runname="d", model_name="tiny-idefics2", encoder=enc, peft=peft)
    calls = {
        "build_model": lambda: build_model("tiny-idefics2"),
        "run_train": lambda: ttrain.run_train(cfg, result_dir=str(tmp_path),
                                              splits=synthetic_vqa_splits()),
        "run_pipeline": lambda: tpipeline.run_pipeline(
            _spec(tpipeline), result_dir=str(tmp_path), splits=synthetic_vqa_splits()),
        "cli-train": lambda: tcli.main(["train", "model_name=tiny-idefics2",
                                        f"result_dir={tmp_path}"]),
        "cli-eval": lambda: tcli.main(["eval", "model_name=tiny-idefics2",
                                       f"result_dir={tmp_path}"]),
        "cli-pipeline": lambda: tcli.main(["pipeline", "-r", "d", "-m", "tiny-idefics2",
                                           "--result-dir", str(tmp_path)]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_cli_splits_run_keys_from_config_overrides():
    run, rest = tcli._split_overrides(["preset=mimic", "device=cpu", "quant=int8-w8a8",
                                       "result_dir=out", "data.num_shot=2"])
    assert run == {"preset": "mimic", "device": "cpu", "result_dir": "out"}
    assert rest == ["quant=int8-w8a8", "data.num_shot=2"]
    assert tcli._split_overrides([])[0] == {"preset": None, "device": None, "result_dir": "results"}


def test_cli_dispatch(pipelines, capsys):
    dirs, _, _ = pipelines
    tcli.main([])
    assert "python -m mimic_tpu_torch eval" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        tcli.main(["serve"])
    assert exc.value.code == 2
    capsys.readouterr()
    tcli.main(["analyze", "pipe", "--result-dir", dirs["torch"]])
    assert RUN in capsys.readouterr().out


def test_cli_pipeline_on_the_cpu(tmp_path):
    """``python -m mimic_tpu_torch pipeline`` end to end: the model comes from
    ``build_model`` (random weights), so train, eval and analyze all run."""
    # the eval keeps the config's batch of 16, so the query set needs 16 rows
    summary = tcli._pipeline(["-r", "cli", "-m", "tiny-idefics2", "-d", "vqav2", "-q", "16", "-s", "1",
                              "--result-dir", str(tmp_path), "--device", "cpu"],
                             splits=synthetic_vqa_splits(n_train=20, n_val=16))
    runname = "cli-tiny-idefics2-vqav2-16-1shot"
    assert summary["trained"] == [runname] and runname in summary["analyzed"]
    assert summary["evaluated"] and all(os.path.exists(p) for p in summary["evaluated"])


# ---------------------------------------------------------------------------
# without the JAX package
# ---------------------------------------------------------------------------


def test_train_then_eval_runs_without_mimic_tpu_jax_optax_flax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        for name in ("mimic_tpu", "jax", "optax", "flax"):
            sys.modules[name] = None  # any import of them now raises
        import json
        import numpy as np
        from mimic_tpu_torch.pipeline import cli
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
        out = {str(tmp_path)!r}
        common = ["model_name=tiny-idefics2", "preset=mimic", "dtype=float32", "device=cpu",
                  "batch_size=2", "data.name=vqav2", "data.num_query_samples=4", "data.num_shot=1",
                  "result_dir=" + out]
        state = cli._train(common + ["runname=nojax", "epochs=1", "accumulate_grad_batches=1"],
                           splits=splits)
        ckpt = out + "/ckpt/nojax-tiny-idefics2-vqav2-4-1shot/epoch-0"
        records, metrics = cli._eval(common + ["ckpt_path=" + ckpt, "quant=int8-w8a8",
                                               "iterations=1"], splits=splits)
        saved = json.load(open(out + "/record/nojax-tiny-idefics2-vqav2-4-1shot/epoch-0.json"))
        assert saved["eval_result"] == metrics and "overall" in metrics and len(records) == 2
        loaded = [m for m in sys.modules if sys.modules[m] is not None]
        assert not any(m.split(".")[0] in ("mimic_tpu", "jax", "optax", "flax") for m in loaded)
        print("ok", state.step, len(records))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok 2 2")


def test_module_entry_prints_usage_without_jax():
    code = ("import sys, runpy\n"
            "for n in ('mimic_tpu', 'jax', 'optax', 'flax'): sys.modules[n] = None\n"
            "sys.argv = ['mimic_tpu_torch']\n"
            "runpy.run_module('mimic_tpu_torch', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert "python -m mimic_tpu_torch eval" in proc.stdout
