"""Workflow orchestration (counterpart of ``mimic_tpu/pipeline/runner.py``).

The task grid ``product(datasets, num_query_samples, num_shots)`` runs
in-process on the runner's device: train (skip-if-done) → eval every saved
epoch checkpoint (skip-if-recorded) → analyze.  ``process_index`` /
``process_count`` shard the grid across hosts when the caller gives them.
"""

from __future__ import annotations

import copy
import itertools
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import EvalConfig, TrainConfig, get_preset
from ..device import DeviceLike
from ..shift.lora import merge_lora
from ..train.checkpoints import existing_ckpt_epochs, load_trainable
from ..utils import get_expand_runname
from .analyze import analyze
from .evaluate import record_path, run_eval
from .train_entry import init_trainable, run_train


@dataclass
class PipelineSpec:
    runname: str
    model_name: str
    preset: str = "mimic"
    datasets: Sequence[str] = ("vqav2",)
    num_query_samples: Sequence[int] = (500,)
    num_shots: Sequence[int] = (32,)
    do_train: bool = True
    do_eval: bool = True
    do_analyze: bool = True
    train_overrides: Dict[str, Any] = field(default_factory=dict)
    eval_overrides: Dict[str, Any] = field(default_factory=dict)


def task_grid(spec: PipelineSpec) -> List[Tuple[str, int, int]]:
    """product(datasets, num_query_samples, num_shots) (pipeline.py:335-342)."""
    return list(
        itertools.product(spec.datasets, spec.num_query_samples, spec.num_shots)
    )


def _make_train_cfg(spec: PipelineSpec, dataset: str, n_query: int, n_shot: int) -> TrainConfig:
    enc, peft = get_preset(spec.preset)
    cfg = TrainConfig(
        runname=spec.runname, model_name=spec.model_name, encoder=enc, peft=peft
    )
    cfg.data.name = dataset
    cfg.data.num_query_samples = n_query
    cfg.data.num_shot = n_shot
    for k, v in spec.train_overrides.items():
        setattr(cfg, k, v)
    return cfg


def run_pipeline(
    spec: PipelineSpec,
    result_dir: str = "results",
    runner=None,
    splits=None,
    process_index: int = 0,
    process_count: int = 1,
    device: Optional[DeviceLike] = None,
) -> Dict[str, Any]:
    """Execute the full workflow for every grid task owned by this host.
    Without a ``runner`` each training run builds its model on ``device``
    (``None`` is the card).  After a task's evals merged LoRA adapters into
    the runner's weights, the runner gets its unmerged base back, so the next
    task trains on the base (the JAX pipeline trains it on the last merge)."""
    summary: Dict[str, Any] = {"trained": [], "evaluated": [], "analyzed": {}}
    for i, (dataset, n_query, n_shot) in enumerate(task_grid(spec)):
        if i % process_count != process_index:
            continue
        train_cfg = _make_train_cfg(spec, dataset, n_query, n_shot)
        runname = get_expand_runname(train_cfg)
        run_dir = os.path.join(result_dir, "ckpt", runname)

        if spec.do_train:
            run_train(train_cfg, result_dir=result_dir, runner=runner, splits=splits,
                      device=device)
            summary["trained"].append(runname)

        if spec.do_eval:
            for epoch in existing_ckpt_epochs(run_dir):
                eval_cfg = EvalConfig(
                    model_name=spec.model_name,
                    ckpt_path=os.path.join(run_dir, f"epoch-{epoch}"),
                    encoder=train_cfg.encoder,
                    peft=train_cfg.peft,
                )
                eval_cfg.data = copy.deepcopy(train_cfg.data)
                for k, v in spec.eval_overrides.items():
                    setattr(eval_cfg, k, v)
                if runner is not None:
                    _load_ckpt_into_runner(eval_cfg, runner)
                    result = run_eval(
                        eval_cfg, runner, result_dir=result_dir, splits=splits
                    )
                    if result is not None:
                        summary["evaluated"].append(record_path(eval_cfg, result_dir))
            if runner is not None and getattr(runner, "_lora_merged", False):
                # the next task trains on the base, not on this task's merge
                runner.params = runner._unmerged_params
                runner._lora_merged = False

        if spec.do_analyze:
            summary["analyzed"].update(analyze(spec.runname, result_dir=result_dir))
    return summary


def _load_ckpt_into_runner(eval_cfg: EvalConfig, runner) -> None:
    """Load the epoch checkpoint's trainable tree into the runner (the analog
    of register_shift_hooks staying active, src/eval.py:52-61).  The template
    (for the key and shape check) is made on the CPU; ``set_shift`` moves the
    loaded tree to the runner's device.

    LoRA adapters are merged into the weights when ``eval_cfg.merge_lora``
    (the default: no adapter products in any decode step), always onto the
    pristine base kept as ``runner._unmerged_params``, so a loop over epoch
    checkpoints merges each onto the same weights; otherwise the base is
    restored and the adapters stay live.  A prefix is passed through either way.
    """
    template = init_trainable(
        _as_train_cfg(eval_cfg), runner.cfg.text, torch.Generator().manual_seed(0), "cpu"
    )
    trainable = load_trainable(eval_cfg.ckpt_path, template)
    lora_scaling = eval_cfg.peft.lora.scaling() if eval_cfg.peft.lora else 1.0
    lora = trainable.get("lora")
    base = getattr(runner, "_unmerged_params", runner.params)
    if lora is not None and eval_cfg.merge_lora:
        runner._unmerged_params = base
        with torch.no_grad():
            runner.params = merge_lora(base, {k: v.to(runner.device) for k, v in lora.items()},
                                       lora_scaling)
        runner._lora_merged = True
        lora, lora_scaling = None, 1.0
    else:
        runner.params = base
        runner._lora_merged = False
    runner.set_shift(trainable.get("shift"), lora, lora_scaling, prefix=trainable.get("prefix"))


def _as_train_cfg(eval_cfg: EvalConfig) -> TrainConfig:
    cfg = TrainConfig(model_name=eval_cfg.model_name)
    cfg.encoder = eval_cfg.encoder
    cfg.peft = eval_cfg.peft
    cfg.data = eval_cfg.data
    return cfg
