"""Training driver: epoch schedule, loop, checkpointing, logging.

Counterpart of ``mimic_tpu/train/trainer.py`` (which imports JAX at the top,
so the port cannot import these from it).  Epoch counts and checkpoint
windows mirror the reference's ``get_max_epochs`` / ``save_when``; the
reference's ``elif "idefics2-8b":`` truthy-string bug stays fixed, as in the
JAX package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

from ..config import TrainConfig, config_to_dict
from ..utils import get_expand_runname
from .checkpoints import all_checkpoints_exist, save_run_config, save_trainable
from .optim import flatten
from .step import TrainState, to_device_batch


def get_max_epochs(model_name: str, num_query_samples: int) -> int:
    if "idefics-9b" in model_name:
        return 15 if num_query_samples < 100 else 10
    if "idefics2-8b" in model_name:
        if num_query_samples < 100:
            return 15
        return 10 if num_query_samples <= 500 else 5
    if "llava" in model_name:
        return 10 if num_query_samples <= 500 else 5
    return 10


def make_save_when(model_name: str, num_query_samples: int, dataset_name: str) -> Callable[[int], bool]:
    def save_when(epoch: int) -> bool:
        if "idefics-9b" in model_name:
            if num_query_samples < 100:
                return epoch >= 10
            if num_query_samples <= 200:
                return epoch >= (5 if dataset_name == "coco" else 7)
            return epoch >= 5
        if "idefics2-8b" in model_name:
            if num_query_samples < 100:
                return epoch >= 10
            if num_query_samples <= 500:
                return epoch >= 5
            return True
        if "llava" in model_name:
            return epoch >= 5 if num_query_samples <= 1000 else True
        return True

    return save_when


class MetricLogger:
    """JSONL metric sink (+ wandb when a project is configured and it imports)."""

    def __init__(self, run_dir: str, wandb_project: Optional[str] = None, runname: str = ""):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, name=runname)
            except Exception:
                self._wandb = None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in metrics.items()}, step=step)


def train_loop(
    cfg: TrainConfig,
    state: TrainState,
    frozen_params,
    train_step,
    epoch_batches: Callable[[int], Iterable],
    *,
    result_dir: str = "results",
    max_epochs: Optional[int] = None,
    log_every: int = 2,
    lr_schedule: Optional[Callable[[int], Any]] = None,
    batch_transform: Optional[Callable[[Any], Dict[str, Any]]] = None,
) -> TrainState:
    """Run epochs of the step over host-built batches.

    ``epoch_batches(epoch)`` yields ``TrainBatch`` objects (host numpy), moved
    to the trainable tree's device by ``to_device_batch``, or by
    ``batch_transform`` when given (``train.vision_cache.TrainVisionCache``
    swaps recurring images' pixels for cached encoded features).  Resume-skip
    semantics match the reference: the whole run is skipped when every
    scheduled checkpoint exists.
    """
    runname = get_expand_runname(cfg)
    run_dir = os.path.join(result_dir, "ckpt", runname)
    max_epochs = max_epochs or cfg.epochs or get_max_epochs(
        cfg.model_name, cfg.data.num_query_samples
    )
    save_when = make_save_when(cfg.model_name, cfg.data.num_query_samples, cfg.data.name)

    if cfg.resume and all_checkpoints_exist(run_dir, max_epochs, save_when):
        print(f"All checkpoints for {runname} exist, skipping.")
        return state

    device = next(iter(flatten(state.trainable).values())).device
    logger = MetricLogger(run_dir, cfg.wandb_project, runname)
    step = int(state.step)
    for epoch in range(max_epochs):
        for batch in epoch_batches(epoch):
            device_batch = (
                batch_transform(batch) if batch_transform is not None
                else to_device_batch(batch, device)
            )
            state, metrics = train_step(state, frozen_params, device_batch)
            step += 1
            if step % log_every == 0:
                if lr_schedule is not None:
                    # reference LearningRateMonitor analog
                    metrics = {**metrics, "lr": float(lr_schedule(step))}
                logger.log(step, metrics)
        if save_when(epoch):
            save_trainable(os.path.join(run_dir, f"epoch-{epoch}"), state.trainable)
    save_run_config(run_dir, config_to_dict(cfg))
    return state

