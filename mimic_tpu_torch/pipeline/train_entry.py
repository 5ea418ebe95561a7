"""Training entry: assembles a full run (counterpart of
``mimic_tpu/pipeline/train_entry.py``).

The training vision-feature cache (``train/vision_cache.py``) is on when
``cfg.vision_cache`` is set and the model has an inline-splice vision tower,
as in the JAX entry.  The trainable tree holds the encoder's shift, LoRA
adapters and a prefix-tuning KV as the config asks.  ``use_mesh`` in a
process group of more than one rank lays the world out as
``cfg.mesh.data_axis`` x ``cfg.mesh.model_axis``: the frozen tree is cut by
``shard_params``, the trainables are ``replicate``d, every rank collates the
same global batch of ``cfg.batch_size`` rows and keeps its ``data`` rows
(``shard_batch``), and the training vision cache is off, as in JAX.
``attn_impl="auto"`` resolves to ``"flash"`` on CUDA and ``"xla"`` on the
CPU; on the flash path the collator pads to multiples of 128, the alignment
the decoder's flash path needs (at the collator's default of 64 a batch
could silently take the plain path).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional

import torch

from ..config import TrainConfig
from ..data.adapters import build_adapter
from ..data.prefetch import prefetch
from ..device import DeviceLike, resolve_device
from ..models.factory import build_model
from .. import parallel
from ..shift.lora import init_lora_params
from ..shift.params import init_shift_params
from ..shift.prefix import init_prefix_params
from ..train.collate import TrainCollator
from ..train.optim import build_optimizer, cosine_warmup_schedule
from ..train.step import TrainState, make_train_step, to_device_batch
from ..train.trainer import get_max_epochs, train_loop
from ..train.vision_cache import TrainVisionCache


def init_trainable(cfg: TrainConfig, text_cfg, generator: torch.Generator, device) -> Dict[str, Any]:
    """``{"shift", "lora", "prefix"}`` as far as the config asks for each, drawn
    from ``generator`` in that order."""
    dev = resolve_device(device)
    trainable: Dict[str, Any] = {}
    if cfg.encoder.kind != "none":
        trainable["shift"] = init_shift_params(cfg.encoder, text_cfg, generator, dev)
    if cfg.peft.lora is not None:
        trainable["lora"] = init_lora_params(cfg.peft.lora, text_cfg, generator, dev)
    if cfg.peft.prefix is not None:
        trainable["prefix"] = init_prefix_params(cfg.peft.prefix, text_cfg, generator, dev)
    if not trainable:
        raise ValueError("Nothing to train: encoder kind 'none' and no LoRA/prefix config")
    return trainable


def resolve_attn_impl(attn_impl: str, device: torch.device) -> str:
    if attn_impl == "auto":
        return "flash" if device.type == "cuda" else "xla"
    return attn_impl


def run_train(
    cfg: TrainConfig,
    result_dir: str = "results",
    runner=None,
    splits=None,
    device: Optional[DeviceLike] = None,
    use_mesh: bool = False,
) -> TrainState:
    """Train ``cfg``'s trainable tree on ``runner`` (built from ``cfg.model_name`` on
    ``device`` when not given; ``None`` is the card) and write
    ``<result_dir>/ckpt/<runname>/`` (rank 0 of a group writes)."""
    if runner is None:
        runner = build_model(cfg.model_name, cfg.data.name, device=device,
                             dtype=getattr(torch, cfg.dtype), seed=cfg.seed)
    dev = runner.device
    adapter = build_adapter(cfg.data, splits=splits)
    trainable = init_trainable(
        cfg, runner.cfg.text, torch.Generator(device=dev).manual_seed(cfg.seed), dev
    )

    dl = adapter.train_dataloader(runner.apply_prompt_template, cfg.batch_size)
    max_epochs = cfg.epochs or get_max_epochs(cfg.model_name, cfg.data.num_query_samples)
    steps_per_epoch = max(len(dl) // max(cfg.accumulate_grad_batches, 1), 1)
    total_steps = steps_per_epoch * max_epochs
    warmup = (
        int(cfg.warmup_step * total_steps)
        if isinstance(cfg.warmup_step, float)
        else int(cfg.warmup_step)
    )
    tx = build_optimizer(
        trainable,
        lr=cfg.peft.lr,
        weight_decay=cfg.weight_decay,
        warmup_steps=warmup,
        total_steps=total_steps,
        grad_clip=cfg.grad_clip_val,
        scale_lr=cfg.peft.scale_lr,
        accumulate_steps=cfg.accumulate_grad_batches,
    )
    attn_impl = resolve_attn_impl(cfg.attn_impl, dev)
    step = make_train_step(
        runner.cfg, cfg.encoder, tx,
        ce_loss_weight=cfg.peft.ce_loss_weight,
        align_loss_weight=cfg.peft.align_loss_weight,
        lora_scaling=cfg.peft.lora.scaling() if cfg.peft.lora else 1.0,
        lora_dropout=cfg.peft.lora.dropout if cfg.peft.lora else 0.0,
        attn_impl=attn_impl,
        seed=cfg.seed,
    )
    # demo images resample from the fixed train set and the tower is frozen:
    # cache their encoded features instead of encoding them every step
    mesh = None
    if use_mesh and _world_size() > 1:
        mesh = parallel.make_mesh(cfg.mesh.data_axis, cfg.mesh.model_axis, device_type=dev.type)
    use_vcache = (
        cfg.vision_cache
        and runner.cfg.family != "idefics1"
        and runner.cfg.vision is not None
        and mesh is None
    )
    collator = TrainCollator(
        runner.processor, cfg.encoder.strategy(),
        num_image_in_query=cfg.data.num_image_in_query,
        pad_multiple=128 if attn_impl == "flash" else 64,
        max_query_len=cfg.data.max_query_len,
        max_full_len=cfg.data.max_full_len,
        emit_image_keys=use_vcache,
    )
    batch_transform = None
    if use_vcache:
        batch_transform = TrainVisionCache(
            runner.cfg, runner.params, max_bytes=cfg.vision_cache_mb * 1024 * 1024,
            attn_impl=attn_impl,
        )
    frozen = runner.params
    if mesh is not None:
        frozen = parallel.shard_params(frozen, mesh)
        trainable = parallel.replicate(trainable, mesh)
        def batch_transform(b):
            return to_device_batch(parallel.shard_batch(b, mesh), dev)
    state = TrainState(trainable, tx.init(trainable), 0)

    def epoch_batches(epoch: int):
        # collate (tokenize + image preprocessing) in background threads while
        # the device runs the current step
        return prefetch(dl, depth=2, transform=collator, workers=max(1, cfg.data.num_workers))

    with parallel.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        return train_loop(
            cfg, state, frozen, step, epoch_batches,
            result_dir=result_dir, max_epochs=max_epochs,
            lr_schedule=cosine_warmup_schedule(cfg.peft.lr, warmup, total_steps),
            batch_transform=batch_transform,
        )


def _world_size() -> int:
    """The process group's size; 1 without one, unless the launcher started
    several processes (torchrun's ``WORLD_SIZE``) that never joined a group."""
    if torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            "run_train(use_mesh=True): WORLD_SIZE > 1 but no process group; set "
            "MIMIC_TPU_DISTRIBUTED=1 (the CLI joins the group) or call init_distributed()"
        )
    return 1
