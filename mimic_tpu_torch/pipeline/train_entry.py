"""Training entry: assembles a full run (counterpart of
``mimic_tpu/pipeline/train_entry.py``).

The training vision-feature cache (``train/vision_cache.py``) is on when
``cfg.vision_cache`` is set and the model has an inline-splice vision tower,
as in the JAX entry.  The trainable tree holds the encoder's shift, LoRA
adapters and a prefix-tuning KV as the config asks.  Differences from the JAX
entry, a later slice's work: one process on one device (no mesh, no per-host
sharding).
``attn_impl="auto"`` resolves to ``"flash"`` on CUDA and ``"xla"`` on the
CPU; on the flash path the collator pads to multiples of 128, the alignment
the decoder's flash path needs (at the collator's default of 64 a batch
could silently take the plain path).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import TrainConfig
from ..data.adapters import build_adapter
from ..data.prefetch import prefetch
from ..device import DeviceLike, resolve_device
from ..models.factory import build_model
from ..shift.lora import init_lora_params
from ..shift.params import init_shift_params
from ..shift.prefix import init_prefix_params
from ..train.collate import TrainCollator
from ..train.optim import build_optimizer, cosine_warmup_schedule
from ..train.step import TrainState, make_train_step
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
) -> TrainState:
    """Train ``cfg``'s trainable tree on ``runner`` (built from ``cfg.model_name`` on
    ``device`` when not given; ``None`` is the card) and write
    ``<result_dir>/ckpt/<runname>/``."""
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
    use_vcache = (
        cfg.vision_cache
        and runner.cfg.family != "idefics1"
        and runner.cfg.vision is not None
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
    state = TrainState(trainable, tx.init(trainable), 0)

    def epoch_batches(epoch: int):
        # collate (tokenize + image preprocessing) in background threads while
        # the device runs the current step
        return prefetch(dl, depth=2, transform=collator, workers=max(1, cfg.data.num_workers))

    return train_loop(
        cfg, state, runner.params, step, epoch_batches,
        result_dir=result_dir, max_epochs=max_epochs,
        lr_schedule=cosine_warmup_schedule(cfg.peft.lr, warmup, total_steps),
        batch_transform=batch_transform,
    )
