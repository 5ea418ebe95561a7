"""The dual-pass training step (counterpart of ``mimic_tpu/train/step.py``).

One step: the record pass over ``[demos][query][answer]`` on the frozen model
under ``torch.no_grad()`` (capturing per-layer hidden states at the query
tokens), the shift pass over ``[query][answer]`` with the shift injected,
the masked losses, the gradient of the trainable tree only, and the
optimizer update.  Frozen weights never require grad; the trainable leaves
are made leaf tensors that require grad for the step's autograd graph.  On
CUDA with ``attn_impl="flash"`` both passes run the attention kernels and the
shift pass's backward runs the backward kernels.

The trainable tree may hold a MimIC / LIVE ``shift``, LoRA adapters
(``lora``, with dropout on their inputs) and a prefix-tuning KV (``prefix``,
riding as a pre-written cache of length P through the cached attention).

Data parallel: under a current mesh (``parallel.use_mesh``) with a ``data``
axis of more than one rank, or with ``ring_batch_axis`` of ``ring_mesh``,
the batch is this rank's rows; the losses take global denominators and the
gradients and metrics are summed over that axis before ``grad_norm``,
clipping and the update, so every rank takes the step of the whole batch.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import EncoderConfig, Strategy
from ..models.config import ModelConfig
from ..models.generate import _param_dtype
from ..models.lvlm import LVLMBatch, lvlm_forward
from ..parallel.mesh import axis_group, current_mesh
from ..shift.params import multi_head, needs_attn_capture, needs_ffn_capture
from ..shift.prefix import prefix_forward_args
from ..utils.tracing import count, span
from .losses import layer_wise_cos, layer_wise_mse, lm_cross_entropy, logits_kl
from .optim import Optimizer, apply_updates, flatten, global_norm, unflatten

Tree = Dict[str, Any]


def to_device_batch(tb, device) -> Dict[str, torch.Tensor]:
    """numpy ``TrainBatch`` → dict of tensors on ``device`` (non-None leaves;
    ``*_image_keys`` are host-side cache keys and stay out).  Token ids and
    gather indices become int64 for indexing.  Each tensor's copy is counted
    in ``host_syncs``: on a card it blocks the host (pageable memory)."""
    out = {}
    for k, v in vars(tb).items():
        if v is None or k.endswith("_image_keys"):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k.endswith("_ids") or k.endswith("_idx"):
            t = t.long()
        count("host_syncs")
        out[k] = t.to(device)
    return out


def _query_lvlm_batch(b: Dict[str, Any]) -> LVLMBatch:
    return LVLMBatch(
        input_ids=b["query_ids"],
        attention_mask=b["query_mask"],
        pixel_values=b.get("query_pixels"),
        pixel_mask=b.get("query_pixel_mask"),
        image_attention_mask=b.get("query_img_attn"),
        patch_mask=b.get("query_patch_mask"),
    )


def _full_lvlm_batch(b: Dict[str, Any]) -> LVLMBatch:
    return LVLMBatch(
        input_ids=b["full_ids"],
        attention_mask=b["full_mask"],
        pixel_values=b.get("full_pixels"),
        pixel_mask=b.get("full_pixel_mask"),
        image_attention_mask=b.get("full_img_attn"),
        patch_mask=b.get("full_patch_mask"),
    )


def compute_loss(
    trainable: Tree,
    frozen: Tree,
    batch: Dict[str, Any],
    *,
    cfg: ModelConfig,
    strategy: Strategy,
    rec_attn: bool,
    rec_ffn: bool,
    mh: bool,
    ce_loss_weight: float,
    align_loss_weight: float,
    logz2: str,
    attn_impl: str = "xla",
    lora_scaling: float = 1.0,
    lora_dropout: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    shift_remat: bool = False,
    ring_kwargs: Optional[Dict[str, Any]] = None,
    data_group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The step's loss and metrics.  ``ring_kwargs`` go to both passes;
    ``data_group``: the batch is this rank's rows (see the module's note)."""
    ring_kwargs = ring_kwargs or {}
    shift = trainable.get("shift") or None
    lora = trainable.get("lora") or None
    prefix = trainable.get("prefix") or None
    loss = torch.zeros((), dtype=torch.float32, device=batch["query_ids"].device)
    metrics: Dict[str, torch.Tensor] = {}

    layer_wise = strategy.has_layer_wise()
    prefix_logits = prefix_attn = prefix_ffn = None
    if strategy != Strategy.LM_LOSS:
        # record pass: frozen weights, no shift, no graph; only the KL
        # strategies read its logits, the others unembed the last row only
        with torch.no_grad(), span("train.record_pass"):
            out1 = lvlm_forward(
                frozen, cfg, _full_lvlm_batch(batch),
                image_feats=batch.get("full_feats"),
                capture_attn=rec_attn, capture_ffn=rec_ffn, logz2=logz2,
                attn_impl=attn_impl,
                last_logit_only=Strategy.LOGITS_KL_DIV not in strategy,
                capture_gather_idx=batch.get("prefix_q_idx") if layer_wise else None,
                **ring_kwargs,
            )
        prefix_logits = out1.logits
        prefix_attn = out1.decoder.attn_capture
        prefix_ffn = out1.decoder.ffn_capture

    with span("train.shift_forward"):
        qb = _query_lvlm_batch(batch)
        prefix_kwargs = {}
        if prefix is not None:
            # the learned KV rides as a pre-written cache of length P and the
            # forward takes the cached attention: every query attends the P slots,
            # causal within the real block (HF past_key_values semantics)
            qb, pos, cache, total = prefix_forward_args(prefix, qb, _param_dtype(frozen))
            prefix_kwargs = dict(position_ids=pos, kv_cache=cache, kv_total_len=total)
        out2 = lvlm_forward(
            frozen, cfg, qb,
            image_feats=batch.get("query_feats"),
            shift=shift, adapters=lora, lora_scaling=lora_scaling,
            lora_dropout=lora_dropout, dropout_generator=dropout_generator,
            multi_head=mh, capture_attn=rec_attn, capture_ffn=rec_ffn,
            logz2=logz2, attn_impl=attn_impl, remat=shift_remat, **prefix_kwargs, **ring_kwargs,
            capture_gather_idx=batch.get("shift_q_idx") if layer_wise else None,
        )

        if Strategy.LM_LOSS in strategy:
            ce = lm_cross_entropy(out2.logits, batch["query_ids"], batch["query_mask"],
                                  group=data_group)
            metrics["ce_loss"] = ce
            w = 1.0 if strategy == Strategy.LM_LOSS else ce_loss_weight
            loss = loss + w * ce

        if layer_wise:
            mse = Strategy.LAYER_WISE_MSE in strategy
            loss_fn = layer_wise_mse if mse else layer_wise_cos
            suffix = "mse_loss" if mse else "cos_sim"
            align = torch.zeros_like(loss)
            for name, shift_cap, prefix_cap in (
                ("attn", out2.decoder.attn_capture, prefix_attn),
                ("ffn", out2.decoder.ffn_capture, prefix_ffn),
            ):
                if shift_cap is None or prefix_cap is None:
                    continue
                # the captures are already gathered at the query tokens
                M = shift_cap.shape[2]
                ident = torch.arange(M, device=shift_cap.device)[None].expand(shift_cap.shape[1], M)
                part = loss_fn(shift_cap, prefix_cap, ident, ident, batch["q_valid"],
                               group=data_group)
                metrics[f"{name}_{suffix}"] = part
                align = align + part
            loss = loss + align_loss_weight * align

        if Strategy.LOGITS_KL_DIV in strategy:
            kl = logits_kl(
                out2.logits, prefix_logits,
                batch["query_ans_idx"], batch["prefix_ans_idx"], batch["ans_valid"],
                group=data_group,
            )
            metrics["logits_kl_loss"] = kl
            loss = loss + align_loss_weight * kl

    metrics["loss"] = loss
    return loss, metrics


class TrainState(NamedTuple):
    trainable: Tree
    opt_state: Any
    step: int


def make_train_step(
    cfg: ModelConfig,
    encoder_cfg: EncoderConfig,
    optimizer: Optimizer,
    *,
    ce_loss_weight: float,
    align_loss_weight: float,
    lora_scaling: float = 1.0,
    lora_dropout: float = 0.0,
    logz2: str = "unmasked",
    attn_impl: str = "xla",
    seed: int = 0,
    shift_remat: bool = False,
    ring_mesh: Any = None,
    ring_axis: str = "sp",
    ring_batch_axis: Optional[str] = None,
    ring_min_len: int = 0,
):
    """Build the ``(state, frozen, batch) → (state, metrics)`` step.

    Gradient accumulation follows the optimizer (``build_optimizer``'s
    ``accumulate_steps``), as in the JAX package.  ``metrics["grad_norm"]``
    is the global norm of the raw gradients.  With ``lora_dropout`` > 0 each
    step draws its dropout masks from a generator seeded with
    (``seed``, ``state.step``): two runs give the same losses, consecutive
    steps different masks (JAX: ``fold_in(PRNGKey(seed), step)``).
    ``shift_remat`` recomputes each shift-pass layer in the backward pass.

    ``attn_impl="ring"`` + ``ring_mesh``: sequences of at least
    ``ring_min_len`` tokens run their attention as a ring over ``ring_axis``
    of the mesh (``ops/ring_attention.py``); shorter ones stay on one rank.
    At the default 0 both passes ride the ring and the shift pass's
    gradients run the ring's backward; every rank of ``ring_axis`` ends with
    the same full gradients, so they are summed over the data axis alone.
    ``ring_batch_axis``: the mesh's data axis, whose rows the batch holds.
    """
    ring_kwargs = {}
    if attn_impl == "ring":
        if ring_mesh is None:
            raise ValueError('attn_impl="ring" requires ring_mesh')
        ring_kwargs = dict(
            ring_mesh=ring_mesh, ring_axis=ring_axis,
            ring_batch_axis=ring_batch_axis, ring_min_len=ring_min_len,
        )
    loss_kwargs = dict(
        cfg=cfg,
        strategy=encoder_cfg.strategy(),
        rec_attn=needs_attn_capture(encoder_cfg),
        rec_ffn=needs_ffn_capture(encoder_cfg),
        mh=multi_head(encoder_cfg),
        ce_loss_weight=ce_loss_weight,
        align_loss_weight=align_loss_weight,
        logz2=logz2,
        attn_impl=attn_impl,
        lora_scaling=lora_scaling,
        lora_dropout=lora_dropout,
        shift_remat=shift_remat,
        ring_kwargs=ring_kwargs,
    )

    def data_group():
        """The data-parallel group of this call: the current mesh's data axis,
        else the ring mesh's batch axis; None for one rank.  On a ("data",
        "sp", "model") mesh the gradients are summed over ``data`` alone:
        every rank of the ring ends with the full gradients, and
        ``copy_to_region`` has already summed the trainables' over ``model``."""
        mesh = current_mesh()
        if mesh is not None:
            return axis_group(mesh, "data")
        return axis_group(ring_mesh, ring_batch_axis) if ring_batch_axis else None

    def step(state: TrainState, frozen: Tree, batch: Dict[str, Any]):
        live = {p: x.detach().requires_grad_(True) for p, x in flatten(state.trainable).items()}
        generator = None
        if lora_dropout > 0.0:
            generator = torch.Generator(device=batch["query_ids"].device)
            generator.manual_seed(int(np.random.SeedSequence([seed, state.step]).generate_state(1)[0]))
        group = data_group()
        with torch.enable_grad():
            loss, metrics = compute_loss(unflatten(live), frozen, batch,
                                         dropout_generator=generator, data_group=group,
                                         **loss_kwargs)
            with span("train.backward"):
                raw = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        flat = {p: torch.zeros_like(x) if g is None else g for (p, x), g in zip(live.items(), raw)}
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        if group is not None:
            # each rank holds its share of the global loss: sum the shares
            for t in (*flat.values(), *metrics.values()):
                dist.all_reduce(t, group=group)
        grads = unflatten(flat)
        with span("train.optimizer"):
            updates, opt_state = optimizer.update(grads, state.opt_state, state.trainable)
            trainable = apply_updates(state.trainable, updates)
            metrics["grad_norm"] = global_norm(grads)
        return TrainState(trainable, opt_state, state.step + 1), metrics

    def step_fn(state: TrainState, frozen: Tree, batch: Dict[str, Any]):
        with span("train.step"):
            return step(state, frozen, batch)

    return step_fn
