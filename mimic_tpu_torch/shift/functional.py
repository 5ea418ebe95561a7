"""Shift application math (pure functions, one decoder layer at a time).

Counterpart of ``mimic_tpu/shift/functional.py``: the MimIC μ-gate
μ = sigmoid(log Z₁ − log Z₂) times the shift vector v, added after attention,
and the LIVE norm-preserving output shift.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..parallel import tp

LayerShift = Dict[str, torch.Tensor]  # per-layer slices (leading L axis removed)


def attn_shift_delta(
    layer_shift: LayerShift,
    q: torch.Tensor,
    log_z2: torch.Tensor,
    multi_head: bool,
    model_split: bool = False,
) -> Optional[torch.Tensor]:
    """The additive MimIC term μ·v for one layer; None when not configured.

    q: [B,T,H,Dqk] post-RoPE queries; log_z2: [B,T,H].  Returns the
    attention output's shape, [B,T,H,Dv] (multi-head) or [B,T,H*Dv] (single
    head), fp32: v's width, which is q's but for latent attention.

    ``model_split``: q, log_z2 and the leaves hold this rank's heads of a
    model axis (the flat form: its columns of ``attn_v`` / ``attn_logz1_w``).
    The single-head μ sums over every head, so its two head sums are summed
    over ``model`` and μ, used on this rank's columns only, enters the region
    through ``copy_to_region``.
    """
    if "attn_v" not in layer_shift:
        return None
    v = layer_shift["attn_v"].float()
    if "attn_logz1_w" not in layer_shift:
        return v[None, None].expand(*q.shape[:2], *v.shape)
    w = layer_shift["attn_logz1_w"].float()
    bias = layer_shift["attn_logz1_b"].float()
    qf = q.float()
    if multi_head:
        log_z1 = torch.einsum("bthd,hd->bth", qf, w) + bias
        mu = torch.sigmoid(log_z1 - log_z2)  # [B,T,H]
        return mu[..., None] * v[None, None]
    b, t, h, d = q.shape
    q_flat = qf.reshape(b, t, h * d)
    log_z1 = torch.einsum("btd,d->bt", q_flat, w.reshape(-1))[..., None]
    if not model_split:
        mu = torch.sigmoid(log_z1 + bias - log_z2.mean(-1, keepdim=True))
        return mu * v[None, None]
    z2_sum = tp.reduce_from_region(log_z2.sum(-1, keepdim=True))
    mu = torch.sigmoid(tp.reduce_from_region(log_z1) + bias - z2_sum / (h * tp.model_size()))
    return tp.copy_to_region(mu) * v[None, None]


def apply_attn_shift(
    layer_shift: LayerShift,
    q: torch.Tensor,
    log_z2: torch.Tensor,
    attn_out: torch.Tensor,
    multi_head: bool,
    model_split: bool = False,
) -> torch.Tensor:
    """attn_out [B,T,H,Dh] → shifted output, same shape/dtype."""
    delta = attn_shift_delta(layer_shift, q, log_z2, multi_head, model_split)
    if delta is None:
        return attn_out
    b, t, h, d = attn_out.shape
    if multi_head:
        return (attn_out.float() + delta).to(attn_out.dtype)
    flat = attn_out.reshape(b, t, h * d).float() + delta
    return flat.reshape(b, t, h, d).to(attn_out.dtype)


def norm_preserving_shift(
    hidden: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """LIVE-style output shift: h' = (h + s·v) / ‖h + s·v‖ · ‖h‖."""
    hf = hidden.float()
    shifted = hf + scale.float() * shift.float()[None, None, :]
    old_norm = torch.linalg.vector_norm(hf, dim=-1, keepdim=True)
    new_norm = torch.linalg.vector_norm(shifted, dim=-1, keepdim=True)
    return (shifted / new_norm * old_norm).to(hidden.dtype)


def apply_output_shift(
    hidden: torch.Tensor,
    shift: Optional[torch.Tensor],
    scale: Optional[torch.Tensor],
) -> torch.Tensor:
    """Apply a norm-preserving output shift when configured; identity otherwise."""
    if shift is None:
        return hidden
    if scale is None:
        scale = torch.ones((), dtype=torch.float32, device=hidden.device)
    return norm_preserving_shift(hidden, shift, scale)
