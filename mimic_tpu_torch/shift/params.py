"""Shift-parameter trees (counterpart of ``mimic_tpu/shift/params.py``).

Same keys, shapes and init distributions as the JAX package, drawn from an
explicit ``torch.Generator`` (the numbers differ from ``jax.random``'s; tests
carry the JAX tree across with ``bridge.to_torch`` instead).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import EncoderConfig, ShiftStrategy
from ..models.config import TextConfig

ShiftParams = Dict[str, torch.Tensor]


def init_shift_params(
    encoder_cfg: EncoderConfig,
    text_cfg: TextConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype=torch.float32,
) -> ShiftParams:
    """MimIC shift v ~ N(0,1)·0.001; log Z₁ weight ~ N(0,1)·0.02, bias 0;
    LIVE shift ~ N(0,1)·0.01 with scale ``shift_scale_init_value``."""
    attn = encoder_cfg.attn()
    ffn = encoder_cfg.ffn()
    L = text_cfg.num_layers
    D = text_cfg.hidden_size
    H = text_cfg.num_heads
    Dh = text_cfg.head_size

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * std).to(dtype)

    params: ShiftParams = {}
    if encoder_cfg.kind == "attn_approximator":
        multi = ShiftStrategy.MULTI_HEAD in attn
        if ShiftStrategy.VECTOR_SHIFT in attn:
            params["attn_v"] = normal((L, H, Dh) if multi else (L, D), 0.001)
        if ShiftStrategy.LEARNABLE_SHIFT_SCALE in attn:
            params["attn_logz1_w"] = normal((L, H, Dh) if multi else (L, D), 0.02)
            params["attn_logz1_b"] = torch.zeros(
                (L, H) if multi else (L, 1), dtype=dtype, device=device
            )
        if ShiftStrategy.VECTOR_SHIFT in ffn:
            params["ffn_shift"] = normal((L, D), 0.001)
    elif encoder_cfg.kind == "attn_ffn_shift":
        init_scale = (
            encoder_cfg.shift_scale_init_value
            if encoder_cfg.shift_scale_init_value is not None
            else 1.0
        )
        if ShiftStrategy.MULTI_HEAD in attn or ShiftStrategy.MULTI_HEAD in ffn:
            raise ValueError("MULTI_HEAD is not supported for output shifts")
        if ShiftStrategy.VECTOR_SHIFT in attn:
            params["attn_out_shift"] = normal((L, D), 0.01)
            params["attn_out_scale"] = torch.full((L,), init_scale, dtype=dtype, device=device)
        if ShiftStrategy.VECTOR_SHIFT in ffn:
            params["ffn_shift"] = normal((L, D), 0.01)
            params["ffn_scale"] = torch.full((L,), init_scale, dtype=dtype, device=device)
    elif encoder_cfg.kind != "none":
        raise ValueError(f"Unknown encoder kind {encoder_cfg.kind!r}")
    return params


def needs_attn_capture(encoder_cfg: EncoderConfig) -> bool:
    return ShiftStrategy.RECORD_HIDDEN_STATES in encoder_cfg.attn()


def needs_ffn_capture(encoder_cfg: EncoderConfig) -> bool:
    return ShiftStrategy.RECORD_HIDDEN_STATES in encoder_cfg.ffn()


def multi_head(encoder_cfg: EncoderConfig) -> bool:
    return ShiftStrategy.MULTI_HEAD in encoder_cfg.attn()
