"""Named encoder/peft presets matching the reference config groups.

Each preset mirrors one ``src/config/encoder/*.yaml`` + ``src/config/peft/*.yaml`` pair.
The reference's ``attn_shift_ffn_mse`` preset is fixed here: its YAML names a
nonexistent ``ShiftStrategy.LEARNABLE_SCALE`` (``src/config/encoder/attn_shift_ffn_mse.yaml:5``)
which we interpret as ``LEARNABLE_SHIFT_SCALE`` (documented deviation).
"""

from __future__ import annotations

from typing import Tuple

from .core import EncoderConfig, LoraConfig, PeftConfig, PrefixConfig


def _mimic() -> Tuple[EncoderConfig, PeftConfig]:
    return (
        EncoderConfig(
            kind="attn_approximator",
            model_strategy="Strategy.LM_LOSS | Strategy.LAYER_WISE_MSE",
            attn_strategy=(
                "ShiftStrategy.VECTOR_SHIFT | ShiftStrategy.LEARNABLE_SHIFT_SCALE"
                " | ShiftStrategy.MULTI_HEAD"
            ),
            ffn_strategy="ShiftStrategy.RECORD_HIDDEN_STATES",
        ),
        PeftConfig(name="mimic", ce_loss_weight=0.5, align_loss_weight=1.0, lr=5e-3),
    )


def _mimic_attn_mse() -> Tuple[EncoderConfig, PeftConfig]:
    return (
        EncoderConfig(
            kind="attn_approximator",
            model_strategy="Strategy.LM_LOSS | Strategy.LAYER_WISE_MSE",
            attn_strategy=(
                "ShiftStrategy.VECTOR_SHIFT | ShiftStrategy.LEARNABLE_SHIFT_SCALE"
                " | ShiftStrategy.MULTI_HEAD | ShiftStrategy.RECORD_HIDDEN_STATES"
            ),
            ffn_strategy="",
        ),
        PeftConfig(name="mimic", ce_loss_weight=0.5, align_loss_weight=1.0, lr=5e-3),
    )


def _licv() -> Tuple[EncoderConfig, PeftConfig]:
    return (
        EncoderConfig(
            kind="attn_ffn_shift",
            model_strategy="Strategy.LM_LOSS | Strategy.LOGITS_KL_DIV",
            attn_strategy="",
            ffn_strategy="ShiftStrategy.VECTOR_SHIFT | ShiftStrategy.LEARNABLE_SHIFT_SCALE",
            shift_scale_init_value=0.1,
        ),
        PeftConfig(
            name="licv", ce_loss_weight=0.5, align_loss_weight=1.0, lr=5e-3, scale_lr=1e-2
        ),
    )


def _lora() -> Tuple[EncoderConfig, PeftConfig]:
    return (
        EncoderConfig(kind="none", model_strategy="Strategy.LM_LOSS", attn_strategy="", ffn_strategy=""),
        PeftConfig(
            name="lora",
            ce_loss_weight=1.0,
            align_loss_weight=0.0,
            lr=5e-4,
            lora=LoraConfig(r=16, alpha=32, dropout=0.05),
        ),
    )


def _mini_lora() -> Tuple[EncoderConfig, PeftConfig]:
    enc, peft = _lora()
    peft.lora = LoraConfig(r=16, alpha=32, dropout=0.05, target_modules=("o_proj",))
    return enc, peft


def _prefix_tuning() -> Tuple[EncoderConfig, PeftConfig]:
    # the reference peft factory accepts "prefix-tuning" (src/utils.py:56-57)
    # but ships no yaml for it — num_virtual_tokens/lr here are our documented
    # choices (HF peft has no num_virtual_tokens default; prefix-tuning papers
    # use 10-30 virtual tokens and lr in the 1e-3..1e-2 range)
    return (
        EncoderConfig(kind="none", model_strategy="Strategy.LM_LOSS", attn_strategy="", ffn_strategy=""),
        PeftConfig(
            name="prefix-tuning",
            ce_loss_weight=1.0,
            align_loss_weight=0.0,
            lr=5e-3,
            prefix=PrefixConfig(num_virtual_tokens=16),
        ),
    )


def _attn_shift_ffn_mse() -> Tuple[EncoderConfig, PeftConfig]:
    return (
        EncoderConfig(
            kind="attn_ffn_shift",
            model_strategy="Strategy.LM_LOSS | Strategy.LAYER_WISE_MSE",
            attn_strategy="ShiftStrategy.VECTOR_SHIFT | ShiftStrategy.LEARNABLE_SHIFT_SCALE",
            ffn_strategy="ShiftStrategy.RECORD_HIDDEN_STATES",
        ),
        PeftConfig(name="mimic", ce_loss_weight=0.5, align_loss_weight=1.0, lr=5e-3),
    )


_PRESETS = {
    "mimic": _mimic,
    "mimic_attn_mse": _mimic_attn_mse,
    "licv": _licv,
    "lora": _lora,
    "mini_lora": _mini_lora,
    "prefix-tuning": _prefix_tuning,
    "attn_shift_ffn_mse": _attn_shift_ffn_mse,
}


def preset_names() -> Tuple[str, ...]:
    return tuple(_PRESETS)


def get_preset(name: str) -> Tuple[EncoderConfig, PeftConfig]:
    """Return fresh (EncoderConfig, PeftConfig) for a named method preset."""
    try:
        return _PRESETS[name]()
    except KeyError:
        raise ValueError(f"Unknown preset {name!r}; valid: {', '.join(_PRESETS)}") from None
