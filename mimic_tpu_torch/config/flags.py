"""Strategy flags for shift encoders and training losses.

Mirrors the semantics of the reference's ``ShiftStrategy`` (``src/shift_encoder.py:15-19``)
and ``Strategy`` (``src/shift_model.py:21-51``) IntFlags, but replaces the reference's
``eval()`` of config strings (``src/shift_encoder.py:30-39``, ``src/train.py:121``) with
an explicit, safe parser.
"""

from __future__ import annotations

import enum
import re
from typing import Type, TypeVar, Union


class ShiftStrategy(enum.IntFlag):
    """What a shift encoder does at each decoder layer (reference src/shift_encoder.py:15)."""

    NONE = 0
    VECTOR_SHIFT = 1
    RECORD_HIDDEN_STATES = 4
    LEARNABLE_SHIFT_SCALE = 8
    MULTI_HEAD = 16

    def validate(self) -> "ShiftStrategy":
        # reference src/shift_encoder.py:73-78
        if ShiftStrategy.LEARNABLE_SHIFT_SCALE in self and ShiftStrategy.VECTOR_SHIFT not in self:
            raise ValueError(
                "ShiftStrategy.LEARNABLE_SHIFT_SCALE must be combined with "
                "ShiftStrategy.VECTOR_SHIFT"
            )
        return self


class Strategy(enum.IntFlag):
    """Which training losses are active (reference src/shift_model.py:21-26)."""

    NONE = 0
    LAYER_WISE_MSE = 2
    LOGITS_KL_DIV = 4
    LM_LOSS = 8
    LAYER_WISE_COS_SIM = 64

    def validate(self) -> "Strategy":
        # layer-wise losses are mutually exclusive (reference src/shift_model.py:34-43)
        layer_wise = Strategy.LAYER_WISE_MSE | Strategy.LAYER_WISE_COS_SIM
        if bin(int(self & layer_wise)).count("1") > 1:
            raise ValueError("LAYER_WISE_MSE and LAYER_WISE_COS_SIM are mutually exclusive.")
        return self

    def has_layer_wise(self) -> bool:
        return bool(self & (Strategy.LAYER_WISE_MSE | Strategy.LAYER_WISE_COS_SIM))

    def layer_wise_name(self) -> str:
        # reference src/shift_model.py:45-51
        if Strategy.LAYER_WISE_MSE in self:
            return "mse_loss"
        if Strategy.LAYER_WISE_COS_SIM in self:
            return "cos_sim"
        raise ValueError("No layer-wise loss strategy is enabled")


_F = TypeVar("_F", bound=enum.IntFlag)

_FLAG_EXPR = re.compile(r"^[\w.\s|]+$")


def parse_flags(cls: Type[_F], spec: Union[_F, str, int, None]) -> _F:
    """Parse ``"Strategy.LM_LOSS | Strategy.LAYER_WISE_MSE"``-style strings safely.

    Accepts an existing flag instance, an int, ``None``/empty string (→ zero flag), or a
    ``|``-joined string of member names, each optionally prefixed with the class name.
    Unknown member names raise ``ValueError`` (the reference's ``eval()`` would raise
    ``AttributeError`` at best and execute arbitrary code at worst — e.g. its own
    ``attn_shift_ffn_mse.yaml:5`` names a nonexistent ``LEARNABLE_SCALE`` flag).
    """
    if spec is None:
        return cls(0)
    if isinstance(spec, cls):
        return spec
    if isinstance(spec, int):
        return cls(spec)
    if not isinstance(spec, str):
        raise TypeError(f"Cannot parse {cls.__name__} from {type(spec).__name__}")
    text = spec.strip()
    if not text or text.lower() in ("none", "null", "0"):
        return cls(0)
    if not _FLAG_EXPR.match(text):
        raise ValueError(f"Invalid {cls.__name__} expression: {spec!r}")
    result = cls(0)
    for part in text.split("|"):
        name = part.strip()
        if "." in name:
            prefix, _, name = name.rpartition(".")
            if prefix != cls.__name__:
                raise ValueError(
                    f"Flag {part.strip()!r} does not belong to {cls.__name__}"
                )
        try:
            result |= cls[name]
        except KeyError:
            raise ValueError(
                f"Unknown {cls.__name__} member {name!r} "
                f"(valid: {', '.join(m.name for m in cls)})"
            ) from None
    return result


def parse_shift_strategy(spec: Union[ShiftStrategy, str, int, None]) -> ShiftStrategy:
    return parse_flags(ShiftStrategy, spec).validate()


def parse_strategy(spec: Union[Strategy, str, int, None]) -> Strategy:
    return parse_flags(Strategy, spec).validate()
