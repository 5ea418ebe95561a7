"""Dataclass configuration system.

Replaces the reference's Hydra/OmegaConf tree (``src/config/*.yaml``) with plain
dataclasses + YAML loading and dotted-path CLI overrides.  No ``eval`` resolvers
(the reference registers one at ``src/utils.py:13``); derived values are computed
explicitly.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .flags import ShiftStrategy, Strategy, parse_shift_strategy, parse_strategy


@dataclass
class DataConfig:
    """Mirrors reference src/config/data.yaml."""

    name: str = "vqav2"
    seed: int = 3407
    num_query_samples: int = 500
    num_shot: int = 32
    num_workers: int = 0
    num_image_in_query: int = 1
    is_icl: bool = False  # set automatically in eval when no checkpoint is given
    # TPU-specific: sequence-length bucketing for static shapes
    max_query_len: int = 128
    max_full_len: int = 2048
    length_buckets: Tuple[int, ...] = ()


@dataclass
class EncoderConfig:
    """Mirrors reference src/config/encoder/*.yaml."""

    kind: str = "attn_approximator"  # "attn_approximator" (MimIC) | "attn_ffn_shift" (LIVE) | "none" (LoRA)
    model_strategy: str = "Strategy.LM_LOSS | Strategy.LAYER_WISE_MSE"
    attn_strategy: str = (
        "ShiftStrategy.VECTOR_SHIFT | ShiftStrategy.LEARNABLE_SHIFT_SCALE | ShiftStrategy.MULTI_HEAD"
    )
    ffn_strategy: str = "ShiftStrategy.RECORD_HIDDEN_STATES"
    shift_scale_init_value: Optional[float] = None

    def strategy(self) -> Strategy:
        return parse_strategy(self.model_strategy)

    def attn(self) -> ShiftStrategy:
        return parse_shift_strategy(self.attn_strategy)

    def ffn(self) -> ShiftStrategy:
        return parse_shift_strategy(self.ffn_strategy)


@dataclass
class LoraConfig:
    """Mirrors reference src/config/peft/lora.yaml per-model blocks."""

    r: int = 16
    alpha: Optional[int] = None  # defaults to 2*r (reference ${eval:'${..r} * 2'})
    dropout: float = 0.05
    target_modules: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")

    def scaling(self) -> float:
        alpha = self.alpha if self.alpha is not None else 2 * self.r
        return alpha / self.r


@dataclass
class PrefixConfig:
    """Prefix-tuning (HF peft ``PrefixTuningConfig`` analog).

    The reference peft factory accepts ``peft.name == "prefix-tuning"``
    (``src/utils.py:50-63``) but ships no config for it; these defaults follow
    HF peft's (``num_virtual_tokens`` has no HF default — 16 is ours,
    documented).  Virtual tokens are learned post-RoPE key/value slots
    prepended to every self-attention layer's cache; real-token positions
    shift by ``num_virtual_tokens`` (HF semantics: the prefix extends the
    attention mask, so cumsum positions count it)."""

    num_virtual_tokens: int = 16


@dataclass
class PeftConfig:
    """Mirrors reference src/config/peft/*.yaml."""

    name: str = "mimic"  # "mimic" | "licv" | "lora" | "prefix-tuning"
    ce_loss_weight: float = 0.5
    align_loss_weight: float = 1.0
    lr: float = 5e-3
    scale_lr: Optional[float] = None  # LIVE uses 1e-2 for scale/log_Z1 params
    lora: Optional[LoraConfig] = None
    prefix: Optional[PrefixConfig] = None


@dataclass
class GenerationConfig:
    """Mirrors reference src/config/eval.yaml generation_args."""

    num_beams: int = 3
    max_new_tokens: int = 10
    length_penalty: float = 0.0


@dataclass
class MeshConfig:
    """TPU device-mesh layout (no reference analog; replaces Lightning strategy strings)."""

    data_axis: int = -1  # -1 = all remaining devices
    model_axis: int = 1


@dataclass
class TrainConfig:
    """Mirrors reference src/config/train.yaml."""

    runname: str = "default"
    model_name: str = "idefics2-8b-base"
    resume: bool = True
    lr: float = 5e-3
    weight_decay: float = 1e-3
    warmup_step: float = 0.1  # float = fraction of total steps; int = absolute
    batch_size: int = 2
    epochs: Optional[int] = None
    ce_loss_weight: float = 0.5
    align_loss_weight: float = 1.0
    accumulate_grad_batches: int = 2
    grad_clip_val: float = 1.0
    dtype: str = "bfloat16"  # TPU-native (reference uses torch.float16)
    attn_impl: str = "auto"  # "auto" (flash on TPU) | "flash" | "xla"
    seed: int = 3407
    # training vision-feature cache (train/vision_cache.py): demo images
    # resample from a fixed train set and the tower is frozen, so record-pass
    # features are constants — cache them instead of re-encoding every step
    # (8B dual-pass step: 2181 → 481 ms once warm).  Inline-splice families
    # only; idefics1 falls back to the uncached path automatically.
    vision_cache: bool = True
    vision_cache_mb: int = 2048
    data: DataConfig = field(default_factory=DataConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    peft: PeftConfig = field(default_factory=PeftConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    wandb_project: Optional[str] = None


@dataclass
class EvalConfig:
    """Mirrors reference src/config/eval.yaml."""

    model_name: str = "idefics2-8b-base"
    resume: bool = True
    ckpt_path: Optional[str] = None
    batch_size: int = 16
    iterations: Optional[int] = None
    max_skip_oom: int = 0
    # fold LoRA adapters into the weights before eval (peft merge_and_unload)
    merge_lora: bool = True
    dtype: str = "bfloat16"
    # int8 serving mode (ops/quant.py): None (bit-parity default), "int8"
    # (dual-copy: bf16 prefill + weight-only int8 decode), "int8-memory"
    # (single weight-only copy), "int8-w8a8" (single copy + int8-MXU W8A8
    # text prefill — fastest, least bit-parity)
    quant: Optional[str] = None
    # vision-feature cache (models/feature_cache.py): the ICL protocol's
    # fixed support images encode once per eval instead of once per
    # occurrence (measured 13.7 → 18.9 q/s at the ICL shape).  Bit-exact —
    # cached and uncached evals produce identical records.  On by default for
    # inline-splice families; idefics1 (cross-attention) ignores it.
    vision_cache: bool = True
    vision_cache_mb: int = 512
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    data: DataConfig = field(default_factory=DataConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    peft: PeftConfig = field(default_factory=PeftConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @property
    def is_icl(self) -> bool:
        # reference src/eval.py:24
        return self.ckpt_path is None


@dataclass
class AnalyzeConfig:
    """Mirrors reference src/config/analyze.yaml."""

    runname: str = "default"
    model_name: str = ""
    verbose: bool = False
    metric_key: Optional[str] = None
    topk: int = 1
    record_dir: Optional[str] = None
    data: DataConfig = field(default_factory=DataConfig)


# ---------------------------------------------------------------------------
# generic dataclass <-> dict plumbing with dotted overrides
# ---------------------------------------------------------------------------


_NESTED_TYPES = {
    "data": DataConfig,
    "encoder": EncoderConfig,
    "peft": PeftConfig,
    "mesh": MeshConfig,
    "generation": GenerationConfig,
    "lora": LoraConfig,
    "prefix": PrefixConfig,
}


def config_from_dict(cls, data: Mapping[str, Any]):
    """Build a config dataclass from a (possibly nested) mapping."""

    def build(c, d):
        kwargs = {}
        for f in dataclasses.fields(c):
            if f.name not in d:
                continue
            val = d[f.name]
            nested = _NESTED_TYPES.get(f.name)
            if nested is not None and isinstance(val, Mapping):
                val = build(nested, val)
            elif isinstance(val, list):
                val = tuple(val)
            kwargs[f.name] = val
        return c(**kwargs)

    return build(cls, data)


def config_to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def apply_overrides(cfg, overrides: List[str]):
    """Apply ``a.b.c=value`` CLI overrides in place; values parsed as JSON when possible."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override {item!r} must look like key=value")
        key, _, raw = item.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = None if raw in ("null", "None") else raw
        obj = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            nxt = getattr(obj, part)
            if nxt is None and part in _NESTED_TYPES:
                nxt = _NESTED_TYPES[part]()
                setattr(obj, part, nxt)
            obj = nxt
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise AttributeError(f"Config has no field {key!r}")
        current = getattr(obj, leaf)
        if isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
        setattr(obj, leaf, value)
    return cfg


def load_yaml_config(cls, path: str):
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return config_from_dict(cls, data)
