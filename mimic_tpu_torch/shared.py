"""The pieces of ``mimic_tpu`` that both packages use unchanged.

They import no JAX (``tests/test_torch_generate.py`` runs the port with
``jax`` unavailable): the model and shift-encoder configs, the processor, the
byte tokenizer and the prompt templates.  Every import of ``mimic_tpu`` in the
port goes through this module, so it is the one place that names what the
port shares with the JAX package.
"""

from mimic_tpu.config import EncoderConfig, ShiftStrategy, get_preset
from mimic_tpu.data.templates import apply_prompt_template
from mimic_tpu.models.config import (
    ModelConfig,
    PerceiverConfig,
    TextConfig,
    VisionConfig,
    get_model_config,
    tiny_text,
)
from mimic_tpu.models.processor import LVLMProcessor
from mimic_tpu.models.tokenizer import SimpleTokenizer

__all__ = [
    "EncoderConfig",
    "LVLMProcessor",
    "ModelConfig",
    "PerceiverConfig",
    "ShiftStrategy",
    "SimpleTokenizer",
    "TextConfig",
    "VisionConfig",
    "apply_prompt_template",
    "get_model_config",
    "get_preset",
    "tiny_text",
]
