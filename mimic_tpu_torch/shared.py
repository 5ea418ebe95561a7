"""The pieces of ``mimic_tpu`` that both packages use unchanged.

They import no JAX (``tests/test_torch_generate.py`` and
``tests/test_torch_train_entry.py`` run the port with ``jax`` unavailable):
the model, shift-encoder and training configs, the processor, the byte
tokenizer, the prompt templates, the dataset adapters, the training-batch
collator and its masking, and the run-name helper (the training pieces load
on first use).  Every import of ``mimic_tpu`` in the port goes through this
module, so it is the one place that names what the port shares with the JAX
package.

``mimic_tpu/train/collate.py`` and ``masking.py`` import only numpy and
JAX-free modules, but ``mimic_tpu/train/__init__.py`` imports the JAX train
step.  ``_train_module`` therefore loads them under their own names beside a
bare package module that lives only while they load: the package itself is
never half-registered, so a later ``import mimic_tpu.train`` (a JAX test in
the same process) runs its ``__init__`` as usual and reuses these modules.
"""

import importlib
import sys
import types
from pathlib import Path

import mimic_tpu
from mimic_tpu.config import (
    DataConfig,
    EncoderConfig,
    ShiftStrategy,
    Strategy,
    TrainConfig,
    config_to_dict,
    get_preset,
)
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


def _train_module(name: str) -> types.ModuleType:
    """``mimic_tpu.train.<name>`` without running ``mimic_tpu/train/__init__.py``."""
    full, pkg_name = f"mimic_tpu.train.{name}", "mimic_tpu.train"
    if full in sys.modules:
        return sys.modules[full]
    if pkg_name in sys.modules:
        return importlib.import_module(full)
    pkg = types.ModuleType(pkg_name)
    pkg.__path__ = [str(Path(mimic_tpu.__file__).parent / "train")]
    pkg.__package__ = pkg_name
    sys.modules[pkg_name] = pkg
    try:
        return importlib.import_module(full)
    finally:
        del sys.modules[pkg_name]


# the training pieces load on first use, so the serving path imports none of them
_LAZY = {
    "TrainBatch": lambda: _train_module("collate").TrainBatch,
    "TrainCollator": lambda: _train_module("collate").TrainCollator,
    "build_adapter": lambda: importlib.import_module("mimic_tpu.data.adapters").build_adapter,
    "prefetch": lambda: importlib.import_module("mimic_tpu.data.prefetch").prefetch,
    "get_expand_runname": lambda: importlib.import_module(
        "mimic_tpu.utils.naming").get_expand_runname,
}


def __getattr__(name: str):
    if name in _LAZY:
        value = _LAZY[name]()
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DataConfig",
    "EncoderConfig",
    "LVLMProcessor",
    "ModelConfig",
    "PerceiverConfig",
    "ShiftStrategy",
    "SimpleTokenizer",
    "Strategy",
    "TextConfig",
    "TrainBatch",
    "TrainCollator",
    "TrainConfig",
    "VisionConfig",
    "apply_prompt_template",
    "build_adapter",
    "config_to_dict",
    "get_expand_runname",
    "get_model_config",
    "get_preset",
    "prefetch",
    "tiny_text",
]
