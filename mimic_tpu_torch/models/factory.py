"""Model factory — ``build_model`` (counterpart of ``mimic_tpu/models/factory.py``).

Builds an ``LVLMRunner`` for a named model: the architecture config, random
parameters at the config's shapes made on the device from a seeded
``torch.Generator``, and the self-contained byte tokenizer.  Loading converted
checkpoints waits until weights are in the repository.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from .config import get_model_config
from .lvlm import init_lvlm_params
from .runner import LVLMRunner
from .tokenizer import SimpleTokenizer


def build_model(
    model_name: str,
    device: Optional[DeviceLike] = None,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    **runner_kwargs,
) -> LVLMRunner:
    """``device=None`` is the card (``resolve_device``); ``runner_kwargs`` go
    to ``LVLMRunner`` (``quant=``, ``pad_multiple=``, ...)."""
    dev = resolve_device(device)
    cfg = get_model_config(model_name)
    tokenizer = SimpleTokenizer()
    cfg = cfg.replace(
        image_token_id=tokenizer.image_token_id,
        pad_token_id=tokenizer.pad_token_id,
        bos_token_id=tokenizer.bos_token_id,
        eos_token_id=tokenizer.eos_token_id,
    )
    if model_name.startswith("tiny-") and tokenizer.vocab_size != cfg.text.vocab_size:
        cfg = cfg.replace(
            text=cfg.text.__class__(**{**cfg.text.__dict__, "vocab_size": tokenizer.vocab_size})
        )
    generator = torch.Generator(device=dev).manual_seed(seed)
    params = init_lvlm_params(cfg, generator, dev, dtype)
    return LVLMRunner(cfg, params, tokenizer, device=dev, **runner_kwargs)
