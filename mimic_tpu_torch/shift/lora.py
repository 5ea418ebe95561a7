"""LoRA adapter parameters (counterpart of ``mimic_tpu/shift/lora.py``; the
baseline's reference uses HF peft, ``src/utils.py:50-63`` +
``src/config/peft/lora.yaml``).

Adapters are stacked per-layer ``[L, ...]`` trees read by the decoder's layer
loop: ``W x + (α/r) · B(A x)`` on the configured attention projections.  A is
kaiming-uniform, B zeros (the delta starts at 0, peft's convention).  The
draws come from an explicit ``torch.Generator`` and differ from
``jax.random``'s; tests carry the JAX tree across with ``bridge.to_torch``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..config import LoraConfig
from ..models.config import TextConfig

LoraParams = Dict[str, torch.Tensor]

_PROJ_DIMS = {
    "q_proj": lambda c: c.num_heads * c.head_size,
    "k_proj": lambda c: c.num_kv_heads * c.head_size,
    "v_proj": lambda c: c.num_kv_heads * c.head_size,
    "o_proj": lambda c: c.hidden_size,
}
_PROJ_IN = {
    "q_proj": lambda c: c.hidden_size,
    "k_proj": lambda c: c.hidden_size,
    "v_proj": lambda c: c.hidden_size,
    "o_proj": lambda c: c.num_heads * c.head_size,
}


def init_lora_params(
    lora_cfg: LoraConfig,
    text_cfg: TextConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype=torch.float32,
) -> LoraParams:
    """``{short}_a`` [L, d_in, r] ~ U(±√(6/d_in)) and ``{short}_b`` [L, r, d_out]
    zeros for each target (``short`` is q / k / v / o)."""
    params: LoraParams = {}
    L, r = text_cfg.num_layers, lora_cfg.r
    for target in lora_cfg.target_modules:
        name = target if target.endswith("_proj") else f"{target}_proj"
        if name not in _PROJ_DIMS:
            raise ValueError(f"Unsupported LoRA target {target!r}")
        short = name[0]
        d_in, d_out = _PROJ_IN[name](text_cfg), _PROJ_DIMS[name](text_cfg)
        bound = math.sqrt(6.0 / d_in)
        u = torch.rand((L, d_in, r), generator=generator, device=device, dtype=torch.float32)
        params[f"{short}_a"] = ((u * 2.0 - 1.0) * bound).to(dtype)
        params[f"{short}_b"] = torch.zeros((L, r, d_out), dtype=dtype, device=device)
    return params


def lora_scaling(lora_cfg: LoraConfig) -> float:
    return lora_cfg.scaling()


def merge_lora(params, adapters: LoraParams, scaling: float):
    """Fold trained adapters into the frozen decoder weights for serving:
    W' = W + scaling · A@B per layer and target projection (peft's
    ``merge_and_unload``), summed in fp32 and cast back to W's dtype; the
    adapters lie on the weights' device.

    Out of place: returns a new tree that shares every untouched leaf; the
    input tree is not modified (the eval keeps the pristine base and merges
    each epoch's adapters onto it).
    """
    layers = dict(params["lm"]["decoder"]["layers"])
    for short in ("q", "k", "v", "o"):
        a, b = adapters.get(f"{short}_a"), adapters.get(f"{short}_b")
        if a is None:
            continue
        w = layers[f"{short}_proj"]
        delta = scaling * torch.einsum("lir,lro->lio", a.float(), b.float())
        layers[f"{short}_proj"] = (w.float() + delta).to(w.dtype)
    out = dict(params)
    out["lm"] = dict(params["lm"])
    out["lm"]["decoder"] = dict(params["lm"]["decoder"])
    out["lm"]["decoder"]["layers"] = layers
    return out
