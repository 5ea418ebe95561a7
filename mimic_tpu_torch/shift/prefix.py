"""Prefix-tuning adapter (counterpart of ``mimic_tpu/shift/prefix.py``; HF
peft ``PrefixTuningConfig`` semantics).

- ``num_virtual_tokens`` learned key/value slots per decoder self-attention
  layer, injected as ``past_key_values``: post-RoPE raw KV entries that every
  real query attends to.
- The attention mask is extended by P leading ones, so real-token positions
  shift by P (``cumsum(attention_mask) - 1`` with the prefix mask prepended).
- Initialization: standard normal (torch ``nn.Embedding``'s default), trained
  in fp32 over the frozen tower.

The prefix is a pre-written KV cache region: training runs the query forward
with a cache of length P through the decoder's cached two-part attention, and
generation prefills into a cache whose first P slots hold the prefix (the
decoder's prefix-merge path, ``prefix_flash_len``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import PrefixConfig
from ..models.config import TextConfig
from ..models.decoder import positions_from_mask

PrefixParams = Dict[str, torch.Tensor]


def init_prefix_params(
    prefix_cfg: PrefixConfig,
    text_cfg: TextConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype=torch.float32,
) -> PrefixParams:
    """{"k": [L, P, Hkv, Dh], "v": [L, P, Hkv, Dh]} ~ N(0, 1)."""
    shape = (text_cfg.num_layers, prefix_cfg.num_virtual_tokens, text_cfg.num_kv_heads,
             text_cfg.head_size)

    def normal():
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return x.to(dtype)

    return {"k": normal(), "v": normal()}


def prefix_len(prefix: Optional[PrefixParams]) -> int:
    return 0 if prefix is None else prefix["k"].shape[1]


def prefix_forward_args(
    prefix: PrefixParams, batch, dtype, extra_len: int = 0,
) -> Tuple[object, torch.Tensor, Dict[str, object], int]:
    """Thread a learned prefix into a forward as pre-written cache slots.

    Returns ``(batch', position_ids, kv_cache, total_len)``:

    - ``batch'`` carries the timeline mask ``[ones(P) | mask | zeros(extra_len)]``
      (``extra_len`` reserves decode slots for generation);
    - ``position_ids`` are the real tokens' positions shifted by P;
    - ``kv_cache`` holds the prefix in slots ``[0, P)`` (length P) with room
      for the T current and ``extra_len`` future tokens.

    Differentiable with respect to the prefix leaves (expand + concat), so the
    same helper serves the train step and the generation prefill.
    """
    k, v = prefix["k"], prefix["v"]
    L, P, Hkv, Dh = k.shape
    am = batch.attention_mask
    B, T = batch.input_ids.shape
    dev = am.device

    def expand(x):
        xb = x.to(dev)[:, None].expand(L, B, P, Hkv, Dh).to(dtype)
        tail = torch.zeros((L, B, T + extra_len, Hkv, Dh), dtype=dtype, device=dev)
        return torch.cat([xb, tail], dim=2)

    cache = {"k": expand(k), "v": expand(v), "length": P}
    mask = torch.cat([am.new_ones(B, P), am, am.new_zeros(B, extra_len)], dim=-1)
    pos = positions_from_mask(am) + P
    return batch._replace(attention_mask=mask), pos, cache, P + T + extra_len
