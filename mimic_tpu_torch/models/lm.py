"""Text language model = embedding + decoder stack + lm head
(counterpart of ``mimic_tpu/models/lm.py``)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..ops.quant import qdot
from ..shared import TextConfig
from .decoder import DecoderOutput, decoder_forward, dense_init, init_decoder_params

Params = Dict[str, Any]


class LMOutput(NamedTuple):
    logits: torch.Tensor
    decoder: DecoderOutput


def init_lm_params(
    cfg: TextConfig, generator: torch.Generator, device, dtype=torch.float32
) -> Params:
    params: Params = {
        "embed": dense_init(generator, (cfg.vocab_size, cfg.hidden_size), dtype, device),
        "decoder": init_decoder_params(cfg, generator, device, dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.hidden_size, cfg.vocab_size), dtype, device
        )
    return params


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids]


def lm_head(params: Params, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits.  A plain product runs in the parameter dtype and is upcast
    after (JAX accumulates into fp32 outputs directly; in fp32 the two agree);
    an int8 ``lm_head`` writes fp32 logits from its fp32 sums (``qdot``)."""
    if cfg.tie_word_embeddings:
        return (hidden @ params["embed"].t()).float()
    return qdot(hidden, params["lm_head"], preferred_element_type=torch.float32)


def lm_forward(
    params: Params,
    cfg: TextConfig,
    input_ids: Optional[torch.Tensor] = None,
    *,
    input_embeds: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    last_logit_only: bool = False,
    **decoder_kwargs,
) -> LMOutput:
    if input_embeds is None:
        input_embeds = embed_tokens(params, input_ids)
    B, T, _ = input_embeds.shape
    if position_ids is None:
        position_ids = torch.arange(T, device=input_embeds.device)[None].expand(B, T)
    out = decoder_forward(
        params["decoder"], cfg, input_embeds, attn_mask, position_ids, **decoder_kwargs
    )
    hidden = out.hidden
    if last_logit_only:
        # generation prefill reads only the final position's logits
        hidden = hidden[:, -1:]
    return LMOutput(logits=lm_head(params, cfg, hidden), decoder=out)
