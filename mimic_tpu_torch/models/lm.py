"""Text language model = embedding + decoder stack + lm head
(counterpart of ``mimic_tpu/models/lm.py``).

Under a model axis whose size divides the vocab (``parallel.shard_params``'
tree) the embedding holds this rank's vocab rows: the lookup is masked to
them and summed over ``model``; the lm head (or the tied embedding) gives
this rank's vocab columns, gathered over ``model`` into the full logits; an
int8 lm head is whole on every rank and gives them whole."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..ops.quant import qdot
from ..parallel import tp
from .config import TextConfig
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


def embed_tokens(params: Params, cfg: TextConfig, input_ids: torch.Tensor) -> torch.Tensor:
    embed = params["embed"]
    width = tp.split_width(cfg.vocab_size)
    if width == cfg.vocab_size:
        return embed[input_ids]
    tp.check_width(embed, 0, width, "embed")
    local = input_ids - tp.model_rank() * width
    mine = (local >= 0) & (local < width)
    rows = embed[local.clamp(0, width - 1)]
    return tp.reduce_from_region(torch.where(mine[..., None], rows, torch.zeros_like(rows)))


def lm_head(params: Params, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits.  A plain product runs in the parameter dtype and is upcast
    after (JAX accumulates into fp32 outputs directly; in fp32 the two agree);
    an int8 ``lm_head`` writes fp32 logits from its fp32 sums (``qdot``)."""
    w = params["embed"].t() if cfg.tie_word_embeddings else params["lm_head"]
    # an int8 handle is whole on every rank (JAX's rules never split it): whole logits
    split = not isinstance(w, dict) and tp.is_split(w, -1, cfg.vocab_size, "lm_head")
    hidden = tp.copy_to_region(hidden, split)
    if cfg.tie_word_embeddings:
        logits = (hidden @ w).float()
    else:
        logits = qdot(hidden, w, preferred_element_type=torch.float32)
    return tp.gather_from_region(logits) if split else logits


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
        input_embeds = embed_tokens(params, cfg, input_ids)
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
