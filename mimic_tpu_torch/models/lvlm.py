"""LVLM assembly: vision tower + connector + text decoder as one function.

Counterpart of ``mimic_tpu/models/lvlm.py``:

- **idefics2**: SigLIP features → perceiver connector → 64 tokens per image
  spliced into the ``<image>`` positions of the text embedding sequence;
- **llava-interleave** (llava-interleave-7b and llava-1.5-7b): the tower's
  features (SigLIP; or CLIP with its class token dropped, llava-1.5) → the
  MLP projector → one token per patch, spliced likewise;
- **idefics1**: CLIP features → perceiver resampler → 64 latents per image,
  read by the decoder's gated cross-attention (no inline tokens); each text
  row attends the images its ``image_attention_mask`` row names;
- **text** (mistral-7b, qwen2-7b): the text tower alone (``cfg.vision`` is None).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.decode_attention import prompt_kv_len
from .config import ModelConfig
from .decoder import make_causal_mask, positions_from_mask
from .lm import LMOutput, embed_tokens, init_lm_params, lm_forward
from .vision import (
    init_llava_projector,
    init_perceiver_params,
    init_vit_params,
    llava_project,
    perceiver_forward,
    vit_forward,
)

Params = Dict[str, Any]


PORTED_FAMILIES = ("idefics2", "idefics1", "llava-interleave", "text")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not ported yet")


def init_lvlm_params(
    cfg: ModelConfig, generator: torch.Generator, device, dtype=torch.float32
) -> Params:
    """Random parameters at the config's shapes, made on ``device``."""
    _check_family(cfg)
    params: Params = {"lm": init_lm_params(cfg.text, generator, device, dtype)}
    if cfg.vision is not None:
        params["vision"] = init_vit_params(cfg.vision, generator, device, dtype)
        if cfg.family == "idefics2":
            params["connector"] = init_perceiver_params(
                cfg.perceiver, cfg.vision.hidden_size, cfg.text.hidden_size, generator,
                device, dtype, project_first=True,
            )
        elif cfg.family == "idefics1":
            params["perceiver"] = init_perceiver_params(
                cfg.perceiver, cfg.vision.hidden_size, cfg.vision.hidden_size, generator,
                device, dtype, project_first=False,
            )
        elif cfg.family == "llava-interleave":
            params["projector"] = init_llava_projector(
                cfg.vision.hidden_size, cfg.text.hidden_size, generator, device, dtype
            )
    return params


def encode_images(
    params: Params,
    cfg: ModelConfig,
    pixel_values: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
) -> torch.Tensor:
    """pixel_values [B,N,H,W,C] → image tokens [B, N*S, D_text] (idefics2:
    S latents; llava: S patches), or cross-attention states [B, N*latents,
    D_vision] (idefics1)."""
    _check_family(cfg)
    B, N = pixel_values.shape[:2]
    flat = pixel_values.reshape((B * N,) + tuple(pixel_values.shape[2:]))
    flat_patch = (
        patch_mask.reshape((B * N,) + tuple(patch_mask.shape[2:]))
        if patch_mask is not None
        else None
    )
    feats = vit_forward(
        params["vision"], cfg.vision, flat, patch_mask=flat_patch, attn_impl=attn_impl
    )
    ctx_mask = flat_patch.reshape(B * N, -1) if flat_patch is not None else None
    if cfg.family == "idefics2":
        feats = perceiver_forward(
            params["connector"], cfg.perceiver, feats,
            norm_eps=cfg.text.norm_eps, context_mask=ctx_mask,
        )
    elif cfg.family == "idefics1":
        # HF IdeficsPerceiverResampler uses torch's LayerNorm default eps 1e-5
        feats = perceiver_forward(
            params["perceiver"], cfg.perceiver, feats, norm_eps=1e-5, context_mask=ctx_mask,
        )
    else:
        if cfg.vision.use_class_token:
            # llava-1.5: vision_feature_select_strategy="default" drops the class token
            feats = feats[:, 1:]
        feats = llava_project(params["projector"], feats)
    S = feats.shape[1]
    return feats.reshape(B, N * S, feats.shape[-1])


def splice_image_embeds(
    text_embeds: torch.Tensor,
    image_feats: torch.Tensor,
    input_ids: torch.Tensor,
    image_token_id: int,
) -> torch.Tensor:
    """Replace embeddings at ``<image>`` positions with image features, in
    order of appearance (HF's masked_scatter)."""
    is_img = input_ids == image_token_id  # [B,T]
    idx = (torch.cumsum(is_img.to(torch.int64), dim=-1) - 1).clamp(0, image_feats.shape[1] - 1)
    gathered = torch.gather(
        image_feats, 1, idx[..., None].expand(-1, -1, image_feats.shape[-1])
    )
    return torch.where(is_img[..., None], gathered.to(text_embeds.dtype), text_embeds)


class LVLMBatch(NamedTuple):
    """Device-ready batch (see ``LVLMProcessor`` for construction)."""

    input_ids: torch.Tensor                       # [B,T]
    attention_mask: torch.Tensor                  # [B,T]
    pixel_values: Optional[torch.Tensor] = None   # [B,N,H,W,C]
    patch_mask: Optional[torch.Tensor] = None     # [B,N,nh,nw] (idefics2 aspect)
    pixel_mask: Optional[torch.Tensor] = None     # [B,N] real image slots
    image_attention_mask: Optional[torch.Tensor] = None  # [B,T,N] (idefics1)


def cross_attention_mask(batch: LVLMBatch, latents: int) -> Optional[torch.Tensor]:
    """idefics1: [B,1,T,N·latents] (True = attend) from the batch's
    ``image_attention_mask`` [B,T,N] and ``pixel_mask`` [B,N], each image's
    column repeated over its latents; None without an image attention mask."""
    if batch.image_attention_mask is None:
        return None
    m = batch.image_attention_mask.bool()
    if batch.pixel_mask is not None:
        m = m & batch.pixel_mask[:, None, :].bool()
    return m.repeat_interleave(latents, dim=-1)[:, None]


def lvlm_forward(
    params: Params,
    cfg: ModelConfig,
    batch: LVLMBatch,
    *,
    image_feats: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    kv_cache: Optional[Dict[str, Any]] = None,
    kv_total_len: Optional[int] = None,
    cache_empty: bool = False,
    **decoder_kwargs,
) -> LMOutput:
    """Full forward.  ``image_feats`` may be precomputed (generation reuses
    them).  With a kv_cache, ``batch.attention_mask`` covers the cached and
    current keys; without one, a causal mask over the sequence is built.

    idefics1: the image features are the decoder's ``cross_states``; each
    image's latents count as ``image_feats.shape[1] // N``, N the image axis of
    ``batch.image_attention_mask`` (the JAX package reads N off
    ``pixel_values``, which a decode step would then have to carry)."""
    _check_family(cfg)
    input_ids = batch.input_ids
    embeds = embed_tokens(params["lm"], input_ids)
    if batch.pixel_values is not None and image_feats is None:
        image_feats = encode_images(
            params, cfg, batch.pixel_values, batch.patch_mask,
            attn_impl=decoder_kwargs.get("attn_impl", "xla"),
        )
    if image_feats is not None:
        if cfg.family == "idefics1":
            decoder_kwargs["cross_states"] = image_feats
            if batch.image_attention_mask is not None:
                latents = image_feats.shape[1] // batch.image_attention_mask.shape[-1]
                decoder_kwargs["cross_mask"] = cross_attention_mask(batch, latents)
        else:
            embeds = splice_image_embeds(embeds, image_feats, input_ids, cfg.image_token_id)

    if kv_cache is not None and not cache_empty:
        # cached two-part attention: a 2D slot-validity mask over the timeline
        total = kv_total_len or (
            kv_cache["k"].shape[2]
            + (prompt_kv_len(kv_cache["prompt_k"]) if "prompt_k" in kv_cache else 0)
        )
        key_mask2d = batch.attention_mask
        pad = total - key_mask2d.shape[1]
        if pad > 0:
            key_mask2d = F.pad(key_mask2d, (0, pad))
        decoder_kwargs.setdefault("key_mask", key_mask2d)
        mask4 = None
    else:
        # cacheless forward or cache-empty prefill: causal + key padding
        mask4 = make_causal_mask(batch.attention_mask, cfg.text.sliding_window)
        decoder_kwargs.setdefault("key_mask", batch.attention_mask)
        if kv_cache is not None:
            decoder_kwargs.setdefault("cache_empty", True)

    if position_ids is None:
        position_ids = positions_from_mask(batch.attention_mask)
        if kv_cache is not None and input_ids.shape[1] == 1:
            position_ids = position_ids[:, -1:]

    return lm_forward(
        params["lm"],
        cfg.text,
        input_embeds=embeds,
        attn_mask=mask4,
        position_ids=position_ids,
        kv_cache=kv_cache,
        **decoder_kwargs,
    )
