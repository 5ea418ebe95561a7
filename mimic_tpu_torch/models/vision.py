"""Vision tower and the idefics2 perceiver connector.

Counterpart of ``mimic_tpu/models/vision.py``: ``vit_forward`` (the SigLIP
tower, variable-aspect patch masks) and ``perceiver_forward`` (the idefics2
connector: modality projection, then a GQA perceiver in text width).  The
position-embedding lookup is real indexing (the JAX package's one-hot matmul
is a TPU workaround).  Not ported yet: CLIP-style towers (class token,
pre-norm, no post-norm), the idefics1 resampler and the llava projector.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import ONEPASS_MAX_S_NONCAUSAL, flash_attention
from ..shared import PerceiverConfig, VisionConfig
from .decoder import dense_init
from .layers import gelu_act, layer_norm, repeat_kv, rms_norm, sdpa_with_lse

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------


def _check_vision_cfg(cfg: VisionConfig) -> None:
    if cfg.use_class_token or not cfg.post_layernorm:
        raise NotImplementedError("CLIP-style vision towers are not ported yet")


def init_vit_params(
    cfg: VisionConfig, generator: torch.Generator, device, dtype=torch.float32
) -> Params:
    _check_vision_cfg(cfg)
    D, Fd, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    p = cfg.patch_size

    def dense(*shape):
        return dense_init(generator, shape, dtype, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    params: Params = {
        "patch_embed": {"kernel": dense(p * p * 3, D), "bias": zeros(D)},
        "pos_embed": dense(cfg.num_patches, D),
        "layers": {
            "ln1_w": ones(L, D),
            "ln1_b": zeros(L, D),
            "q_proj": dense(L, D, D),
            "q_bias": zeros(L, D),
            "k_proj": dense(L, D, D),
            "k_bias": zeros(L, D),
            "v_proj": dense(L, D, D),
            "v_bias": zeros(L, D),
            "o_proj": dense(L, D, D),
            "o_bias": zeros(L, D),
            "ln2_w": ones(L, D),
            "ln2_b": zeros(L, D),
            "fc1": dense(L, D, Fd),
            "fc1_bias": zeros(L, Fd),
            "fc2": dense(L, Fd, D),
            "fc2_bias": zeros(L, D),
        },
        "post_ln_w": ones(D),
        "post_ln_b": zeros(D),
    }
    return params


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B,H,W,C] → [B, (H/p)*(W/p), p*p*C]; row-major patch scan order."""
    B, H, W, C = pixels.shape
    nh, nw = H // patch, W // patch
    x = pixels.reshape(B, nh, patch, nw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, nh * nw, patch * patch * C)


def bucket_position_ids(patch_mask: torch.Tensor) -> torch.Tensor:
    """NaViT-style bucketized position ids for variable-aspect images.

    patch_mask [B, nh, nw] (top-left valid region) → ids [B, nh*nw] into an
    ``nh*nw``-entry table: the valid ``nb_h × nb_w`` grid is stretched over the
    full grid (HF Idefics2VisionEmbeddings semantics); padded patches get 0.
    """
    B, nh, nw = patch_mask.shape
    valid = patch_mask > 0
    valid_h = valid.any(dim=2).sum(dim=1).clamp_min(1)  # [B]
    valid_w = valid.any(dim=1).sum(dim=1).clamp_min(1)

    def buckets(valid_n, side):
        dev = patch_mask.device
        frac = torch.arange(side, device=dev)[None, :] / valid_n[:, None]  # [B, side]
        boundaries = torch.arange(1, side, device=dev) / side
        return (frac[:, :, None] >= boundaries[None, None, :]).sum(dim=-1)

    ids = buckets(valid_h, nh)[:, :, None] * nw + buckets(valid_w, nw)[:, None, :]
    ids = torch.where(valid, ids, 0)
    return ids.reshape(B, nh * nw)


def vit_forward(
    params: Params,
    cfg: VisionConfig,
    pixels: torch.Tensor,
    patch_mask: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
) -> torch.Tensor:
    """pixels [B,H,W,C] → features [B, N, D] (post-layernorm applied).

    Pixels are cast to the tower's parameter dtype (JAX promotes an fp32 pixel
    batch through a bf16 tower in fp32; in fp32 the two agree).

    ``attn_impl="flash"`` routes attention through the attention kernels on a
    128-aligned patch axis (1024-aligned beyond ``ONEPASS_MAX_S_NONCAUSAL``):
    the sequence is zero-padded once before the layer loop, the pad slots are
    masked out of attention as keys, and their rows are sliced off at the end.
    """
    _check_vision_cfg(cfg)
    w_dtype = params["patch_embed"]["kernel"].dtype
    x = patchify(pixels.to(w_dtype), cfg.patch_size) @ params["patch_embed"]["kernel"]
    x = x + params["patch_embed"]["bias"]
    B = x.shape[0]
    if patch_mask is not None:
        x = x + params["pos_embed"][bucket_position_ids(patch_mask)]
        key_mask = (patch_mask.reshape(B, -1) > 0)[:, None, None, :]  # [B,1,1,N]
    else:
        x = x + params["pos_embed"][None]
        key_mask = None

    H = cfg.num_heads
    Dh = cfg.hidden_size // H
    n_tokens = x.shape[1]
    use_flash = attn_impl == "flash"
    flash_kmask = None
    if use_flash:
        n128 = n_tokens + (-n_tokens) % 128
        n_pad = (-n_tokens) % (128 if n128 <= ONEPASS_MAX_S_NONCAUSAL else 1024)
        if n_pad:
            x = F.pad(x, (0, 0, 0, n_pad))
        if patch_mask is not None:
            valid = patch_mask.reshape(B, -1) > 0
        else:
            valid = torch.ones(B, n_tokens, dtype=torch.bool, device=x.device)
        flash_kmask = F.pad(valid.to(torch.int32), (0, n_pad))

    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {name: w[l] for name, w in layers.items()}
        residual = x
        hn = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
        B_, N, D = hn.shape
        q = (hn @ lp["q_proj"] + lp["q_bias"]).reshape(B_, N, H, Dh)
        k = (hn @ lp["k_proj"] + lp["k_bias"]).reshape(B_, N, H, Dh)
        v = (hn @ lp["v_proj"] + lp["v_bias"]).reshape(B_, N, H, Dh)
        if use_flash:
            attn, _, _ = flash_attention(
                q, k, v, flash_kmask, causal=False, need_unmasked=False
            )
        else:
            attn, _ = sdpa_with_lse(q, k, v, mask=key_mask)
        x = residual + attn.reshape(B_, N, D) @ lp["o_proj"] + lp["o_bias"]
        residual = x
        hn = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
        hn = gelu_act(hn @ lp["fc1"] + lp["fc1_bias"], cfg.hidden_act)
        x = residual + hn @ lp["fc2"] + lp["fc2_bias"]

    if use_flash and x.shape[1] != n_tokens:
        x = x[:, :n_tokens]
    return layer_norm(x, params["post_ln_w"], params["post_ln_b"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# idefics2 perceiver connector
# ---------------------------------------------------------------------------


def init_perceiver_params(
    pcfg: PerceiverConfig,
    vision_dim: int,
    out_dim: int,
    generator: torch.Generator,
    device,
    dtype=torch.float32,
    project_first: bool = False,
) -> Params:
    """IDEFICS-2 connector (``project_first=True``): vision features are
    MLP-projected to ``out_dim`` and the perceiver runs in ``out_dim`` with
    RMSNorm + gated-SiLU MLP (HF ``Idefics2PerceiverResampler``)."""
    if pcfg.style != "idefics2":
        raise NotImplementedError("the idefics1 perceiver resampler is not ported yet")
    H = pcfg.num_heads
    Hkv = pcfg.num_kv_heads or H
    width = out_dim if project_first else vision_dim
    Dh = pcfg.head_dim or width // H
    Fd = pcfg.intermediate_size or 4 * width
    L = pcfg.num_layers

    def dense(*shape):
        return dense_init(generator, shape, dtype, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params: Params = {
        "latents": dense(pcfg.num_latents, width),
        "layers": {
            "ln_latents": ones(L, width),
            "ln_context": ones(L, width),
            "q_proj": dense(L, width, H * Dh),
            "k_proj": dense(L, width, Hkv * Dh),
            "v_proj": dense(L, width, Hkv * Dh),
            "o_proj": dense(L, H * Dh, width),
            "post_ln": ones(L, width),
            "gate_proj": dense(L, width, Fd),
            "up_proj": dense(L, width, Fd),
            "down_proj": dense(L, Fd, width),
        },
        "final_ln": ones(width),
    }
    if project_first:
        params["modality_proj"] = {
            "gate": dense(vision_dim, Fd),
            "up": dense(vision_dim, Fd),
            "down": dense(Fd, out_dim),
        }
    return params


def perceiver_forward(
    params: Params,
    pcfg: PerceiverConfig,
    vision_feats: torch.Tensor,
    norm_eps: float = 1e-6,
    context_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """vision_feats [B, N, width_in] → [B, num_latents, width_out].

    Each layer: latents attend to concat(context, latents), then a gated MLP,
    both with residuals.  ``context_mask`` [B, N] masks padded patches out of
    the keys.  Attention is plain ``sdpa_with_lse``, as in the JAX package.
    """
    if pcfg.style != "idefics2":
        raise NotImplementedError("the idefics1 perceiver resampler is not ported yet")
    if "modality_proj" in params:
        mp = params["modality_proj"]
        vision_feats = (F.silu(vision_feats @ mp["gate"]) * (vision_feats @ mp["up"])) @ mp["down"]

    B = vision_feats.shape[0]
    width = vision_feats.shape[-1]
    H = pcfg.num_heads
    Hkv = pcfg.num_kv_heads or H
    Dh = pcfg.head_dim or width // H
    n_lat = params["latents"].shape[0]
    latents = params["latents"][None].expand(B, n_lat, width).to(vision_feats.dtype)

    kv_mask = None
    if context_mask is not None:
        full = torch.cat(
            [context_mask.bool(), torch.ones(B, n_lat, dtype=torch.bool, device=latents.device)],
            dim=1,
        )
        kv_mask = full[:, None, None, :]  # [B,1,1,N+latents]

    layers = params["layers"]
    for l in range(pcfg.num_layers):
        lp = {name: w[l] for name, w in layers.items()}
        residual = latents
        ln_lat = rms_norm(latents, lp["ln_latents"], norm_eps)
        ln_ctx = rms_norm(vision_feats, lp["ln_context"], norm_eps)
        kv_input = torch.cat([ln_ctx, ln_lat], dim=1)
        nq, nk = ln_lat.shape[1], kv_input.shape[1]
        q = (ln_lat @ lp["q_proj"]).reshape(B, nq, H, Dh)
        k = (kv_input @ lp["k_proj"]).reshape(B, nk, Hkv, Dh)
        v = (kv_input @ lp["v_proj"]).reshape(B, nk, Hkv, Dh)
        attn, _ = sdpa_with_lse(q, repeat_kv(k, H // Hkv), repeat_kv(v, H // Hkv), kv_mask)
        latents = residual + attn.reshape(B, nq, H * Dh) @ lp["o_proj"]
        residual = latents
        ln = rms_norm(latents, lp["post_ln"], norm_eps)
        latents = residual + (F.silu(ln @ lp["gate_proj"]) * (ln @ lp["up_proj"])) @ lp["down_proj"]
    return rms_norm(latents, params["final_ln"], norm_eps)
