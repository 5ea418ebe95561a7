"""Vision towers and the perceiver connectors.

Counterpart of ``mimic_tpu/models/vision.py``: ``vit_forward`` (the SigLIP
tower with variable-aspect patch masks, and the CLIP-style tower of idefics1:
class token, pre-layernorm, ``quick_gelu``) and ``perceiver_forward`` (the
idefics2 connector: modality projection, then a GQA perceiver in text width;
the idefics1 resampler: LayerNorm with bias, a ReLU MLP and per-head q/k
layernorms in the vision width).  The position-embedding lookup is real
indexing (the JAX package's one-hot matmul is a TPU workaround).  The llava
towers leave before the final norm (``post_layernorm=False``: llava takes
``vision_feature_layer=-2``); their tree keeps ``post_ln_*`` as the JAX
initialiser and converter write it, unused.  ``llava_project`` is the llava
projector (two linears around an exact GELU).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import ONEPASS_MAX_S_NONCAUSAL, flash_attention
from .config import PerceiverConfig, VisionConfig
from .decoder import dense_init
from .layers import gelu_act, layer_norm, repeat_kv, rms_norm, sdpa_with_lse

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------


def init_vit_params(
    cfg: VisionConfig, generator: torch.Generator, device, dtype=torch.float32
) -> Params:
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
    if cfg.use_class_token:
        params["class_embed"] = dense(D)
        params["pre_ln_w"] = ones(D)
        params["pre_ln_b"] = zeros(D)
    return params


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B,H,W,C] → [B, (H/p)*(W/p), p*p*C]; row-major patch scan order.  Pixels
    past the last whole patch are dropped, as HF's stride-p patch convolution
    drops them (SigLIP at 384 px with patch 14: 27 x 27 patches, the last 6
    rows and columns unread)."""
    B, H, W, C = pixels.shape
    nh, nw = H // patch, W // patch
    x = pixels[:, : nh * patch, : nw * patch]
    x = x.reshape(B, nh, patch, nw, patch, C).permute(0, 1, 3, 2, 4, 5)
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
    """pixels [B,H,W,C] → features [B, N, D] (post-layernorm applied where the
    config has one; N counts the class token first in a CLIP-style tower).

    Pixels are cast to the tower's parameter dtype (JAX promotes an fp32 pixel
    batch through a bf16 tower in fp32; in fp32 the two agree).

    ``attn_impl="flash"`` routes attention through the attention kernels on a
    128-aligned patch axis (1024-aligned beyond ``ONEPASS_MAX_S_NONCAUSAL``):
    the sequence is zero-padded once before the layer loop, the pad slots are
    masked out of attention as keys, and their rows are sliced off at the end.
    """
    w_dtype = params["patch_embed"]["kernel"].dtype
    x = patchify(pixels.to(w_dtype), cfg.patch_size) @ params["patch_embed"]["kernel"]
    x = x + params["patch_embed"]["bias"]
    B = x.shape[0]
    if cfg.use_class_token:
        cls = params["class_embed"][None, None].expand(B, 1, cfg.hidden_size)
        x = torch.cat([cls, x.to(cls.dtype)], dim=1)
    if patch_mask is not None:
        x = x + params["pos_embed"][bucket_position_ids(patch_mask)]
        key_mask = (patch_mask.reshape(B, -1) > 0)[:, None, None, :]  # [B,1,1,N]
    else:
        x = x + params["pos_embed"][None]
        key_mask = None
    if cfg.use_class_token:
        x = layer_norm(x, params["pre_ln_w"], params["pre_ln_b"], cfg.norm_eps)

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
            if cfg.use_class_token:  # the class token is always a key
                valid = F.pad(valid, (1, 0), value=True)
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
    if not cfg.post_layernorm:
        return x
    return layer_norm(x, params["post_ln_w"], params["post_ln_b"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# perceiver resampler (idefics1) / connector (idefics2)
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
    """IDEFICS-1 style (``pcfg.style == "idefics1"``, ``project_first=False``):
    latents live in ``vision_dim``; LayerNorm + ReLU MLP + optional per-head
    qk-layernorms (HF ``IdeficsPerceiverResampler``).
    IDEFICS-2 connector (``project_first=True``): vision features are
    MLP-projected to ``out_dim`` and the perceiver runs in ``out_dim`` with
    RMSNorm + gated-SiLU MLP (HF ``Idefics2PerceiverResampler``)."""
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

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if pcfg.style == "idefics1":
        layers = {
            "ln_latents_w": ones(L, width),
            "ln_latents_b": zeros(L, width),
            "ln_context_w": ones(L, width),
            "ln_context_b": zeros(L, width),
            "q_proj": dense(L, width, H * Dh),
            "k_proj": dense(L, width, Hkv * Dh),
            "v_proj": dense(L, width, Hkv * Dh),
            "o_proj": dense(L, H * Dh, width),
            "mlp_ln_w": ones(L, width),
            "mlp_ln_b": zeros(L, width),
            "fc": dense(L, width, Fd),
            "c_proj": dense(L, Fd, width),
        }
        if pcfg.qk_layernorm:
            layers["q_ln_w"] = ones(L, Dh)
            layers["q_ln_b"] = zeros(L, Dh)
            layers["k_ln_w"] = ones(L, Dh)
            layers["k_ln_b"] = zeros(L, Dh)
        return {
            "latents": dense(pcfg.num_latents, width),
            "layers": layers,
            "final_ln_w": ones(width),
            "final_ln_b": zeros(width),
        }
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
    if pcfg.style == "idefics1":
        return _perceiver_idefics1(params, pcfg, vision_feats, norm_eps, context_mask)
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

    kv_mask = _context_key_mask(context_mask, n_lat)

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


def _context_key_mask(context_mask: Optional[torch.Tensor], n_lat: int) -> Optional[torch.Tensor]:
    """[B, N] patch mask → [B,1,1,N+latents] key mask (the latents always attend)."""
    if context_mask is None:
        return None
    B = context_mask.shape[0]
    ones = torch.ones(B, n_lat, dtype=torch.bool, device=context_mask.device)
    return torch.cat([context_mask.bool(), ones], dim=1)[:, None, None, :]


def _perceiver_idefics1(
    params: Params,
    pcfg: PerceiverConfig,
    vision_feats: torch.Tensor,
    norm_eps: float,
    context_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """HF IdeficsPerceiverResampler semantics: per layer,
    latents += attn(q=ln(latents), kv=ln(context) ⊕ ln(latents));
    latents += ReLU-MLP(ln(latents)); then a final LayerNorm."""
    B, _, width = vision_feats.shape
    H = pcfg.num_heads
    Dh = pcfg.head_dim or width // H
    n_lat = params["latents"].shape[0]
    latents = params["latents"][None].expand(B, n_lat, width).to(vision_feats.dtype)
    kv_mask = _context_key_mask(context_mask, n_lat)

    layers = params["layers"]
    for l in range(pcfg.num_layers):
        lp = {name: w[l] for name, w in layers.items()}
        ctx_n = layer_norm(vision_feats, lp["ln_context_w"], lp["ln_context_b"], norm_eps)
        lat_n = layer_norm(latents, lp["ln_latents_w"], lp["ln_latents_b"], norm_eps)
        kv_in = torch.cat([ctx_n, lat_n], dim=1)
        nq, nk = lat_n.shape[1], kv_in.shape[1]
        q = (lat_n @ lp["q_proj"]).reshape(B, nq, H, Dh)
        k = (kv_in @ lp["k_proj"]).reshape(B, nk, H, Dh)
        v = (kv_in @ lp["v_proj"]).reshape(B, nk, H, Dh)
        if "q_ln_w" in lp:
            q = layer_norm(q, lp["q_ln_w"], lp["q_ln_b"], norm_eps)
            k = layer_norm(k, lp["k_ln_w"], lp["k_ln_b"], norm_eps)
        attn, _ = sdpa_with_lse(q, k, v, kv_mask)
        latents = latents + attn.reshape(B, nq, H * Dh) @ lp["o_proj"]
        m = layer_norm(latents, lp["mlp_ln_w"], lp["mlp_ln_b"], norm_eps)
        latents = latents + torch.relu(m @ lp["fc"]) @ lp["c_proj"]
    return layer_norm(latents, params["final_ln_w"], params["final_ln_b"], norm_eps)


# ---------------------------------------------------------------------------
# llava projector
# ---------------------------------------------------------------------------


def init_llava_projector(
    vision_dim: int, text_dim: int, generator: torch.Generator, device, dtype=torch.float32
) -> Params:
    return {
        "fc1": dense_init(generator, (vision_dim, text_dim), dtype, device),
        "fc1_bias": torch.zeros(text_dim, dtype=dtype, device=device),
        "fc2": dense_init(generator, (text_dim, text_dim), dtype, device),
        "fc2_bias": torch.zeros(text_dim, dtype=dtype, device=device),
    }


def llava_project(params: Params, vision_feats: torch.Tensor) -> torch.Tensor:
    """[.., vision_dim] → [.., text_dim]: fc2(gelu(fc1(x))), the GELU exact."""
    x = F.gelu(vision_feats @ params["fc1"] + params["fc1_bias"], approximate="none")
    return x @ params["fc2"] + params["fc2_bias"]
