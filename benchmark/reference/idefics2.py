"""idefics2 (HuggingFaceM4/idefics2-8b-base): SigLIP at 980 px with patch
masks, the perceiver connector (a gated-SiLU modality MLP, then GQA perceiver
layers over the image's valid patches and the latents, RMS norms), 64 tokens
an image spliced between ``<fake_token_around_image>`` markers; a Mistral
text tower."""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import plain

BIAS = False  # Mistral: no q/k/v bias
POST_LN = True


def expand(text: str, s: Dict[str, int]) -> str:
    img, fake = "<image>", "<fake_token_around_image>"
    out = text.replace(img, fake + img * s["image_tokens"] + fake)
    return out.replace(fake + fake, fake)


def connector(cp, s, eps, feats: torch.Tensor, valid: torch.Tensor, prec) -> torch.Tensor:
    """[N, Dv] patch features (``valid`` [N]) → [latents, D]."""
    mp = cp["modality_proj"]
    x = prec.mm(F.silu(prec.mm(feats, mp["gate"])) * prec.mm(feats, mp["up"]), mp["down"])
    lat = cp["latents"].float()
    H, Hkv, Dh = s["Hp"], s["Hkvp"], s["Dhp"]
    keys_ok = torch.cat([valid, torch.ones(lat.shape[0], dtype=torch.bool, device=x.device)])
    lay = cp["layers"]
    for l in range(s["Lp"]):
        ln_lat = plain.rms_norm(lat, lay["ln_latents"][l], eps)
        ctx = torch.cat([plain.rms_norm(x, lay["ln_context"][l], eps), ln_lat])
        q = prec.mm(ln_lat, lay["q_proj"][l]).reshape(-1, H, Dh)
        k = prec.mm(ctx, lay["k_proj"][l]).reshape(-1, Hkv, Dh).repeat_interleave(H // Hkv, 1)
        v = prec.mm(ctx, lay["v_proj"][l]).reshape(-1, Hkv, Dh).repeat_interleave(H // Hkv, 1)
        sc = torch.einsum("thd,shd->hts", q, k) / math.sqrt(Dh)
        sc = sc.masked_fill(~keys_ok[None, None], float("-inf"))
        a = torch.einsum("hts,shd->thd", torch.softmax(sc, -1), v).reshape(-1, H * Dh)
        lat = lat + prec.mm(a, lay["o_proj"][l])
        h = plain.rms_norm(lat, lay["post_ln"][l], eps)
        lat = lat + prec.mm(F.silu(prec.mm(h, lay["gate_proj"][l])) * prec.mm(h, lay["up_proj"][l]),
                            lay["down_proj"][l])
    return plain.rms_norm(lat, cp["final_ln"], eps)


def encode_image(params, cfg: Dict[str, Any], s, pixels, mask, prec) -> torch.Tensor:
    """One processed image → its [64, D] tokens."""
    feats = plain.vit(params["vision"], s, cfg["vision_config"]["layer_norm_eps"], pixels,
                      mask, POST_LN, prec)
    valid = mask.reshape(-1) > 0
    return connector(params["connector"], s, cfg["text_config"]["rms_norm_eps"], feats,
                     valid, prec)

