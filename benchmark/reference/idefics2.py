"""idefics2 (HuggingFaceM4/idefics2-8b-base): SigLIP at 980 px with patch
masks, the perceiver connector (a gated-SiLU modality MLP, then GQA perceiver
layers over the image's valid patches and the latents, RMS norms), 64 tokens
an image spliced between ``<fake_token_around_image>`` markers; a Mistral
text tower.  The family's contract is ``benchmark/README.md``'s."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.lib import family
from benchmark.lib.family import image_tokens, process_image, vit_rows  # noqa: F401
from benchmark.reference import plain

BIAS = False  # Mistral: no q/k/v bias
POST_LN = True


def sizes(cfg: Dict[str, Any]) -> Dict[str, int]:
    s = family.base_sizes(cfg)
    t, p = cfg["text_config"], cfg["perceiver_config"]
    s.update(latents=p["resampler_n_latents"], Lp=p["resampler_depth"],
             Hp=p["resampler_n_heads"], Dhp=p["resampler_head_dim"],
             Hkvp=p["num_key_value_heads"],
             # the connector's modality MLP runs at the text tower's width,
             # the perceiver layers' MLPs at 4 x the text width (HF modeling)
             Fm=t["intermediate_size"], Fp=4 * t["hidden_size"])
    s["image_tokens"] = s["latents"]
    return s


def specs(cfg: Dict[str, Any], s: Dict[str, int]) -> List[family.Leaf]:
    D, Dv, Lp, Fm, Fp = s["D"], s["Dv"], s["Lp"], s["Fm"], s["Fp"]
    q, kv = s["Hp"] * s["Dhp"], s["Hkvp"] * s["Dhp"]
    per = [("ln_latents", (Lp, D), "norm"), ("ln_context", (Lp, D), "norm"),
           ("q_proj", (Lp, D, q), "dense"), ("k_proj", (Lp, D, kv), "dense"),
           ("v_proj", (Lp, D, kv), "dense"), ("o_proj", (Lp, q, D), "dense"),
           ("post_ln", (Lp, D), "norm"), ("gate_proj", (Lp, D, Fp), "dense"),
           ("up_proj", (Lp, D, Fp), "dense"), ("down_proj", (Lp, Fp, D), "dense")]
    return (family.dense_gqa_leaves(s, BIAS) + family.siglip_leaves(s)
            + family.group(("connector", "modality_proj"),
                           [("gate", (Dv, Fm), "dense"), ("up", (Dv, Fm), "dense"),
                            ("down", (Fm, D), "dense")])
            + [(("connector", "latents"), (s["latents"], D), "dense"),
               (("connector", "final_ln"), (D,), "norm")]
            + family.group(("connector", "layers"), per))


shift_shapes = family.head_shift_shapes


def expect(cfg: Dict[str, Any], s: Dict[str, int]) -> Dict[str, Any]:
    want = {**family.dense_gqa_expect(cfg, s, BIAS), **family.siglip_expect(cfg, s, POST_LN),
            "image_seq_len": s["image_tokens"],
            "perceiver.num_latents": s["latents"], "perceiver.num_layers": s["Lp"],
            "perceiver.num_heads": s["Hp"]}
    # the port's perceiver leaves these unset where they take their defaults
    want["perceiver.num_kv_heads"] = family.Defaulted(
        s["Hkvp"], lambda pc: pc.perceiver.num_heads)
    want["perceiver.head_dim"] = family.Defaulted(
        s["Dhp"], lambda pc: pc.text.hidden_size // pc.perceiver.num_heads)
    return want


def decoder(params, s, cfg: Dict[str, Any], embeds, key_ok, shift, u_len, capture_idx, prec,
            remat: bool = False):
    return plain.decoder(params["lm"]["decoder"], s, cfg["text_config"], embeds, key_ok, shift,
                         u_len, capture_idx, prec, BIAS, remat)


def expand(text: str, image_hw: List[Tuple[int, int]], cfg: Dict[str, Any],
           s: Dict[str, int]) -> str:
    img, fake = "<image>", "<fake_token_around_image>"
    out = family.expand_each(text, [fake + img * image_tokens(hw, cfg, s) + fake
                                    for hw in image_hw])
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

