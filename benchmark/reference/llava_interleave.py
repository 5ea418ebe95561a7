"""llava-interleave (llava-hf/llava-interleave-qwen-7b-hf): SigLIP at 384 px
(square resize), features from the second-to-last layer (no post-layernorm),
the two-layer projector with an exact GELU, one token a patch (729 an
image); a Qwen2 text tower with q/k/v biases.  The family's contract is
``benchmark/README.md``'s."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.lib import family
from benchmark.lib.family import image_tokens, process_image, vit_rows  # noqa: F401
from benchmark.reference import plain

BIAS = True  # Qwen2: biases on q, k, v
POST_LN = False  # vision_feature_layer -2: the tower's output before its final norm


def sizes(cfg: Dict[str, Any]) -> Dict[str, int]:
    s = family.base_sizes(cfg)
    s["image_tokens"] = s["n_patches"]
    return s


def specs(cfg: Dict[str, Any], s: Dict[str, int]) -> List[family.Leaf]:
    D = s["D"]
    return (family.dense_gqa_leaves(s, BIAS) + family.siglip_leaves(s)
            + family.group(("projector",), [("fc1", (s["Dv"], D), "dense"),
                                            ("fc1_bias", (D,), "bias"),
                                            ("fc2", (D, D), "dense"),
                                            ("fc2_bias", (D,), "bias")]))


shift_shapes = family.head_shift_shapes


def expect(cfg: Dict[str, Any], s: Dict[str, int]) -> Dict[str, Any]:
    return {**family.dense_gqa_expect(cfg, s, BIAS), **family.siglip_expect(cfg, s, POST_LN),
            "image_seq_len": s["image_tokens"]}


def decoder(params, s, cfg: Dict[str, Any], embeds, key_ok, shift, u_len, capture_idx, prec,
            remat: bool = False):
    return plain.decoder(params["lm"]["decoder"], s, cfg["text_config"], embeds, key_ok, shift,
                         u_len, capture_idx, prec, BIAS, remat)


def expand(text: str, image_hw: List[Tuple[int, int]], cfg: Dict[str, Any],
           s: Dict[str, int]) -> str:
    return family.expand_each(text, ["<image>" * image_tokens(hw, cfg, s) for hw in image_hw])


def encode_image(params, cfg: Dict[str, Any], s, pixels, mask, prec) -> torch.Tensor:
    feats = plain.vit(params["vision"], s, cfg["vision_config"]["layer_norm_eps"], pixels,
                      mask, POST_LN, prec)
    pp = params["projector"]
    x = F.gelu(prec.mm(feats, pp["fc1"]) + pp["fc1_bias"].float(), approximate="none")
    return prec.mm(x, pp["fc2"]) + pp["fc2_bias"].float()

