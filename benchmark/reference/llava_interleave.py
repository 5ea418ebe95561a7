"""llava-interleave (llava-hf/llava-interleave-qwen-7b-hf): SigLIP at 384 px
(square resize), features from the second-to-last layer (no post-layernorm),
the two-layer projector with an exact GELU, one token a patch (729 an
image); a Qwen2 text tower with q/k/v biases."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from benchmark.reference import plain

BIAS = True  # Qwen2: biases on q, k, v
POST_LN = False  # vision_feature_layer -2: the tower's output before its final norm


def expand(text: str, s: Dict[str, int]) -> str:
    return text.replace("<image>", "<image>" * s["image_tokens"])


def encode_image(params, cfg: Dict[str, Any], s, pixels, mask, prec) -> torch.Tensor:
    feats = plain.vit(params["vision"], s, cfg["vision_config"]["layer_norm_eps"], pixels,
                      mask, POST_LN, prec)
    pp = params["projector"]
    x = F.gelu(prec.mm(feats, pp["fc1"]) + pp["fc1_bias"].float(), approximate="none")
    return prec.mm(x, pp["fc2"]) + pp["fc2_bias"].float()

