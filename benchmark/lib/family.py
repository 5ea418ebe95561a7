"""What the model families share, for ``reference/<family>.py`` to build on.

A family module is the one place where a family's architecture lives (its
sizes, leaves, shift shapes, the port's configuration keys, reference
decoder and image geometry; ``benchmark/README.md`` lists the contract).
The pieces here are those the present families have in common: the text
and SigLIP widths of a configuration file, the leaves of a dense GQA text
tower and of a SigLIP tower, a shift of one width per head, the port's keys
for those parts, and an image path with a fixed token count per image.
A family takes what applies and adds its own.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from benchmark.reference import plain

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str]


def base_sizes(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The text tower's and the SigLIP tower's widths and depths, by the names
    of the configuration file (``configs/<config>.json``)."""
    t, v = cfg["text_config"], cfg["vision_config"]
    s = dict(
        V=t["vocab_size"], D=t["hidden_size"], L=t["num_hidden_layers"],
        H=t["num_attention_heads"], Hkv=t["num_key_value_heads"],
        F=t["intermediate_size"], Dh=t["hidden_size"] // t["num_attention_heads"],
        Dv=v["hidden_size"], Fv=v["intermediate_size"], Hv=v["num_attention_heads"],
        patch=v["patch_size"], image=v["image_size"],
        Lv=v["num_hidden_layers"] + 1 + cfg.get("vision_feature_layer", -1),
    )
    s["n_patches"] = (s["image"] // s["patch"]) ** 2
    return s


def group(prefix: Tuple[str, ...],
          leaves: Sequence[Tuple[str, Tuple[int, ...], str]]) -> List[Leaf]:
    """``(name, shape, init)`` under ``prefix``."""
    return [(prefix + (n,), shape, init) for n, shape, init in leaves]


def lm_leaves(s: Dict[str, int]) -> List[Leaf]:
    """The embedding, the lm head and the final norm."""
    D = s["D"]
    return [(("lm", "embed"), (s["V"], D), "dense"),
            (("lm", "lm_head"), (D, s["V"]), "dense"),
            (("lm", "decoder", "final_ln"), (D,), "norm")]


def dense_gqa_leaves(s: Dict[str, int], bias: bool) -> List[Leaf]:
    """``lm_leaves``, then a dense GQA tower's stacked layers (Mistral's;
    ``bias``: Qwen2's biases on q, k, v after them)."""
    D, L, H, Hkv, Dh, F = s["D"], s["L"], s["H"], s["Hkv"], s["Dh"], s["F"]
    dec = [("input_ln", (L, D), "norm"), ("q_proj", (L, D, H * Dh), "dense"),
           ("k_proj", (L, D, Hkv * Dh), "dense"), ("v_proj", (L, D, Hkv * Dh), "dense"),
           ("o_proj", (L, H * Dh, D), "dense"), ("post_ln", (L, D), "norm"),
           ("gate_proj", (L, D, F), "dense"), ("up_proj", (L, D, F), "dense"),
           ("down_proj", (L, F, D), "dense")]
    if bias:
        dec += [("q_bias", (L, H * Dh), "bias"), ("k_bias", (L, Hkv * Dh), "bias"),
                ("v_bias", (L, Hkv * Dh), "bias")]
    return lm_leaves(s) + group(("lm", "decoder", "layers"), dec)


def siglip_leaves(s: Dict[str, int]) -> List[Leaf]:
    """The SigLIP tower: patch embedding, position table, post-layernorm,
    stacked layers."""
    Dv, Fv, Lv = s["Dv"], s["Fv"], s["Lv"]
    out = [(("vision", "patch_embed", "kernel"), (s["patch"] ** 2 * 3, Dv), "dense"),
           (("vision", "patch_embed", "bias"), (Dv,), "bias"),
           (("vision", "pos_embed"), (s["n_patches"], Dv), "dense"),
           (("vision", "post_ln_w"), (Dv,), "norm"),
           (("vision", "post_ln_b"), (Dv,), "bias")]
    vit = [("ln1_w", (Lv, Dv), "norm"), ("ln1_b", (Lv, Dv), "bias")]
    for p in "qkvo":
        vit += [(f"{p}_proj", (Lv, Dv, Dv), "dense"), (f"{p}_bias", (Lv, Dv), "bias")]
    vit += [("ln2_w", (Lv, Dv), "norm"), ("ln2_b", (Lv, Dv), "bias"),
            ("fc1", (Lv, Dv, Fv), "dense"), ("fc1_bias", (Lv, Fv), "bias"),
            ("fc2", (Lv, Fv, Dv), "dense"), ("fc2_bias", (Lv, Dv), "bias")]
    return out + group(("vision", "layers"), vit)


def head_shift_shapes(s: Dict[str, int]) -> Dict[str, Tuple[int, ...]]:
    """The MimIC shift of a tower whose query and value heads are ``Dh`` wide."""
    L, H, Dh = s["L"], s["H"], s["Dh"]
    return {"attn_v": (L, H, Dh), "attn_logz1_w": (L, H, Dh), "attn_logz1_b": (L, H)}


# ---------------------------------------------------------------------------
# the port's configuration keys
# ---------------------------------------------------------------------------


class Defaulted(NamedTuple):
    """An ``expect`` value for a key the port may leave unset (None):
    ``default(port_config)`` is the value it then takes."""
    value: Any
    default: Callable[[Any], Any]


def dense_gqa_expect(cfg: Dict[str, Any], s: Dict[str, int], attn_bias: bool) -> Dict[str, Any]:
    t = cfg["text_config"]
    return {
        "text.vocab_size": s["V"], "text.hidden_size": s["D"], "text.num_layers": s["L"],
        "text.num_heads": s["H"], "text.num_kv_heads": s["Hkv"],
        "text.intermediate_size": s["F"], "text.head_size": s["Dh"],
        "text.norm_eps": t["rms_norm_eps"], "text.rope_theta": t["rope_theta"],
        "text.attn_bias": attn_bias, "text.sliding_window": None,
    }


def siglip_expect(cfg: Dict[str, Any], s: Dict[str, int], post_layernorm: bool) -> Dict[str, Any]:
    return {
        "vision.hidden_size": s["Dv"], "vision.num_layers": s["Lv"],
        "vision.num_heads": s["Hv"], "vision.intermediate_size": s["Fv"],
        "vision.image_size": s["image"], "vision.patch_size": s["patch"],
        "vision.norm_eps": cfg["vision_config"]["layer_norm_eps"],
        "vision.use_class_token": False, "vision.post_layernorm": post_layernorm,
    }


# ---------------------------------------------------------------------------
# image geometry
# ---------------------------------------------------------------------------


def process_image(img: np.ndarray, cfg: Dict[str, Any], s: Dict[str, int]):
    """The processor's canvas and patch mask (``plain.process_image``)."""
    return plain.process_image(img, cfg["processor"], s["patch"])


def vit_rows(shape_hw: Tuple[int, int], cfg: Dict[str, Any], s: Dict[str, int]) -> int:
    """The tower's rows for one image: the patches that carry pixels."""
    return plain.valid_patches(shape_hw, cfg["processor"], s["patch"])


def image_tokens(shape_hw: Tuple[int, int], cfg: Dict[str, Any], s: Dict[str, int]) -> int:
    """``s["image_tokens"]`` for every image, whatever its size."""
    return s["image_tokens"]


def expand_each(text: str, pieces: Sequence[str]) -> str:
    """The k-th ``<image>`` of ``text`` replaced by ``pieces[k]``."""
    parts = text.split("<image>")
    if len(parts) != len(pieces) + 1:
        raise ValueError(f"{len(parts) - 1} <image> markers for {len(pieces)} images")
    return "".join(p + x for p, x in zip(parts, list(pieces) + [""]))
