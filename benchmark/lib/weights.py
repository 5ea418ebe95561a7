"""Random weights made on the device from the run's seed.

The tree has the layout the port's ``build_model(..., params=...)`` takes
(stacked ``[L, ...]`` leaves, weights stored ``[in, out]``) and the plain
reference reads: both sides are handed the same tensors' values.  Each leaf
is one ``torch.randn`` call from one ``torch.Generator`` on the device, in
the served dtype, so a cell's ~17 GB take a few dozen large calls.

Dense weights, embeddings, latents and biases are N(0, 1)·0.02; norm weights
are 1 + N(0, 1)·0.02, so that neither a skipped bias nor a skipped norm weight
goes unseen by the reference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

STD = 0.02


def sizes(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The widths and depths a family's tree is built from, by the names of
    the configuration file (``configs/<config>.json``)."""
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
    if cfg["family"] == "idefics2":
        p = cfg["perceiver_config"]
        s.update(latents=p["resampler_n_latents"], Lp=p["resampler_depth"],
                 Hp=p["resampler_n_heads"], Dhp=p["resampler_head_dim"],
                 Hkvp=p["num_key_value_heads"],
                 # the connector's modality MLP runs at the text tower's width,
                 # the perceiver layers' MLPs at 4 x the text width (HF modeling)
                 Fm=t["intermediate_size"], Fp=4 * t["hidden_size"])
        s["image_tokens"] = s["latents"]
    else:
        s["image_tokens"] = s["n_patches"]
    return s


def specs(cfg: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """(path, shape, init) of every leaf; init is "dense", "norm" or "bias"."""
    s = sizes(cfg)
    D, L, H, Hkv, Dh, F = s["D"], s["L"], s["H"], s["Hkv"], s["Dh"], s["F"]
    Dv, Fv, Lv = s["Dv"], s["Fv"], s["Lv"]
    out = [
        (("lm", "embed"), (s["V"], D), "dense"),
        (("lm", "lm_head"), (D, s["V"]), "dense"),
        (("lm", "decoder", "final_ln"), (D,), "norm"),
    ]
    dec = [("input_ln", (L, D), "norm"), ("q_proj", (L, D, H * Dh), "dense"),
           ("k_proj", (L, D, Hkv * Dh), "dense"), ("v_proj", (L, D, Hkv * Dh), "dense"),
           ("o_proj", (L, H * Dh, D), "dense"), ("post_ln", (L, D), "norm"),
           ("gate_proj", (L, D, F), "dense"), ("up_proj", (L, D, F), "dense"),
           ("down_proj", (L, F, D), "dense")]
    if cfg["family"] == "llava_interleave":  # Qwen2: biases on q, k, v
        dec += [("q_bias", (L, H * Dh), "bias"), ("k_bias", (L, Hkv * Dh), "bias"),
                ("v_bias", (L, Hkv * Dh), "bias")]
    out += [(("lm", "decoder", "layers", n), shape, init) for n, shape, init in dec]
    out += [
        (("vision", "patch_embed", "kernel"), (s["patch"] ** 2 * 3, Dv), "dense"),
        (("vision", "patch_embed", "bias"), (Dv,), "bias"),
        (("vision", "pos_embed"), (s["n_patches"], Dv), "dense"),
        (("vision", "post_ln_w"), (Dv,), "norm"),
        (("vision", "post_ln_b"), (Dv,), "bias"),
    ]
    vit = [("ln1_w", (Lv, Dv), "norm"), ("ln1_b", (Lv, Dv), "bias")]
    for p in "qkvo":
        vit += [(f"{p}_proj", (Lv, Dv, Dv), "dense"), (f"{p}_bias", (Lv, Dv), "bias")]
    vit += [("ln2_w", (Lv, Dv), "norm"), ("ln2_b", (Lv, Dv), "bias"),
            ("fc1", (Lv, Dv, Fv), "dense"), ("fc1_bias", (Lv, Fv), "bias"),
            ("fc2", (Lv, Fv, Dv), "dense"), ("fc2_bias", (Lv, Dv), "bias")]
    out += [(("vision", "layers", n), shape, init) for n, shape, init in vit]
    if cfg["family"] == "idefics2":
        Lp, Fm, Fp = s["Lp"], s["Fm"], s["Fp"]
        q, kv = s["Hp"] * s["Dhp"], s["Hkvp"] * s["Dhp"]
        out += [
            (("connector", "modality_proj", "gate"), (Dv, Fm), "dense"),
            (("connector", "modality_proj", "up"), (Dv, Fm), "dense"),
            (("connector", "modality_proj", "down"), (Fm, D), "dense"),
            (("connector", "latents"), (s["latents"], D), "dense"),
            (("connector", "final_ln"), (D,), "norm"),
        ]
        per = [("ln_latents", (Lp, D), "norm"), ("ln_context", (Lp, D), "norm"),
               ("q_proj", (Lp, D, q), "dense"), ("k_proj", (Lp, D, kv), "dense"),
               ("v_proj", (Lp, D, kv), "dense"), ("o_proj", (Lp, q, D), "dense"),
               ("post_ln", (Lp, D), "norm"), ("gate_proj", (Lp, D, Fp), "dense"),
               ("up_proj", (Lp, D, Fp), "dense"), ("down_proj", (Lp, Fp, D), "dense")]
        out += [(("connector", "layers", n), shape, init) for n, shape, init in per]
    else:
        out += [
            (("projector", "fc1"), (Dv, D), "dense"),
            (("projector", "fc1_bias"), (D,), "bias"),
            (("projector", "fc2"), (D, D), "dense"),
            (("projector", "fc2_bias"), (D,), "bias"),
        ]
    return out


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a run's seed."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % 2**63)


def make_weights(cfg: Dict[str, Any], seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The cell's weights from ``seed``: the same seed gives the same tensors."""
    gen = generator(seed, 1, device)
    tree: Dict[str, Any] = {}
    for path, shape, init in specs(cfg):
        x = torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(STD)
        if init == "norm":
            x.add_(1.0)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return tree


def make_shift(cfg: Dict[str, Any], init: Dict[str, float], seed: int, device) -> Dict[str, torch.Tensor]:
    """The MimIC multi-head shift, fp32: v ~ N(0,1)·``attn_v_std``, the log Z1
    weight ~ N(0,1)·``logz1_w_std``, its bias ``logz1_b``."""
    s = sizes(cfg)
    gen = generator(seed, 2, device)
    shape = (s["L"], s["H"], s["Dh"])
    v = torch.randn(shape, generator=gen, device=device) * init["attn_v_std"]
    w = torch.randn(shape, generator=gen, device=device) * init["logz1_w_std"]
    b = torch.full((s["L"], s["H"]), float(init["logz1_b"]), device=device)
    return {"attn_v": v, "attn_logz1_w": w, "attn_logz1_b": b}
