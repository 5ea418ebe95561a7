"""The probe family: what the next families need from the harness, in a
tiny model that only the reference runs.  Its query and key heads are
``Dq`` wide and its value heads ``Dh`` (as latent attention's 192 and 128),
so the shift's log Z1 weight is wider than its v; each layer's MLP is a
softmax mixture of ``E`` experts, stacked ``[L, E, D, Fe]``; an image takes
one token for each patch that carries pixels, so its token count depends on
its size."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark.lib import family
from benchmark.lib.family import process_image, vit_rows  # noqa: F401
from benchmark.reference import plain


def sizes(cfg: Dict[str, Any]) -> Dict[str, int]:
    s = family.base_sizes(cfg)
    t = cfg["text_config"]
    s.update(Dq=s["Dh"] + t["qk_rope_head_dim"], E=t["n_routed_experts"],
             Fe=t["moe_intermediate_size"])
    return s


def specs(cfg: Dict[str, Any], s: Dict[str, int]) -> List[family.Leaf]:
    D, L, H, Dh, Dq, E, Fe = (s[k] for k in ("D", "L", "H", "Dh", "Dq", "E", "Fe"))
    layers = [("input_ln", (L, D), "norm"), ("q_proj", (L, D, H * Dq), "dense"),
              ("k_proj", (L, D, H * Dq), "dense"), ("v_proj", (L, D, H * Dh), "dense"),
              ("o_proj", (L, H * Dh, D), "dense"), ("post_ln", (L, D), "norm"),
              ("router", (L, D, E), "dense")]
    experts = [("gate", (L, E, D, Fe), "dense"), ("up", (L, E, D, Fe), "dense"),
               ("down", (L, E, Fe, D), "dense")]
    return (family.lm_leaves(s) + family.group(("lm", "decoder", "layers"), layers)
            + family.group(("lm", "decoder", "experts"), experts) + family.siglip_leaves(s)
            + [(("projector", "fc"), (s["Dv"], D), "dense")])


def shift_shapes(s: Dict[str, int]) -> Dict[str, Tuple[int, ...]]:
    L, H = s["L"], s["H"]
    return {"attn_v": (L, H, s["Dh"]), "attn_logz1_w": (L, H, s["Dq"]), "attn_logz1_b": (L, H)}


def expect(cfg: Dict[str, Any], s: Dict[str, int]) -> Dict[str, Any]:
    return {**family.siglip_expect(cfg, s, post_layernorm=False),
            "text.hidden_size": s["D"], "text.num_layers": s["L"],
            "text.qk_head_dim": s["Dq"], "text.v_head_dim": s["Dh"], "text.num_experts": s["E"],
            "text.expert_size": family.Defaulted(s["Fe"], lambda pc: pc.text.hidden_size // 2)}


def decoder(params, s, cfg: Dict[str, Any], embeds, key_ok, shift, u_len, capture_idx, prec,
            remat: bool = False):
    """``plain.decoder``'s contract, with Dq-wide queries and keys, Dh-wide
    values and the mixture of experts."""
    dp = params["lm"]["decoder"]
    lay, ex = dp["layers"], dp["experts"]
    tc = cfg["text_config"]
    B, T, D = embeds.shape
    H, Dh, Dq, E = s["H"], s["Dh"], s["Dq"], s["E"]
    eps, theta = tc["rms_norm_eps"], tc["rope_theta"]
    dev = embeds.device
    pos = (torch.cumsum(key_ok.long(), -1) - 1).clamp_min(0)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    keys = torch.arange(T, device=dev)
    u_range = keys[None, :] < (u_len if u_len is not None
                               else torch.full((T,), T, device=dev))[:, None]

    def layer(x, l):
        h = plain.rms_norm(x, lay["input_ln"][l], eps)
        q = plain.rope(prec.mm(h, lay["q_proj"][l]).reshape(B, T, H, Dq), pos, theta)
        k = plain.rope(prec.mm(h, lay["k_proj"][l]).reshape(B, T, H, Dq), pos, theta)
        v = prec.mm(h, lay["v_proj"][l]).reshape(B, T, H, Dh)
        outs = []
        for b in range(B):
            a, lse_u = plain.attention(q[b], k[b], v[b], causal & key_ok[b][None, :].bool(),
                                       u_range)
            if shift:
                mu = torch.sigmoid(torch.einsum("thd,hd->th", q[b], shift["attn_logz1_w"][l])
                                   + shift["attn_logz1_b"][l] - lse_u)
                a = a + mu[..., None] * shift["attn_v"][l]
            outs.append(a)
        x = x + prec.mm(torch.stack(outs).reshape(B, T, H * Dh), lay["o_proj"][l])
        h = plain.rms_norm(x, lay["post_ln"][l], eps)
        gates = torch.softmax(prec.mm(h, lay["router"][l]), -1)
        f = sum(gates[..., e:e + 1]
                * prec.mm(F.silu(prec.mm(h, ex["gate"][l, e])) * prec.mm(h, ex["up"][l, e]),
                          ex["down"][l, e]) for e in range(E))
        cap = None
        if capture_idx is not None:
            cap = torch.gather(f, 1, capture_idx[..., None].expand(-1, -1, D))
        return x + f, cap

    x, caps = embeds.float(), []
    for l in range(s["L"]):
        if remat:
            x, cap = torch.utils.checkpoint.checkpoint(layer, x, l, use_reentrant=False)
        else:
            x, cap = layer(x, l)
        caps.append(cap)
    x = plain.rms_norm(x, dp["final_ln"], eps)
    return x, (torch.stack(caps) if capture_idx is not None else None)


def image_tokens(shape_hw: Tuple[int, int], cfg: Dict[str, Any], s: Dict[str, int]) -> int:
    return vit_rows(shape_hw, cfg, s)


def expand(text: str, image_hw: List[Tuple[int, int]], cfg: Dict[str, Any],
           s: Dict[str, int]) -> str:
    return family.expand_each(text, ["<image>" * image_tokens(hw, cfg, s) for hw in image_hw])


def encode_image(params, cfg: Dict[str, Any], s, pixels, mask, prec) -> torch.Tensor:
    """The valid patches' SigLIP features, projected to the text width."""
    feats = plain.vit(params["vision"], s, cfg["vision_config"]["layer_norm_eps"], pixels, mask,
                      False, prec)
    return prec.mm(feats[mask.reshape(-1) > 0], params["projector"]["fc"])
