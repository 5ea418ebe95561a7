"""Kimi-VL (moonshotai/Kimi-VL-A3B-Instruct): a DeepSeek-V3 text tower and
MoonViT.  The family's contract is ``benchmark/README.md``'s; the published
text config sits at the top level of the configuration file, MoonViT's and
the processor's values under ``vision_config``, ``projector`` and
``processor`` (each listed under ``assumed``).

Written from the published architecture (``modeling_kimi_vl.py``,
``modeling_deepseek.py``, arXiv:2504.07491), in float32 with every product
through ``plain.Precision``, nothing imported from the program:

- Multi-head latent attention without a q LoRA: q = ``q_proj``(x) as H heads
  of nope + rope; ``kv_a_proj``(x) = latent (RMS-normed, eps 1e-6) + one
  rope key shared by every head; ``kv_b_proj``(latent) = each head's k_nope
  and v.  RoPE on the rope dims after DeepSeek-V3's pair de-interleave;
  softmax scale 1/sqrt(nope + rope).  The MimIC gate's log Z1 reads the
  post-RoPE q (192 wide), its v adds to the attention output (128 wide).
- Layers from ``first_k_dense_replace`` on: fp32 router logits, sigmoid
  scores, the top k of score + correction bias, weights the chosen scores
  over their sum times ``routed_scaling_factor``; each row's experts run
  expert by expert (each expert's weights upcast where it runs: no fp32 copy
  of the model is kept), plus the shared experts' SwiGLU.
- MoonViT on one image at its own resolution: patches row by row, the
  position table resized by ``F.interpolate`` (bicubic) to the patch grid,
  2D RoPE as complex rotations (column, row alternating), attention over the
  image's patches, a final LayerNorm; the 2 x 2 merge, the projector's
  LayerNorm, Linear, GELU, Linear.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark.lib import family
from benchmark.reference import plain

KV_NORM_EPS = 1e-6  # DeepseekV3RMSNorm's default, which kv_a_layernorm takes


def sizes(cfg: Dict[str, Any]) -> Dict[str, int]:
    v = cfg["vision_config"]
    H, Dn, Dr = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    G, merge = v["init_pos_emb_height"], v["merge_kernel_size"][0]
    s = dict(
        V=cfg["vocab_size"], D=cfg["hidden_size"], L=cfg["num_hidden_layers"], H=H, Hkv=H,
        F=cfg["intermediate_size"], Dn=Dn, Dr=Dr, Dq=Dn + Dr, Dh=cfg["v_head_dim"],
        R=cfg["kv_lora_rank"], E=cfg["n_routed_experts"], topk=cfg["num_experts_per_tok"],
        Fe=cfg["moe_intermediate_size"], Fs=cfg["moe_intermediate_size"] * cfg["n_shared_experts"],
        K=cfg["first_k_dense_replace"], Dv=v["hidden_size"], Fv=v["intermediate_size"],
        Hv=v["num_attention_heads"], patch=v["patch_size"], Lv=v["num_hidden_layers"], G=G,
        merge=merge, limit=cfg["processor"]["in_token_limit"],
    )
    s.update(Lm=s["L"] - s["K"], n_patches=G * G, image=G * s["patch"])
    return s


def specs(cfg: Dict[str, Any], s: Dict[str, int]) -> List[family.Leaf]:
    D, L, H, Dq, Dh, Dn, R = (s[k] for k in ("D", "L", "H", "Dq", "Dh", "Dn", "R"))
    K, Lm, E, F_, Fe, Fs, Dv = (s[k] for k in ("K", "Lm", "E", "F", "Fe", "Fs", "Dv"))
    layers = [("input_ln", (L, D), "norm"), ("q_proj", (L, D, H * Dq), "dense"),
              ("kv_a_proj", (L, D, R + s["Dr"]), "dense"), ("kv_a_ln", (L, R), "norm"),
              ("kv_b_proj", (L, R, H * (Dn + Dh)), "dense"), ("o_proj", (L, H * Dh, D), "dense"),
              ("post_ln", (L, D), "norm")]
    dense = [("gate_proj", (K, D, F_), "dense"), ("up_proj", (K, D, F_), "dense"),
             ("down_proj", (K, F_, D), "dense")]
    moe = [("router", (Lm, D, E), "dense"), ("router_bias", (Lm, E), "bias"),
           ("gate", (Lm, E, D, Fe), "dense"), ("up", (Lm, E, D, Fe), "dense"),
           ("down", (Lm, E, Fe, D), "dense"), ("shared_gate", (Lm, D, Fs), "dense"),
           ("shared_up", (Lm, D, Fs), "dense"), ("shared_down", (Lm, Fs, D), "dense")]
    wide = s["merge"] ** 2 * Dv
    projector = [("ln_w", (Dv,), "norm"), ("ln_b", (Dv,), "bias"), ("fc1", (wide, wide), "dense"),
                 ("fc1_bias", (wide,), "bias"), ("fc2", (wide, D), "dense"),
                 ("fc2_bias", (D,), "bias")]
    return (family.lm_leaves(s) + family.group(("lm", "decoder", "layers"), layers)
            + family.group(("lm", "decoder", "dense"), dense)
            + family.group(("lm", "decoder", "moe"), moe) + family.siglip_leaves(s)
            + family.group(("projector",), projector))


def shift_shapes(s: Dict[str, int]) -> Dict[str, Tuple[int, ...]]:
    """v on the attention output (Dh = 128), the log Z1 weight on q (Dq = 192)."""
    L, H = s["L"], s["H"]
    return {"attn_v": (L, H, s["Dh"]), "attn_logz1_w": (L, H, s["Dq"]), "attn_logz1_b": (L, H)}


def expect(cfg: Dict[str, Any], s: Dict[str, int]) -> Dict[str, Any]:
    v = cfg["vision_config"]
    return {
        "family": "kimi-vl",
        "text.vocab_size": s["V"], "text.hidden_size": s["D"], "text.num_layers": s["L"],
        "text.num_heads": s["H"], "text.num_kv_heads": s["H"], "text.intermediate_size": s["F"],
        "text.norm_eps": cfg["rms_norm_eps"], "text.rope_theta": cfg["rope_theta"],
        "text.kv_lora_rank": s["R"], "text.qk_nope_head_dim": s["Dn"],
        "text.qk_rope_head_dim": s["Dr"], "text.v_head_dim": s["Dh"],
        "text.n_routed_experts": s["E"],
        "text.num_experts_per_tok": s["topk"], "text.moe_intermediate_size": s["Fe"],
        "text.n_shared_experts": cfg["n_shared_experts"],
        "text.first_k_dense_replace": s["K"],
        "text.routed_scaling_factor": cfg["routed_scaling_factor"],
        "text.attn_bias": cfg["attention_bias"], "text.sliding_window": None,
        "text.qk_layernorm": False, "text.tie_word_embeddings": cfg["tie_word_embeddings"],
        "vision.hidden_size": s["Dv"], "vision.num_layers": s["Lv"],
        "vision.num_heads": s["Hv"], "vision.intermediate_size": s["Fv"],
        "vision.image_size": s["image"], "vision.patch_size": s["patch"],
        "vision.norm_eps": v["layer_norm_eps"], "vision.rope_theta": v["rope_theta"],
        "vision.hidden_act": "gelu_tanh", "vision.in_token_limit": s["limit"],
        "vision.merge_kernel": s["merge"],
        "vision.use_class_token": False, "vision.post_layernorm": True,
    }


# ---------------------------------------------------------------------------
# the text tower
# ---------------------------------------------------------------------------


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's ``view(d/2, 2).transpose`` of the rope dims."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def _swiglu(x, gate, up, down, prec):
    return prec.mm(F.silu(prec.mm(x, gate)) * prec.mm(x, up), down)


def moe(x: torch.Tensor, mp, l: int, s: Dict[str, int], cfg: Dict[str, Any], prec):
    """The expert MLP of MoE layer ``l`` over x [N, D] (fp32)."""
    scores = torch.sigmoid(prec.mm(x, mp["router"][l]))
    idx = torch.topk(scores + mp["router_bias"][l].float(), s["topk"], dim=-1).indices
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    out = _swiglu(x, mp["shared_gate"][l], mp["shared_up"][l], mp["shared_down"][l], prec)
    for e in range(s["E"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            y = _swiglu(x[rows], mp["gate"][l, e], mp["up"][l, e], mp["down"][l, e], prec)
            out = out.index_add(0, rows, y * w[rows, slot, None])
    return out


def decoder(params, s, cfg: Dict[str, Any], embeds, key_ok, shift, u_len, capture_idx, prec,
            remat: bool = False):
    """``plain.decoder``'s contract for the latent-attention, routed-expert tower."""
    dp = params["lm"]["decoder"]
    lay, dense, mp = dp["layers"], dp["dense"], dp["moe"]
    B, T, D = embeds.shape
    H, Dn, Dr, Dh, R = s["H"], s["Dn"], s["Dr"], s["Dh"], s["R"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    dev = embeds.device
    pos = (torch.cumsum(key_ok.long(), -1) - 1).clamp_min(0)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    keys = torch.arange(T, device=dev)
    u_range = keys[None, :] < (u_len if u_len is not None
                               else torch.full((T,), T, device=dev))[:, None]

    def layer(x, l):
        h = plain.rms_norm(x, lay["input_ln"][l], eps)
        q = prec.mm(h, lay["q_proj"][l]).reshape(B, T, H, Dn + Dr)
        ckv = prec.mm(h, lay["kv_a_proj"][l])
        kv = prec.mm(plain.rms_norm(ckv[..., :R], lay["kv_a_ln"][l], KV_NORM_EPS),
                     lay["kv_b_proj"][l]).reshape(B, T, H, Dn + Dh)
        q_pe = plain.rope(_deinterleave(q[..., Dn:]), pos, theta)
        k_pe = plain.rope(_deinterleave(ckv[..., None, R:]), pos, theta)
        q = torch.cat([q[..., :Dn], q_pe], -1)
        k = torch.cat([kv[..., :Dn], k_pe.expand(B, T, H, Dr)], -1)
        v = kv[..., Dn:]
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
        if l < s["K"]:
            f = _swiglu(h, dense["gate_proj"][l], dense["up_proj"][l], dense["down_proj"][l], prec)
        else:
            f = moe(h.reshape(B * T, D), mp, l - s["K"], s, cfg, prec).reshape(B, T, D)
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


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------


def fitted_size(shape_hw: Tuple[int, int], cfg: Dict[str, Any]) -> Tuple[int, int]:
    """The size after the processor's resize (only above ``in_token_limit``
    patches) and before its padding."""
    proc = cfg["processor"]
    p, h, w = proc["patch_size"], shape_hw[0], shape_hw[1]
    n = (w // p) * (h // p)
    if n > proc["in_token_limit"]:
        scale = math.sqrt(proc["in_token_limit"] / n)
        h, w = int(h * scale), int(w * scale)
    return h, w


def _grid(shape_hw, cfg, s) -> Tuple[int, int]:
    """(rows, columns) of patches after padding to a multiple of patch x merge."""
    unit = s["patch"] * s["merge"]
    h, w = fitted_size(shape_hw, cfg)
    return -(-h // unit) * s["merge"], -(-w // unit) * s["merge"]


def vit_rows(shape_hw: Tuple[int, int], cfg: Dict[str, Any], s: Dict[str, int]) -> int:
    gh, gw = _grid(shape_hw, cfg, s)
    return gh * gw


def image_tokens(shape_hw: Tuple[int, int], cfg: Dict[str, Any], s: Dict[str, int]) -> int:
    return vit_rows(shape_hw, cfg, s) // s["merge"] ** 2


def expand(text: str, image_hw: List[Tuple[int, int]], cfg: Dict[str, Any],
           s: Dict[str, int]) -> str:
    return family.expand_each(text, ["<image>" * image_tokens(hw, cfg, s) for hw in image_hw])


def process_image(img: np.ndarray, cfg: Dict[str, Any], s: Dict[str, int]):
    """Raw uint8 image → (the normalised padded image [gh·p, gw·p, 3], None):
    PIL's bicubic resize where it has too many patches, black padding at the
    bottom and right, then (x / 255 - mean) / std."""
    proc = cfg["processor"]
    h, w = fitted_size(img.shape[:2], cfg)
    arr = plain.resize(img, h, w, proc["resample"])
    gh, gw = _grid(img.shape[:2], cfg, s)
    p = s["patch"]
    padded = np.zeros((gh * p, gw * p, 3), np.uint8)
    padded[:h, :w] = arr
    mean = np.asarray(proc["image_mean"], np.float32)
    std = np.asarray(proc["image_std"], np.float32)
    return (padded.astype(np.float32) / 255.0 - mean) / std, None


def _rope_2d(x: torch.Tensor, gh: int, gw: int, theta: float) -> torch.Tensor:
    """x [N, H, Dh] (patches row by row) times MoonViT's complex rotations."""
    Dh = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, Dh, 4, device=x.device)[: Dh // 4].double() / Dh)
    rows, cols = torch.meshgrid(torch.arange(gh, device=x.device),
                                torch.arange(gw, device=x.device), indexing="ij")
    ang = torch.stack([torch.outer(cols.reshape(-1).double(), freqs),
                       torch.outer(rows.reshape(-1).double(), freqs)], -1).reshape(gh * gw, -1)
    cis = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)[:, None]
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], Dh // 2, 2).contiguous())
    return torch.view_as_real(xc * cis).reshape(x.shape)


def encode_image(params, cfg: Dict[str, Any], s, pixels, mask, prec) -> torch.Tensor:
    """One processed image → its tokens [(gh/2)·(gw/2), D]."""
    vp, pp = params["vision"], params["projector"]
    v = cfg["vision_config"]
    p, Dv, Hv, G, m = s["patch"], s["Dv"], s["Hv"], s["G"], s["merge"]
    eps = v["layer_norm_eps"]
    gh, gw = pixels.shape[0] // p, pixels.shape[1] // p
    x = pixels.float().reshape(gh, p, gw, p, 3).permute(0, 2, 1, 3, 4).reshape(gh * gw, -1)
    x = prec.mm(x, vp["patch_embed"]["kernel"]) + vp["patch_embed"]["bias"].float()
    table = vp["pos_embed"].float().reshape(G, G, Dv).permute(2, 0, 1)[None]
    x = x + F.interpolate(table, size=(gh, gw), mode="bicubic",
                          align_corners=False)[0].permute(1, 2, 0).reshape(gh * gw, Dv)
    Dh = Dv // Hv
    lay = vp["layers"]
    for l in range(s["Lv"]):
        h = plain.layer_norm(x, lay["ln1_w"][l], lay["ln1_b"][l], eps)
        q, k, vv = ((prec.mm(h, lay[f"{n}_proj"][l]) + lay[f"{n}_bias"][l].float())
                    .reshape(-1, Hv, Dh) for n in "qkv")
        q, k = _rope_2d(q, gh, gw, v["rope_theta"]), _rope_2d(k, gh, gw, v["rope_theta"])
        sc = torch.einsum("thd,shd->hts", q, k) / math.sqrt(Dh)
        a = torch.einsum("hts,shd->thd", torch.softmax(sc, -1), vv).reshape(-1, Dv)
        del sc
        x = x + prec.mm(a, lay["o_proj"][l]) + lay["o_bias"][l].float()
        h = plain.layer_norm(x, lay["ln2_w"][l], lay["ln2_b"][l], eps)
        h = F.gelu(prec.mm(h, lay["fc1"][l]) + lay["fc1_bias"][l].float(), approximate="tanh")
        x = x + prec.mm(h, lay["fc2"][l]) + lay["fc2_bias"][l].float()
    x = plain.layer_norm(x, vp["post_ln_w"], vp["post_ln_b"], eps)
    x = x.reshape(gh // m, m, gw // m, m, Dv).permute(0, 2, 1, 3, 4).reshape(-1, m * m, Dv)
    x = plain.layer_norm(x, pp["ln_w"], pp["ln_b"], cfg["projector"]["pre_norm_eps"])
    x = F.gelu(prec.mm(x.reshape(x.shape[0], -1), pp["fc1"]) + pp["fc1_bias"].float(),
               approximate="none")
    return prec.mm(x, pp["fc2"]) + pp["fc2_bias"].float()
