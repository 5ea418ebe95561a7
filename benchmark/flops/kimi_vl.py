"""Operations and bytes of Kimi-VL from shapes (``benchmark/lib/counting.py``'s
rules: products of linear layers and attention at 2 operations a
multiply-add, activation gradients only where a gradient passes, nothing
recomputed, a pass with the shift over every row and one without over its
real rows).

What differs from the dense towers:

- Latent attention: q_proj, kv_a_proj, kv_b_proj and o_proj a row; scores
  at Dq (192) a pair and head, P·V at Dh (128).
- Routed experts: the router and each row's k experts' SwiGLU and the
  shared experts' a row (layer 0 is dense).
- MoonViT over each image's patches (``counting.vit``) and the projector
  over its merged patches.

Besides the step's ``model_flops`` and the attention bounds that the shared
roofline metrics read, two bounds of this family's own kernels:
``mla_attn_fwd_bound_s`` (the decoder's attention forward calls alone) and
``moe_gemm_bound_s`` (the routed grouped products, forward and activation
backward, each call reading every expert's weights once).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from benchmark.lib import counting
from benchmark.lib.counting import BF16, F32, pairs, seconds


def attn_linear(s: Dict[str, int]) -> float:
    """Latent attention's projections, a row."""
    D, H, Dq, Dh, Dn, R = (s[k] for k in ("D", "H", "Dq", "Dh", "Dn", "R"))
    return 2.0 * (D * H * Dq + D * (R + s["Dr"]) + R * H * (Dn + Dh) + H * Dh * D)


def mlp_linear(s: Dict[str, int], layer: int) -> float:
    """The MLP of ``layer``, a row: dense SwiGLU, or router + k experts + shared."""
    D = s["D"]
    if layer < s["K"]:
        return 6.0 * D * s["F"]
    return 2.0 * D * s["E"] + 6.0 * D * (s["topk"] * s["Fe"] + s["Fs"])


def _attn_ops(s: Dict[str, int], g: Dict[str, float], shift: bool) -> float:
    H, Dq, Dh = s["H"], s["Dq"], s["Dh"]
    if shift:
        return 2.0 * H * (Dq * g["all_pairs"] + Dh * (g["pairs"] + g["dead"] * g["S"]))
    return 2.0 * H * (Dq + Dh) * g["pairs"]


def decoder_forward(s: Dict[str, int], g: Dict[str, float], shift: bool) -> float:
    rows = g["rows"]
    return sum(rows * (attn_linear(s) + mlp_linear(s, l)) + _attn_ops(s, g, shift)
               for l in range(s["L"]))


def decoder_backward(s: Dict[str, int], g: Dict[str, float]) -> float:
    """Activation gradients of the shift pass down to every layer's shift:
    layer 0 through o_proj and its MLP only."""
    H, Dq, Dh, D = s["H"], s["Dq"], s["Dh"], s["D"]
    attn = 4.0 * H * (Dq * g["all_pairs"] + Dh * g["pairs"])
    upper = sum(g["rows"] * (attn_linear(s) + mlp_linear(s, l)) + attn for l in range(1, s["L"]))
    return upper + g["rows"] * (2.0 * H * Dh * D + mlp_linear(s, 0))


def connector(s: Dict[str, int], n_valid) -> float:
    """The projector over each image's merged patches."""
    tokens = np.asarray(n_valid, float).sum() / s["merge"] ** 2
    wide = s["merge"] ** 2 * s["Dv"]
    return 2.0 * tokens * (wide * wide + wide * s["D"])


def mla_attn_fwd_bound(s: Dict[str, int], g: Dict[str, float], shift: bool) -> float:
    """Seconds: a pass's latent-attention forward calls (one a layer): q, k
    (Dq) and v (Dh) read, o (Dh) written, lse and lse_u with the shift."""
    H, Dq, Dh = s["H"], s["Dq"], s["Dh"]
    keys = g["B"] * g["S"] if shift else g["keys"]
    byts = (g["rows"] * H * (Dq + Dh) * BF16 + keys * H * (Dq + Dh) * BF16
            + (2 * g["rows"] * H * F32 if shift else 0.0))
    return s["L"] * seconds(byts, _attn_ops(s, g, shift))


def mla_attn_bwd_bound(s: Dict[str, int], g: Dict[str, float]) -> float:
    """Seconds: the shift pass's backward calls (layers 1..L-1): q, o, dO read
    and dq written a row; k, v read and dk, dv written a key; lse, lse_u and
    the gradient of lse_u read."""
    H, Dq, Dh = s["H"], s["Dq"], s["Dh"]
    ops = 4.0 * H * (Dq * g["all_pairs"] + Dh * g["pairs"])
    byts = (2 * g["rows"] * H * (Dq + Dh) * BF16 + 2 * g["B"] * g["S"] * H * (Dq + Dh) * BF16
            + 3 * g["rows"] * H * F32)
    return (s["L"] - 1) * seconds(byts, ops)


def moe_gemm_bound(s: Dict[str, int], rows: float, backward: bool) -> float:
    """Seconds: one pass's routed grouped products over ``rows`` rows (gate,
    up, down a layer; the same three against the transposed weights in the
    backward): every expert's weights read once a call, the rows' k
    assignments read and written."""
    D, Fe, E, k = s["D"], s["Fe"], s["E"], s["topk"]
    n = rows * k
    weights = E * D * Fe * BF16
    per_layer = (2 * seconds(weights + n * (D + Fe) * BF16, 2.0 * n * D * Fe)   # gate, up
                 + seconds(weights + n * (Fe + D) * BF16, 2.0 * n * Fe * D))    # down
    return s["Lm"] * per_layer * (2 if backward else 1)


def train_step(s: Dict[str, int], geo: Dict[str, Any]) -> Dict[str, float]:
    """One MimIC step (``counting.train_step``'s parts, this family's tower)."""
    images = np.concatenate([geo["rec_valid"], geo["shift_valid"]])
    rec = pairs(geo["rec_key_ok"], "real")
    sh = pairs(geo["shift_key_ok"], "all")
    flops = (counting.vit(s, images) + connector(s, images)
             + decoder_forward(s, rec, shift=False) + counting.lm_head(s, rec["B"])
             + decoder_forward(s, sh, shift=True) + 2 * counting.lm_head(s, geo["ce_rows"])
             + decoder_backward(s, sh))
    mla = mla_attn_fwd_bound(s, rec, shift=False) + mla_attn_fwd_bound(s, sh, shift=True)
    return {"model_flops": flops,
            "attn_fwd_bound_s": counting.vit_attn_bound(s, images) + mla,
            "attn_bwd_bound_s": mla_attn_bwd_bound(s, sh),
            "mla_attn_fwd_bound_s": mla,
            "moe_gemm_bound_s": (moe_gemm_bound(s, rec["rows"], backward=False)
                                 + moe_gemm_bound(s, sh["rows"], backward=True))}


def eval_call(s: Dict[str, int], geo: Dict[str, Any]) -> Dict[str, float]:
    """One beam-search call: the vision path, the prefill with the shift,
    the last row's logits, then ``new_tokens - 1`` cached steps."""
    images = np.asarray(geo["valid"])
    pre = pairs(geo["prompt_key_ok"], "all")
    rows = int(pre["B"]) * geo["beams"]
    real = float(np.asarray(geo["prompt_key_ok"]).sum(1).mean())
    H, Dq, Dh = s["H"], s["Dq"], s["Dh"]
    steps = 0.0
    for i in range(1, geo["new_tokens"]):
        attn = 2.0 * H * (Dq * (pre["S"] + i) + Dh * (real + i))
        steps += sum(rows * (attn_linear(s) + mlp_linear(s, l)) + rows * attn
                     for l in range(s["L"])) + counting.lm_head(s, rows)
    flops = (counting.vit(s, images) + connector(s, images) + decoder_forward(s, pre, shift=True)
             + counting.lm_head(s, pre["B"]) + steps)
    mla = mla_attn_fwd_bound(s, pre, shift=True)
    return {"model_flops": flops, "attn_fwd_bound_s": counting.vit_attn_bound(s, images) + mla,
            "mla_attn_fwd_bound_s": mla,
            "moe_gemm_bound_s": moe_gemm_bound(s, pre["rows"], backward=False)}
