"""Operations and bytes from shapes: the work a model needs, whatever runs it.

Counted: the products of linear layers (2 operations a multiply-add), the
attention products, the lm head.  Not counted: norms, activations, the
shift's gate, anything elementwise, anything recomputed.

- A linear layer's forward is 2·in·out a row.  Frozen weights get no weight
  gradient, so its backward is 2·in·out a row too (the input's gradient), and
  only where a gradient has to pass.
- Attention counts pairs a row may attend (causal and padding masks; every
  valid key for the vision tower): QKᵀ and PV at 2·Dh a pair and head each.
  Where the MimIC shift reads the unmasked log-normalizer (log Z2) the scores
  of every (row, key) pair are needed: QKᵀ then counts T·S pairs, and its
  gradient reaches every pair too.  A row with no attendable key (a left pad)
  is the mean of v over all keys: PV over all S.
- The backward of the shift pass needs no gradient into layer 0's q, k or v
  (they come from frozen embeddings): layer 0 runs only o_proj's and the
  MLP's backward.
- Rows: a pass that carries the shift needs every row, pads included (their
  keys enter log Z2); a pass without it needs its real tokens only.

Bytes (for the kernels' bounds) count each input read once and each output
written once, in the dtype the kernel reads and writes: bf16 q/k/v/o,
fp32 log-normalizers.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .copied import PEAK_BYTES, PEAK_OPS

BF16, F32 = 2, 4


def seconds(n_bytes: float, n_ops: float) -> float:
    """The bound of one kernel call (the copied ``bound()`` rule), in seconds."""
    return max(n_bytes / PEAK_BYTES, n_ops / PEAK_OPS["bf16"])


def pairs(key_ok: np.ndarray, rows: str) -> Dict[str, float]:
    """Causal attention geometry of a batch with key mask ``key_ok`` [B, T].

    ``rows``: "real" (a pass without the shift: real rows only) or "all"
    (every row).  Returns rows, attendable pairs, all (row, key) pairs, the
    keys some row attends, and the dead rows (no attendable key)."""
    ok = np.asarray(key_ok, bool)
    B, T = ok.shape
    seen = np.cumsum(ok, axis=1)                 # [B, T] ok keys at or before t
    use = ok if rows == "real" else np.ones_like(ok)
    dead = use & (seen == 0)
    n_rows = float(use.sum())
    att = float((seen * use).sum())
    return dict(rows=n_rows, pairs=att, all_pairs=float(use.sum() * T),
                keys=float(ok.sum()), dead=float(dead.sum()), S=float(T), B=float(B))


def linear_ops(s: Dict[str, int]) -> Dict[str, float]:
    """Multiply-adds ×2 of one decoder layer's linear parts, a row."""
    D, H, Hkv, Dh, F = s["D"], s["H"], s["Hkv"], s["Dh"], s["F"]
    qkv = 2.0 * D * (H + 2 * Hkv) * Dh
    return dict(qkv=qkv, o=2.0 * H * Dh * D, mlp=2.0 * 3 * D * F)


def decoder_forward(s: Dict[str, int], g: Dict[str, float], shift: bool) -> float:
    """One decoder pass over a batch of geometry ``g`` (``pairs``)."""
    lin = linear_ops(s)
    L, H, Dh = s["L"], s["H"], s["Dh"]
    per_layer = g["rows"] * sum(lin.values())
    if shift:
        attn = 2.0 * Dh * H * (g["all_pairs"] + g["pairs"] + g["dead"] * g["S"])
    else:
        attn = 4.0 * Dh * H * g["pairs"]
    return L * (per_layer + attn)


def decoder_backward(s: Dict[str, int], g: Dict[str, float]) -> float:
    """Activation gradients of the shift pass down to every layer's shift."""
    lin = linear_ops(s)
    L, H, Dh = s["L"], s["H"], s["Dh"]
    upper = g["rows"] * (lin["qkv"] + lin["o"] + lin["mlp"]) \
        + 4.0 * Dh * H * (g["pairs"] + g["all_pairs"])
    layer0 = g["rows"] * (lin["o"] + lin["mlp"])
    return (L - 1) * upper + layer0


def lm_head(s: Dict[str, int], rows: float) -> float:
    return 2.0 * s["D"] * s["V"] * rows


def vit(s: Dict[str, int], n_valid: np.ndarray) -> float:
    """The vision tower over images of ``n_valid`` valid patches each."""
    n = np.asarray(n_valid, float)
    Dv, Fv, Lv = s["Dv"], s["Fv"], s["Lv"]
    embed = 2.0 * n.sum() * s["patch"] ** 2 * 3 * Dv
    linear = 2.0 * n.sum() * (4 * Dv * Dv + 2 * Dv * Fv)
    attn = 4.0 * Dv * (n ** 2).sum()
    return embed + Lv * (linear + attn)


def vit_attn_bound(s: Dict[str, int], n_valid: np.ndarray) -> float:
    """Seconds: the bound of every vision-tower attention call (one a layer)."""
    n = np.asarray(n_valid, float)
    Dv = s["Dv"]
    ops = 4.0 * Dv * (n ** 2).sum()
    byts = 4.0 * n.sum() * Dv * BF16              # q, k, v read, o written
    return s["Lv"] * seconds(byts, ops)


def decoder_attn_fwd_bound(s: Dict[str, int], g: Dict[str, float], shift: bool) -> float:
    """Seconds: the bound of a pass's attention forward calls (one a layer)."""
    H, Hkv, Dh = s["H"], s["Hkv"], s["Dh"]
    if shift:
        ops = 2.0 * Dh * H * (g["all_pairs"] + g["pairs"] + g["dead"] * g["S"])
        kv_keys = g["B"] * g["S"]
        lse = 2 * g["rows"] * H * F32
    else:
        ops = 4.0 * Dh * H * g["pairs"]
        kv_keys = g["keys"]
        lse = 0.0
    byts = 2 * g["rows"] * H * Dh * BF16 + 2 * kv_keys * Hkv * Dh * BF16 + lse
    return s["L"] * seconds(byts, ops)


def decoder_attn_bwd_bound(s: Dict[str, int], g: Dict[str, float]) -> float:
    """Seconds: the bound of the shift pass's attention backward calls
    (layers 1..L-1): q, o, dO read and dq written for every row; k, v read and
    dk, dv written for every key; lse, lse_u and the gradient of lse_u read."""
    H, Hkv, Dh = s["H"], s["Hkv"], s["Dh"]
    ops = 4.0 * Dh * H * (g["pairs"] + g["all_pairs"])
    byts = (4 * g["rows"] * H * Dh * BF16 + 4 * g["B"] * g["S"] * Hkv * Dh * BF16
            + 3 * g["rows"] * H * F32)
    return (s["L"] - 1) * seconds(byts, ops)


def decode_step(s: Dict[str, int], rows: int, keys_ok: float, keys_all: float,
                shift: bool) -> float:
    """One cached decode step of ``rows`` one-token rows over ``keys_*`` keys
    a row on average (the masked read, and every key for log Z2)."""
    lin = linear_ops(s)
    H, Dh = s["H"], s["Dh"]
    qk = keys_all if shift else keys_ok
    attn = 2.0 * Dh * H * (qk + keys_ok)
    return s["L"] * rows * (sum(lin.values()) + attn) + lm_head(s, rows)


def train_step(s: Dict[str, int], geo: Dict[str, Any], connector) -> Dict[str, float]:
    """One MimIC step: the vision path for every image of both passes, the
    record pass (real rows, no shift, the last row's logits), the shift pass
    (every row, log Z2, logits where a next token is scored) and its
    backward to the shift."""
    images = np.concatenate([geo["rec_valid"], geo["shift_valid"]])
    rec = pairs(geo["rec_key_ok"], "real")
    sh = pairs(geo["shift_key_ok"], "all")
    flops = (vit(s, images) + connector(s, images)
             + decoder_forward(s, rec, shift=False) + lm_head(s, rec["B"])
             + decoder_forward(s, sh, shift=True) + 2 * lm_head(s, geo["ce_rows"])
             + decoder_backward(s, sh))
    fwd = (vit_attn_bound(s, images) + decoder_attn_fwd_bound(s, rec, shift=False)
           + decoder_attn_fwd_bound(s, sh, shift=True))
    return {"model_flops": flops, "attn_fwd_bound_s": fwd,
            "attn_bwd_bound_s": decoder_attn_bwd_bound(s, sh)}


def eval_call(s: Dict[str, int], geo: Dict[str, Any], connector) -> Dict[str, float]:
    """One beam-search call: the vision path, the prefill over the padded
    prompts (log Z2 reads every key), the last row's logits, then
    ``new_tokens - 1`` cached steps of ``B x beams`` rows."""
    images = np.asarray(geo["valid"])
    pre = pairs(geo["prompt_key_ok"], "all")
    rows = int(pre["B"]) * geo["beams"]
    real = float(np.asarray(geo["prompt_key_ok"]).sum(1).mean())
    steps = sum(decode_step(s, rows, real + i, pre["S"] + i, shift=True)
                for i in range(1, geo["new_tokens"]))
    flops = (vit(s, images) + connector(s, images) + decoder_forward(s, pre, shift=True)
             + lm_head(s, pre["B"]) + steps)
    fwd = vit_attn_bound(s, images) + decoder_attn_fwd_bound(s, pre, shift=True)
    return {"model_flops": flops, "attn_fwd_bound_s": fwd}
