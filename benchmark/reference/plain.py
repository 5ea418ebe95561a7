"""The plain reference: what the LVLM families share, in float32, in plain
PyTorch (each family's own parts, such as its connector, are in
``reference/<family>.py``).

Written from the published architectures (SigLIP, Mistral / Qwen2) and the
MimIC method, with no kernel, cache or batching of the program, and nothing
imported from it.
It takes the raw images and texts a cell made and works out again whatever
the program's processor and collator derive from them (PIL-exact resizing,
normalisation, patch masks, byte-level token ids, padding, the gathered query
rows), then runs the model layer by layer.

Semantics the program fixes and this file follows (each is the MimIC
reference's or HF's):

- log Z2 of the MimIC gate is the logsumexp of the scores over every key
  present, ignoring the causal and padding masks: in a cacheless pass every
  key of the (padded) sequence; during generation the whole padded prompt for
  prompt rows, and the keys up to and including its own for a generated row.
- A row with no attendable key (a left pad) is the mean of v over those keys.
- Weights are stored [in, out]; patches are flattened (row, column, channel).

``Precision("fp32")`` runs every product in float32 with TF32 off (the
reference); ``Precision("fp8")`` rounds both operands of every linear layer
to float8 e4m3 with a scale per row and per output column (the control: the
nearest precision below the bf16 the configurations state).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Tree = Dict[str, Any]

# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def _fake_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.kind == "fp8":
            x, w = _fake_fp8(x, -1), _fake_fp8(w, 0)
        return x @ w


class no_tf32:
    """Float32 products in float32: TF32 off for the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


# ---------------------------------------------------------------------------
# the byte-level tokenizer (the configurations' assumed tokenizer)
# ---------------------------------------------------------------------------

SPECIALS = {"<pad>": 256, "<s>": 257, "</s>": 258, "<image>": 259,
            "<fake_token_around_image>": 260, "<end_of_utterance>": 261,
            "<|im_start|>": 262, "<|im_end|>": 263}
PAD, BOS, EOS, IMAGE = 256, 257, 258, 259
_ORDERED = sorted(SPECIALS, key=len, reverse=True)


def encode(text: str) -> List[int]:
    """BOS, then specials matched longest first, every other character as its
    UTF-8 bytes."""
    ids, i = [BOS], 0
    while i < len(text):
        for tok in _ORDERED:
            if text.startswith(tok, i):
                ids.append(SPECIALS[tok])
                i += len(tok)
                break
        else:
            ids.extend(text[i].encode("utf-8"))
            i += 1
    return ids


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_rows(rows: Sequence[List[int]], width: int, side: str) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.full((len(rows), width), PAD, np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for b, r in enumerate(rows):
        if len(r) > width:
            raise ValueError(f"{len(r)} tokens exceed the width {width}")
        sl = slice(width - len(r), width) if side == "left" else slice(0, len(r))
        ids[b, sl] = r
        mask[b, sl] = 1
    return ids, mask


# ---------------------------------------------------------------------------
# images: PIL's resampling, exactly (8-bit, fixed point, two passes)
# ---------------------------------------------------------------------------

_PRECISION_BITS = 22


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_FILTERS = {"bilinear": (1.0, _bilinear), "bicubic": (2.0, _bicubic)}


def _coeffs(in_size: int, out_size: int, resample: str):
    support0, fn = _FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            kk[xx, x] = int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0 else \
                int(0.5 + v * (1 << _PRECISION_BITS))
            idx[xx, x] = x + xmin
    return idx, kk


def _pass(img: np.ndarray, out_size: int, axis: int, resample: str) -> np.ndarray:
    """One pass along ``axis`` (1: columns, 0: rows) of a [H, W, 3] uint8 image."""
    idx, kk = _coeffs(img.shape[axis], out_size, resample)
    src = np.moveaxis(img.astype(np.int64), axis, 0)            # [in, other, 3]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(idx.shape[1]):
        acc += src[idx[:, j]] * kk[:, j][:, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, h: int, w: int, resample: str) -> np.ndarray:
    """``PIL.Image.resize((w, h), BILINEAR | BICUBIC)`` of an RGB uint8 array:
    the horizontal pass, then the vertical one, each rounded to 8 bits."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    out = img
    if img.shape[1] != w:
        out = _pass(out, w, 1, resample)
    if img.shape[0] != h:
        out = _pass(out, h, 0, resample)
    return out


def fitted_size(shape_hw: Tuple[int, int], proc: Dict[str, Any]) -> Tuple[int, int]:
    """The size an image of raw size ``shape_hw`` is resized to: ``longest_edge``
    keeps the aspect (longest edge ``size``, shortest at least ``min_size``),
    ``square`` stretches to ``size``."""
    size = proc["size"]
    if proc["resize"] != "longest_edge":
        return size, size
    h, w = shape_hw
    scale = size / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    if min(nh, nw) < proc["min_size"]:
        up = proc["min_size"] / min(nh, nw)
        nh, nw = min(size, round(nh * up)), min(size, round(nw * up))
    return nh, nw


def process_image(img: np.ndarray, proc: Dict[str, Any], patch: int):
    """Raw uint8 image → (normalised [size, size, 3] float32 canvas, patch
    mask [size/p, size/p] or None), as the model's image processor defines it:
    resized to ``fitted_size``, normalised, and for ``longest_edge`` put on a
    zero canvas at the top left, the patches it touches valid."""
    size = proc["size"]
    mean = np.asarray(proc["image_mean"], np.float32)
    std = np.asarray(proc["image_std"], np.float32)
    nh, nw = fitted_size(img.shape[:2], proc)
    arr = (resize(img, nh, nw, proc["resample"]).astype(np.float32) / 255.0 - mean) / std
    if proc["resize"] != "longest_edge":
        return arr, None
    canvas = np.zeros((size, size, 3), np.float32)
    canvas[:nh, :nw] = arr
    grid = size // patch
    mask = np.zeros((grid, grid), np.int64)
    mask[: -(-nh // patch), : -(-nw // patch)] = 1
    return canvas, mask


def valid_patches(shape_hw: Tuple[int, int], proc: Dict[str, Any], patch: int) -> int:
    """How many patches of an image of raw size ``shape_hw`` carry pixels:
    those it touches, within the canvas's ``size // patch`` grid (the tower
    drops a canvas's last partial patch)."""
    nh, nw = fitted_size(shape_hw, proc)
    grid = proc["size"] // patch
    return min(-(-nh // patch), grid) * min(-(-nw // patch), grid)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention; x [B, T, H, Dh], pos [B, T]."""
    Dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, Dh, 2, device=x.device, dtype=torch.float64) / Dh))
    ang = pos.double()[..., None] * inv                       # [B, T, Dh/2]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, :, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, :, None]
    rot = torch.cat([-x[..., Dh // 2:], x[..., : Dh // 2]], -1)
    return x * cos + rot * sin


def bucket_ids(mask: torch.Tensor) -> torch.Tensor:
    """NaViT position ids of a patch mask [nh, nw] whose valid region is the
    top-left nb_h x nb_w block: that block stretched over the full grid."""
    nh, nw = mask.shape
    vh = int(mask.any(1).sum().clamp_min(1))
    vw = int(mask.any(0).sum().clamp_min(1))
    dev = mask.device
    bh = torch.clamp(torch.arange(nh, device=dev) * nh // vh, max=nh - 1)
    bw = torch.clamp(torch.arange(nw, device=dev) * nw // vw, max=nw - 1)
    ids = bh[:, None] * nw + bw[None, :]
    return torch.where(mask > 0, ids, 0).reshape(-1)


def vit(vp: Tree, s: Dict[str, int], eps: float, pixels: torch.Tensor,
        mask: Optional[torch.Tensor], post_ln: bool, prec: Precision) -> torch.Tensor:
    """One image [H, W, 3] → features [N, Dv] (SigLIP)."""
    p = s["patch"]
    nh, nw = pixels.shape[0] // p, pixels.shape[1] // p
    x = pixels[: nh * p, : nw * p].float().reshape(nh, p, nw, p, 3).permute(0, 2, 1, 3, 4)
    x = prec.mm(x.reshape(nh * nw, p * p * 3), vp["patch_embed"]["kernel"])
    x = x + vp["patch_embed"]["bias"].float()
    if mask is not None:
        x = x + vp["pos_embed"][bucket_ids(mask)].float()
        valid = mask.reshape(-1) > 0
    else:
        x = x + vp["pos_embed"].float()
        valid = torch.ones(nh * nw, dtype=torch.bool, device=x.device)
    H = s["Hv"]
    Dh = s["Dv"] // H
    lay = vp["layers"]
    for l in range(s["Lv"]):
        h = layer_norm(x, lay["ln1_w"][l], lay["ln1_b"][l], eps)
        q, k, v = ((prec.mm(h, lay[f"{n}_proj"][l]) + lay[f"{n}_bias"][l].float())
                   .reshape(-1, H, Dh) for n in "qkv")
        sc = torch.einsum("thd,shd->hts", q, k) / math.sqrt(Dh)
        sc = sc.masked_fill(~valid[None, None, :], float("-inf"))
        a = torch.einsum("hts,shd->thd", torch.softmax(sc, -1), v).reshape(-1, H * Dh)
        del sc
        x = x + prec.mm(a, lay["o_proj"][l]) + lay["o_bias"][l].float()
        h = layer_norm(x, lay["ln2_w"][l], lay["ln2_b"][l], eps)
        h = F.gelu(prec.mm(h, lay["fc1"][l]) + lay["fc1_bias"][l].float(), approximate="tanh")
        x = x + prec.mm(h, lay["fc2"][l]) + lay["fc2_bias"][l].float()
    if post_ln:
        x = layer_norm(x, vp["post_ln_w"], vp["post_ln_b"], eps)
    return x


def attention(q, k, v, allowed, u_range):
    """Softmax attention of one row of a batch.

    q [T, H, Dh], k / v [S, H, Dh] (heads already expanded), ``allowed``
    [T, S] (the causal and padding masks), ``u_range`` [T, S]: the keys each
    row's log Z2 spans, which are also the keys a row with no attendable key
    averages.  Returns (out [T, H, Dh], log Z2 [T, H])."""
    sc = torch.einsum("thd,shd->hts", q, k) / math.sqrt(q.shape[-1])
    dead = ~allowed.any(-1)                                     # [T]
    eff = torch.where(dead[:, None], u_range, allowed)
    p = torch.softmax(sc.masked_fill(~eff[None], float("-inf")), -1)
    # a dead row: every key of its range alike (its scores are ignored)
    p = torch.where(dead[None, :, None], eff[None].float() / eff.sum(-1)[None, :, None], p)
    out = torch.einsum("hts,shd->thd", p, v)
    lse_u = torch.logsumexp(sc.masked_fill(~u_range[None], float("-inf")), -1).transpose(0, 1)
    return out, lse_u


def decoder(dp: Tree, s: Dict[str, int], tc: Dict[str, Any], embeds: torch.Tensor,
            key_ok: torch.Tensor, shift: Optional[Tree], u_len: Optional[torch.Tensor],
            capture_idx: Optional[torch.Tensor], prec: Precision, bias: bool,
            remat: bool = False):
    """The text tower over ``embeds`` [B, T, D].

    ``key_ok`` [B, T]: real tokens; positions count them from 0 (a left pad
    sits at 0).  ``u_len`` [T]: row t's log Z2 spans keys [0, u_len[t]); None:
    every key.  ``shift``: the multi-head MimIC shift or None.  Returns
    (final hidden [B, T, D], MLP block outputs at ``capture_idx`` [L, B, M, D]
    or None)."""
    B, T, D = embeds.shape
    H, Hkv, Dh, L = s["H"], s["Hkv"], s["Dh"], s["L"]
    eps, theta = tc["rms_norm_eps"], tc["rope_theta"]
    dev = embeds.device
    pos = (torch.cumsum(key_ok.long(), -1) - 1).clamp_min(0)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    keys = torch.arange(T, device=dev)
    u_range = (keys[None, :] < (u_len if u_len is not None
                                else torch.full((T,), T, device=dev))[:, None])
    lay = dp["layers"]

    def layer(x, l):
        h = rms_norm(x, lay["input_ln"][l], eps)
        q = prec.mm(h, lay["q_proj"][l])
        k = prec.mm(h, lay["k_proj"][l])
        v = prec.mm(h, lay["v_proj"][l])
        if bias:
            q, k, v = (q + lay["q_bias"][l].float(), k + lay["k_bias"][l].float(),
                       v + lay["v_bias"][l].float())
        q = rope(q.reshape(B, T, H, Dh), pos, theta)
        k = rope(k.reshape(B, T, Hkv, Dh), pos, theta).repeat_interleave(H // Hkv, 2)
        v = v.reshape(B, T, Hkv, Dh).repeat_interleave(H // Hkv, 2)
        outs = []
        for b in range(B):
            a, lse_u = attention(q[b], k[b], v[b], causal & key_ok[b][None, :].bool(), u_range)
            if shift:
                mu = torch.sigmoid(torch.einsum("thd,hd->th", q[b], shift["attn_logz1_w"][l])
                                   + shift["attn_logz1_b"][l] - lse_u)
                a = a + mu[..., None] * shift["attn_v"][l]
            outs.append(a)
        a = torch.stack(outs).reshape(B, T, H * Dh)
        x = x + prec.mm(a, lay["o_proj"][l])
        h = rms_norm(x, lay["post_ln"][l], eps)
        f = prec.mm(F.silu(prec.mm(h, lay["gate_proj"][l])) * prec.mm(h, lay["up_proj"][l]),
                    lay["down_proj"][l])
        cap = None
        if capture_idx is not None:
            cap = torch.gather(f, 1, capture_idx[..., None].expand(-1, -1, D))
        return x + f, cap

    x, caps = embeds.float(), []
    for l in range(L):
        if remat:
            x, cap = torch.utils.checkpoint.checkpoint(layer, x, l, use_reentrant=False)
        else:
            x, cap = layer(x, l)
        caps.append(cap)
    x = rms_norm(x, dp["final_ln"], eps)
    return x, (torch.stack(caps) if capture_idx is not None else None)


def splice(embeds: torch.Tensor, ids: torch.Tensor, feats: List[torch.Tensor]) -> torch.Tensor:
    """Each row's image-token positions, in order, take its images' features
    (a list per row of [S, D] tensors)."""
    rows = []
    for b in range(ids.shape[0]):
        pos = torch.nonzero(ids[b] == IMAGE).flatten()
        f = torch.cat(feats[b]) if feats[b] else embeds.new_zeros(0, embeds.shape[-1])
        if f.shape[0] != pos.numel():
            raise ValueError(f"row {b}: {pos.numel()} image tokens for {f.shape[0]} features")
        e = embeds[b].clone()
        e[pos] = f
        rows.append(e)
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# MimIC's losses and the optimizer (AdamW after a global-norm clip)
# ---------------------------------------------------------------------------


def ce_loss(logits, ids, mask):
    """Next-token cross-entropy over positions whose next token is real."""
    lp = torch.log_softmax(logits[:, :-1], -1)
    nll = -torch.gather(lp, -1, ids[:, 1:, None])[..., 0]
    m = mask[:, 1:].float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def mse_loss(shift_caps, rec_caps, valid):
    """Layer-wise MSE at the paired query rows: a sample's mean over layers,
    valid rows and width, then the batch mean."""
    sq = (shift_caps - rec_caps).square().sum(-1)                 # [L, B, M]
    sq = torch.where(valid[None], sq, 0.0)
    L, B, _, D = shift_caps.shape
    per = sq.sum((0, 2)) / (L * valid.sum(1).clamp_min(1) * D)
    return per.mean()


def schedule(opt: Dict[str, Any], count: int) -> float:
    peak, warm, total_steps = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if count < warm:
        return peak * min(count / max(warm, 1), 1.0)
    progress = min(max((count - warm) / max(total_steps - warm, 1), 0.0), 1.0)
    return peak * 0.5 * (1.0 + math.cos(math.pi * progress))


def decayed(name: str) -> bool:
    return "bias" not in name and "logz1_b" not in name


def adamw(params: Tree, grads: Tree, state: Dict[str, Any], opt: Dict[str, Any]):
    """One update; returns (params, state, the clipped gradients)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    clip = opt["grad_clip"]
    g = {k: (v / norm * clip if norm >= clip else v) for k, v in grads.items()}
    count = state["count"] + 1
    out, mu, nu = {}, {}, {}
    lr = schedule(opt, state["count"])
    for k, x in g.items():
        mu[k] = (1 - b1) * x + b1 * state["mu"][k]
        nu[k] = (1 - b2) * x * x + b2 * state["nu"][k]
        u = (mu[k] / (1 - b1 ** count)) / (torch.sqrt(nu[k] / (1 - b2 ** count)) + eps)
        if decayed(k):
            u = u + opt["weight_decay"] * params[k]
        out[k] = params[k] - lr * u
    return out, {"count": count, "mu": mu, "nu": nu}, g
