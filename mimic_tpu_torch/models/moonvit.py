"""MoonViT, Kimi-VL's vision tower, its projector and its processor.

It has no counterpart in the JAX package, whose towers take fixed canvases.
MoonViT reads each image at its own resolution (at most ``in_token_limit``
patches of 14 px, the image padded with black to a multiple of 28 px): a
SigLIP-shaped tower (pre-norm LayerNorms, q/k/v and output biases, a
GELU-tanh MLP, a final LayerNorm) whose patches take a learnable
``(image_size / patch)``² position table interpolated bicubically to the
image's patch grid, and a 2D RoPE on q and k whose rotary pairs alternate
between the patch's column and its row.  Every 2 x 2 patches are merged into
one token: each patch LayerNorm-ed, the four side by side (4 x 1152), then
Linear, GELU, Linear to the text width.

Layout, chosen so that nothing waits for the host on the card:

- The processor emits each image's patches in merge order (the 2 x 2 groups
  one after another, the groups row by row), so the merge is a reshape, and
  pads every image to the batch's largest patch count: ``pixel_values``
  ``[B, N, P, 14·14·3]`` (a patch flattened row, column, channel),
  ``patch_mask`` ``[B, N, P]`` holding 0 on padding and 1 + row·2¹⁶ + column
  on a patch.  Attention is order-free, and a patch's row and column give its
  RoPE angles and its position embedding, so no step needs the grid on the
  host.
- The tower runs each image as one row of ``[B·N, P]``, its padding masked
  out of the keys (the D72 attention kernels on the card, ``P`` padded to a
  multiple of 128): no image attends another's patches.
- ``encode`` returns each text row's image tokens in order, the real ones of
  its images first: ``[B, N·P/4, D]``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_attention import ONEPASS_MAX_S_NONCAUSAL, flash_attention
from .config import ModelConfig, VisionConfig
from .decoder import dense_init
from .layers import gelu_act, sdpa_with_lse
from .processor import SIGLIP_MEAN, SIGLIP_STD, ImageProcessor, LVLMProcessor
from .tokenizer import SpecialTokens
from .vision import layer_norm

Params = Dict[str, Any]

ROW_SHIFT = 16  # patch_mask = 1 + row << ROW_SHIFT + column
PROJECTOR_NORM_EPS = 1e-5


def init_projector(vision_dim: int, merge: int, text_dim: int, generator, device,
                   dtype=torch.float32) -> Params:
    """The merge's projector: a LayerNorm of the tower's width, then
    Linear (merge² · width → the same), GELU, Linear (→ the text width)."""
    wide = merge * merge * vision_dim
    return {
        "ln_w": torch.ones(vision_dim, dtype=dtype, device=device),
        "ln_b": torch.zeros(vision_dim, dtype=dtype, device=device),
        "fc1": dense_init(generator, (wide, wide), dtype, device),
        "fc1_bias": torch.zeros(wide, dtype=dtype, device=device),
        "fc2": dense_init(generator, (wide, text_dim), dtype, device),
        "fc2_bias": torch.zeros(text_dim, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------


def patch_rows_cols(codes: torch.Tensor):
    """patch_mask codes [R, P] → (valid, row, column, grid height, grid width)
    on the device: pads at row and column 0, the grid from the image's largest
    row and column."""
    valid = codes > 0
    x = (codes - 1).clamp_min(0)
    r, c = x >> ROW_SHIFT, x & ((1 << ROW_SHIFT) - 1)
    h = torch.where(valid, r, -1).amax(1, keepdim=True) + 1
    w = torch.where(valid, c, -1).amax(1, keepdim=True) + 1
    return valid, r, c, h.clamp_min(1), w.clamp_min(1)


def _cubic_weights(t: torch.Tensor, a: float = -0.75):
    """PyTorch's bicubic convolution weights of the taps at -1, 0, 1, 2."""

    def near(x):  # |x| <= 1
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def far(x):  # 1 < |x| < 2
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    return far(t + 1), near(t), near(1 - t), far(2 - t)


def _taps(dst: torch.Tensor, out_size: torch.Tensor, in_size: int):
    """``F.interpolate(mode="bicubic", align_corners=False)``'s four source
    indices and weights along one axis, for output index ``dst`` of an axis of
    ``out_size`` read from ``in_size``."""
    real = (in_size / out_size.float()) * (dst.float() + 0.5) - 0.5
    base = torch.clamp(torch.floor(real), max=in_size - 1)
    t = (real - base).clamp(0, 1).float()
    base = base.long()
    idx = [(base - 1 + k).clamp(0, in_size - 1) for k in range(4)]
    return idx, _cubic_weights(t)


def interpolated_positions(table: torch.Tensor, r, c, h, w) -> torch.Tensor:
    """The position table [G·G, C], bicubically resized to each image's
    (h, w) grid as ``F.interpolate`` resizes it, at each patch's (r, c):
    [R, P, C] in fp32."""
    G = math.isqrt(table.shape[0])
    grid = table.reshape(G, G, -1).float()
    iy, wy = _taps(r, h, G)
    ix, wx = _taps(c, w, G)
    out = None
    for a in range(4):
        for b in range(4):
            term = grid[iy[a], ix[b]] * (wy[a] * wx[b])[..., None]
            out = term if out is None else out + term
    return out


def rope_2d(x: torch.Tensor, r, c, theta: float) -> torch.Tensor:
    """MoonViT's 2D RoPE on x [R, P, H, Dh]: rotary pair j (elements 2j and
    2j + 1) turns by column · f_(j/2) for even j and row · f_(j/2) for odd j,
    f_k = theta^(-4k / Dh); computed in fp32, returned in x's dtype."""
    Dh = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, Dh, 4, device=x.device)[: Dh // 4].float() / Dh)
    pos = torch.stack([c, r], -1).float()                              # [R, P, 2]
    ang = (pos[..., None, :] * freqs[:, None]).reshape(*r.shape, Dh // 2)  # pairs in order
    cos, sin = ang.cos()[:, :, None], ang.sin()[:, :, None]
    xr = x.float().reshape(*x.shape[:-1], Dh // 2, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], -1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# the tower, the projector, the whole path
# ---------------------------------------------------------------------------


def moonvit_forward(params: Params, cfg: VisionConfig, patches: torch.Tensor,
                    codes: torch.Tensor, attn_impl: str = "xla") -> torch.Tensor:
    """patches [R, P, p·p·3], codes [R, P] (``patch_mask``) → features
    [R, P, D] after the final LayerNorm (padding rows hold values that nothing
    reads).  ``attn_impl="flash"``: the attention kernels over P padded to a
    multiple of 128."""
    w_dtype = params["patch_embed"]["kernel"].dtype
    x = patches.to(w_dtype) @ params["patch_embed"]["kernel"] + params["patch_embed"]["bias"]
    valid, r, c, h, w = patch_rows_cols(codes)
    x = x + interpolated_positions(params["pos_embed"], r, c, h, w).to(x.dtype)
    R, P, D = x.shape
    H = cfg.num_heads
    Dh = D // H
    use_flash = attn_impl == "flash"
    if use_flash:
        n128 = P + (-P) % 128
        n_pad = (-P) % (128 if n128 <= ONEPASS_MAX_S_NONCAUSAL else 1024)
        x, r, c = F.pad(x, (0, 0, 0, n_pad)), F.pad(r, (0, n_pad)), F.pad(c, (0, n_pad))
        key_mask = F.pad(valid.to(torch.int32), (0, n_pad))
    else:
        key_mask = valid[:, None, None, :]
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {name: t[l] for name, t in layers.items()}
        hn = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
        q, k, v = ((hn @ lp[f"{n}_proj"] + lp[f"{n}_bias"]).reshape(R, -1, H, Dh) for n in "qkv")
        q, k = rope_2d(q, r, c, cfg.rope_theta), rope_2d(k, r, c, cfg.rope_theta)
        if use_flash:
            attn, _, _ = flash_attention(q, k, v, key_mask, causal=False, need_unmasked=False)
        else:
            attn, _ = sdpa_with_lse(q, k, v, mask=key_mask)
        x = x + attn.reshape(R, -1, D) @ lp["o_proj"] + lp["o_bias"]
        hn = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
        hn = gelu_act(hn @ lp["fc1"] + lp["fc1_bias"], cfg.hidden_act)
        x = x + hn @ lp["fc2"] + lp["fc2_bias"]
    if x.shape[1] != P:
        x = x[:, :P].contiguous()  # whole rows for the norm kernel
    return layer_norm(x, params["post_ln_w"], params["post_ln_b"], cfg.norm_eps)


def project(params: Params, feats: torch.Tensor, merge: int) -> torch.Tensor:
    """[R, P, Dv] in merge order → [R, P / merge², D]."""
    R, P, Dv = feats.shape
    x = layer_norm(feats, params["ln_w"], params["ln_b"], PROJECTOR_NORM_EPS)
    x = x.reshape(R, P // merge ** 2, merge ** 2 * Dv)
    x = F.gelu(x @ params["fc1"] + params["fc1_bias"], approximate="none")
    return x @ params["fc2"] + params["fc2_bias"]


def encode(params: Params, cfg: ModelConfig, pixel_values: torch.Tensor,
           patch_mask: torch.Tensor, attn_impl: str = "xla") -> torch.Tensor:
    """pixel_values [B, N, P, p·p·3], patch_mask [B, N, P] → each row's image
    tokens [B, N·P/m², D], its images' real tokens first and in order."""
    B, N, P = patch_mask.shape
    m = cfg.vision.merge_kernel
    codes = patch_mask.reshape(B * N, P)
    feats = moonvit_forward(params["vision"], cfg.vision, pixel_values.reshape(B * N, P, -1),
                            codes, attn_impl)
    tokens = project(params["projector"], feats, m)
    D = tokens.shape[-1]
    tokens = tokens.reshape(B, N * (P // m ** 2), D)
    pad = (codes[:, :: m * m] == 0).reshape(B, -1).to(torch.uint8)
    order = torch.argsort(pad, dim=1, stable=True)
    return torch.gather(tokens, 1, order[..., None].expand(-1, -1, D))


# ---------------------------------------------------------------------------
# the processor
# ---------------------------------------------------------------------------


class MoonViTProcessor(LVLMProcessor):
    """Kimi-VL's image processing and token expansion: each image resized
    (bicubic) only where it has more than ``in_token_limit`` patches, padded
    with black to a multiple of ``patch · merge`` pixels, normalised with mean
    and std 0.5, cut into patches in merge order; each ``<image>`` becomes
    one ``<image>`` token per merged patch of its own image."""

    def __init__(self, cfg: ModelConfig, tokenizer, image_size: Optional[int] = None):
        super().__init__(cfg, tokenizer)
        v = cfg.vision
        self.merge, self.limit = v.merge_kernel, v.in_token_limit
        self.image_processor = ImageProcessor(size=v.image_size, mean=SIGLIP_MEAN,
                                              std=SIGLIP_STD, resample="bicubic")

    def _prepare(self, image) -> np.ndarray:
        """A raw image → the uint8 array the patches are cut from."""
        arr = self.image_processor._to_array(image)
        p, unit = self.patch_size, self.patch_size * self.merge
        h, w = arr.shape[:2]
        if (w // p) * (h // p) > self.limit:
            scale = math.sqrt(self.limit / ((w // p) * (h // p)))
            arr = self.image_processor._resize(arr, int(h * scale), int(w * scale))
            h, w = arr.shape[:2]
        out = np.zeros((h + (-h) % unit, w + (-w) % unit, 3), np.uint8)
        out[:h, :w] = arr
        return out

    def grid(self, image) -> tuple:
        """(rows, columns) of patches an image takes."""
        arr = self._prepare(image)
        return arr.shape[0] // self.patch_size, arr.shape[1] // self.patch_size

    def image_tokens(self, image) -> int:
        gh, gw = self.grid(image)
        return gh * gw // self.merge ** 2

    def expand_image_tokens(self, text: str, images: Optional[Sequence[Any]] = None) -> str:
        img = SpecialTokens.IMAGE
        parts = text.split(img)
        images = list(images or [])
        if len(parts) - 1 != len(images):
            raise ValueError(f"{len(parts) - 1} {img} markers for {len(images)} images")
        runs = [img * self.image_tokens(im) for im in images] + [""]
        return "".join(p + run for p, run in zip(parts, runs))

    def __call__(self, images, text, pad_to: Optional[int] = None,
                 max_images: Optional[int] = None, pixels: bool = True) -> Dict[str, np.ndarray]:
        """The base's outputs; ``pixels=False``: the token ids and masks alone
        (the images set the widths but are not cut into patches)."""
        if isinstance(text, str):
            text = [text]
            images = [images] if images is not None else None
        rows = images if images is not None else [[] for _ in text]
        batch_ids = [self.tokenizer.encode(self.expand_image_tokens(t, im), add_bos=True)
                     for t, im in zip(text, rows)]
        input_ids, attention_mask = self.tokenizer.pad_batch(batch_ids, pad_to=pad_to)
        out: Dict[str, np.ndarray] = {"input_ids": input_ids, "attention_mask": attention_mask}
        if pixels and images is not None and any(len(i) for i in images):
            px, mask, codes = self._process_images(images, max_images)
            out["pixel_values"], out["pixel_mask"], out["patch_mask"] = px, mask, codes
        return out

    def _patches(self, image):
        """(patches [n, p·p·3] in merge order, codes [n]) of one image."""
        arr = self._prepare(image)
        p, m = self.patch_size, self.merge
        gh, gw = arr.shape[0] // p, arr.shape[1] // p
        x = (arr.astype(np.float32) / 255.0 - np.asarray(self.image_processor.mean, np.float32)) \
            / np.asarray(self.image_processor.std, np.float32)
        # [gh/m, m, p, gw/m, m, p, 3] → groups row by row, the m x m patches of a group
        x = x.reshape(gh // m, m, p, gw // m, m, p, 3).transpose(0, 3, 1, 4, 2, 5, 6)
        rr, cc = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        rc = (rr * (1 << ROW_SHIFT) + cc + 1).reshape(gh // m, m, gw // m, m).transpose(0, 2, 1, 3)
        return x.reshape(gh * gw, p * p * 3), rc.reshape(-1).astype(np.int32)

    def _process_images(self, batch_images: List[List[Any]], max_images: Optional[int]):
        n_max = max(max(len(imgs) for imgs in batch_images), 1)
        if max_images is not None:
            if n_max > max_images:
                raise ValueError(f"{n_max} images exceed max_images={max_images}")
            n_max = max_images
        cut = [[self._patches(img) for img in imgs] for imgs in batch_images]
        P = max(x.shape[0] for row in cut for x, _ in row)
        B, d = len(batch_images), self.patch_size ** 2 * 3
        pixels = np.zeros((B, n_max, P, d), np.float32)
        mask = np.zeros((B, n_max), np.int32)
        codes = np.zeros((B, n_max, P), np.int32)
        for b, row in enumerate(cut):
            for i, (x, rc) in enumerate(row):
                pixels[b, i, : len(x)] = x
                codes[b, i, : len(rc)] = rc
                mask[b, i] = 1
        return pixels, mask, codes
