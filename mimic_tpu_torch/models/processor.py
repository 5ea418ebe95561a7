"""Input processing: text+images → fixed-shape model batches.

Replaces the HF processors the reference relies on
(``testbed/models/model_base.py:337-381``): prompt strings containing ``<image>``
markers are expanded into image-token runs, tokenized, padded, and paired with
preprocessed pixel arrays.

Static-shape discipline (TPU): callers may pass ``pad_to``/``max_images`` so every
batch in a run compiles once; the processor never emits data-dependent shapes when
these are set.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .config import ModelConfig
from .tokenizer import SpecialTokens

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclass
class ImageProcessor:
    """Resize + rescale + normalize → [H, W, 3] float32 arrays.

    ``mode="square"`` stretches to ``size×size`` (IdeficsImageProcessor /
    SiglipImageProcessor behavior); ``mode="shortest_crop"`` resizes the
    shortest edge to ``size`` then center-crops (CLIPImageProcessor — llava-1.5);
    ``mode="longest_edge"`` keeps the aspect ratio with the longest edge at
    ``size`` (min shortest edge ``min_size``), pads the canvas top-left, and also
    returns the valid-pixel region (Idefics2 behavior — the vision tower gets a
    patch attention mask).
    """

    size: int
    mean: Sequence[float] = SIGLIP_MEAN
    std: Sequence[float] = SIGLIP_STD
    mode: str = "square"
    min_size: int = 378
    # HF processors differ: idefics2 resizes BILINEAR, idefics1 (IdeficsImageProcessor)
    # and CLIP/SigLIP (llava) resize BICUBIC
    resample: str = "bilinear"

    def __call__(self, image) -> np.ndarray:
        arr, _ = self.process_with_region(image)
        return arr

    def process_with_region(self, image):
        """Returns (normalized [size,size,3], (valid_h, valid_w))."""
        arr = self._to_array(image)

        def normalize(a):
            a = a.astype(np.float32) / 255.0
            mean = np.asarray(self.mean, np.float32)
            std = np.asarray(self.std, np.float32)
            return (a - mean) / std

        if self.mode == "longest_edge":
            h, w = arr.shape[:2]
            scale = self.size / max(h, w)
            nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
            if min(nh, nw) < self.min_size:
                up = self.min_size / min(nh, nw)
                nh, nw = min(self.size, round(nh * up)), min(self.size, round(nw * up))
            arr = self._resize(arr, nh, nw)
            # HF order: resize → rescale → normalize → pad with 0.0 — padding
            # happens AFTER normalization, so padded pixels are exactly 0, which
            # matters for boundary patches that are only partially valid
            canvas = np.zeros((self.size, self.size, 3), np.float32)
            canvas[:nh, :nw] = normalize(arr)
            return canvas, (nh, nw)
        if self.mode == "shortest_crop":
            # HF get_resize_output_image_size(default_to_square=False) +
            # center_crop: shortest edge → size (int-truncated long edge),
            # floor-centered crop
            h, w = arr.shape[:2]
            short, long = (w, h) if w <= h else (h, w)
            new_short, new_long = self.size, int(self.size * long / short)
            nh, nw = (new_long, new_short) if w <= h else (new_short, new_long)
            arr = self._resize(arr, nh, nw)
            top = (nh - self.size) // 2
            left = (nw - self.size) // 2
            arr = arr[top:top + self.size, left:left + self.size]
            return normalize(arr), (self.size, self.size)
        arr = self._resize(arr, self.size, self.size)
        return normalize(arr), (self.size, self.size)

    @staticmethod
    def _to_array(image) -> np.ndarray:
        if isinstance(image, (str, os.PathLike)):
            from PIL import Image

            image = Image.open(image)
        if isinstance(image, np.ndarray):
            arr = image
        else:  # PIL image
            image = image.convert("RGB")
            arr = np.asarray(image)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.shape[-1] == 4:
            arr = arr[..., :3]
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr

    def _resize(self, arr: np.ndarray, h: int, w: int) -> np.ndarray:
        """Resize with the family's PIL filter: native C++ (bit-exact PIL
        reimplementation, ``native/image_ops.cpp``) → PIL → numpy fallback."""
        if arr.shape[0] == h and arr.shape[1] == w:
            return arr
        from ..native import resize_native

        out = resize_native(arr, h, w, self.resample)
        if out is not None:
            return out
        try:
            from PIL import Image

            flt = Image.BICUBIC if self.resample == "bicubic" else Image.BILINEAR
            return np.asarray(Image.fromarray(arr).resize((w, h), flt))
        except ImportError:  # pragma: no cover
            ys = np.linspace(0, arr.shape[0] - 1, h)
            xs = np.linspace(0, arr.shape[1] - 1, w)
            return arr[ys.astype(int)][:, xs.astype(int)]


class LVLMProcessor:
    """Tokenize prompts (expanding ``<image>`` markers) and preprocess images.

    Expansion by family:
    - idefics2: ``<image>`` → ``<fake><image>*n<fake>`` with adjacent runs merged
      (HF Idefics2Processor behavior)
    - llava-interleave: ``<image>`` → ``<image>*n``
    - idefics1: ``<image>`` → ``<fake><image><fake>`` (single token; vision enters
      through cross-attention, and the processor also emits image_attention_mask)
    """

    def __init__(self, cfg: ModelConfig, tokenizer, image_size: Optional[int] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        size = image_size or (cfg.vision.image_size if cfg.vision else 224)
        # CLIP towers (idefics1, llava-1.5) use OpenAI-CLIP statistics; SigLIP
        # towers (idefics2, llava-interleave) use 0.5/0.5
        clip_tower = cfg.family == "idefics1" or (
            cfg.vision is not None and cfg.vision.use_class_token
        )
        mean, std = (CLIP_MEAN, CLIP_STD) if clip_tower else (SIGLIP_MEAN, SIGLIP_STD)
        # idefics2 keeps aspect ratio (HF longest-edge resize + pixel mask);
        # llava-1.5 (CLIP tower) resizes shortest-edge + center-crops;
        # idefics1 / llava-interleave (SigLIP) use fixed square resize
        if cfg.family == "idefics2":
            mode = "longest_edge"
        elif cfg.family == "llava-interleave" and cfg.vision and cfg.vision.use_class_token:
            mode = "shortest_crop"
        else:
            mode = "square"
        self.image_processor = ImageProcessor(
            size=size, mean=mean, std=std, mode=mode,
            min_size=min(378, size),
            # idefics2 = BILINEAR (Idefics2ImageProcessor); idefics1 and the
            # CLIP/SigLIP towers of llava = BICUBIC (their HF processors)
            resample="bilinear" if cfg.family == "idefics2" else "bicubic",
        )
        self.patch_size = cfg.vision.patch_size if cfg.vision else 14

    # -- text ---------------------------------------------------------------

    def expand_image_tokens(self, text: str, images=None) -> str:
        img = SpecialTokens.IMAGE
        fake = SpecialTokens.FAKE_IMAGE
        if self.cfg.family == "llava-interleave":
            return text.replace(img, img * self.cfg.image_seq_len)
        if self.cfg.family == "idefics1":
            # HF IdeficsProcessor item-wise assembly (via the reference's split on
            # "<image>" with empty segments dropped, testbed/models/idefics.py:126-141):
            # text chunks are strip(" ")-ed; an image emits
            # "<fake><image><fake>", or "<image><fake>" directly after another
            # image (consecutive images share ONE fake token).  A whitespace-only
            # chunk between images strips to "" but still breaks the run (both
            # images keep their own fake pair) — so a blanket fake-fake merge
            # would be wrong here.
            parts = text.split(img)
            pieces = []
            last_was_image = False
            for j, seg in enumerate(parts):
                if j > 0:
                    pieces.append(img + fake if last_was_image else fake + img + fake)
                    last_was_image = True
                if seg:
                    pieces.append(seg.strip(" "))
                    last_was_image = False
            return "".join(pieces)
        expanded = text.replace(img, fake + img * self.cfg.image_seq_len + fake)
        # adjacent expansions share one fake token (HF Idefics2Processor behavior)
        return expanded.replace(fake + fake, fake)

    def __call__(
        self,
        images: Optional[List[List[Any]]],
        text: Union[str, List[str]],
        pad_to: Optional[int] = None,
        max_images: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        if isinstance(text, str):
            text = [text]
            images = [images] if images is not None else None
        batch_ids = [
            self.tokenizer.encode(self.expand_image_tokens(t), add_bos=True) for t in text
        ]
        input_ids, attention_mask = self.tokenizer.pad_batch(batch_ids, pad_to=pad_to)
        out: Dict[str, np.ndarray] = {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
        }
        if images is not None and any(len(i) for i in images):
            pixels, mask, patch_mask = self._process_images(images, max_images)
            out["pixel_values"], out["pixel_mask"] = pixels, mask
            if patch_mask is not None:
                out["patch_mask"] = patch_mask
            if self.cfg.family == "idefics1":
                out["image_attention_mask"] = self._image_attention_mask(
                    input_ids, out["pixel_values"].shape[1]
                )
        return out

    # -- images -------------------------------------------------------------

    def _process_images(self, batch_images: List[List[Any]], max_images: Optional[int]):
        n_max = max(len(imgs) for imgs in batch_images)
        if max_images is not None:
            if n_max > max_images:
                raise ValueError(f"{n_max} images exceed max_images={max_images}")
            n_max = max_images
        n_max = max(n_max, 1)
        size = self.image_processor.size
        ps = self.patch_size
        np_side = size // ps
        aspect = self.image_processor.mode == "longest_edge"
        B = len(batch_images)
        pixels = np.zeros((B, n_max, size, size, 3), np.float32)
        mask = np.zeros((B, n_max), np.int32)
        patch_mask = np.zeros((B, n_max, np_side, np_side), np.int32) if aspect else None
        for b, imgs in enumerate(batch_images):
            for i, img in enumerate(imgs):
                arr, (vh, vw) = self.image_processor.process_with_region(img)
                pixels[b, i] = arr
                mask[b, i] = 1
                if aspect:
                    # a patch attends if any of its pixels are valid (HF semantics)
                    patch_mask[b, i, : -(-vh // ps), : -(-vw // ps)] = 1
        return pixels, mask, patch_mask

    def _image_attention_mask(self, input_ids: np.ndarray, n_images: int) -> np.ndarray:
        """[B,T,n_images]: each text token attends to the nearest *preceding* image
        (Flamingo/IDEFICS semantics).  Tokens after an EOS attend to NO image until
        the next image token appears (HF ``IdeficsProcessor``
        ``image_attention_mask_for_packed_input_ids`` — the EOS token itself keeps
        its image; ``seen_eod`` is only set after the assignment)."""
        img_id = self.tokenizer.image_token_id
        eos_id = self.tokenizer.eos_token_id
        B, T = input_ids.shape
        mask = np.zeros((B, T, n_images), np.int32)
        for b in range(B):
            current = -1
            seen_eos = False
            for t in range(T):
                if input_ids[b, t] == img_id:
                    current += 1
                    seen_eos = False
                if 0 <= current < n_images and not seen_eos:
                    mask[b, t, current] = 1
                if input_ids[b, t] == eos_id:
                    seen_eos = True
        return mask
