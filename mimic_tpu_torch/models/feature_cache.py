"""Keyed vision-feature cache (counterpart of ``mimic_tpu/models/feature_cache.py``).

The ICL eval resamples its demonstrations from one fixed support set, and the
MimIC train loader from one fixed train set, so the same images recur batch
after batch while the vision tower is frozen.  ``VisionFeatureCache`` keys each
image by a digest of its source (``image_key``) and keeps its encoded feature
tokens (vision tower + connector, ``models/lvlm.py::encode_images``) on the
device of the parameters:

- hits skip the vision tower and never move their pixels to the device;
- misses, deduplicated within the batch, are encoded in one call of exactly
  their number of rows under ``torch.no_grad()``.  The JAX package pads that
  call to a power-of-two row count so that XLA reuses its compiled programs;
  eager PyTorch compiles nothing, and the padding would cost up to half the
  tower's work on a cold batch;
- entries are evicted least recently used first under a byte budget
  (``max_bytes``), after the batch's features are assembled, so a hit of the
  current batch is never evicted while it is in use.

A cached feature is the encode function's own output, so every occurrence of
an image sees identical features.  Inline-splice families only: idefics1's
cross-attention is rejected.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bridge import tree_leaves
from .config import ModelConfig
from .lvlm import encode_images

# key for an all-zero padding slot (pixel_mask == 0); its features are never
# gathered by splice_image_embeds, so one shared entry per shape suffices
_PAD = "pad"


def image_key(img: Any) -> Tuple:
    """Content digest of a source image (PIL image or array-like).

    Hashing the SOURCE (pre-processing) is cheap (raw uint8 bytes) and
    subsumes the processed pixels and patch mask: one processor configuration
    per runner makes processing deterministic in the source.
    """
    if img is None:
        return (_PAD,)
    if hasattr(img, "mode") and hasattr(img, "tobytes"):  # PIL duck type
        return (
            "pil", img.mode, tuple(img.size),
            hashlib.blake2b(img.tobytes(), digest_size=16).digest(),
        )
    arr = np.ascontiguousarray(np.asarray(img))
    return (
        "arr", arr.shape, str(arr.dtype),
        hashlib.blake2b(arr.tobytes(), digest_size=16).digest(),
    )


def _rows(x: np.ndarray, idx: List[int], device: torch.device) -> torch.Tensor:
    """``x`` [B, N, ...] flattened to [B*N, ...], rows ``idx`` as [M, 1, ...] on
    ``device``; only those rows leave the host."""
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    return torch.from_numpy(np.ascontiguousarray(flat[idx]))[:, None].to(device)


class VisionFeatureCache:
    """LRU image-key → encoded-feature store, on the parameters' device."""

    def __init__(self, max_bytes: int = 512 * 1024 * 1024):
        self.max_bytes = max_bytes
        self._store: "OrderedDict[Tuple, torch.Tensor]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def clear(self) -> None:
        self._store.clear()
        self._bytes = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def get_features(
        self,
        params: Dict[str, Any],
        cfg: ModelConfig,
        pixel_values: np.ndarray,        # [B,N,H,W,C], host
        patch_mask: Optional[np.ndarray],  # [B,N,nh,nw] or None
        keys: Sequence[Tuple],           # flat, length B*N (row-major)
        attn_impl: str = "xla",
    ) -> torch.Tensor:
        """Assemble [B, N*S, D] image features, encoding only cache misses.

        ``keys[b*N + i]`` identifies ``pixel_values[b, i]``; use ``(_PAD,)``
        (``image_key(None)``) for padding slots.  Misses are deduplicated
        within the batch, so a demo image repeated across contexts encodes
        once even on a cold cache; hits never touch the vision tower.
        """
        if cfg.family == "idefics1":
            raise ValueError("feature cache does not support cross-attention families")
        B, N = pixel_values.shape[:2]
        keys = list(keys)
        if len(keys) != B * N:
            raise ValueError(f"{len(keys)} keys for {B}x{N} images")

        # ordered-unique miss keys with a representative flat index each;
        # hit entries are touched NOW so this batch's working set is MRU and
        # cannot be evicted by the insert below
        miss_order: "OrderedDict[Tuple, int]" = OrderedDict()
        for flat, k in enumerate(keys):
            if k in self._store:
                self._store.move_to_end(k)
            elif k not in miss_order:
                miss_order[k] = flat
        self.misses += len(miss_order)
        self.hits += len(keys) - len(miss_order)

        if miss_order:
            device = tree_leaves(params["vision"])[0].device
            idx = list(miss_order.values())
            px = _rows(pixel_values, idx, device)
            pm = _rows(patch_mask, idx, device) if patch_mask is not None else None
            with torch.no_grad():
                feats = encode_images(params, cfg, px, pm, attn_impl=attn_impl)  # [M, S, D]
            for j, k in enumerate(miss_order):
                # a copy of its own: a view would keep the whole batch alive
                self._store[k] = feats[j].clone()
                self._bytes += feats[j].numel() * feats.element_size()

        slices: List[torch.Tensor] = []
        for k in keys:
            slices.append(self._store[k])
            self._store.move_to_end(k)
        out = torch.stack(slices)  # [B*N, S, D]

        # evict AFTER assembly: this batch's whole working set (hits AND new
        # misses, all MRU by now) stays resident while it is being used; a
        # byte budget smaller than one batch evicts oldest-first afterwards
        while self._bytes > self.max_bytes and len(self._store) > 1:
            _, old = self._store.popitem(last=False)
            self._bytes -= old.numel() * old.element_size()

        S, D = out.shape[1], out.shape[2]
        return out.reshape(B, N * S, D)
