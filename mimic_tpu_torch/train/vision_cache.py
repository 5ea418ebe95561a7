"""Vision-feature cache for training (counterpart of ``mimic_tpu/train/vision_cache.py``).

The MimIC train loader resamples its demonstrations from one fixed train set
and the vision tower is frozen, so every demo image's features are constants
that an uncached step recomputes step after step.  ``TrainVisionCache`` is a
``train_loop`` batch transform: it swaps each ``TrainBatch``'s pixel fields
for cached encoded features (``models/feature_cache.py``; keys from
``TrainCollator(emit_image_keys=True)``), which the step consumes as
``full_feats`` / ``query_feats`` (``train/step.py::compute_loss``).  After the
first epoch every train image is a hit and the step runs no vision tower.

Features are the encode function's own outputs; against the uncached step the
loss may differ by float ulps where the encode batches differ in shape.
Inline-splice families only (idefics1 is rejected).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..bridge import tree_leaves
from ..models.config import ModelConfig
from ..models.feature_cache import VisionFeatureCache
from .collate import TrainBatch
from .step import to_device_batch

_PIXEL_FIELDS = ("pixels", "pixel_mask", "patch_mask")


class TrainVisionCache:
    """Batch transform: ``TrainBatch`` → device dict with cached image features."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        max_bytes: int = 2 * 1024 * 1024 * 1024,
        attn_impl: Optional[str] = None,
    ):
        if cfg.family == "idefics1":
            raise ValueError("train vision cache does not support cross-attention families")
        self.cfg = cfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        # the kernels on the card, plain attention on the CPU
        self.attn_impl = attn_impl or ("flash" if self.device.type == "cuda" else "xla")
        self.cache = VisionFeatureCache(max_bytes=max_bytes)

    def __call__(self, tb: TrainBatch) -> Dict[str, torch.Tensor]:
        cached = [p for p in ("full", "query")
                  if getattr(tb, f"{p}_image_keys") is not None
                  and getattr(tb, f"{p}_pixels") is not None]
        # features replace the pixel path entirely (the inline splice needs
        # only the input ids), so the pixels of a cached pass never move
        batch = to_device_batch(dataclasses.replace(
            tb, **{f"{p}_{s}": None for p in cached for s in _PIXEL_FIELDS}), self.device)
        for p in cached:
            batch[f"{p}_feats"] = self.cache.get_features(
                self.params, self.cfg, getattr(tb, f"{p}_pixels"),
                getattr(tb, f"{p}_patch_mask"), getattr(tb, f"{p}_image_keys"),
                attn_impl=self.attn_impl,
            )
        return batch
