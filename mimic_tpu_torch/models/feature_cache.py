"""Content keys for source images (from ``mimic_tpu/models/feature_cache.py``).

Only ``image_key`` lives here so far: the training collator uses it to label
the images of a batch.  The keyed vision-feature cache itself is not ported
yet.
"""

from __future__ import annotations

import hashlib
from typing import Any, Tuple

import numpy as np

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
