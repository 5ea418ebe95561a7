"""Environment/config-driven path registry.

Replaces the reference's machine-id-switched constants (``src/paths.py:5-62``) with
environment variables so the same code runs on any host or TPU VM; values may point at
local disks or mounted GCS buckets (``/gcs/...``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Optional


def _env(name: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(name, default)


@dataclass
class Paths:
    """All external data/model/result locations.

    Each field is overridable via ``MIMIC_TPU_<UPPERCASE_FIELD>`` environment variables.
    """

    result_dir: str = "results"
    # dataset roots (same roles as reference src/paths.py)
    vqav2_dir: Optional[str] = None
    ok_vqa_dir: Optional[str] = None
    ocr_vqa_dir: Optional[str] = None
    ocr_vqa_images_dir: Optional[str] = None
    coco_dir: Optional[str] = None
    karpathy_coco_caption_dir: Optional[str] = None
    flickr30k_dir: Optional[str] = None
    flickr30k_images_dir: Optional[str] = None
    seed_dir: Optional[str] = None
    mme_dir: Optional[str] = None
    hateful_memes_dir: Optional[str] = None
    # model weight roots (converted JAX checkpoints or HF snapshots)
    idefics_9b_path: Optional[str] = None
    idefics2_8b_base_path: Optional[str] = None
    llava_interleave_7b_path: Optional[str] = None
    # fixed internal eval subsets (reference src/dataset_utils/vqa.py:42-65)
    internal_vqav2_dir: Optional[str] = None
    internal_ocr_vqa_dir: Optional[str] = None

    @classmethod
    def from_env(cls, **overrides) -> "Paths":
        kwargs = {}
        for f in fields(cls):
            env_val = _env(f"MIMIC_TPU_{f.name.upper()}")
            if env_val is not None:
                kwargs[f.name] = env_val
        kwargs.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**kwargs)

    def require(self, name: str) -> str:
        val = getattr(self, name)
        if val is None:
            raise FileNotFoundError(
                f"Path '{name}' is not configured. Set MIMIC_TPU_{name.upper()} "
                f"or pass it explicitly."
            )
        return val


_default_paths: Optional[Paths] = None


def get_paths() -> Paths:
    global _default_paths
    if _default_paths is None:
        _default_paths = Paths.from_env()
    return _default_paths


def set_paths(paths: Paths) -> None:
    global _default_paths
    _default_paths = paths
