"""Adapter registry + factory — the ``dataset_mapping`` analog
(``src/dataset_utils/__init__.py:7-28``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Type

from ...config import DataConfig
from ...config.paths import Paths, get_paths
from .. import sources
from .base import DatasetAdapter, seeded_shuffle
from .caption import CaptionAdapter
from .hateful_memes import HatefulMemesAdapter
from .mme import MMEAdapter
from .seed_bench import SeedBenchAdapter
from .vqa import VQAAdapter

dataset_mapping: Dict[str, Type[DatasetAdapter]] = {}
for cls in (VQAAdapter, CaptionAdapter, MMEAdapter, SeedBenchAdapter, HatefulMemesAdapter):
    for name in cls.support_datasets:
        dataset_mapping[name] = cls


def load_splits(name: str, paths: Paths, data_cfg: DataConfig) -> Dict[str, List]:
    """Read the raw splits for a dataset from configured paths."""
    if name == "vqav2":
        splits = sources.load_vqav2(paths.require("vqav2_dir"), paths.require("coco_dir"))
        # fixed internal 10k eval subset override (src/dataset_utils/vqa.py:42-54)
        if paths.internal_vqav2_dir:
            internal = sources.load_vqav2(paths.internal_vqav2_dir, paths.require("coco_dir"))
            splits["validation"] = internal["validation"]
        return splits
    if name == "ok_vqa":
        return sources.load_ok_vqa(paths.require("ok_vqa_dir"), paths.require("coco_dir"))
    if name == "ocr_vqa":
        splits = sources.load_ocr_vqa(paths.require("ocr_vqa_dir"), paths.ocr_vqa_images_dir)
        if paths.internal_ocr_vqa_dir:
            internal = sources.load_ocr_vqa(
                paths.internal_ocr_vqa_dir, paths.ocr_vqa_images_dir
            )
            splits["validation"] = internal["validation"]
        return splits
    if name == "coco":
        return sources.load_coco_caption(
            paths.require("karpathy_coco_caption_dir"), paths.require("coco_dir")
        )
    if name == "flickr":
        return sources.load_flickr30k(
            paths.require("flickr30k_dir"), paths.require("flickr30k_images_dir")
        )
    if name == "seed_bench":
        test = sources.load_seed_bench(paths.require("seed_dir"))["test"]
        return sources.train_validation_from_test(test, data_cfg.num_query_samples)
    if name == "mme":
        test = sources.load_mme(paths.require("mme_dir"))["test"]
        return sources.train_validation_from_test(test, data_cfg.num_query_samples)
    if name == "hateful_memes":
        return sources.load_hateful_memes(paths.require("hateful_memes_dir"))
    raise ValueError(f"Unknown dataset {name!r}")


def build_adapter(
    data_cfg: DataConfig,
    paths: Optional[Paths] = None,
    splits: Optional[Dict[str, List]] = None,
) -> DatasetAdapter:
    """Build the adapter for ``data_cfg.name``; pass ``splits`` directly for
    in-memory/synthetic datasets (tests)."""
    cls = dataset_mapping.get(data_cfg.name)
    if cls is None:
        raise ValueError(
            f"Unknown dataset {data_cfg.name!r}; valid: {', '.join(sorted(dataset_mapping))}"
        )
    if splits is None:
        splits = load_splits(data_cfg.name, paths or get_paths(), data_cfg)
    support = splits.get("train", [])
    query = splits.get("validation", splits.get("test", []))
    return cls(data_cfg, support, query)


__all__ = [
    "CaptionAdapter",
    "DatasetAdapter",
    "HatefulMemesAdapter",
    "MMEAdapter",
    "SeedBenchAdapter",
    "VQAAdapter",
    "build_adapter",
    "dataset_mapping",
    "load_splits",
    "seeded_shuffle",
]
