"""Dataset readers: local files → plain item lists.

Replaces the reference's HF ``GeneratorBasedBuilder`` loader scripts
(``testbed/data/*/*.py`` — script-based datasets are removed in modern
``datasets`` anyway).  Each reader returns ``{"train": [...], "validation": [...]}``
of dicts whose field names match the reference's loaders so retrievers/adapters work
unchanged.  ``item["image"]`` is a file path; images are decoded lazily at
batch-processing time.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional



def most_common_from_dict(answers: List[Dict[str, Any]]) -> str:
    """Most common 'answer' value (reference testbed/data/common.py:84-86)."""
    counts = Counter(a["answer"] for a in answers)
    return counts.most_common(1)[0][0]


def _vqa_style_split(
    questions_path: str, annotations_path: str, images_dir: str, image_pattern: str
) -> List[Dict[str, Any]]:
    questions = json.load(open(questions_path))["questions"]
    annotations = json.load(open(annotations_path))["annotations"]
    by_qid = {ann["question_id"]: ann for ann in annotations}
    items = []
    for q in questions:
        record = dict(q)
        record.update(by_qid[q["question_id"]])
        record["image"] = os.path.join(
            images_dir, image_pattern.format(image_id=record["image_id"])
        )
        record["answer"] = most_common_from_dict(record["answers"])
        items.append(record)
    return items


def load_vqav2(data_dir: str, images_dir: str) -> Dict[str, List]:
    """VQAv2 layout (testbed/data/vqav2/vqav2.py): ``v2_OpenEnded_mscoco_*`` files."""
    out = {}
    for split, name in (("train", "train2014"), ("validation", "val2014")):
        out[split] = _vqa_style_split(
            os.path.join(data_dir, f"v2_OpenEnded_mscoco_{name}_questions.json"),
            os.path.join(data_dir, f"v2_mscoco_{name}_annotations.json"),
            os.path.join(images_dir, name),
            f"COCO_{name}_{{image_id:0>12}}.jpg",
        )
    return out


def load_ok_vqa(data_dir: str, images_dir: str) -> Dict[str, List]:
    """OK-VQA layout (testbed/data/ok_vqa/ok_vqa.py)."""
    out = {}
    for split, name in (("train", "train2014"), ("validation", "val2014")):
        out[split] = _vqa_style_split(
            os.path.join(data_dir, f"OpenEnded_mscoco_{name}_questions.json"),
            os.path.join(data_dir, f"mscoco_{name}_annotations.json"),
            os.path.join(images_dir, name),
            f"COCO_{name}_{{image_id:0>12}}.jpg",
        )
    return out


def load_ocr_vqa(data_dir: str, images_dir: Optional[str]) -> Dict[str, List]:
    """OCR-VQA layout (testbed/data/ocr_vqa/ocr_vqa.py): one ``dataset.json``."""
    dataset = json.load(open(os.path.join(data_dir, "dataset.json")))
    split_ids = {1: "train", 2: "validation", 3: "test"}
    out: Dict[str, List] = {"train": [], "validation": [], "test": []}
    for image_id, info in dataset.items():
        split = split_ids.get(info["split"])
        if split is None:
            continue
        ext = os.path.splitext(info["imageURL"])[1]
        image = (
            os.path.join(images_dir, f"{image_id}{ext}") if images_dir else info["imageURL"]
        )
        for idx, (question, answer) in enumerate(zip(info["questions"], info["answers"])):
            out[split].append(
                {
                    "image": image,
                    "question": question,
                    "question_id": f"{image_id}-{idx}",
                    "answer": answer,
                    "image_id": image_id,
                    "genre": info.get("genre"),
                    "authorName": info.get("authorName"),
                    "title": info.get("title"),
                }
            )
    return out


def _karpathy_split(
    annotations_path: str, images_dir_for: Dict[str, str], splits: Dict[str, str]
) -> Dict[str, List]:
    data = json.load(open(annotations_path))
    out: Dict[str, List] = {k: [] for k in splits.values()}
    for image_metadata in data["images"]:
        split = image_metadata["split"]
        if split not in splits:
            continue
        images_dir = images_dir_for[split]
        record = {
            "image": os.path.join(images_dir, image_metadata["filename"]),
            "filepath": os.path.join(images_dir, image_metadata["filename"]),
            "sentids": image_metadata["sentids"],
            "filename": image_metadata["filename"],
            "imgid": image_metadata["imgid"],
            "split": split,
            "cocoid": image_metadata.get("cocoid", image_metadata["imgid"]),
            "caption": image_metadata["sentences"][0]["raw"],
            "sentences_tokens": [s["tokens"] for s in image_metadata["sentences"]],
            "sentences_raw": [s["raw"] for s in image_metadata["sentences"]],
            "sentences_sentid": [s["sentid"] for s in image_metadata["sentences"]],
        }
        out[splits[split]].append(record)
    return out


def load_coco_caption(data_dir: str, images_dir: str) -> Dict[str, List]:
    """Karpathy COCO captions (testbed/data/coco/coco.py): ``dataset_coco.json``."""
    return _karpathy_split(
        os.path.join(data_dir, "dataset_coco.json"),
        {
            "train": os.path.join(images_dir, "train2014"),
            "val": os.path.join(images_dir, "val2014"),
            "test": os.path.join(images_dir, "val2014"),
        },
        {"train": "train", "val": "validation", "test": "test"},
    )


def load_flickr30k(data_dir: str, images_dir: str) -> Dict[str, List]:
    """Karpathy Flickr30k (testbed/data/flickr/flickr.py): ``dataset_flickr30k.json``."""
    img_dir = os.path.join(images_dir)
    return _karpathy_split(
        os.path.join(data_dir, "dataset_flickr30k.json"),
        {"train": img_dir, "val": img_dir, "test": img_dir},
        {"train": "train", "val": "validation", "test": "test"},
    )


def load_seed_bench(data_dir: str) -> Dict[str, List]:
    """SEED-Bench (testbed/data/seed_bench/seed_bench.py): ``SEED-Bench.json`` +
    ``SEED-Bench-image``; items with missing image files are skipped."""
    ann = json.load(open(os.path.join(data_dir, "SEED-Bench.json")))
    images_dir = os.path.join(data_dir, "SEED-Bench-image")
    items = []
    for item in ann["questions"]:
        image = os.path.join(images_dir, item["data_id"])
        if not os.path.exists(image):
            continue
        items.append(
            {
                "answer": item["answer"],
                "choice_a": item["choice_a"],
                "choice_b": item["choice_b"],
                "choice_c": item["choice_c"],
                "choice_d": item["choice_d"],
                "data_id": item["data_id"],
                "data_type": item["data_type"],
                "question": item["question"],
                "question_id": item["question_id"],
                "question_type_id": str(item["question_type_id"]),
                "image": image,
                "segment": item.get("segment"),
            }
        )
    return {"test": items}


def load_mme(data_dir: str) -> Dict[str, List]:
    """MME parquet dir (reference loads with ``load_dataset('parquet', ...)``,
    src/dataset_utils/mme.py:51)."""
    import glob

    try:
        import pyarrow.parquet as pq
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("pyarrow required to read MME parquet files") from e

    items: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(data_dir, "**", "*.parquet"), recursive=True)):
        table = pq.read_table(path)
        for row in table.to_pylist():
            items.append(row)
    return {"test": items}


def load_hateful_memes(data_dir: str) -> Dict[str, List]:
    """Hateful Memes jsonl layout (testbed/data/hateful_memes/hateful_memes.py)."""
    out = {}
    for split, fname in (("train", "train.jsonl"), ("validation", "dev.jsonl")):
        items = []
        with open(os.path.join(data_dir, fname)) as f:
            for line in f:
                item = json.loads(line)
                item["img"] = os.path.join(data_dir, item["img"])
                items.append(item)
        out[split] = items
    return out


def train_validation_from_test(
    items: List, num_query_samples: int
) -> Dict[str, List]:
    """``train_test_split(train_size=n, shuffle=False)`` semantics used by the
    mme/seed adapters (src/dataset_utils/mme.py:57-63): first n = support,
    rest = query."""
    return {"train": items[:num_query_samples], "validation": items[num_query_samples:]}
