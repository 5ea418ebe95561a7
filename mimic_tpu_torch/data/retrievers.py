"""Per-dataset retriever and postprocess registrations.

Behavioral parity with the reference's per-dataset ``__init__.py`` modules under
``testbed/data/`` (vqav2, ok_vqa, ocr_vqa, coco, flickr, seed_bench, hateful_memes)
and the inline mme registrations (``src/dataset_utils/mme.py:15-43``).

A retriever maps one raw item → (chat messages, images); ``is_last`` marks the query
item, whose answer role is left content-less so it becomes the generation prompt.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from .okvqa import okvqa_postprocess_registration  # noqa: F401  (registers ok_vqa)
from .registry import register_dataset_retriever, register_postprocess


def _image_msg(n: int = 1) -> Dict[str, Any]:
    return {"role": "image", "content": [{"type": "image"}] * n}


def _text_msg(role: str, text: str) -> Dict[str, Any]:
    return {"role": role, "content": [{"type": "text", "text": text}]}


def _answer_msg(is_last: bool, text: str) -> Dict[str, Any]:
    return {"role": "answer"} if is_last else _text_msg("answer", text)


def _vqa_retriever(item: Dict[str, Any], is_last: bool) -> Tuple[List[Dict[str, Any]], Any]:
    return (
        [
            _image_msg(),
            _text_msg("question", item["question"]),
            _answer_msg(is_last, item.get("answer", "")),
        ],
        item["image"],
    )


@register_dataset_retriever("vqav2")
def vqav2_retriever(item, is_last: bool):
    return _vqa_retriever(item, is_last)


@register_postprocess("vqav2")
def vqav2_postprocess(text):
    return text


@register_dataset_retriever("ocr_vqa")
def ocr_vqa_retriever(item, is_last: bool):
    return _vqa_retriever(item, is_last)


@register_postprocess("ocr_vqa")
def ocr_vqa_postprocess(text):
    return text


def _caption_retriever(item, is_last: bool):
    return (
        [
            _image_msg(),
            (
                {"role": "caption"}
                if is_last
                else _text_msg("caption", item["caption"])
            ),
        ],
        item["image"],
    )


@register_dataset_retriever("coco")
def coco_retriever(item, is_last: bool):
    return _caption_retriever(item, is_last)


@register_postprocess("coco")
def coco_postprocess(text):
    return text


@register_dataset_retriever("flickr")
def flickr_retriever(item, is_last: bool):
    return _caption_retriever(item, is_last)


@register_postprocess("flickr")
def flickr_postprocess(text):
    return text


@register_dataset_retriever("seed_bench")
def seed_bench_retriever(item, is_last: bool):
    num_images = len(item["image"]) if isinstance(item["image"], list) else 1
    return (
        [
            _image_msg(num_images),
            _text_msg("question", item["question"]),
            {
                "role": "choices",
                "content": [
                    {
                        "type": "text",
                        "text": (
                            f"A. {item['choice_a']} B. {item['choice_b']} "
                            f"C. {item['choice_c']} D. {item['choice_d']}"
                        ),
                    },
                    {"type": "text", "text": "Answer with the letter."},
                ],
            },
            _answer_msg(is_last, item.get("answer", "")),
        ],
        item["image"],
    )


@register_postprocess("seed_bench")
def seed_bench_postprocess(text):
    return text


@register_dataset_retriever("mme")
def mme_retriever(item, is_last: bool):
    return _vqa_retriever(item, is_last)


@register_postprocess("mme")
def mme_postprocess(text):
    # yes/no → {1, 0}; anything else → -1 (reference src/dataset_utils/mme.py:37-43)
    if text.lower() == "yes":
        return 1
    if text.lower() == "no":
        return 0
    return -1


@register_dataset_retriever("hateful_memes")
def hateful_memes_retriever(item, is_last: bool):
    return (
        [
            _image_msg(),
            _text_msg(
                "question",
                f'is an image with written "{item["text"]}" on it. Is it hateful?',
            ),
            _answer_msg(is_last, "yes" if item.get("label") == 1 else "no"),
        ],
        item["img"],
    )


_WORD_RE = re.compile(r"[a-z]+(?:[-'][a-z]+)*|\S")


@register_postprocess("hateful_memes")
def hateful_memes_postprocess(pred):
    hateful = {"yes", "y", "hateful", "hate"}
    non_hateful = {"no", "n", "non-hateful", "not hateful", "benign"}
    for token in _WORD_RE.findall(pred.lower()):
        if token in hateful:
            return 1
        if token in non_hateful:
            return 0
    return 0
