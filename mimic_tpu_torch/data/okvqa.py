"""OK-VQA retriever + stemming postprocess registration
(parity with reference ``testbed/data/ok_vqa/__init__.py:209-237``)."""

from __future__ import annotations

from ..evaluate.okvqa_stem import okvqa_postprocess
from .registry import register_dataset_retriever, register_postprocess


@register_dataset_retriever("ok_vqa")
def ok_vqa_retriever(item, is_last: bool):
    return (
        [
            {"role": "image", "content": [{"type": "image"}]},
            {"role": "question", "content": [{"type": "text", "text": item["question"]}]},
            (
                {"role": "answer"}
                if is_last
                else {
                    "role": "answer",
                    "content": [{"type": "text", "text": item.get("answer", "")}],
                }
            ),
        ],
        item["image"],
    )


@register_postprocess("ok_vqa")
def okvqa_postprocess_registration(pred: str) -> str:
    return okvqa_postprocess(pred)
