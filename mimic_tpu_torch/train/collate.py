"""Training-batch construction (host side).

Mirrors the input assembly of ``ShiftModel.forward`` (``src/shift_model.py:193-243``):

- shift-pass text:  ``query ⊕ [PAD] ⊕ answer ⊕ [EOS]`` with only the query images
- record-pass text: ``demos ⊕ [PAD] ⊕ query ⊕ [PAD] ⊕ answer ⊕ [EOS]`` with all
  images
- attention masks are recomputed as ``input_ids != pad`` so the injected [PAD]
  separators are invisible to attention (reference ``:212, 222``)

All segment masks become fixed-width gather pairs here, on the host, so the jitted
step sees only static shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import Strategy
from ..models.processor import LVLMProcessor
from .masking import generate_label_mask, mask_to_gather, paired_gather_width


@dataclass
class TrainBatch:
    # shift (query-only) pass
    query_ids: np.ndarray
    query_mask: np.ndarray
    query_pixels: Optional[np.ndarray]
    query_pixel_mask: Optional[np.ndarray]
    query_img_attn: Optional[np.ndarray]
    query_patch_mask: Optional[np.ndarray] = None
    # record (full-context) pass; None when strategy is LM_LOSS only
    full_ids: Optional[np.ndarray] = None
    full_mask: Optional[np.ndarray] = None
    full_pixels: Optional[np.ndarray] = None
    full_pixel_mask: Optional[np.ndarray] = None
    full_img_attn: Optional[np.ndarray] = None
    full_patch_mask: Optional[np.ndarray] = None
    # layer-wise alignment gathers (query tokens in both passes, paired by order)
    prefix_q_idx: Optional[np.ndarray] = None
    shift_q_idx: Optional[np.ndarray] = None
    q_valid: Optional[np.ndarray] = None
    # logits-KL gathers (answer+EOS tokens in both passes)
    prefix_ans_idx: Optional[np.ndarray] = None
    query_ans_idx: Optional[np.ndarray] = None
    ans_valid: Optional[np.ndarray] = None
    # content keys per pixel slot (emit_image_keys=True; train.vision_cache):
    # flat lists of length B*N aligned with the pixel layout — NOT device data
    query_image_keys: Optional[List] = None
    full_image_keys: Optional[List] = None


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class TrainCollator:
    """String batch (from the context dataloader) → TrainBatch arrays."""

    def __init__(
        self,
        processor: LVLMProcessor,
        strategy: Strategy,
        num_image_in_query: int = 1,
        pad_multiple: int = 64,
        max_query_len: Optional[int] = None,
        max_full_len: Optional[int] = None,
        emit_image_keys: bool = False,
    ):
        self.proc = processor
        self.tk = processor.tokenizer
        self.strategy = strategy
        self.num_image_in_query = num_image_in_query
        self.pad_multiple = pad_multiple
        self.max_query_len = max_query_len
        self.max_full_len = max_full_len
        # content keys for the training vision-feature cache (the frozen
        # tower makes per-image features constants; demos resample from a
        # fixed train set, so features recur across steps/epochs)
        self.emit_image_keys = emit_image_keys

    @staticmethod
    def _image_keys(nested: List[List[Any]], n_max: int) -> List:
        from ..models.feature_cache import image_key

        pad = image_key(None)
        keys: List = []
        for row in nested:
            keys.extend(image_key(im) for im in row)
            keys.extend([pad] * (n_max - len(row)))
        return keys

    def _pad_to(self, texts: List[str], limit: Optional[int]) -> Optional[int]:
        lens = [
            len(self.tk.encode(self.proc.expand_image_tokens(t), add_bos=True))
            for t in texts
        ]
        width = _round_up(max(lens), self.pad_multiple)
        if limit is not None:
            width = min(width, max(limit, max(lens)))
        return width

    def __call__(self, batch: Dict[str, Any]) -> TrainBatch:
        pad_tok = self.tk.pad_token
        eos_tok = self.tk.eos_token
        pad_id = self.tk.pad_token_id
        queries: List[str] = batch["query_texts"]
        answers: List[str] = batch["answers"]
        images: List[List[Any]] = batch.get("images") or [[] for _ in queries]

        query_answer = [
            q + pad_tok + a + eos_tok for q, a in zip(queries, answers)
        ]
        query_images = [imgs[-self.num_image_in_query :] for imgs in images]
        q_enc = self.proc(
            query_images if any(query_images) else None,
            query_answer,
            pad_to=self._pad_to(query_answer, self.max_query_len),
        )
        # reference :212 — masks out the injected [PAD] separator too
        q_mask = (q_enc["input_ids"] != pad_id).astype(np.int32)

        out = TrainBatch(
            query_ids=q_enc["input_ids"],
            query_mask=q_mask,
            query_pixels=q_enc.get("pixel_values"),
            query_pixel_mask=q_enc.get("pixel_mask"),
            query_img_attn=q_enc.get("image_attention_mask"),
            query_patch_mask=q_enc.get("patch_mask"),
        )
        if self.emit_image_keys and out.query_pixels is not None:
            out.query_image_keys = self._image_keys(
                query_images, out.query_pixels.shape[1]
            )

        if self.strategy == Strategy.LM_LOSS:
            return out  # no record pass needed (reference :213-214)

        prefixes: List[str] = batch["prefix_texts"]
        full = [
            p + pad_tok + q + pad_tok + a + eos_tok
            for p, q, a in zip(prefixes, queries, answers)
        ]
        f_enc = self.proc(
            images if any(images) else None,
            full,
            pad_to=self._pad_to(full, self.max_full_len),
        )
        f_mask = (f_enc["input_ids"] != pad_id).astype(np.int32)
        out.full_ids = f_enc["input_ids"]
        out.full_mask = f_mask
        out.full_pixels = f_enc.get("pixel_values")
        out.full_pixel_mask = f_enc.get("pixel_mask")
        out.full_img_attn = f_enc.get("image_attention_mask")
        out.full_patch_mask = f_enc.get("patch_mask")
        if self.emit_image_keys and out.full_pixels is not None:
            out.full_image_keys = self._image_keys(images, out.full_pixels.shape[1])

        side = self.tk.padding_side
        if self.strategy.has_layer_wise():
            # record pass: everything after the demos separator = query⊕PAD⊕ans⊕EOS,
            # pads excluded (reference :229-233)
            prefix_q = generate_label_mask(out.full_ids, pad_id, 1, side)
            # shift pass: all real tokens except BOS (reference :252-259)
            bos = self.tk.bos_token_id
            shift_q = (q_mask.astype(bool)) & (q_enc["input_ids"] != bos)
            width = paired_gather_width(prefix_q, shift_q)
            out.prefix_q_idx, v1 = mask_to_gather(prefix_q, width)
            out.shift_q_idx, v2 = mask_to_gather(shift_q, width)
            if not np.array_equal(v1.sum(1), v2.sum(1)):
                raise ValueError(
                    "query-token counts differ between record and shift passes "
                    f"({v1.sum(1)} vs {v2.sum(1)}); check tokenizer consistency"
                )
            out.q_valid = v1

        if Strategy.LOGITS_KL_DIV in self.strategy:
            prefix_ans = generate_label_mask(out.full_ids, pad_id, 2, side)
            query_ans = generate_label_mask(out.query_ids, pad_id, 1, side)
            width = paired_gather_width(prefix_ans, query_ans)
            out.prefix_ans_idx, v1 = mask_to_gather(prefix_ans, width)
            out.query_ans_idx, v2 = mask_to_gather(query_ans, width)
            if not np.array_equal(v1.sum(1), v2.sum(1)):
                raise ValueError("answer-token counts differ between passes")
            out.ans_valid = v1

        return out
