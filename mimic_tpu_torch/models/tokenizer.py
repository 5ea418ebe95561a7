"""Tokenizer protocol + implementations.

The framework talks to tokenizers through a small protocol so models work with
either the self-contained byte-level ``SimpleTokenizer`` (tests, smoke runs, no
external files) or ``HFTokenizerAdapter`` wrapping a local HuggingFace tokenizer
(real checkpoints; the reference loads these via AutoProcessor,
``testbed/models/model_base.py:36-46``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class SpecialTokens:
    PAD = "<pad>"
    BOS = "<s>"
    EOS = "</s>"
    IMAGE = "<image>"
    FAKE_IMAGE = "<fake_token_around_image>"
    END_UTTERANCE = "<end_of_utterance>"
    IM_START = "<|im_start|>"
    IM_END = "<|im_end|>"


class SimpleTokenizer:
    """Byte-level tokenizer with named special tokens.

    ids 0..255 are raw bytes; special tokens follow.  Deterministic, reversible,
    dependency-free — the test/dev stand-in for a real SentencePiece/BPE tokenizer.
    """

    def __init__(self, padding_side: str = "right", extra_specials: Sequence[str] = ()):
        base = [
            SpecialTokens.PAD,
            SpecialTokens.BOS,
            SpecialTokens.EOS,
            SpecialTokens.IMAGE,
            SpecialTokens.FAKE_IMAGE,
            SpecialTokens.END_UTTERANCE,
            SpecialTokens.IM_START,
            SpecialTokens.IM_END,
        ]
        self._specials: Dict[str, int] = {}
        for i, tok in enumerate([*base, *extra_specials]):
            self._specials[tok] = 256 + i
        self._specials_by_id = {v: k for k, v in self._specials.items()}
        # longest-first matching so <image> wins over < byte
        self._ordered = sorted(self._specials, key=len, reverse=True)
        self.padding_side = padding_side

    @property
    def vocab_size(self) -> int:
        return 256 + len(self._specials)

    @property
    def pad_token_id(self) -> int:
        return self._specials[SpecialTokens.PAD]

    @property
    def bos_token_id(self) -> int:
        return self._specials[SpecialTokens.BOS]

    @property
    def eos_token_id(self) -> int:
        return self._specials[SpecialTokens.EOS]

    @property
    def image_token_id(self) -> int:
        return self._specials[SpecialTokens.IMAGE]

    @property
    def pad_token(self) -> str:
        return SpecialTokens.PAD

    @property
    def eos_token(self) -> str:
        return SpecialTokens.EOS

    def special_id(self, token: str) -> int:
        return self._specials[token]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = [self.bos_token_id] if add_bos else []
        i = 0
        while i < len(text):
            matched = False
            for tok in self._ordered:
                if text.startswith(tok, i):
                    ids.append(self._specials[tok])
                    i += len(tok)
                    matched = True
                    break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i < 256:
                byte_buf.append(i)
            else:
                flush()
                if not skip_special_tokens:
                    out.append(self._specials_by_id.get(i, ""))
        flush()
        return "".join(out)

    def pad_batch(
        self, batch_ids: List[List[int]], pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad a list of id lists → (input_ids [B,T], attention_mask [B,T])."""
        max_len = max(len(ids) for ids in batch_ids)
        if pad_to is not None:
            if max_len > pad_to:
                raise ValueError(f"sequence length {max_len} exceeds pad_to={pad_to}")
            max_len = pad_to
        B = len(batch_ids)
        input_ids = np.full((B, max_len), self.pad_token_id, np.int32)
        mask = np.zeros((B, max_len), np.int32)
        for b, ids in enumerate(batch_ids):
            n = len(ids)
            if self.padding_side == "left":
                input_ids[b, max_len - n :] = ids
                mask[b, max_len - n :] = 1
            else:
                input_ids[b, :n] = ids
                mask[b, :n] = 1
        return input_ids, mask


class HFTokenizerAdapter:
    """Wrap a HuggingFace tokenizer loaded from a local path into the protocol."""

    def __init__(self, tokenizer, image_token: str = SpecialTokens.IMAGE):
        self.tk = tokenizer
        self.padding_side = tokenizer.padding_side
        self._image_token = image_token

    @classmethod
    def from_pretrained(cls, path: str, **kwargs):
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(path, local_files_only=True), **kwargs)

    @property
    def vocab_size(self) -> int:
        return len(self.tk)

    @property
    def pad_token_id(self) -> int:
        return self.tk.pad_token_id

    @property
    def bos_token_id(self) -> int:
        return self.tk.bos_token_id

    @property
    def eos_token_id(self) -> int:
        return self.tk.eos_token_id

    @property
    def image_token_id(self) -> int:
        return self.tk.convert_tokens_to_ids(self._image_token)

    @property
    def pad_token(self) -> str:
        return self.tk.pad_token

    @property
    def eos_token(self) -> str:
        return self.tk.eos_token

    def special_id(self, token: str) -> int:
        return self.tk.convert_tokens_to_ids(token)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self.tk.encode(text, add_special_tokens=add_bos)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tk.decode(ids, skip_special_tokens=skip_special_tokens)

    def pad_batch(self, batch_ids, pad_to=None):
        max_len = max(len(ids) for ids in batch_ids)
        if pad_to is not None:
            max_len = pad_to
        B = len(batch_ids)
        input_ids = np.full((B, max_len), self.pad_token_id, np.int32)
        mask = np.zeros((B, max_len), np.int32)
        for b, ids in enumerate(batch_ids):
            n = len(ids)
            if self.padding_side == "left":
                input_ids[b, max_len - n :] = ids
                mask[b, max_len - n :] = 1
            else:
                input_ids[b, :n] = ids
                mask[b, :n] = 1
        return input_ids, mask
