"""LVLMRunner — the evaluation-facing model handle.

Counterpart of ``mimic_tpu/models/runner.py``: bundles config, frozen
parameters, tokenizer/processor and prompt template, and exposes
``set_shift`` / ``set_quant`` / ``apply_prompt_template`` /
``process_input`` / ``generate``, the surface the shared eval adapters drive.
The parameters live in a ``ParamModule`` on the runner's device.

Not ported yet: sampling, the vision feature cache, the ``"int8-w8a8"``
serving mode, LoRA adapters and prefix tuning.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..bridge import ParamModule
from ..device import DeviceLike, resolve_device
from ..ops.quant import is_quantized, quantize_lm_params
from ..shared import LVLMProcessor, ModelConfig
from ..shared import apply_prompt_template as render_template
from .generate import beam_generate, greedy_generate
from .lvlm import LVLMBatch


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _has_quantized(tree: Any) -> bool:
    if is_quantized(tree):
        return True
    return isinstance(tree, dict) and any(_has_quantized(v) for v in tree.values())


class LVLMRunner:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        tokenizer,
        device: DeviceLike,
        logz2: str = "unmasked",
        pad_multiple: int = 128,
        length_buckets: tuple = (),
        quant: Optional[str] = None,
    ):
        if cfg.family != "idefics2":
            raise NotImplementedError(f"model family {cfg.family!r} is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.module = ParamModule(params).to(self.device)
        self.decode_params = None
        if quant:
            self.set_quant(quant)
        self.tokenizer = tokenizer
        self.template = "idefics2"
        self.processor = LVLMProcessor(cfg, tokenizer)
        self.shift = None
        self.logz2 = logz2
        self.pad_multiple = pad_multiple
        self.length_buckets = tuple(length_buckets)

    @property
    def params(self) -> Dict[str, Any]:
        return self.module.tree()

    @property
    def model_name(self) -> str:
        return self.cfg.name

    def set_shift(self, shift, adapters=None, lora_scaling: float = 1.0, prefix=None) -> None:
        """Activate trained shift parameters for all later forwards."""
        if adapters is not None or prefix is not None:
            raise NotImplementedError("LoRA adapters and prefix tuning are not ported yet")
        self.shift = (
            None if shift is None else {k: v.to(self.device) for k, v in shift.items()}
        )

    def set_quant(self, quant: Optional[str]) -> None:
        """(Re)build the weight-only int8 serving tree from the current params.

        - ``"int8"``: dual copy; the prefill reads the full-precision tree,
          every decode step the int8 copy (``decode_params``), whose tensors
          other than the quantized matmuls are shared with the main tree.
        - ``"int8-memory"``: single copy; the text tower's matmul weights are
          replaced by their int8 form everywhere (prefill included) and the
          ``ParamModule`` is rebuilt, so the bf16 stacks are freed once
          nothing else holds them.  Applying it again changes nothing.
        - ``None``: drop the int8 copy.

        ``"int8"`` on an already-quantized tree and an unknown mode raise
        ``ValueError``; ``"int8-w8a8"`` raises ``NotImplementedError``.
        Quantization runs one layer at a time on the runner's device; the
        scales stay fp32 (never cast a tree that holds quantized handles).
        """
        if quant is None:
            self.decode_params = None
            return
        if quant == "int8-w8a8":
            raise NotImplementedError(
                "the int8-w8a8 mode (W8A8 prefill matmuls) is not ported yet: it is the next slice")
        already = _has_quantized(self.params)
        if quant == "int8":
            if already:
                raise ValueError("params already int8-quantized (int8-memory mode)")
            with torch.no_grad():
                self.decode_params = quantize_lm_params(self.params)
        elif quant == "int8-memory":
            self.decode_params = None
            if not already:
                with torch.no_grad():
                    quantized = quantize_lm_params(self.params)
                self.module = ParamModule(quantized)
        else:
            raise ValueError(
                f"unknown quant mode {quant!r} (supported: 'int8', 'int8-memory'; "
                "'int8-w8a8' is not ported yet)"
            )

    def apply_prompt_template(self, conversation, add_generation_prompt: bool = False):
        return render_template(conversation, self.template, add_generation_prompt)

    def _to_batch(self, enc: Dict[str, np.ndarray]) -> LVLMBatch:
        def t(name):
            return torch.from_numpy(enc[name]).to(self.device) if name in enc else None

        return LVLMBatch(
            input_ids=t("input_ids").long(),
            attention_mask=t("attention_mask"),
            pixel_values=t("pixel_values"),
            patch_mask=t("patch_mask"),
        )

    def process_input(self, images, text, pad_to: Optional[int] = None) -> LVLMBatch:
        if text and not isinstance(text, str) and not isinstance(text[0], str):
            text = self.apply_prompt_template(text)
        return self._to_batch(self.processor(images, text, pad_to=pad_to))

    def generate(
        self,
        images,
        text,
        num_beams: int = 1,
        max_new_tokens: int = 10,
        length_penalty: float = 0.0,
        do_sample: bool = False,
        **_: Any,
    ) -> List[str]:
        """Prompt → decoded continuations (prompt stripped), HF-generate parity.

        Prompt lengths are bucketed to ``pad_multiple`` (or the smallest
        fitting ``length_buckets`` entry), left-padded.  On a CUDA device the
        vision tower and the prefill run the attention kernels
        (``attn_impl="flash"``); on the CPU they run plain ``sdpa_with_lse``.
        """
        if do_sample:
            raise NotImplementedError("sampling is not ported yet")
        old_side = self.tokenizer.padding_side
        self.tokenizer.padding_side = "left"
        try:
            rendered = (
                text
                if isinstance(text, str)
                or (isinstance(text, list) and text and isinstance(text[0], str))
                else self.apply_prompt_template(text)
            )
            # the padded width depends on the text alone: probe without images
            T = self.processor(None, rendered)["input_ids"].shape[1]
            pad_to = _round_up(T, self.pad_multiple)
            fitting = [b for b in self.length_buckets if b >= T]
            if fitting:
                pad_to = min(fitting)
            enc = self.processor(images, rendered, pad_to=pad_to)
        finally:
            self.tokenizer.padding_side = old_side

        batch = self._to_batch(enc)
        common = dict(
            max_new_tokens=max_new_tokens,
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id,
            shift=self.shift,
            logz2=self.logz2,
            attn_impl="flash" if self.device.type == "cuda" else "xla",
            decode_params=self.decode_params,
        )
        if num_beams > 1:
            result = beam_generate(
                self.params, self.cfg, batch, num_beams=num_beams,
                length_penalty=length_penalty, **common,
            )
        else:
            result = greedy_generate(self.params, self.cfg, batch, **common)
        tokens = result.tokens.cpu().numpy()
        return [self.tokenizer.decode(row, skip_special_tokens=True) for row in tokens]
