"""LVLMRunner — the evaluation-facing model handle.

Counterpart of ``mimic_tpu/models/runner.py``: bundles config, frozen
parameters, tokenizer/processor and prompt template, and exposes
``set_shift`` / ``set_quant`` / ``apply_prompt_template`` /
``process_input`` / ``generate``, the surface the shared eval adapters drive.
The parameters live in a ``ParamModule`` on the runner's device.
``enable_vision_cache`` keeps encoded image features across ``generate``
calls (``models/feature_cache.py``); ``generate(do_sample=True)`` samples.
Trained shift, LoRA adapters and a prefix-tuning prefix (``set_shift``) are
passed into every forward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..bridge import ParamModule
from ..device import DeviceLike, resolve_device
from ..ops.quant import is_quantized, quantize_lm_params
from ..parallel import tp
from ..data.templates import apply_prompt_template as render_template
from .config import ModelConfig
from .feature_cache import VisionFeatureCache, image_key
from .generate import beam_generate, greedy_generate, sample_generate
from ..utils.tracing import count, span
from .lvlm import PORTED_FAMILIES, LVLMBatch
from .moonvit import MoonViTProcessor
from .processor import ImageProcessor, LVLMProcessor

# the prompt template of each family (JAX runner.py's table)
_FAMILY_TEMPLATE = {
    "idefics1": "idefics1",
    "idefics2": "idefics2",
    "llava-interleave": "llava-interleave",
    # text-only towers (the reference's mistral / qwen2 wrappers) and Kimi-VL use
    # the ChatML template
    "text": "llava-interleave",
    "kimi-vl": "llava-interleave",
}


class _SpannedImageProcessor(ImageProcessor):
    """The copy's image processor with each resize in a ``processor.resize`` span."""

    def _resize(self, arr: np.ndarray, h: int, w: int) -> np.ndarray:
        with span("processor.resize", device=False):
            return super()._resize(arr, h, w)


class _Spans:
    """A processor's image work (resize, rescale, normalise, padding,
    stacking) in a ``processor.images`` span and each resize in a
    ``processor.resize`` span; its outputs are the processor's own."""

    def __init__(self, cfg: ModelConfig, tokenizer, image_size: Optional[int] = None):
        super().__init__(cfg, tokenizer, image_size=image_size)
        self.image_processor = _SpannedImageProcessor(**dataclasses.asdict(self.image_processor))

    def _process_images(self, batch_images, max_images):
        with span("processor.images", device=False):
            return super()._process_images(batch_images, max_images)


class _SpannedProcessor(_Spans, LVLMProcessor):
    """``LVLMProcessor`` (a held copy of the JAX package's, left as it is)
    with spans."""


class _SpannedMoonViTProcessor(_Spans, MoonViTProcessor):
    """Kimi-VL's native-resolution processor with spans."""


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _has_quantized(tree: Any) -> bool:
    if is_quantized(tree):
        return True
    return isinstance(tree, dict) and any(_has_quantized(v) for v in tree.values())


def _whole_matmuls(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """``params`` with every weight ``quantize_lm_params`` quantizes whole: each
    one ``shard_params`` split is gathered over the current mesh's ``model``
    axis (``tp.gather_split``, the bits before the cut), so that its scales and
    the fused ``qkv_proj`` / ``gateup_proj`` columns are those of the whole
    weight.  The rest of the tree is shared as it is."""
    t = cfg.text
    q, kv = t.num_heads * t.head_size, t.num_kv_heads * t.head_size
    # the split dimension, from the end, and its full width
    widths = {"q_proj": (-1, q), "k_proj": (-1, kv), "v_proj": (-1, kv), "o_proj": (-2, q),
              "gate_proj": (-1, t.intermediate_size), "up_proj": (-1, t.intermediate_size),
              "down_proj": (-2, t.intermediate_size)}

    def whole(name, w, what):
        if name not in widths or is_quantized(w):
            return w
        dim, full = widths[name]
        return tp.gather_split(w, w.dim() + dim, full, what)

    lm, dec = dict(params["lm"]), dict(params["lm"]["decoder"])
    for group in ("layers", "cross"):
        if group in dec:
            dec[group] = {k: whole(k, w, f"{group} {k}") for k, w in dec[group].items()}
    lm["decoder"] = dec
    if "lm_head" in lm and not is_quantized(lm["lm_head"]):
        lm["lm_head"] = tp.gather_split(lm["lm_head"], 1, t.vocab_size, "lm_head")
    return dict(params, lm=lm)


class LVLMRunner:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        tokenizer,
        device: Optional[DeviceLike] = None,
        logz2: str = "unmasked",
        pad_multiple: int = 128,
        length_buckets: tuple = (),
        quant: Optional[str] = None,
        image_size: Optional[int] = None,
    ):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(f"model family {cfg.family!r} is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.module = ParamModule(params).to(self.device)
        self.decode_params = None
        self.vision_cache: Optional[VisionFeatureCache] = None
        if quant:
            self.set_quant(quant)
        self.tokenizer = tokenizer
        self.template = _FAMILY_TEMPLATE[cfg.family]
        spanned = _SpannedMoonViTProcessor if cfg.family == "kimi-vl" else _SpannedProcessor
        self.processor = spanned(cfg, tokenizer, image_size=image_size)
        self.shift = None
        self.adapters = None
        self.lora_scaling = 1.0
        self.prefix = None
        self.logz2 = logz2
        self.pad_multiple = pad_multiple
        self.length_buckets = tuple(length_buckets)

    @property
    def params(self) -> Dict[str, Any]:
        return self.module.tree()

    @params.setter
    def params(self, tree: Dict[str, Any]) -> None:
        self.module = ParamModule(tree).to(self.device)

    @property
    def model_name(self) -> str:
        return self.cfg.name

    def set_shift(self, shift, adapters=None, lora_scaling: float = 1.0, prefix=None) -> None:
        """Activate trained shift / LoRA / prefix parameters for all later
        forwards (each tree moved to the runner's device)."""

        def to_device(tree):
            return None if tree is None else {k: v.to(self.device) for k, v in tree.items()}

        self.shift = to_device(shift)
        self.adapters = to_device(adapters)
        self.lora_scaling = lora_scaling
        self.prefix = to_device(prefix)

    def enable_vision_cache(self, max_bytes: int = 512 * 1024 * 1024) -> VisionFeatureCache:
        """Cache encoded image features across ``generate`` calls, keyed by
        the source images' content: each support image of an ICL eval is
        encoded once per eval instead of once per occurrence.  A cached
        feature is the encode function's own output.  Inline-splice families
        only: idefics1 raises ``ValueError``, as in the JAX package."""
        if self.cfg.family == "idefics1":
            raise ValueError("vision cache does not support cross-attention families")
        self.vision_cache = VisionFeatureCache(max_bytes=max_bytes)
        return self.vision_cache

    def set_quant(self, quant: Optional[str]) -> None:
        """(Re)build the int8 serving tree from the current params.

        - ``"int8"``: dual copy; the prefill reads the full-precision tree,
          every decode step the int8 copy (``decode_params``), whose tensors
          other than the quantized matmuls are shared with the main tree.
        - ``"int8-memory"``: single copy; the text tower's matmul weights are
          replaced by their int8 form everywhere (prefill included) and the
          ``ParamModule`` is rebuilt, so the bf16 stacks are freed once
          nothing else holds them.  Applying it again changes nothing.
        - ``"int8-w8a8"``: the single copy with the self-attention layer
          stacks marked for W8A8 (``act_quant``): on CUDA the text prefill's
          matmuls (M >= 256) quantize their rows per token and run int8 × int8
          (``ops/quant.py::w8a8_matmul``); decode is that of
          ``"int8-memory"``.  The least bit-parity of the modes (activations
          round too).  On a tree that is already int8 nothing is re-marked,
          as in the JAX package.
        - ``None``: drop the int8 copy.

        ``"int8"`` on an already-quantized tree and an unknown mode raise
        ``ValueError``.
        Quantization runs one layer at a time on the runner's device; the
        scales stay fp32 (never cast a tree that holds quantized handles).
        Under a model axis the runner's tree is ``shard_params``' cut: the
        weights are gathered whole first (``_whole_matmuls``), so the handles
        are the whole tree's, bit for bit, whole on every rank as JAX's rules
        leave them; the rest of the tree stays cut.
        The vision-feature cache is emptied: the tree it was filled from changes.
        """
        if self.vision_cache is not None:
            self.vision_cache.clear()
        if quant is None:
            self.decode_params = None
            return
        already = _has_quantized(self.params)
        if quant == "int8":
            if already:
                raise ValueError("params already int8-quantized (int8-memory mode)")
            with torch.no_grad():
                self.decode_params = quantize_lm_params(_whole_matmuls(self.params, self.cfg))
        elif quant in ("int8-memory", "int8-w8a8"):
            self.decode_params = None
            if not already:
                with torch.no_grad():
                    quantized = quantize_lm_params(_whole_matmuls(self.params, self.cfg),
                                                   act_quant=quant == "int8-w8a8")
                self.module = ParamModule(quantized)
        else:
            raise ValueError(
                f"unknown quant mode {quant!r} (supported: 'int8', 'int8-memory', 'int8-w8a8')"
            )

    def apply_prompt_template(self, conversation, add_generation_prompt: bool = False):
        return render_template(conversation, self.template, add_generation_prompt)

    def _to_batch(self, enc: Dict[str, np.ndarray], pixels: bool = True) -> LVLMBatch:
        def t(name):
            if name not in enc:
                return None
            count("host_syncs")  # on a card, a blocking copy from pageable memory
            return torch.from_numpy(enc[name]).to(self.device)

        return LVLMBatch(
            input_ids=t("input_ids").long(),
            attention_mask=t("attention_mask"),
            pixel_values=t("pixel_values") if pixels else None,
            patch_mask=t("patch_mask") if pixels else None,
            pixel_mask=t("pixel_mask") if pixels else None,
            image_attention_mask=t("image_attention_mask"),
        )

    def process_input(self, images, text, pad_to: Optional[int] = None) -> LVLMBatch:
        if text and not isinstance(text, str) and not isinstance(text[0], str):
            text = self.apply_prompt_template(text)
        return self._to_batch(self.processor(images, text, pad_to=pad_to))

    def _image_cache_keys(self, images, enc) -> list:
        """One content key per [B, N] pixel slot (padding slots share a key).

        Source images are hashed raw (pre-processing) when their nesting
        matches the processed layout; otherwise the processed pixel slots
        themselves are digested (slower but always layout-correct)."""
        B, N = enc["pixel_values"].shape[:2]
        pad = image_key(None)
        nested = images
        if nested is not None and not isinstance(nested, (list, tuple)):
            nested = [[nested]]
        elif nested and not isinstance(nested[0], (list, tuple)):
            nested = [list(nested)]
        if (
            nested is not None
            and len(nested) == B
            and all(len(row) <= N for row in nested)
        ):
            keys = []
            for row in nested:
                keys.extend(image_key(im) for im in row)
                keys.extend([pad] * (N - len(row)))
            return keys
        px, mask = enc["pixel_values"], enc["pixel_mask"]
        return [
            image_key(px[b, i]) if mask[b, i] else pad
            for b in range(B)
            for i in range(N)
        ]

    def generate(
        self,
        images,
        text,
        num_beams: int = 1,
        max_new_tokens: int = 10,
        length_penalty: float = 0.0,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        **_: Any,
    ) -> List[str]:
        """Prompt → decoded continuations (prompt stripped), HF-generate parity.

        Prompt lengths are bucketed to ``pad_multiple`` (or the smallest
        fitting ``length_buckets`` entry), left-padded.  On a CUDA device the
        vision tower and the prefill run the attention kernels
        (``attn_impl="flash"``); on the CPU they run plain ``sdpa_with_lse``.
        With the vision cache on, the image features come from the cache and
        the pixels of a hit never reach the device.  ``do_sample=True``
        samples (``temperature``, ``top_k``, ``top_p``) from a
        ``torch.Generator`` on the runner's device seeded with ``seed``;
        ``num_beams`` is then ignored, as in the JAX runner.  The call is
        the root of an ``eval.generate`` span; the processor's two calls run
        in ``processor.probe`` and ``processor.encode`` spans.
        """
        with span("eval.generate"):
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
                # (Kimi-VL: on each image's size too, probed without its pixels)
                with span("processor.probe", device=False):
                    probe = ((images, dict(pixels=False)) if self.cfg.family == "kimi-vl"
                             else (None, {}))
                    T = self.processor(probe[0], rendered, **probe[1])["input_ids"].shape[1]
                pad_to = _round_up(T, self.pad_multiple)
                fitting = [b for b in self.length_buckets if b >= T]
                if fitting:
                    pad_to = min(fitting)
                with span("processor.encode", device=False):
                    enc = self.processor(images, rendered, pad_to=pad_to)
            finally:
                self.tokenizer.padding_side = old_side

            attn_impl = "flash" if self.device.type == "cuda" else "xla"
            image_feats = None
            use_cache = self.vision_cache is not None and "pixel_values" in enc
            if use_cache:
                image_feats = self.vision_cache.get_features(
                    self.params, self.cfg, enc["pixel_values"], enc.get("patch_mask"),
                    self._image_cache_keys(images, enc), attn_impl=attn_impl,
                )
            batch = self._to_batch(enc, pixels=not use_cache)
            common = dict(
                max_new_tokens=max_new_tokens,
                eos_token_id=self.tokenizer.eos_token_id,
                pad_token_id=self.tokenizer.pad_token_id,
                shift=self.shift,
                adapters=self.adapters,
                lora_scaling=self.lora_scaling,
                prefix=self.prefix,
                logz2=self.logz2,
                attn_impl=attn_impl,
                decode_params=self.decode_params,
                image_feats=image_feats,
            )
            if do_sample:
                generator = torch.Generator(device=self.device).manual_seed(seed)
                result = sample_generate(
                    self.params, self.cfg, batch, generator=generator,
                    temperature=temperature, top_k=top_k, top_p=top_p, **common,
                )
            elif num_beams > 1:
                result = beam_generate(
                    self.params, self.cfg, batch, num_beams=num_beams,
                    length_penalty=length_penalty, **common,
                )
            else:
                result = greedy_generate(self.params, self.cfg, batch, **common)
            count("host_syncs")  # the tokens read back
            tokens = result.tokens.cpu().numpy()
            return [self.tokenizer.decode(row, skip_special_tokens=True) for row in tokens]
