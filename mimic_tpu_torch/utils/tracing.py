"""Introspection utilities (counterpart of ``mimic_tpu/utils/tracing.py``).

The reference's ``ForwardTracker`` / ``GradTracker`` / ``LocalsTracker``
capture per-module activations, gradients and a method's locals through
hooks.  The functional model returns its intermediates instead:

- ``capture_forward``: the forward with every layer's attention and MLP block
  outputs stacked ``[L,B,T,D]``;
- ``capture_grads``: the gradients of a scalar function of the logits with
  respect to every layer's block outputs, from one backward pass through
  zero perturbations added at those outputs (JAX: ``jax.grad`` over them);
- ``attention_probs``: one layer's attention probabilities, recomputed from
  its captured input;
- ``profile``: a ``torch.profiler`` trace of a region, written as a Chrome
  trace (JAX: ``jax.profiler``).

``**kwargs`` reach ``lvlm_forward``: ``attn_impl="flash"`` runs the attention
kernels on the card, and ``capture_grads`` then differentiates through their
backward kernels.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from ..models.config import ModelConfig
from ..models.decoder import make_causal_mask
from ..models.layers import apply_rope, repeat_kv, rms_norm, rope_cos_sin
from ..models.lvlm import LVLMBatch, lvlm_forward


def capture_forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    batch: LVLMBatch,
    **kwargs,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward pass returning (logits, {"attn": [L,B,T,D], "ffn": [L,B,T,D]})."""
    out = lvlm_forward(params, cfg, batch, capture_attn=True, capture_ffn=True, **kwargs)
    return out.logits, {
        "attn": out.decoder.attn_capture,
        "ffn": out.decoder.ffn_capture,
    }


def capture_grads(
    params: Dict[str, Any],
    cfg: ModelConfig,
    batch: LVLMBatch,
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    **kwargs,
) -> Dict[str, torch.Tensor]:
    """d loss(logits) / d (per-layer block outputs), one backward pass.

    Zero perturbations [L,B,T,D] in the model's dtype are added at every
    layer's attention and MLP block outputs; by linearity the gradient with
    respect to them at zero is the gradient with respect to the outputs.  The
    JAX version runs ``capture_forward`` first for their shapes; here the
    shapes come from the config and the batch.
    """
    B, T = batch.input_ids.shape
    shape = (cfg.text.num_layers, B, T, cfg.text.hidden_size)
    embed = params["lm"]["embed"]
    with torch.enable_grad():
        eps = [torch.zeros(shape, dtype=embed.dtype, device=embed.device, requires_grad=True)
               for _ in range(2)]
        out = lvlm_forward(params, cfg, batch, perturb_attn=eps[0], perturb_ffn=eps[1], **kwargs)
        g_attn, g_ffn = torch.autograd.grad(loss_fn(out.logits), eps)
    return {"attn": g_attn, "ffn": g_ffn}


def attention_probs(
    params: Dict[str, Any],
    cfg: ModelConfig,
    batch: LVLMBatch,
    layer: int,
    **kwargs,
) -> torch.Tensor:
    """Recompute layer ``layer``'s attention probabilities [B,H,T,S] (fp32)
    from its captured input, as the JAX version does: q/k projections and
    biases, RoPE at positions 0..T-1, the qk-norms after RoPE, the GQA repeat,
    and the causal mask with the padding and any sliding window."""
    out = lvlm_forward(params, cfg, batch, capture_layer_inputs=True, **kwargs)
    h = out.decoder.layer_inputs[layer]  # [B,T,D]
    text = cfg.text
    lp = {name: w[layer] for name, w in params["lm"]["decoder"]["layers"].items()}
    x = rms_norm(h, lp["input_ln"], text.norm_eps)
    B, T, _ = x.shape
    H, Hkv, Dh = text.num_heads, text.num_kv_heads, text.head_size
    q = x @ lp["q_proj"]
    k = x @ lp["k_proj"]
    if "q_bias" in lp:
        q = q + lp["q_bias"]
        k = k + lp["k_bias"]
    q = q.reshape(B, T, H, Dh)
    k = k.reshape(B, T, Hkv, Dh)
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    cos, sin = rope_cos_sin(positions, Dh, text.rope_theta, x.dtype)
    q, k = apply_rope(q, k, cos, sin)
    if text.qk_layernorm:
        q = rms_norm(q, lp["q_ln"], text.norm_eps)
        k = rms_norm(k, lp["k_ln"], text.norm_eps)
    k = repeat_kv(k, text.num_groups)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / (Dh**0.5)
    mask = make_causal_mask(batch.attention_mask, text.sliding_window)
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=scores.device))
    return torch.softmax(scores, dim=-1)


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block, CPU and (with a card) CUDA
    activities; on exit the trace is written to ``log_dir/trace.json``
    (Chrome's trace format: chrome://tracing, Perfetto, TensorBoard's
    profiler plugin).  Yields the profiler, whose ``key_averages()`` sum
    the events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
