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
  trace (JAX: ``jax.profiler``), with the program's spans beside it;
- ``span`` / ``count``: the program's own spans and counters at its layer
  boundaries (the train step's stages, the eval's processor, prefill and beam
  steps, host syncs), recorded only while a ``torch.profiler`` profile
  records and read back by ``recorded``.

``**kwargs`` reach ``lvlm_forward``: ``attn_impl="flash"`` runs the attention
kernels on the card, and ``capture_grads`` then differentiates through their
backward kernels.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# the model modules import ``span`` and ``count`` from here, so the helpers
# above the recorder import the models when they are called
if TYPE_CHECKING:
    from ..models.config import ModelConfig
    from ..models.lvlm import LVLMBatch


def capture_forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    batch: LVLMBatch,
    **kwargs,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward pass returning (logits, {"attn": [L,B,T,D], "ffn": [L,B,T,D]})."""
    from ..models.lvlm import lvlm_forward

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
    from ..models.lvlm import lvlm_forward

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
    from ..models.decoder import is_mla, make_causal_mask
    from ..models.layers import apply_rope, repeat_kv, rms_norm, rope_cos_sin
    from ..models.lvlm import lvlm_forward

    text = cfg.text
    if is_mla(text):
        raise NotImplementedError("attention_probs: latent attention's q and k are not "
                                  "recomputed here (q_proj / k_proj towers only)")
    out = lvlm_forward(params, cfg, batch, capture_layer_inputs=True, **kwargs)
    h = out.decoder.layer_inputs[layer]  # [B,T,D]
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


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------

_SPANS: List["_Span"] = []
_COUNTS: Dict[str, int] = {}
_IDS = itertools.count()
_OPEN = threading.local()  # each thread's stack of open spans
_IDLE = contextlib.nullcontext()


class _Span:
    """One span: its name, id, parent and root ids, host start and end on the
    profiler's clock (``time.time_ns``), and on a card two timing events on
    the current stream, read only by ``recorded``."""

    __slots__ = ("name", "device", "id", "parent", "root", "start_ns", "end_ns", "events")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self.end_ns: Optional[int] = None
        self.events: Optional[List[torch.cuda.Event]] = None

    def __enter__(self) -> "_Span":
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        _SPANS.append(self)
        self.start_ns = time.time_ns()
        if self.device and torch.cuda.is_initialized():
            self.events = [torch.cuda.Event(enable_timing=True)]
            self.events[0].record()
        return self

    def __exit__(self, *exc) -> None:
        if self.events is not None:
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[1].record()
        self.end_ns = time.time_ns()
        _OPEN.stack.pop()


def span(name: str, device: bool = True):
    """A context manager that records the block as span ``name`` while a
    ``torch.profiler`` profile records, and does nothing otherwise (one flag
    check: no event, no record, no allocation).  ``device=False``: a span of
    host work alone, with no device events."""
    if not _autograd_profiler._is_profiler_enabled:
        return _IDLE
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a ``torch.profiler`` profile records."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def reset() -> None:
    """Forget the spans and counters recorded so far."""
    global _IDS
    _SPANS.clear()
    _COUNTS.clear()
    _IDS = itertools.count()


def recorded() -> Dict[str, Any]:
    """The closed spans and the counters recorded since the last ``reset``.

    Each span is a dict: ``name``, ``id``, ``parent`` (None for a root),
    ``root``, ``start_ns`` / ``end_ns`` (host, on the profiler's clock),
    ``host_ms``, ``device_ms`` (between its two events on its stream; None for
    a host span or without a card) and the self times ``self_host_ms`` /
    ``self_device_ms``: the duration less what its child spans cover.  Reading
    the device events first waits for the card."""
    spans = [s for s in list(_SPANS) if s.end_ns is not None]
    if any(s.events is not None for s in spans):
        torch.cuda.synchronize()
    out = []
    for s in spans:
        out.append(dict(
            name=s.name, id=s.id, parent=s.parent, root=s.root,
            start_ns=s.start_ns, end_ns=s.end_ns, host_ms=(s.end_ns - s.start_ns) / 1e6,
            device_ms=None if s.events is None else s.events[0].elapsed_time(s.events[1]),
        ))
    child_host: Dict[int, float] = {}
    child_device: Dict[int, float] = {}
    for r in out:
        if r["parent"] is not None:
            child_host[r["parent"]] = child_host.get(r["parent"], 0.0) + r["host_ms"]
            if r["device_ms"] is not None:
                child_device[r["parent"]] = child_device.get(r["parent"], 0.0) + r["device_ms"]
    for r in out:
        r["self_host_ms"] = r["host_ms"] - child_host.get(r["id"], 0.0)
        r["self_device_ms"] = (None if r["device_ms"] is None
                               else r["device_ms"] - child_device.get(r["id"], 0.0))
    return {"spans": out, "counts": dict(_COUNTS)}


def _write_spans(trace_path: str, path: str) -> None:
    """The recorded spans as a Chrome trace on the time base of the profiler's
    trace at ``trace_path`` (its ``baseTimeNanoseconds``), so that their
    ``traceEvents`` laid beside the profiler's put the program's stages over
    its operators and kernels; the counters under ``otherData``."""
    with open(trace_path) as f:
        base = json.load(f).get("baseTimeNanoseconds", 0)
    rec = recorded()
    pid = os.getpid()
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
         "args": {"name": "mimic_tpu_torch spans"}}]
    for r in rec["spans"]:
        events.append({
            "ph": "X", "cat": "program_span", "name": r["name"], "pid": pid, "tid": 0,
            "ts": (r["start_ns"] - base) / 1e3, "dur": r["host_ms"] * 1e3,
            "args": {k: r[k] for k in ("id", "parent", "root", "device_ms",
                                       "self_host_ms", "self_device_ms")},
        })
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base, "otherData": {"counts": rec["counts"]}}, f)


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block, CPU and (with a card) CUDA
    activities; on exit the trace is written to ``log_dir/trace.json``
    (Chrome's trace format: chrome://tracing, Perfetto, TensorBoard's
    profiler plugin) and the program's spans recorded in the block to
    ``log_dir/spans.json``, on the same time base.  Yields the profiler,
    whose ``key_averages()`` sum the events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    reset()
    try:
        with prof:
            yield prof
    finally:
        trace = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(trace)
        _write_spans(trace, os.path.join(log_dir, "spans.json"))
