"""Functional decoder stack: the idefics2 text tower (Mistral-style).

Counterpart of ``mimic_tpu/models/decoder.py``.  Parameters are stacked
``[L, ...]`` tensors (the JAX pytree); the JAX ``lax.scan`` over layers is a
Python loop over ``params["layers"][name][l]`` views.  The MimIC shift enters
per layer beside the weights, and attention returns its log-normalizer so the
μ-gate can use it as log Z₂ (``logz2="masked"``) or the unmasked logsumexp of
the reference ``do_shift`` (``logz2="unmasked"``).

Ported: stacked self-attention layers with the shift-key split, the
cache-empty prefill through the attention kernels (``attn_impl="flash"``), the
cached two-part decode with a beam-shared prompt region, and the cache append.
The hidden-state captures of the training step (``capture_attn`` /
``capture_ffn``, optionally gathered at ``capture_gather_idx``) are ported;
the flash path differentiates through ``flash_attention_diff``.
Int8 weights (``ops/quant.py`` handles, fused ``qkv_proj`` / ``gateup_proj``
or unfused) go through ``qdot`` and ``fused_mlp`` as stacked handles
``{"q8", "scale", "layer": l}`` (no per-layer copy); an int8 prompt cache
(``ops/decode_attention.py``) through ``cached_attention``'s int8 branch.
Not ported yet (raise ``NotImplementedError``): gated cross-attention
(idefics1), q/k/v biases (qwen2), qk-layernorms, the sliding window
(Mistral), LoRA adapters, prefix-merge prefill, ring attention, layer-input
captures and perturbations, rematerialisation, per-row cache writes.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..ops.decode_attention import is_quantized_kv, prompt_kv_len
from ..ops.flash_attention import flash_attention_diff
from ..ops.quant import fused_mlp, qdot
from ..shared import TextConfig
from ..shift.functional import apply_attn_shift, apply_output_shift
from .layers import (
    apply_rope,
    cached_attention,
    repeat_kv,
    rms_norm,
    rope_cos_sin,
    sdpa_with_lse,
    swiglu_mlp,
    unmasked_lse,
)

Params = Dict[str, Any]


class DecoderOutput(NamedTuple):
    hidden: torch.Tensor                                # [B,T,D] final hidden states (pre lm_head)
    attn_capture: Optional[torch.Tensor] = None         # [L,B,T|M,D] self-attn block outputs
    ffn_capture: Optional[torch.Tensor] = None          # [L,B,T|M,D] MLP block outputs
    kv_cache: Optional[Dict[str, Any]] = None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def dense_init(
    generator: torch.Generator, shape, dtype, device, scale: float = 0.02
) -> torch.Tensor:
    """N(0, 1)·scale, drawn in fp32 and cast (one leading-axis slab at a time,
    so an 8B tower never holds a whole fp32 copy of a stacked weight)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    slabs = out if len(shape) == 3 else out[None]
    for slab in slabs:
        slab.copy_(
            torch.randn(slab.shape, generator=generator, device=device, dtype=torch.float32)
            * scale
        )
    return out


def _check_text_cfg(cfg: TextConfig) -> None:
    for name, value in (
        ("gated cross-attention", cfg.cross_attn_interval),
        ("q/k/v biases", cfg.attn_bias),
        ("qk-layernorms", cfg.qk_layernorm),
        ("the sliding window", cfg.sliding_window),
    ):
        if value:
            raise NotImplementedError(f"{name} in the text tower is not ported yet")


def init_decoder_params(
    cfg: TextConfig, generator: torch.Generator, device, dtype=torch.float32
) -> Params:
    _check_text_cfg(cfg)
    L, D, H, Hkv, Dh, F = (
        cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
        cfg.head_size, cfg.intermediate_size,
    )

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def dense(*shape):
        return dense_init(generator, shape, dtype, device)

    layers = {
        "input_ln": ones(L, D),
        "q_proj": dense(L, D, H * Dh),
        "k_proj": dense(L, D, Hkv * Dh),
        "v_proj": dense(L, D, Hkv * Dh),
        "o_proj": dense(L, H * Dh, D),
        "post_ln": ones(L, D),
        "gate_proj": dense(L, D, F),
        "up_proj": dense(L, D, F),
        "down_proj": dense(L, F, D),
    }
    return {"layers": layers, "final_ln": ones(D)}


def init_kv_cache(
    cfg: TextConfig, batch: int, max_len: int, device, dtype=torch.float32
) -> Dict[str, Any]:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_size)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": 0,
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _project_qkv(lp: Params, x: torch.Tensor, cfg: TextConfig):
    B, T, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
    if "qkv_proj" in lp:
        # the int8 serving tree fuses q/k/v into one matmul
        qkv = qdot(x, lp["qkv_proj"])
        q = qkv[..., : H * Dh]
        k = qkv[..., H * Dh : (H + Hkv) * Dh]
        v = qkv[..., (H + Hkv) * Dh :]
    else:
        q, k, v = (qdot(x, lp[name]) for name in ("q_proj", "k_proj", "v_proj"))
    return q.reshape(B, T, H, Dh), k.reshape(B, T, Hkv, Dh), v.reshape(B, T, Hkv, Dh)


def _self_attention(
    lp: Params,
    ls: Params,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],
    cfg: TextConfig,
    cache_k: Optional[torch.Tensor],
    cache_v: Optional[torch.Tensor],
    cache_len: int,
    multi_head: bool,
    logz2: str,
    key_mask: Optional[torch.Tensor],
    use_flash: bool,
    prompt_k: Optional[torch.Tensor] = None,
    prompt_v: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,
):
    """Returns (attn block output [B,T,D], new k block, new v block)."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(lp, x, cfg)
    q, k = apply_rope(q, k, cos, sin)
    need_unmasked = bool(ls) and logz2 == "unmasked"

    if cache_k is not None:
        key_mask_new = key_mask[:, cache_len:cache_len + T]
        gen_key_mask = key_mask[:, prompt_kv_len(prompt_k):] if prompt_k is not None else key_mask
        gen_key_mask = gen_key_mask[:, : cache_k.shape[1]]
        attn, lse, lse_u = cached_attention(
            q, k, v, cache_k, cache_v, cache_len, gen_key_mask, key_mask_new,
            prompt_k=prompt_k, prompt_v=prompt_v, prompt_mask=prompt_mask,
            need_unmasked=need_unmasked,
        )
    elif use_flash:
        # the CUDA kernels on the card, their plain version on the CPU: causal +
        # key padding handled inside, both log-normalizers come out; gradients
        # (out, lse and lse_u) through the backward kernels
        attn, lse, lse_u = flash_attention_diff(
            q, k, v, key_mask, causal=True, need_unmasked=need_unmasked
        )
    else:
        k_rep = repeat_kv(k, cfg.num_groups)
        v_rep = repeat_kv(v, cfg.num_groups)
        attn, lse = sdpa_with_lse(q, k_rep, v_rep, mask)
        lse_u = unmasked_lse(q, k_rep) if need_unmasked else lse
    if ls:
        log_z2 = lse if logz2 == "masked" else lse_u
        attn = apply_attn_shift(ls, q, log_z2, attn, multi_head)
    return qdot(attn.reshape(B, T, -1), lp["o_proj"]), k, v


def _layer_view(w: Any, l: int) -> Any:
    """Layer ``l`` of a stacked leaf: a view of a tensor, or for a quantized
    handle (weights or prompt KV) the stacked handle with ``layer`` set, which
    the kernels read in place."""
    if isinstance(w, dict):
        return dict(w, layer=l)
    return w[l]


_UNPORTED_DEFAULTS = {
    "adapters": None, "lora_scaling": 1.0, "lora_dropout": 0.0, "dropout_rng": None,
    "cross_states": None, "cross_mask": None, "ring_mesh": None,
    "capture_layer_inputs": False, "perturb_attn": None, "perturb_ffn": None,
    "remat": False, "cache_write_pos": None, "prefix_flash_len": 0,
}


def decoder_forward(
    params: Params,
    cfg: TextConfig,
    input_embeds: torch.Tensor,
    attn_mask: Optional[torch.Tensor],
    position_ids: torch.Tensor,
    *,
    shift: Optional[Params] = None,
    multi_head: bool = True,
    kv_cache: Optional[Dict[str, Any]] = None,
    logz2: str = "unmasked",
    key_mask: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    cache_empty: bool = False,
    capture_attn: bool = False,
    capture_ffn: bool = False,
    capture_gather_idx: Optional[torch.Tensor] = None,
    **unported: Any,
) -> DecoderOutput:
    """Run the decoder stack.

    attn_mask: [B,1,T,S] boolean (True = attend) for the plain ``"xla"`` path,
    or None.  position_ids: [B,T].  shift: stacked shift tree ([L, ...]
    leaves) or None.  attn_impl: ``"xla"`` (plain) or ``"flash"`` (the
    attention kernels, when ``select_attn_path`` allows).  kv_cache: dict with
    ``k``/``v`` [L,B,S,Hkv,Dh], ``length`` (int) and optionally the
    beam-shared ``prompt_k``/``prompt_v`` [L,B0,Sp,Hkv,Dh].
    capture_attn / capture_ffn: return each layer's attention / MLP block
    output (after any output shift) as ``[L,B,T,D]``, or ``[L,B,M,D]`` at the
    rows ``capture_gather_idx`` [B,M] selects (an indexing gather; the JAX
    package's one-hot matmul exists for the TPU and is exact either way).

    The cache's ``k``/``v`` tensors are updated in place (the current block is
    written at the timeline length) instead of copied; the returned cache dict
    holds the same tensors with ``length`` advanced by T.
    """
    for name, value in unported.items():
        if name not in _UNPORTED_DEFAULTS:
            raise TypeError(f"decoder_forward() got an unexpected keyword argument {name!r}")
        if isinstance(value, torch.Tensor) or value != _UNPORTED_DEFAULTS[name]:
            raise NotImplementedError(f"decoder_forward: {name} is not ported yet")
    _check_text_cfg(cfg)
    B, T, D = input_embeds.shape
    cos, sin = rope_cos_sin(position_ids, cfg.head_size, cfg.rope_theta, input_embeds.dtype)

    shift = shift or {}
    attn_shift_keys = ("attn_v", "attn_logz1_w", "attn_logz1_b")
    layer_shift = {k: v for k, v in shift.items() if k in attn_shift_keys}
    out_shift = {k: v for k, v in shift.items() if k not in attn_shift_keys}

    use_cache = kv_cache is not None
    cache_len = int(kv_cache["length"]) if use_cache else 0
    has_prompt = use_cache and "prompt_k" in kv_cache
    prompt_quant = has_prompt and is_quantized_kv(kv_cache["prompt_k"])
    prompt_len = prompt_kv_len(kv_cache["prompt_k"]) if has_prompt else 0
    if use_cache and key_mask is None:
        key_mask = torch.ones(
            B, prompt_len + kv_cache["k"].shape[2], dtype=torch.int32,
            device=input_embeds.device,
        )
    prompt_mask = None
    if has_prompt:
        # per-beam rows of the timeline mask are identical within a batch row's
        # beam group (one prefill, tiled): reduce to B0 rows once
        B0 = (kv_cache["prompt_k"]["q8"] if prompt_quant else kv_cache["prompt_k"]).shape[1]
        prompt_mask = key_mask[:, :prompt_len].reshape(B0, B // B0, prompt_len)[:, 0]
    attend_cacheless = not use_cache or cache_empty
    selected = select_attn_path(
        cfg, attn_impl, T, cacheless=attend_cacheless, has_key_mask=key_mask is not None
    )
    ATTN_PATH_LOG.append(selected)
    if prompt_quant:
        ATTN_PATH_LOG.append("quant_kv")  # once per call, as JAX logs it once per trace
    use_flash = selected == "flash"
    layer_key_mask = key_mask[:, :T] if (use_cache and cache_empty) else key_mask

    layers = params["layers"]
    write_at = cache_len - prompt_len

    def capture(x: torch.Tensor) -> torch.Tensor:
        if capture_gather_idx is None:
            return x
        idx = capture_gather_idx.long()[..., None].expand(-1, -1, x.shape[-1])
        return torch.gather(x, 1, idx)

    attn_caps, ffn_caps = [], []
    h = input_embeds
    for l in range(cfg.num_layers):
        lp = {name: _layer_view(w, l) for name, w in layers.items()}
        ls = {name: w[l] for name, w in layer_shift.items()}
        os_ = {name: w[l] for name, w in out_shift.items()}
        residual = h
        hn = rms_norm(h, lp["input_ln"], cfg.norm_eps)
        attn_out, k_new, v_new = _self_attention(
            lp, ls, hn, cos, sin, attn_mask, cfg,
            None if attend_cacheless else kv_cache["k"][l],
            None if attend_cacheless else kv_cache["v"][l],
            cache_len, multi_head, logz2,
            key_mask=layer_key_mask,
            use_flash=use_flash,
            prompt_k=_layer_view(kv_cache["prompt_k"], l) if has_prompt else None,
            prompt_v=_layer_view(kv_cache["prompt_v"], l) if has_prompt else None,
            prompt_mask=prompt_mask,
        )
        attn_out = apply_output_shift(
            attn_out, os_.get("attn_out_shift"), os_.get("attn_out_scale")
        )
        h = residual + attn_out
        residual = h
        hn = rms_norm(h, lp["post_ln"], cfg.norm_eps)
        if "gateup_proj" in lp:
            # decode-sized M on the card: the whole MLP in one kernel; else the
            # two-qdot path (JAX decoder.py:541-552)
            ffn_out = fused_mlp(hn, lp["gateup_proj"], lp["down_proj"])
            if ffn_out is None:
                gu = qdot(hn, lp["gateup_proj"])
                F = gu.shape[-1] // 2
                ffn_out = qdot(torch.nn.functional.silu(gu[..., :F]) * gu[..., F:],
                               lp["down_proj"])
        else:
            ffn_out = swiglu_mlp(hn, lp["gate_proj"], lp["up_proj"], lp["down_proj"])
        ffn_out = apply_output_shift(ffn_out, os_.get("ffn_shift"), os_.get("ffn_scale"))
        h = residual + ffn_out
        if capture_attn:
            attn_caps.append(capture(attn_out))
        if capture_ffn:
            ffn_caps.append(capture(ffn_out))
        if use_cache:
            # the layer read its cache slice above; slots >= the written length
            # are masked there, so appending now changes nothing it saw
            kv_cache["k"][l, :, write_at:write_at + T] = k_new.to(kv_cache["k"].dtype)
            kv_cache["v"][l, :, write_at:write_at + T] = v_new.to(kv_cache["v"].dtype)

    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    new_cache = None
    if use_cache:
        new_cache = {"k": kv_cache["k"], "v": kv_cache["v"], "length": cache_len + T}
        if has_prompt:
            new_cache["prompt_k"] = kv_cache["prompt_k"]
            new_cache["prompt_v"] = kv_cache["prompt_v"]
    return DecoderOutput(
        hidden=h,
        attn_capture=torch.stack(attn_caps) if capture_attn else None,
        ffn_capture=torch.stack(ffn_caps) if capture_ffn else None,
        kv_cache=new_cache,
    )


# ---------------------------------------------------------------------------
# attention path selection
# ---------------------------------------------------------------------------

# log of the attention path each decoder_forward call selected — tests and the
# chip smoke run assert which implementation actually ran
ATTN_PATH_LOG: list = []


def select_attn_path(
    cfg: TextConfig,
    attn_impl: str,
    T: int,
    *,
    cacheless: bool,
    has_key_mask: bool,
) -> str:
    """Which attention implementation a decoder_forward call uses.

    - ``"flash"``: the attention kernels — cacheless, 2D key mask present,
      128-aligned T and head size, no sliding window narrower than T;
    - ``"cached"``: the two-part read-only-cache path (decode steps);
    - ``"xla"``: plain masked sdpa (the name is kept from the JAX package).
    """
    if attn_impl == "ring":
        raise NotImplementedError("ring attention is not ported yet")
    if not cacheless:
        return "cached"
    if (
        attn_impl == "flash"
        and has_key_mask
        and T % 128 == 0
        and cfg.head_size % 128 == 0
        and (cfg.sliding_window is None or T <= cfg.sliding_window)
    ):
        return "flash"
    return "xla"


# ---------------------------------------------------------------------------
# masks / positions helpers
# ---------------------------------------------------------------------------


def make_causal_mask(
    attention_mask: torch.Tensor, sliding_window: Optional[int] = None
) -> torch.Tensor:
    """[B,T] padding mask → [B,1,T,T] causal+padding boolean mask (True=attend)."""
    B, T = attention_mask.shape
    dev = attention_mask.device
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    if sliding_window is not None:
        idx = torch.arange(T, device=dev)
        causal = causal & ((idx[:, None] - idx[None, :]) < sliding_window)
    key_ok = attention_mask[:, None, None, :].bool()
    return causal[None, None] & key_ok


def positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF-style position ids for padded batches: cumsum(mask) - 1, clamped at 0."""
    pos = torch.cumsum(attention_mask.to(torch.int64), dim=-1) - 1
    return pos.clamp_min(0)
