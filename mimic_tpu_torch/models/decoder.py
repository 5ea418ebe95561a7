"""Functional decoder stack: the idefics2 text tower (Mistral-style) and the
idefics1 text tower (LLaMA-style, with gated cross-attention).

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
the flash path differentiates through ``flash_attention_diff``.  LoRA
adapters (with dropout on their inputs), the prefix-tuning prefill
(``prefix_flash_len``) and per-layer rematerialisation (``remat``).
Int8 weights (``ops/quant.py`` handles, fused ``qkv_proj`` / ``gateup_proj``
or unfused) go through ``qdot`` and ``fused_mlp`` as stacked handles
``{"q8", "scale", "layer": l}`` (no per-layer copy); an int8 prompt cache
(``ops/decode_attention.py``) through ``cached_attention``'s int8 branch.
IDEFICS-1's gated cross-attention (``cross_states`` / ``cross_mask``): one
cross layer before each group of ``cross_attn_interval`` self layers, q from
the text, k/v from the image states, plain ``sdpa_with_lse`` and
tanh-gated residuals; its weights are sliced per layer as 2-D tensors or 2-D
int8 handles (as ``jax.tree.map(lambda a: a[g], ...)`` does).
Qwen2's q/k/v biases (added after the projection, before any LoRA delta),
self-attention qk-norms (RMS norms per head, after RoPE as in the JAX package)
and Mistral's sliding window (the plain prefill's mask and the cached decode).
Not ported yet (raise ``NotImplementedError``): ring attention, layer-input
captures and perturbations, per-row cache writes.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from ..ops.decode_attention import is_quantized_kv, prompt_kv_len
from ..ops.flash_attention import flash_attention_diff
from ..ops.quant import fused_mlp, qdot
from .config import TextConfig
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


def init_decoder_params(
    cfg: TextConfig, generator: torch.Generator, device, dtype=torch.float32
) -> Params:
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
    if cfg.attn_bias:
        # qwen2: biases on q/k/v, never quantized (JAX ops/quant.py:175)
        layers["q_bias"] = torch.zeros(L, H * Dh, dtype=dtype, device=device)
        layers["k_bias"] = torch.zeros(L, Hkv * Dh, dtype=dtype, device=device)
        layers["v_bias"] = torch.zeros(L, Hkv * Dh, dtype=dtype, device=device)
    if cfg.qk_layernorm:
        layers["q_ln"] = ones(L, Dh)
        layers["k_ln"] = ones(L, Dh)
    params: Params = {"layers": layers, "final_ln": ones(D)}
    G = cfg.num_cross_layers
    if G:
        # gated cross-attention (IDEFICS-1): q from the text, k/v from image states
        kv_dim = cfg.cross_kv_dim or D
        params["cross"] = {
            "input_ln": ones(G, D),
            "q_proj": dense(G, D, H * Dh),
            "k_proj": dense(G, kv_dim, Hkv * Dh),
            "v_proj": dense(G, kv_dim, Hkv * Dh),
            "o_proj": dense(G, H * Dh, D),
            "post_ln": ones(G, D),
            "gate_proj": dense(G, D, F),
            "up_proj": dense(G, D, F),
            "down_proj": dense(G, F, D),
            "alpha_attn": torch.zeros(G, dtype=dtype, device=device),
            "alpha_dense": torch.zeros(G, dtype=dtype, device=device),
        }
        if cfg.cross_qk_layernorm:
            params["cross"]["q_ln"] = ones(G, Dh)
            params["cross"]["k_ln"] = ones(G, Dh)
    return params


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


def lora_dropout_keep(
    generator: torch.Generator, layer: int, slot: int, shape, rate: float
) -> torch.Tensor:
    """LoRA dropout's keep mask (bool, ``shape``) for adapter input ``slot``
    (0-3: q, k, v, o) of ``layer``: each element kept with probability
    1 - ``rate`` (JAX: ``bernoulli(key[layer, slot], 1 - rate, shape)``),
    drawn from ``generator`` in call order.  One function of (generator,
    layer, slot, shape), so that a test can hand in the masks JAX drew."""
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return u < 1.0 - rate


def _lora_delta(
    ad: Params, name: str, x: torch.Tensor, scaling: float,
    keep: Optional[torch.Tensor] = None, rate: float = 0.0,
) -> Optional[torch.Tensor]:
    """scaling · B(A(dropout(x))) for one projection, or None (dropout on the
    adapter input only, peft's semantics).  The adapter math runs in the
    adapter's dtype (fp32 trainables over a bf16 tower: ``torch.matmul`` does
    not promote bf16 x fp32 as ``jnp.dot`` does, so x is cast); the delta
    returns in x's dtype."""
    a, b = ad.get(f"{name}_a"), ad.get(f"{name}_b")
    if a is None:
        return None
    if keep is not None:
        x = torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
    return (scaling * torch.matmul(torch.matmul(x.to(a.dtype), a), b)).to(x.dtype)


def _project_qkv(
    lp: Params, ad: Params, x: torch.Tensor, cfg: TextConfig, scaling: float,
    keeps: Optional[list], rate: float,
):
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
    if "q_bias" in lp:
        q, k, v = q + lp["q_bias"], k + lp["k_bias"], v + lp["v_bias"]
    out = []
    for slot, (name, y) in enumerate((("q", q), ("k", k), ("v", v))):
        delta = _lora_delta(ad, name, x, scaling, keeps[slot] if keeps else None, rate)
        out.append(y if delta is None else y + delta)
    q, k, v = out
    return q.reshape(B, T, H, Dh), k.reshape(B, T, Hkv, Dh), v.reshape(B, T, Hkv, Dh)


def _merge_prefix(q, attn_f, lse_f, lse_u_f, prefix_k, prefix_v, G):
    """The prefix-tuning prefill's merge (JAX ``decoder.py:232-276``): the
    block's own cacheless attention (attn_f, lse_f, lse_u_f) and the P prefix
    slots, all attendable, through a small unmasked sdpa; the two normalized
    parts are combined by logsumexp in fp32.  Returns (attn, lse, lse_u), lse_u
    (when lse_u_f is given) the logsumexp of the block's unmasked and the
    prefix's log-normalizers."""
    attn_p, lse_p = sdpa_with_lse(q, repeat_kv(prefix_k, G), repeat_kv(prefix_v, G), None)
    m = torch.maximum(lse_f, lse_p)
    wf, wp = torch.exp(lse_f - m), torch.exp(lse_p - m)
    denom = wf + wp
    attn = (
        attn_f.float() * (wf / denom)[..., None] + attn_p.float() * (wp / denom)[..., None]
    ).to(q.dtype)
    lse = m + torch.log(denom)
    lse_u = None
    if lse_u_f is not None:
        mu = torch.maximum(lse_u_f, lse_p)
        lse_u = mu + torch.log(torch.exp(lse_u_f - mu) + torch.exp(lse_p - mu))
    return attn, lse, lse_u


def _self_attention(
    lp: Params,
    ls: Params,
    ad: Params,
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
    lora_scaling: float = 1.0,
    keeps: Optional[list] = None,
    drop_rate: float = 0.0,
    prompt_k: Optional[torch.Tensor] = None,
    prompt_v: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,
    prefix_merge_len: int = 0,
):
    """Returns (attn block output [B,T,D], new k block, new v block).

    ``prefix_merge_len`` (P > 0, the prefix-tuning prefill): the cache holds
    only the P prefix slots; the block takes the cacheless path and
    ``_merge_prefix`` adds them."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(lp, ad, x, cfg, lora_scaling, keeps, drop_rate)
    q, k = apply_rope(q, k, cos, sin)
    if cfg.qk_layernorm:
        # after RoPE, as the JAX package orders them (HF's Qwen3 norms before it)
        q = rms_norm(q, lp["q_ln"], cfg.norm_eps)
        k = rms_norm(k, lp["k_ln"], cfg.norm_eps)
    need_unmasked = bool(ls) and logz2 == "unmasked"

    P = prefix_merge_len if cache_k is not None else 0
    if P:
        # the block attends itself through the cacheless branches below
        key_mask = key_mask[:, cache_len:cache_len + T]
        if not use_flash:
            causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
            mask = causal[None, None] & (key_mask > 0)[:, None, None, :]
    if cache_k is not None and not P:
        key_mask_new = key_mask[:, cache_len:cache_len + T]
        gen_key_mask = key_mask[:, prompt_kv_len(prompt_k):] if prompt_k is not None else key_mask
        gen_key_mask = gen_key_mask[:, : cache_k.shape[1]]
        attn, lse, lse_u = cached_attention(
            q, k, v, cache_k, cache_v, cache_len, gen_key_mask, key_mask_new,
            prompt_k=prompt_k, prompt_v=prompt_v, prompt_mask=prompt_mask,
            window=cfg.sliding_window, need_unmasked=need_unmasked,
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
    if P:
        attn, lse, lse_u = _merge_prefix(
            q, attn, lse, lse_u if need_unmasked else None, cache_k[:, :P], cache_v[:, :P],
            cfg.num_groups,
        )
    if ls:
        log_z2 = lse if logz2 == "masked" else lse_u
        attn = apply_attn_shift(ls, q, log_z2, attn, multi_head)
    attn_flat = attn.reshape(B, T, -1)
    out = qdot(attn_flat, lp["o_proj"])
    delta = _lora_delta(ad, "o", attn_flat, lora_scaling, keeps[3] if keeps else None, drop_rate)
    return (out if delta is None else out + delta), k, v


def _cross_attention(
    cp: Params,
    x: torch.Tensor,
    cross_states: torch.Tensor,
    cross_mask: Optional[torch.Tensor],
    cfg: TextConfig,
) -> torch.Tensor:
    """IDEFICS-1 gated cross-attention and gated MLP of one cross layer (JAX
    ``_cross_attention``).  ``cross_mask`` [B,1,T,S] (True = attend) or None.
    A text row before the first image has an all-false mask row: the plain
    ``sdpa_with_lse`` gives it the mean of v, never NaN, as in JAX."""
    B, T, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
    S = cross_states.shape[1]
    h = rms_norm(x, cp["input_ln"], cfg.norm_eps)
    q = qdot(h, cp["q_proj"]).reshape(B, T, H, Dh)
    k = qdot(cross_states, cp["k_proj"]).reshape(B, S, Hkv, Dh)
    v = qdot(cross_states, cp["v_proj"]).reshape(B, S, Hkv, Dh)
    if cfg.cross_qk_layernorm:
        q = rms_norm(q, cp["q_ln"], cfg.norm_eps)
        k = rms_norm(k, cp["k_ln"], cfg.norm_eps)
    attn, _ = sdpa_with_lse(
        q, repeat_kv(k, cfg.num_groups), repeat_kv(v, cfg.num_groups), cross_mask
    )
    attn_out = qdot(attn.reshape(B, T, -1), cp["o_proj"])
    h = x + torch.tanh(cp["alpha_attn"]).to(x.dtype) * attn_out
    m = rms_norm(h, cp["post_ln"], cfg.norm_eps)
    mlp_out = swiglu_mlp(m, cp["gate_proj"], cp["up_proj"], cp["down_proj"])
    return h + torch.tanh(cp["alpha_dense"]).to(x.dtype) * mlp_out


def _cross_view(w: Any, g: int) -> Any:
    """Cross layer ``g`` of a stacked leaf; a quantized handle becomes a 2-D
    handle (its ``q8`` / ``scale`` sliced), as the JAX package slices it."""
    if isinstance(w, dict):
        return {name: t[g] for name, t in w.items()}
    return w[g]


def _layer_view(w: Any, l: int) -> Any:
    """Layer ``l`` of a stacked leaf: a view of a tensor, or for a quantized
    handle (weights or prompt KV) the stacked handle with ``layer`` set, which
    the kernels read in place."""
    if isinstance(w, dict):
        return dict(w, layer=l)
    return w[l]


_UNPORTED_DEFAULTS = {
    "ring_mesh": None,
    "capture_layer_inputs": False, "perturb_attn": None, "perturb_ffn": None,
    "cache_write_pos": None,
}


def decoder_forward(
    params: Params,
    cfg: TextConfig,
    input_embeds: torch.Tensor,
    attn_mask: Optional[torch.Tensor],
    position_ids: torch.Tensor,
    *,
    shift: Optional[Params] = None,
    adapters: Optional[Params] = None,
    lora_scaling: float = 1.0,
    lora_dropout: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    multi_head: bool = True,
    kv_cache: Optional[Dict[str, Any]] = None,
    logz2: str = "unmasked",
    key_mask: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    cache_empty: bool = False,
    capture_attn: bool = False,
    capture_ffn: bool = False,
    capture_gather_idx: Optional[torch.Tensor] = None,
    remat: bool = False,
    prefix_flash_len: int = 0,
    cross_states: Optional[torch.Tensor] = None,
    cross_mask: Optional[torch.Tensor] = None,
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

    adapters: stacked LoRA tree (``shift/lora.py``), added to the q/k/v/o
    projections (after ``qdot`` and the fused ``qkv_proj`` split of an int8
    tree) times ``lora_scaling``; with ``lora_dropout`` > 0 and a
    ``dropout_generator``, each adapter input is dropped by
    ``lora_dropout_keep``'s mask, drawn before the layer runs.
    remat: with gradients recorded, each layer's body runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass.
    prefix_flash_len: P > 0 when the cache holds only P prefix-tuning slots
    (the prefix prefill): the prompt block takes the cacheless path and the
    prefix part is merged in (``_merge_prefix``); logged as ``"<path>+prefix"``.
    cross_states [B,S,Dkv] / cross_mask [B,1,T,S]: the image states of a
    gated cross-attention tower (idefics1) and which of them each row
    attends; cross layer g runs before self layer g·``cross_attn_interval``
    (without ``cross_states`` the cross layers are skipped, as in JAX).

    The current block's k/v are written into the cache at the timeline
    length.  Without gradients they are written in place and the returned
    cache holds the same tensors; with gradients recorded the returned
    cache's tensors are new: autograd may hold views of the old ones for the
    backward pass (``torch.einsum`` saves the cache itself where no permute
    copies it, as with one KV head), and the prefix train step's cache is
    made from the trainable prefix.  Its ``length`` is advanced by T.
    """
    for name, value in unported.items():
        if name not in _UNPORTED_DEFAULTS:
            raise TypeError(f"decoder_forward() got an unexpected keyword argument {name!r}")
        if isinstance(value, torch.Tensor) or value != _UNPORTED_DEFAULTS[name]:
            raise NotImplementedError(f"decoder_forward: {name} is not ported yet")
    B, T, D = input_embeds.shape
    cos, sin = rope_cos_sin(position_ids, cfg.head_size, cfg.rope_theta, input_embeds.dtype)

    shift = shift or {}
    adapters = adapters or {}
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
    # the prefix-tuning prefill: the block attends itself cachelessly (through
    # the kernels) and the prefix part is merged in, instead of
    # cached_attention's [B,Hkv,G,T,S] fp32 scores at multi-thousand-token prompts
    prefix_merge = (
        prefix_flash_len > 0 and use_cache and not cache_empty and not has_prompt
        and T > 1 and cfg.sliding_window is None
    )
    selected = select_attn_path(
        cfg, attn_impl, T, cacheless=attend_cacheless or prefix_merge,
        has_key_mask=key_mask is not None,
    )
    ATTN_PATH_LOG.append(selected + "+prefix" if prefix_merge else selected)
    if prompt_quant:
        ATTN_PATH_LOG.append("quant_kv")  # once per call, as JAX logs it once per trace
    use_flash = selected == "flash"
    layer_key_mask = key_mask[:, :T] if (use_cache and cache_empty) else key_mask
    drop = dropout_generator is not None and lora_dropout > 0.0 and bool(adapters)
    in_place = not torch.is_grad_enabled()
    remat = remat and torch.is_grad_enabled()

    layers = params["layers"]
    write_at = cache_len - prompt_len

    def capture(x: torch.Tensor) -> torch.Tensor:
        if capture_gather_idx is None:
            return x
        idx = capture_gather_idx.long()[..., None].expand(-1, -1, x.shape[-1])
        return torch.gather(x, 1, idx)

    def layer_body(h: torch.Tensor, l: int, keeps: Optional[list]):
        lp = {name: _layer_view(w, l) for name, w in layers.items()}
        ls = {name: w[l] for name, w in layer_shift.items()}
        os_ = {name: w[l] for name, w in out_shift.items()}
        ad = {name: w[l] for name, w in adapters.items()}
        residual = h
        hn = rms_norm(h, lp["input_ln"], cfg.norm_eps)
        attn_out, k_new, v_new = _self_attention(
            lp, ls, ad, hn, cos, sin, attn_mask, cfg,
            None if attend_cacheless else kv_cache["k"][l],
            None if attend_cacheless else kv_cache["v"][l],
            cache_len, multi_head, logz2,
            key_mask=layer_key_mask,
            use_flash=use_flash,
            lora_scaling=lora_scaling, keeps=keeps, drop_rate=lora_dropout,
            prompt_k=_layer_view(kv_cache["prompt_k"], l) if has_prompt else None,
            prompt_v=_layer_view(kv_cache["prompt_v"], l) if has_prompt else None,
            prompt_mask=prompt_mask,
            prefix_merge_len=prefix_flash_len if prefix_merge else 0,
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
        return residual + ffn_out, attn_out, ffn_out, k_new, v_new

    attn_caps, ffn_caps, k_blocks, v_blocks = [], [], [], []
    cross = params.get("cross") if cfg.cross_attn_interval else None
    h = input_embeds
    for l in range(cfg.num_layers):
        if cross is not None and cross_states is not None and l % cfg.cross_attn_interval == 0:
            g = l // cfg.cross_attn_interval
            cp = {name: _cross_view(w, g) for name, w in cross.items()}
            h = _cross_attention(cp, h, cross_states, cross_mask, cfg)
        keeps = None
        if drop:
            # drawn outside the rematerialised body: the recompute must see the
            # same masks, and checkpoint restores only the default generators
            shapes = ((B, T, D),) * 3 + ((B, T, cfg.num_heads * cfg.head_size),)
            keeps = [
                lora_dropout_keep(dropout_generator, l, slot, shape, lora_dropout)
                if f"{name}_a" in adapters else None
                for slot, (name, shape) in enumerate(zip("qkvo", shapes))
            ]
        if remat:
            h, attn_out, ffn_out, k_new, v_new = torch.utils.checkpoint.checkpoint(
                layer_body, h, l, keeps, use_reentrant=False
            )
        else:
            h, attn_out, ffn_out, k_new, v_new = layer_body(h, l, keeps)
        if capture_attn:
            attn_caps.append(capture(attn_out))
        if capture_ffn:
            ffn_caps.append(capture(ffn_out))
        if use_cache and in_place:
            # the layer read its cache slice above; slots >= the written length
            # are masked there, so appending now changes nothing it saw
            kv_cache["k"][l, :, write_at:write_at + T] = k_new.to(kv_cache["k"].dtype)
            kv_cache["v"][l, :, write_at:write_at + T] = v_new.to(kv_cache["v"].dtype)
        elif use_cache:
            k_blocks.append(k_new)
            v_blocks.append(v_new)

    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    new_cache = None
    if use_cache:
        ck, cv = kv_cache["k"], kv_cache["v"]
        if not in_place:
            def append(c, blocks):
                return torch.cat(
                    [c[:, :, :write_at], torch.stack(blocks).to(c.dtype), c[:, :, write_at + T:]],
                    dim=2,
                )

            ck, cv = append(ck, k_blocks), append(cv, v_blocks)
        new_cache = {"k": ck, "v": cv, "length": cache_len + T}
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
