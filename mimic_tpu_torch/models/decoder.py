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
Kimi-VL's tower (the port's alone): multi-head latent attention (``_project_mla``:
q / k heads 192 wide, v heads 128, through the same kernels) and routed experts
from ``first_k_dense_replace`` on (``models/moe.py``), on one rank.
The tracing utilities' layer-input captures (``capture_layer_inputs``) and
additive perturbations of the block outputs (``perturb_attn`` /
``perturb_ffn``), and the serve engine's per-row cache writes
(``cache_write_pos``).

Under a current mesh with a ``model`` axis (``parallel.use_mesh``, the tree
from ``parallel.shard_params``) q/k/v and the MLP's gate/up are
column-parallel, ``o_proj`` and ``down_proj`` row-parallel and followed by an
all-reduce (``parallel/tp.py``).  Where every rank's block holds whole heads
(``tp.whole_heads``) each rank attends over its own heads: the KV cache holds
its KV heads, and the attention shift, LoRA's B (and ``o``'s A) are sliced to
them, their gradients summed over ``model``.  Where a block cuts inside a head
the attention's region is gathered: q/k/v (their biases and LoRA deltas added
on this rank's columns) are gathered to every head, each rank attends over all
of them with the whole shift leaves, the KV cache holds every KV head, and the
output is scattered back to this rank's rows of ``o_proj``.  Int8 handles
are whole on every rank, as JAX's rules leave them: their layers run every
head with no collective (the split q/k/v biases gathered), the KV cache holds
every KV head, and so does the cache of a prefill whose decode steps read
them (``init_kv_cache(handles=True)``: one region per call, read off the
cache).  Ring attention (``attn_impl="ring"`` with ``ring_mesh``) runs the
cacheless attention of long sequences as a sequence-parallel ring
(``ops/ring_attention.py``) over the region's heads, and records gradients
through its ``RingAttentionDiff``; a ring over the ``model`` axis itself runs
in the gathered region.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from ..ops.decode_attention import is_quantized_kv, prompt_kv_len
from ..ops.flash_attention import flash_attention_diff
from ..ops.flash_backward import BWD_HEAD_DIMS
from ..ops.quant import fused_mlp, is_quantized, qdot
from ..ops.ring_attention import ring_attention_sharded
from ..parallel import tp
from ..parallel.mesh import axis_rank, axis_size, current_mesh
from .config import TextConfig
from .moe import moe_block
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

# kv_a_layernorm's eps: DeepseekV3RMSNorm's default (the published config sets none)
KV_NORM_EPS = 1e-6


def is_mla(cfg: TextConfig) -> bool:
    """Whether the tower has latent attention.  The latent-attention and
    expert fields are the port's alone: a text config without them (the JAX
    package's dataclass) describes a dense tower of one head width."""
    return getattr(cfg, "kv_lora_rank", None) is not None


def head_widths(cfg: TextConfig) -> tuple:
    """(query / key, value) head widths: ``TextConfig.qk_head_size`` and
    ``v_head_size`` (192 / 128 for Kimi-VL's latent attention); ``head_size``
    twice for the JAX package's config, which has neither."""
    return (getattr(cfg, "qk_head_size", cfg.head_size), getattr(cfg, "v_head_size", cfg.head_size))


def moe_layers(cfg: TextConfig) -> int:
    """How many of the last layers have routed experts."""
    return getattr(cfg, "num_moe_layers", 0)


class DecoderOutput(NamedTuple):
    hidden: torch.Tensor                                # [B,T,D] final hidden states (pre lm_head)
    attn_capture: Optional[torch.Tensor] = None         # [L,B,T|M,D] self-attn block outputs
    ffn_capture: Optional[torch.Tensor] = None          # [L,B,T|M,D] MLP block outputs
    kv_cache: Optional[Dict[str, Any]] = None
    layer_inputs: Optional[torch.Tensor] = None         # [L,B,T,D] hidden state at layer entry


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

    if is_mla(cfg):
        (Dq, Dv), R, Dn = head_widths(cfg), cfg.kv_lora_rank, cfg.qk_nope_head_dim
        layers = {
            "input_ln": ones(L, D),
            "q_proj": dense(L, D, H * Dq),
            "kv_a_proj": dense(L, D, R + cfg.qk_rope_head_dim),
            "kv_a_ln": ones(L, R),
            "kv_b_proj": dense(L, R, H * (Dn + Dv)),
            "o_proj": dense(L, H * Dv, D),
            "post_ln": ones(L, D),
        }
    else:
        layers = {
            "input_ln": ones(L, D),
            "q_proj": dense(L, D, H * Dh),
            "k_proj": dense(L, D, Hkv * Dh),
            "v_proj": dense(L, D, Hkv * Dh),
            "o_proj": dense(L, H * Dh, D),
            "post_ln": ones(L, D),
        }
    moe = moe_layers(cfg)
    mlp = {"gate_proj": lambda n: dense(n, D, F), "up_proj": lambda n: dense(n, D, F),
           "down_proj": lambda n: dense(n, F, D)}
    if not moe:
        layers.update({name: make(L) for name, make in mlp.items()})
    if cfg.attn_bias:
        # qwen2: biases on q/k/v, never quantized (JAX ops/quant.py:175)
        layers["q_bias"] = torch.zeros(L, H * Dh, dtype=dtype, device=device)
        layers["k_bias"] = torch.zeros(L, Hkv * Dh, dtype=dtype, device=device)
        layers["v_bias"] = torch.zeros(L, Hkv * Dh, dtype=dtype, device=device)
    if cfg.qk_layernorm:
        layers["q_ln"] = ones(L, Dh)
        layers["k_ln"] = ones(L, Dh)
    params: Params = {"layers": layers, "final_ln": ones(D)}
    if moe:
        # the leading dense layers, then the expert layers
        params["dense"] = {name: make(L - moe) for name, make in mlp.items()}
        E, Fe = cfg.n_routed_experts, cfg.moe_intermediate_size
        Fs = Fe * cfg.n_shared_experts
        params["moe"] = {
            "router": dense(moe, D, E),
            "router_bias": torch.zeros(moe, E, dtype=dtype, device=device),
            "gate": dense(moe, E, D, Fe),
            "up": dense(moe, E, D, Fe),
            "down": dense(moe, E, Fe, D),
            "shared_gate": dense(moe, D, Fs),
            "shared_up": dense(moe, D, Fs),
            "shared_down": dense(moe, Fs, D),
        }
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


def holds_handles(params: Params) -> bool:
    """Whether a decoder tree's self-attention layers hold int8 handles (the
    decode tree of an int8 mode): whole on every rank under a model axis."""
    return _stack_handles(params["layers"])


def _stack_handles(stack: Params) -> bool:
    return any(is_quantized(w) for w in stack.values())


def init_kv_cache(
    cfg: TextConfig, batch: int, max_len: int, device, dtype=torch.float32, *,
    handles: bool = False,
) -> Dict[str, Any]:
    """An empty cache of the KV heads this rank's attention holds (all of them
    without a model axis, in a gathered head region, or where the decode tree
    holds int8 handles: ``handles``, see ``tp.head_region``)."""
    kv_heads = tp.head_region(cfg.num_heads, cfg.num_kv_heads, cfg.head_size,
                              handles=handles)[1]
    # latent attention caches each head's whole key (q/k width) and value
    shape = (cfg.num_layers, batch, max_len, kv_heads)
    return {
        "k": torch.zeros(shape + head_widths(cfg)[:1], dtype=dtype, device=device),
        "v": torch.zeros(shape + head_widths(cfg)[1:], dtype=dtype, device=device),
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
    keep: Optional[torch.Tensor] = None, rate: float = 0.0, out_width: Optional[int] = None,
) -> Optional[torch.Tensor]:
    """scaling · B(A(dropout(x))) for one projection, or None (dropout on the
    adapter input only, peft's semantics).  The adapter math runs in the
    adapter's dtype (fp32 trainables over a bf16 tower: ``torch.matmul`` does
    not promote bf16 x fp32 as ``jnp.dot`` does, so x is cast); the delta
    returns in x's dtype.

    Under a model axis: q/k/v's delta is this rank's ``out_width`` columns (B
    sliced); ``o``'s input is this rank's columns, so A is sliced to its rows
    and A's partial product summed over ``model`` before B."""
    a, b = ad.get(f"{name}_a"), ad.get(f"{name}_b")
    if a is None:
        return None
    if keep is not None:
        keep = tp.local_block(keep, -1, x.shape[-1])
        x = torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
    split_in = a.shape[0] != x.shape[-1]
    u = torch.matmul(x.to(a.dtype), tp.shared_heads(a, 0, x.shape[-1]))
    if split_in:
        u = tp.reduce_from_region(u)
    if out_width is not None and out_width != b.shape[-1]:
        u, b = tp.copy_to_region(u), tp.shared_heads(b, -1, out_width)
    return (scaling * torch.matmul(u, b)).to(x.dtype)


def _project(x: torch.Tensor, x_split: torch.Tensor, w: Any, full: int, what: str):
    """``x @ w`` for a q/k/v projection of ``full`` columns: the input through
    ``copy_to_region`` (``x_split``) where the rules split ``w``'s columns."""
    split = not isinstance(w, dict) and tp.is_split(w, -1, full, what)
    return qdot(x_split if split else x, w)


def _attn_out(attn: torch.Tensor, o_proj: Any, cfg: TextConfig) -> tuple:
    """(the attention output [B,T,H·Dh] cut to this rank's rows of ``o_proj``,
    whether those rows are split): in a gathered region the rows are scattered
    out of every head's output; an int8 handle's rows are whole."""
    full = cfg.num_heads * head_widths(cfg)[1]
    rows_split = not isinstance(o_proj, dict) and tp.is_split(o_proj, 0, full, "o_proj")
    flat = attn.reshape(*attn.shape[:2], -1)
    return tp.scatter_to_region(flat, tp.split_width(full) if rows_split else full), rows_split


def _mlp(hn: torch.Tensor, gate: Any, up: Any, down: Any, F: int) -> torch.Tensor:
    """The SwiGLU MLP, column-parallel gate/up and row-parallel down under a
    model axis."""
    split = not isinstance(gate, dict) and tp.is_split(gate, -1, F, "gate_proj")
    return tp.reduce_from_region(swiglu_mlp(tp.copy_to_region(hn, split), gate, up, down), split)


def _project_qkv(
    lp: Params, ad: Params, x: torch.Tensor, cfg: TextConfig, scaling: float,
    keeps: Optional[list], rate: float, region: tuple,
):
    """q, k, v over the ``region``'s (query heads, KV heads)."""
    B, T, _ = x.shape
    H, Hkv = region
    Dh = cfg.head_size
    if "qkv_proj" in lp:
        # the int8 serving tree fuses q/k/v into one matmul, whole on every rank
        qkv = qdot(x, lp["qkv_proj"])
        q = qkv[..., : H * Dh]
        k = qkv[..., H * Dh : (H + Hkv) * Dh]
        v = qkv[..., (H + Hkv) * Dh :]
    else:
        x_in = tp.copy_to_region(x)
        q = _project(x, x_in, lp["q_proj"], cfg.num_heads * Dh, "q_proj")
        k, v = (_project(x, x_in, lp[name], cfg.num_kv_heads * Dh, name)
                for name in ("k_proj", "v_proj"))
    if "q_bias" in lp:
        # the rules split the biases; beside a whole int8 handle they are gathered
        q, k, v = (y + tp.gather_from_region(lp[f"{name}_bias"], y.shape[-1])
                   for name, y in (("q", q), ("k", k), ("v", v)))
    out = []
    for slot, (name, y, heads) in enumerate((("q", q, H), ("k", k, Hkv), ("v", v, Hkv))):
        delta = _lora_delta(ad, name, x, scaling, keeps[slot] if keeps else None, rate,
                            out_width=y.shape[-1])
        # a gathered region: this rank's columns to every head
        out.append(tp.gather_from_region(y if delta is None else y + delta, heads * Dh))
    q, k, v = out
    return q.reshape(B, T, H, Dh), k.reshape(B, T, Hkv, Dh), v.reshape(B, T, Hkv, Dh)


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotary layout: the pairs (2i, 2i + 1) of the last axis
    become the halves (i, d/2 + i) that ``apply_rope`` rotates."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def _project_mla(lp: Params, x: torch.Tensor, cfg: TextConfig, cos, sin):
    """Latent attention's q [B,T,H,nope+rope], k [B,T,H,nope+rope] and v
    [B,T,H,Dv], RoPE applied: q from ``q_proj`` (no q LoRA); ``kv_a_proj``
    gives the latent (RMS-normed by ``kv_a_ln``, then ``kv_b_proj`` to each
    head's k_nope and v) and one rope key that every head shares."""
    B, T, _ = x.shape
    H, Dn, Dr, R = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    q = qdot(x, lp["q_proj"]).reshape(B, T, H, Dn + Dr)
    ckv = qdot(x, lp["kv_a_proj"])
    kv = qdot(rms_norm(ckv[..., :R], lp["kv_a_ln"], KV_NORM_EPS), lp["kv_b_proj"])
    kv = kv.reshape(B, T, H, Dn + cfg.v_head_dim)
    q_pe, k_pe = apply_rope(_deinterleave(q[..., Dn:]), _deinterleave(ckv[..., None, R:]),
                            cos, sin)
    q = torch.cat([q[..., :Dn], q_pe], dim=-1)
    k = torch.cat([kv[..., :Dn], k_pe.expand(B, T, H, Dr)], dim=-1)
    return q, k, kv[..., Dn:]


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
    ring: Optional[tuple] = None,
    region: Optional[tuple] = None,
):
    """Returns (attn block output [B,T,D], new k block, new v block).

    ``prefix_merge_len`` (P > 0, the prefix-tuning prefill): the cache holds
    only the P prefix slots; the block takes the cacheless path and
    ``_merge_prefix`` adds them.  ``ring``: (mesh, sequence axis, batch axis)
    of the ring attention path.  ``region``: the call's ``tp.head_region``."""
    B, T, _ = x.shape
    if is_mla(cfg):
        q, k, v = _project_mla(lp, x, cfg, cos, sin)
    else:
        q, k, v = _project_qkv(lp, ad, x, cfg, lora_scaling, keeps, drop_rate, region)
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
    elif ring is not None:
        # sequence-parallel exact attention: Q stays local, K/V blocks travel
        # the ring; the same (out, lse, lse_u) contract as the kernels
        mesh, seq_axis, batch_axis = ring
        attn, lse, lse_u = ring_attention_sharded(
            mesh, q, k, v, key_mask, axis_name=seq_axis, causal=True,
            need_unmasked=need_unmasked, batch_axis=batch_axis,
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
    # this rank's own heads (a whole-heads split); in a gathered region q holds
    # every head and the shift leaves enter whole
    own_heads = q.shape[2] != cfg.num_heads
    if ls:
        log_z2 = lse if logz2 == "masked" else lse_u
        if own_heads:
            # this rank's heads (multi-head leaves) or columns (the flat form)
            width = q.shape[2] * (1 if multi_head else cfg.head_size)
            ls = {name: w if name == "attn_logz1_b" and not multi_head
                  else tp.shared_heads(w, 0, width) for name, w in ls.items()}
        attn = apply_attn_shift(ls, q, log_z2, attn, multi_head, model_split=own_heads)
    attn_flat, rows_split = _attn_out(attn, lp["o_proj"], cfg)
    out = tp.reduce_from_region(qdot(attn_flat, lp["o_proj"]), rows_split)
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
    H, Hkv = tp.head_region(cfg.num_heads, cfg.num_kv_heads, cfg.head_size,
                            handles=_stack_handles(cp))
    Dh = cfg.head_size
    S = cross_states.shape[1]
    h = rms_norm(x, cp["input_ln"], cfg.norm_eps)
    h_in, states_in = tp.copy_to_region(h), tp.copy_to_region(cross_states)
    q = _project(h, h_in, cp["q_proj"], cfg.num_heads * Dh, "cross q_proj")
    k, v = (_project(cross_states, states_in, cp[name], cfg.num_kv_heads * Dh, f"cross {name}")
            for name in ("k_proj", "v_proj"))
    q = tp.gather_from_region(q, H * Dh).reshape(B, T, H, Dh)
    k = tp.gather_from_region(k, Hkv * Dh).reshape(B, S, Hkv, Dh)
    v = tp.gather_from_region(v, Hkv * Dh).reshape(B, S, Hkv, Dh)
    if cfg.cross_qk_layernorm:
        q = rms_norm(q, cp["q_ln"], cfg.norm_eps)
        k = rms_norm(k, cp["k_ln"], cfg.norm_eps)
    attn, _ = sdpa_with_lse(
        q, repeat_kv(k, cfg.num_groups), repeat_kv(v, cfg.num_groups), cross_mask
    )
    attn_flat, rows_split = _attn_out(attn, cp["o_proj"], cfg)
    attn_out = tp.reduce_from_region(qdot(attn_flat, cp["o_proj"]), rows_split)
    h = x + torch.tanh(cp["alpha_attn"]).to(x.dtype) * attn_out
    m = rms_norm(h, cp["post_ln"], cfg.norm_eps)
    mlp_out = _mlp(m, cp["gate_proj"], cp["up_proj"], cp["down_proj"], cfg.intermediate_size)
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
    capture_layer_inputs: bool = False,
    perturb_attn: Optional[torch.Tensor] = None,
    perturb_ffn: Optional[torch.Tensor] = None,
    cache_write_pos: Optional[torch.Tensor] = None,
    ring_mesh: Any = None,
    ring_axis: str = "sp",
    ring_batch_axis: Optional[str] = None,
    ring_min_len: int = 0,
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
    capture_layer_inputs: return each layer's input hidden state as
    ``layer_inputs`` [L,B,T,D].  perturb_attn / perturb_ffn [L,B,T,D]: added
    to each layer's attention / MLP block output after its output shift (and
    so inside the captures); under ``remat`` each layer's slice enters the
    checkpoint as an argument, so gradients reach it.

    The current block's k/v are written into the cache at the timeline
    length.  Without gradients they are written in place and the returned
    cache holds the same tensors; with gradients recorded the returned
    cache's tensors are new: autograd may hold views of the old ones for the
    backward pass (``torch.einsum`` saves the cache itself where no permute
    copies it, as with one KV head), and the prefix train step's cache is
    made from the trainable prefix.  Its ``length`` is advanced by T.

    cache_write_pos [B] (a one-token step, T = 1; the serve engine's slots):
    row b's k/v are written at column ``cache_write_pos[b]`` of a cache whose
    ``length`` stays as it is.  A row whose position is the cache's width
    (a retired slot) writes nothing, as JAX's scatter drops an out-of-range
    update: the write goes to a clamped column with that column's own value,
    so no index leaves the cache and nothing waits for the device.

    ``attn_impl="ring"`` with ``ring_mesh`` (a ``DeviceMesh``): cacheless
    sequences of at least ``ring_min_len`` tokens that split over the mesh's
    ``ring_axis`` take ``ops/ring_attention.py``; ``ring_batch_axis`` names
    the mesh's data axis when the batch is this rank's rows of it.  Shorter
    ones take the plain path, as in JAX.  With gradients recorded the ring
    runs its backward through the backward kernels (``RingAttentionDiff``);
    under ``remat`` the recompute runs the ring's exchange again, in the
    same order on every rank.
    """
    B, T, D = input_embeds.shape
    if cache_write_pos is not None and (kv_cache is None or T != 1):
        raise ValueError("cache_write_pos needs a kv_cache and a one-token step (T = 1)")
    if (is_mla(cfg) or moe_layers(cfg)) and (
            tp.model_size() > 1 or ring_mesh is not None or adapters or prefix_flash_len
            or holds_handles(params)):
        raise ValueError(
            "latent attention and routed experts run on one rank, in bf16 or fp32, without "
            "LoRA or prefix tuning: no model axis, ring, LoRA, prefix or int8 weights")
    rope_dim = cfg.qk_rope_head_dim if is_mla(cfg) else cfg.head_size
    cos, sin = rope_cos_sin(position_ids, rope_dim, cfg.rope_theta, input_embeds.dtype)

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
        # the ring has no prefix-merge contract
        ring_mesh=None if prefix_merge else ring_mesh, ring_axis=ring_axis,
        ring_min_len=ring_min_len, on_card=input_embeds.device.type == "cuda",
    )
    ring = (ring_mesh, ring_axis, ring_batch_axis) if selected == "ring" else None
    # the heads every layer's self-attention runs over, one region for the call
    region = tp.head_region(
        cfg.num_heads, cfg.num_kv_heads, cfg.head_size, handles=holds_handles(params),
        ring_axis=ring_axis if ring is not None else None,
        cache_heads=kv_cache["k"].shape[3] if use_cache else None)
    ATTN_PATH_LOG.append(selected + "+prefix" if prefix_merge else selected)
    if prompt_quant:
        ATTN_PATH_LOG.append("quant_kv")  # once per call, as JAX logs it once per trace
    del ATTN_PATH_LOG[:-ATTN_PATH_LOG_MAX]
    use_flash = selected == "flash"
    layer_key_mask = key_mask[:, :T] if (use_cache and cache_empty) else key_mask
    drop = dropout_generator is not None and lora_dropout > 0.0 and bool(adapters)
    mesh = current_mesh()
    in_place = not torch.is_grad_enabled()
    remat = remat and torch.is_grad_enabled()

    layers = params["layers"]
    n_dense = cfg.num_layers - moe_layers(cfg)
    mlps = params.get("dense"), params.get("moe")
    write_at = cache_len - prompt_len

    def capture(x: torch.Tensor) -> torch.Tensor:
        if capture_gather_idx is None:
            return x
        idx = capture_gather_idx.long()[..., None].expand(-1, -1, x.shape[-1])
        return torch.gather(x, 1, idx)

    if cache_write_pos is not None:
        rows = torch.arange(B, device=input_embeds.device)
        width = kv_cache["k"].shape[2]
        write_col = cache_write_pos.long().clamp_max(width - 1)
        write_keep = (cache_write_pos < width)[:, None, None]

        def write_rows(c: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            """What c [..., B, S, Hkv, Dh] holds at the rows' columns after the
            write of new [..., B, 1, Hkv, Dh]."""
            old = c[..., rows, write_col, :, :]
            return torch.where(write_keep, new[..., 0, :, :].to(c.dtype), old)

    def layer_body(h: torch.Tensor, l: int, keeps: Optional[list],
                   pa: Optional[torch.Tensor], pf: Optional[torch.Tensor]):
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
            ring=ring, region=region,
        )
        attn_out = apply_output_shift(
            attn_out, os_.get("attn_out_shift"), os_.get("attn_out_scale")
        )
        if pa is not None:
            attn_out = attn_out + pa.to(attn_out.dtype)
        h = residual + attn_out
        residual = h
        hn = rms_norm(h, lp["post_ln"], cfg.norm_eps)
        if mlps[1] is not None and l >= n_dense:
            ffn_out = moe_block(hn, {name: w[l - n_dense] for name, w in mlps[1].items()}, cfg)
        elif mlps[0] is not None:
            mp = {name: w[l] for name, w in mlps[0].items()}
            ffn_out = _mlp(hn, mp["gate_proj"], mp["up_proj"], mp["down_proj"],
                           cfg.intermediate_size)
        elif "gateup_proj" in lp:
            # decode-sized M on the card: the whole MLP in one kernel; else the
            # two-qdot path (JAX decoder.py:541-552)
            ffn_out = fused_mlp(hn, lp["gateup_proj"], lp["down_proj"])
            if ffn_out is None:
                gu = qdot(hn, lp["gateup_proj"])
                F = gu.shape[-1] // 2
                ffn_out = qdot(torch.nn.functional.silu(gu[..., :F]) * gu[..., F:],
                               lp["down_proj"])
        else:
            ffn_out = _mlp(hn, lp["gate_proj"], lp["up_proj"], lp["down_proj"],
                           cfg.intermediate_size)
        ffn_out = apply_output_shift(ffn_out, os_.get("ffn_shift"), os_.get("ffn_scale"))
        if pf is not None:
            ffn_out = ffn_out + pf.to(ffn_out.dtype)
        return residual + ffn_out, attn_out, ffn_out, k_new, v_new

    attn_caps, ffn_caps, layer_ins, k_blocks, v_blocks = [], [], [], [], []
    cross = params.get("cross") if cfg.cross_attn_interval else None
    h = input_embeds
    for l in range(cfg.num_layers):
        if cross is not None and cross_states is not None and l % cfg.cross_attn_interval == 0:
            g = l // cfg.cross_attn_interval
            cp = {name: _cross_view(w, g) for name, w in cross.items()}
            h = _cross_attention(cp, h, cross_states, cross_mask, cfg)
        if capture_layer_inputs:
            layer_ins.append(h)
        pa = perturb_attn[l] if perturb_attn is not None else None
        pf = perturb_ffn[l] if perturb_ffn is not None else None
        keeps = None
        if drop:
            # drawn outside the rematerialised body: the recompute must see the
            # same masks, and checkpoint restores only the default generators.
            # Under a data axis each rank draws the whole batch's masks and keeps
            # its rows, so the masks are those of the batch in one process
            n_data = axis_size(mesh, "data")
            shapes = ((B * n_data, T, D),) * 3 + ((B * n_data, T, cfg.num_heads * cfg.head_size),)
            keeps = [
                lora_dropout_keep(dropout_generator, l, slot, shape, lora_dropout)
                .narrow(0, axis_rank(mesh, "data") * B, B)
                if f"{name}_a" in adapters else None
                for slot, (name, shape) in enumerate(zip("qkvo", shapes))
            ]
        if remat:
            h, attn_out, ffn_out, k_new, v_new = torch.utils.checkpoint.checkpoint(
                layer_body, h, l, keeps, pa, pf, use_reentrant=False
            )
        else:
            h, attn_out, ffn_out, k_new, v_new = layer_body(h, l, keeps, pa, pf)
        if capture_attn:
            attn_caps.append(capture(attn_out))
        if capture_ffn:
            ffn_caps.append(capture(ffn_out))
        if use_cache and in_place and cache_write_pos is not None:
            # one advanced-index write per layer, after the layer read its slice
            for c, new in ((kv_cache["k"][l], k_new), (kv_cache["v"][l], v_new)):
                c[rows, write_col] = write_rows(c, new)
        elif use_cache and in_place:
            # the layer read its cache slice above; slots >= the written length
            # are masked there, so appending now changes nothing it saw
            kv_cache["k"][l, :, write_at:write_at + T] = k_new.to(kv_cache["k"].dtype)
            kv_cache["v"][l, :, write_at:write_at + T] = v_new.to(kv_cache["v"].dtype)
        elif use_cache:
            k_blocks.append(k_new)
            v_blocks.append(v_new)

    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    new_cache = None
    if use_cache and cache_write_pos is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        if not in_place:
            def write(c, blocks):
                c = c.clone()
                c[:, rows, write_col] = write_rows(c, torch.stack(blocks))
                return c

            ck, cv = write(ck, k_blocks), write(cv, v_blocks)
        new_cache = {"k": ck, "v": cv, "length": cache_len}
    elif use_cache:
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
        layer_inputs=torch.stack(layer_ins) if capture_layer_inputs else None,
    )


# ---------------------------------------------------------------------------
# attention path selection
# ---------------------------------------------------------------------------

# log of the attention path each decoder_forward call selected — tests and the
# chip smoke run assert which implementation actually ran; every call appends,
# so it keeps only the newest ATTN_PATH_LOG_MAX entries
ATTN_PATH_LOG: list = []
ATTN_PATH_LOG_MAX = 1024


def select_attn_path(
    cfg: TextConfig,
    attn_impl: str,
    T: int,
    *,
    cacheless: bool,
    has_key_mask: bool,
    ring_mesh: Any = None,
    ring_axis: str = "sp",
    ring_min_len: int = 0,
    on_card: bool = False,
) -> str:
    """Which attention implementation a decoder_forward call uses.

    - ``"flash"``: the attention kernels — cacheless, 2D key mask present,
      128-aligned T, query / key and value head widths a pair that both the
      forward and the backward kernels take (``BWD_HEAD_DIMS``: 128 / 128,
      and latent attention's 192 / 128), no sliding window narrower than T.
      A latent-attention tower on the card asked for ``"flash"`` that cannot
      take the kernels raises: its heads have no other path on the card;
    - ``"ring"``: the sequence-parallel ring over ``ring_axis`` of
      ``ring_mesh`` — long cacheless sequences whose length splits over the
      axis (the record pass of a >32-shot MimIC step and, at JAX's default
      ``ring_min_len=0``, the shift pass with its gradients); short passes
      stay on one rank.  ``on_card``: the ring's blocks run the kernels, so each
      chunk must also meet the flash path's alignment, and a ``"ring"`` pass
      that stays on one rank takes the kernels where ``"flash"`` would (on
      the CPU it stays ``"xla"``, as in JAX);
    - ``"cached"``: the two-part read-only-cache path (decode steps);
    - ``"xla"``: plain masked sdpa (the name is kept from the JAX package).
    """
    if not cacheless:
        return "cached"

    def flash_ok(t):
        return (has_key_mask and t % 128 == 0
                and head_widths(cfg) in BWD_HEAD_DIMS
                and (cfg.sliding_window is None or t <= cfg.sliding_window))

    if attn_impl == "flash" and flash_ok(T):
        return "flash"
    if attn_impl == "flash" and on_card and is_mla(cfg):
        raise ValueError(f"latent attention on the card takes the kernels: T {T} must be a "
                         f"multiple of 128 with a key mask")
    if attn_impl != "ring":
        return "xla"
    if has_key_mask and ring_mesh is not None and cfg.sliding_window is None:
        n_sp = axis_size(ring_mesh, ring_axis)
        if (
            T % n_sp == 0 and T >= max(ring_min_len, n_sp)
            and (not on_card or flash_ok(T // n_sp))
        ):
            return "ring"
    return "flash" if on_card and flash_ok(T) else "xla"


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


def make_decode_mask(attention_mask: torch.Tensor, total_len: int) -> torch.Tensor:
    """[B,S'] running key mask → [B,1,1,total_len] boolean mask of a one-token
    decode step (the slots past S' closed)."""
    pad = total_len - attention_mask.shape[1]
    if pad > 0:
        attention_mask = torch.nn.functional.pad(attention_mask, (0, pad))
    return attention_mask[:, None, None, :].bool()


def positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF-style position ids for padded batches: cumsum(mask) - 1, clamped at 0."""
    pos = torch.cumsum(attention_mask.to(torch.int64), dim=-1) - 1
    return pos.clamp_min(0)
