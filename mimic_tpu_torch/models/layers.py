"""Core functional layers: norms, RoPE, attention-with-logsumexp, MLP.

Counterpart of ``mimic_tpu/models/layers.py``.  Functions are pure and take
plain tensors; attention returns the softmax log-normalizer (lse) beside its
output so the MimIC shift can use it as log Z₂.

Score products run in fp32 (inputs upcast before the einsum), the counterpart
of JAX's ``preferred_element_type=float32``; probabilities are rounded to the
value dtype before the PV product, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.decode_attention import is_quantized_kv, prompt_attention_int8, prompt_kv_len
from ..ops.quant import qdot

# large-negative fill for masked logits; finite to keep lse well-defined in fp32
NEG_INF = -2.0e38


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], eps: float
) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (llama convention: rotate_half)
# ---------------------------------------------------------------------------


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float, dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions [..., T] → [..., T, head_dim]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exps / head_dim))
    freqs = positions[..., None].float() * inv_freq  # [..., T, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k: [B,T,H,D]; cos,sin: [B,T,D] (broadcast over heads)."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


# ---------------------------------------------------------------------------
# scaled dot-product attention with logsumexp
# ---------------------------------------------------------------------------


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B,S,Hkv,D] → [B,S,Hkv*groups,D] (GQA key/value head expansion)."""
    if groups == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, groups, d).reshape(b, s, h * groups, d)


def sdpa_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention returning (output [B,T,H,D], lse [B,T,H]).

    q: [B,T,H,D], k/v: [B,S,H,D]; mask broadcastable to [B,H,T,S], True = attend.
    A row with no attendable key gets the uniform mean of v (its scores all sit
    at the finite ``NEG_INF``), never NaN.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)  # [B,H,T]
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype), lse.transpose(1, 2)


def unmasked_lse(
    q: torch.Tensor, k: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """log Σ_s exp(q·k_s·scale) over *all* key positions, ignoring any mask
    (the reference ``do_shift``'s log Z₂).  Returns [B,T,H]."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    return torch.logsumexp(scores, dim=-1).transpose(1, 2)


def cached_attention(
    q: torch.Tensor,        # [B,T,H,D] current queries
    k_new: torch.Tensor,    # [B,T,Hkv,D] current keys (kv heads, not expanded)
    v_new: torch.Tensor,    # [B,T,Hkv,Dv] (Dv = D but for latent attention)
    cache_k: torch.Tensor,  # [B,S,Hkv,D] read-only cache
    cache_v: torch.Tensor,  # [B,S,Hkv,Dv]
    cache_len: int,         # number of written timeline slots
    key_mask: torch.Tensor,  # [B,S] slot validity over cache_k's region
    key_mask_new: torch.Tensor,  # [B,T] validity of the current block's tokens
    scale: Optional[float] = None,
    prompt_k: Optional[torch.Tensor] = None,  # [B0,Sp,Hkv,D] beam-shared prompt
    prompt_v: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,  # [B0,Sp]
    window: Optional[int] = None,  # sliding-window size (Mistral), slot-indexed
    need_unmasked: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-part attention for decode with a KV cache (plain torch).

    The current block's keys are not written into the cache here (the decoder
    appends them after the layer loop).  Masks: cache part = slot < written
    length AND key_mask; current part = causal within the block AND
    key_mask_new.  Returns (out [B,T,H,D], lse [B,T,H], lse_unmasked [B,T,H]);
    the unmasked variant spans exactly the written slots + current block.

    Beam-shared prompt (``prompt_k/v/mask`` at batch B0 = B/beams): the prompt
    region is stored once per batch row and the beams are folded into the
    query-group axis, so its KV is read once per row.  ``cache_k/v`` then hold
    only the generated region and ``cache_len`` counts the full timeline.

    Int8 prompt KV (``prompt_k/v`` quantized handles with a ``layer`` index,
    ``ops/decode_attention.py``): ``prompt_attention_int8`` (the kernel on
    CUDA) returns the prompt region's partial softmax state, merged here by
    logsumexp with the generated and current parts; plain causal decode only
    (no sliding window, no ``need_unmasked``), and both returned
    log-normalizers are the masked one.

    ``window`` (Mistral): a query at timeline position p attends the keys at
    positions p' with p - p' < window (HF's semantics).  The current block's
    query t sits at ``cache_len + t``, a generated-region slot s at
    ``Sp + s`` (Sp the prompt region's length, 0 without one), a prompt slot
    at s.  The unmasked log-normalizer ignores the window, as it ignores every
    mask.
    """
    B, T, H, D = q.shape
    if prompt_k is not None and is_quantized_kv(prompt_k):
        if window is not None or need_unmasked:
            raise NotImplementedError(
                "int8 prompt KV supports plain causal decode only "
                "(no sliding window, no unmasked-lse shift consumer)"
            )
        return _cached_attention_int8_prompt(
            q, k_new, v_new, cache_k, cache_v, cache_len, key_mask, key_mask_new, scale,
            prompt_k, prompt_v, prompt_mask,
        )
    S, Hkv, Dv = cache_k.shape[1], cache_k.shape[2], cache_v.shape[-1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / (D**0.5)
    dev = q.device
    qg = (q.float() * scale).to(q.dtype).reshape(B, T, Hkv, G, D).float()
    s_cache = torch.einsum("btkgd,bskd->bkgts", qg, cache_k.float())  # [B,Hkv,G,T,S]
    s_new = torch.einsum("btkgd,bskd->bkgts", qg, k_new.to(cache_k.dtype).float())

    gen_len = cache_len
    s_prompt = None
    if prompt_k is not None:
        B0, Sp = prompt_k.shape[0], prompt_k.shape[1]
        Kb = B // B0
        gen_len = cache_len - Sp
        # fold beams into the group axis: prompt KV is read once per batch row
        qf = qg.reshape(B0, Kb, T, Hkv, G, D).permute(0, 2, 3, 1, 4, 5)
        qf = qf.reshape(B0, T, Hkv, Kb * G, D)
        s_prompt = torch.einsum(
            "btkgd,bskd->bkgts", qf, prompt_k.to(cache_k.dtype).float()
        )  # [B0,Hkv,Kb*G,T,Sp]

    slot = torch.arange(S, device=dev)
    written = (slot < gen_len)[None, None, None, None, :]
    cache_mask = written & key_mask[:, None, None, None, :].bool()
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))[None, None, None]
    new_mask = causal & key_mask_new[:, None, None, None, :].bool()
    if window is not None:
        t_idx = torch.arange(T, device=dev)
        q_pos = cache_len + t_idx  # [T]
        gen_pos = (Sp if s_prompt is not None else 0) + slot  # [S]
        cache_mask = cache_mask & ((q_pos[:, None] - gen_pos[None, :]) < window)
        new_mask = new_mask & ((t_idx[:, None] - t_idx[None, :]) < window)

    parts = [
        torch.where(cache_mask, s_cache, NEG_INF),
        torch.where(new_mask, s_new, NEG_INF),
    ]
    u_parts = [torch.where(written, s_cache, NEG_INF), s_new] if need_unmasked else None
    if s_prompt is not None:
        s_prompt_b = (
            s_prompt.reshape(B0, Hkv, Kb, G, T, Sp)
            .permute(0, 2, 1, 3, 4, 5)
            .reshape(B, Hkv, G, T, Sp)
        )
        pm = prompt_mask.bool().repeat_interleave(Kb, dim=0)[:, None, None, None, :]  # [B,Sp]
        if window is not None:
            prompt_pos = torch.arange(Sp, device=dev)
            pm = pm & (((cache_len + torch.arange(T, device=dev))[:, None]
                        - prompt_pos[None, :]) < window)
        parts.insert(0, torch.where(pm, s_prompt_b, NEG_INF))
        if need_unmasked:
            u_parts.insert(0, s_prompt_b)  # prompt slots are all written

    all_scores = torch.cat(parts, dim=-1)
    lse = torch.logsumexp(all_scores, dim=-1)  # [B,Hkv,G,T]
    p = torch.exp(all_scores - lse[..., None]).to(cache_v.dtype).float()
    out = torch.zeros(B, T, Hkv, G, Dv, dtype=torch.float32, device=dev)
    off = 0
    if s_prompt is not None:
        # fold the prompt probabilities back to B0×(Kb·G) so prompt_v is read once
        p_pf = (
            p[..., :Sp]
            .reshape(B0, Kb, Hkv, G, T, Sp)
            .permute(0, 2, 1, 3, 4, 5)
            .reshape(B0, Hkv, Kb * G, T, Sp)
        )
        o_p = torch.einsum(
            "bkgts,bskd->btkgd", p_pf, prompt_v.to(cache_v.dtype).float()
        )  # [B0,T,Hkv,Kb*G,Dv]
        o_p = o_p.reshape(B0, T, Hkv, Kb, G, Dv).permute(0, 3, 1, 2, 4, 5)
        out = out + o_p.reshape(B, T, Hkv, G, Dv)
        off = Sp
    p_cache, p_new = p[..., off:off + S], p[..., off + S:]
    out = out + torch.einsum("bkgts,bskd->btkgd", p_cache, cache_v.float())
    out = out + torch.einsum(
        "bkgts,bskd->btkgd", p_new, v_new.to(cache_v.dtype).float()
    )
    out = out.reshape(B, T, H, Dv).to(q.dtype)

    lse_u = torch.logsumexp(torch.cat(u_parts, dim=-1), dim=-1) if need_unmasked else lse

    def to_bth(x):
        return x.reshape(B, H, T).transpose(1, 2)

    return out, to_bth(lse), to_bth(lse_u)


def _cached_attention_int8_prompt(
    q, k_new, v_new, cache_k, cache_v, cache_len, key_mask, key_mask_new, scale,
    prompt_k, prompt_v, prompt_mask,
):
    """The int8-prompt branch of ``cached_attention`` (JAX ``layers.py:216-246``).

    The kernel gets ``qg`` in the activation dtype, already multiplied by
    1/√D, as in JAX; it multiplies by log2 e and rounds back itself."""
    B, T, H, D = q.shape
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / (D**0.5)
    dev = q.device
    qg = (q.float() * scale).to(q.dtype).reshape(B, T, Hkv, G, D)
    gen_len = cache_len - prompt_kv_len(prompt_k)
    qf = qg.float()
    s_cache = torch.einsum("btkgd,bskd->bkgts", qf, cache_k.float())
    s_new = torch.einsum("btkgd,bskd->bkgts", qf, k_new.to(cache_k.dtype).float())
    written = (torch.arange(S, device=dev) < gen_len)[None, None, None, None, :]
    cache_mask = written & key_mask[:, None, None, None, :].bool()
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))[None, None, None]
    new_mask = causal & key_mask_new[:, None, None, None, :].bool()

    o_p, m_p, l_p = prompt_attention_int8(qg, prompt_k, prompt_v, prompt_mask)
    rest = torch.cat([torch.where(cache_mask, s_cache, NEG_INF),
                      torch.where(new_mask, s_new, NEG_INF)], dim=-1)  # [B,Hkv,G,T,S+T]
    m_r = rest.amax(dim=-1)
    p_r = torch.exp(rest - m_r[..., None])
    l_r = p_r.sum(dim=-1)
    p_r = p_r.to(cache_v.dtype).float()
    o_r = torch.einsum("bkgts,bskd->bkgtd", p_r[..., :S], cache_v.float()) + torch.einsum(
        "bkgts,bskd->bkgtd", p_r[..., S:], v_new.to(cache_v.dtype).float()
    )
    m_tot = torch.maximum(m_p, m_r)
    ap = torch.exp(m_p - m_tot)
    ar = torch.exp(m_r - m_tot)
    l_tot = (l_p * ap + l_r * ar).clamp_min(1e-30)
    o = o_p * ap[..., None] + o_r * ar[..., None]
    out = (o / l_tot[..., None]).permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)
    lse = (m_tot + torch.log(l_tot)).reshape(B, H, T).transpose(1, 2)
    return out, lse, lse


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_mlp(
    x: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor, down_w: torch.Tensor
) -> torch.Tensor:
    """LLaMA-family MLP: down(silu(gate(x)) * up(x)); weights stored [in, out],
    plain tensors or int8 handles (``qdot`` dispatches)."""
    return qdot(F.silu(qdot(x, gate_w)) * qdot(x, up_w), down_w)


def gelu_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if kind == "gelu":
        return F.gelu(x)
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"Unknown activation {kind!r}")
