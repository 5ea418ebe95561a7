"""Attention forward emitting softmax log-normalizers: kernels and plain version.

Counterpart of ``mimic_tpu/ops/flash_attention.py``.  The MimIC shift needs
log Z₂ = logsumexp of the attention scores; the kernels carry the running
(max, sum) pair anyway and emit it in two flavours per query row:

- ``lse``: the masked log-normalizer (the softmax denominator);
- ``lse_unmasked``: logsumexp over every key, ignoring causal and padding
  masks (the reference ``do_shift``'s log Z₂).

Layout at the boundary is the JAX package's: q ``[B,T,H,D]``, k/v
``[B,S,Hkv,D]`` (GQA by head index), key_mask ``[B,S]`` (nonzero = attend, may
hold interior zeros).  Every function returns ``(out [B,T,H,D],
lse [B,T,H] fp32, lse_unmasked [B,T,H] fp32)``.

Two hand-written CUDA kernels (``csrc/``, built by ``_build.py``):

- ``flash_fwd`` (replaces Pallas ``_kernel``): online softmax over key tiles;
- ``onepass_fwd`` (replaces Pallas ``_onepass_kernel``): full-row softmax,
  the row's max and sum final before P·V.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version, ``attention_plain``, only for CPU tensors.  ``LAUNCHES`` counts
kernel launches by name; nothing else touches it.  Gradients go through
``flash_attention_diff`` (a ``torch.autograd.Function`` whose backward is the
pair of kernels of ``flash_backward.py``).

Rows with no attendable key (left-padded prompt rows, padded ViT slots) are
finite everywhere: masked scores sit at ``NEG = -1e30`` and the denominator is
clamped at 1e-30, so the plain version and ``onepass_fwd`` give the uniform
mean of v over all S keys (as ``sdpa_with_lse`` and the JAX one-pass kernel
do).  ``flash_fwd`` gives the same when ``need_unmasked`` is set (it then
visits every key tile); without it, it skips fully masked tiles and gives the
mean over the keys of the tiles it visited.  Rows with an attendable key agree
in every version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.layers import repeat_kv

NEG = -1.0e30

# dispatch thresholds, kept from the JAX package so each shape routes to the
# same contract (re-deciding them from H100 timings is later work)
ONEPASS_MAX_S = 3072
ONEPASS_MAX_S_NONCAUSAL = 8192

# head dims (SigLIP 72, the text tower 128) and dtypes the CUDA kernels are
# instantiated for
KERNEL_HEAD_DIMS = (72, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "onepass_fwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


Out3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    causal: bool = True,
    scale: Optional[float] = None,
    need_unmasked: bool = True,
) -> Out3:
    """The plain PyTorch version of both kernels (same contract).

    Materialises the ``[B,H,T,S]`` fp32 score tensor.  Scores are computed in
    fp32 from the inputs, masked scores sit at ``NEG``, probabilities are
    rounded to v's dtype before the P·V product (as the kernels do), and the
    denominator is clamped at 1e-30.
    """
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / (D**0.5)
    kf = repeat_kv(k, H // Hkv).float()
    vf = repeat_kv(v, H // Hkv)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * sc  # [B,H,T,S]
    lse_u = torch.logsumexp(s, dim=-1) if need_unmasked else None
    allowed = None
    if key_mask is not None:
        allowed = (key_mask != 0)[:, None, None, :]
    if causal:
        tri = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()[None, None]
        allowed = tri if allowed is None else allowed & tri
    masked = s if allowed is None else torch.where(allowed, s, NEG)
    m = masked.amax(dim=-1)
    p = torch.exp(masked - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)  # [B,H,T]
    pv = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), vf.float())
    out = (pv / l.transpose(1, 2)[..., None]).to(q.dtype)
    lse = (m + torch.log(l)).transpose(1, 2)
    lse_u = lse if lse_u is None else lse_u.transpose(1, 2)
    return out, lse.contiguous(), lse_u.contiguous()


def _launch(
    name: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    causal: bool,
    scale: Optional[float],
    need_unmasked: bool,
) -> Out3:
    """Check the inputs, launch kernel ``name`` on the current stream, count it."""
    from . import _build

    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    if k.device != dev or v.device != dev or (key_mask is not None and key_mask.device != dev):
        raise ValueError(f"{name}: q, k, v and key_mask must be on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"{name}: q/k/v must share one dtype of {list(_KERNEL_DTYPES)}, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {KERNEL_HEAD_DIMS}")
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if T == 0 or S == 0 or B == 0:
        raise ValueError(f"{name}: empty input")
    if key_mask is None:
        km = torch.ones(B, S, dtype=torch.int32, device=dev)
    else:
        if tuple(key_mask.shape) != (B, S):
            raise ValueError(f"{name}: key_mask shape {tuple(key_mask.shape)} != {(B, S)}")
        km = (key_mask != 0).to(torch.int32).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    sc = scale if scale is not None else 1.0 / (D**0.5)
    out = torch.empty_like(q)
    lse = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    lse_u = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = getattr(lib, f"mimic_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(),
            out.data_ptr(), lse.data_ptr(), lse_u.data_ptr(),
            B, T, S, H, Hkv, D, _KERNEL_DTYPES[q.dtype], float(sc),
            int(causal), int(need_unmasked), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.mimic_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
    return out, lse, lse_u


def _route(name: str, q: torch.Tensor, *args) -> Out3:
    if q.device.type == "cuda":
        return _launch(name, q, *args)
    if q.device.type == "cpu":
        return attention_plain(q, *args)
    raise ValueError(f"{name}: no kernel and no plain path for device {q.device}")


def onepass_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    causal: bool = True,
    scale: Optional[float] = None,
    need_unmasked: bool = True,
) -> Out3:
    """Full-row attention (``onepass_fwd`` on CUDA, the plain version on CPU)."""
    return _route("onepass_fwd", q, k, v, key_mask, causal, scale, need_unmasked)


def _dispatch(q, k, v, key_mask, causal, scale, need_unmasked) -> Out3:
    """The JAX package's forward rule (see ``flash_attention``)."""
    T, S = q.shape[1], k.shape[1]
    max_s = ONEPASS_MAX_S if causal else ONEPASS_MAX_S_NONCAUSAL
    if S % 128 == 0 and T % 8 == 0 and S <= max_s:
        return onepass_attention(q, k, v, key_mask, causal, scale, need_unmasked)
    return _route("flash_fwd", q, k, v, key_mask, causal, scale, need_unmasked)


class FlashAttentionDiff(torch.autograd.Function):
    """``flash_attention`` with gradients: the counterpart of the JAX package's
    ``jax.custom_vjp`` ``flash_attention_diff``.

    Forward: the dispatched kernel on CUDA, ``attention_plain`` on the CPU
    (without an autograd graph).  Backward: ``flash_attention_backward``, the
    two backward kernels on CUDA always (the JAX size crossover to a plain
    pullback is a TPU cut-off and is not carried over), the plain backward on
    the CPU.  The cotangents of ``out``, ``lse`` and ``lse_u`` all reach ds;
    ``lse_u``'s is dropped without ``need_unmasked``, as in JAX.  ``key_mask``
    gets no gradient.
    """

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale, need_unmasked):
        out, lse, lse_u = _dispatch(q, k, v, key_mask, causal, scale, need_unmasked)
        if lse_u is lse:  # the plain version returns one tensor for both
            lse_u = lse.clone()
        ctx.save_for_backward(q, k, v, key_mask, out, lse, lse_u)
        ctx.causal, ctx.scale, ctx.need_unmasked = causal, scale, need_unmasked
        ctx.set_materialize_grads(False)
        return out, lse, lse_u

    @staticmethod
    def backward(ctx, g_out, g_lse, g_lse_u):
        from .flash_backward import flash_attention_backward

        q, k, v, key_mask, out, lse, lse_u = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_backward(
            q, k, v, key_mask, out, lse, lse_u, g_out, g_lse, g_lse_u,
            causal=ctx.causal, scale=ctx.scale, need_unmasked=ctx.need_unmasked,
        )
        return dq, dk, dv, None, None, None, None


def flash_attention_diff(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    causal: bool = True,
    scale: Optional[float] = None,
    need_unmasked: bool = True,
) -> Out3:
    """Differentiable ``flash_attention`` (see ``FlashAttentionDiff``)."""
    return FlashAttentionDiff.apply(q, k, v, key_mask, causal, scale, need_unmasked)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    causal: bool = True,
    scale: Optional[float] = None,
    need_unmasked: bool = True,
) -> Out3:
    """Attention with the (out, lse, lse_unmasked) contract, auto-dispatched.

    The JAX package's rule: key axes that are 128-aligned, query axes that are
    8-aligned and rows up to ``ONEPASS_MAX_S`` (causal) or
    ``ONEPASS_MAX_S_NONCAUSAL`` go to the full-row kernel; everything else to
    the online-softmax kernel.  The JAX package's tiny-shape cut-off to plain
    XLA is not carried over: on CUDA every call launches one of the kernels.
    When gradients are being recorded and q, k or v requires grad, the call
    goes through ``flash_attention_diff``: the kernels write their outputs
    through raw pointers, which autograd cannot see.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return flash_attention_diff(q, k, v, key_mask, causal, scale, need_unmasked)
    return _dispatch(q, k, v, key_mask, causal, scale, need_unmasked)
