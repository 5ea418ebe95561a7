"""Attention backward from the saved log-normalizers: kernels and plain version.

Counterpart of ``mimic_tpu/ops/flash_backward.py``.  With s = σ q·kᵀ
recomputed in fp32 and the forward's saved ``lse`` / ``lse_u``:

    p    = exp(s − lse)     (attendable keys: key mask and causal), else 0
    p_u  = exp(s − lse_u)   (every key; only with ``need_unmasked``)
    ds   = p ∘ (g_out·vᵀ − Δ) + g_lse ∘ p + g_lse_u ∘ p_u,   Δ = Σ_d g_out ∘ out
    dq   = σ ds·k,   dk = σ dsᵀ·q,   dv = pᵀ·g_out

folded over the GQA group for dk and dv.  ``g_lse`` carries the gradient of
the μ-gate's log Z₂ when ``logz2="masked"``, ``g_lse_u`` when
``logz2="unmasked"``.

Two hand-written CUDA kernels (``csrc/flash_bwd.cu``, built by ``_build.py``):

- ``flash_bwd_dq`` (replaces Pallas ``_dq_kernel``);
- ``flash_bwd_dkv`` (replaces Pallas ``_dkv_kernel``), GQA folded in-kernel.

Δ is a plain reduction outside them, as in the JAX package.
``flash_attention_backward`` launches both for CUDA tensors (or raises) and
takes the plain version, ``flash_attention_backward_plain``, only for CPU
tensors.  ``LAUNCHES`` counts kernel launches by name; nothing else touches
it.  The kernels take head dim 128 (the text tower, the only one that
trains) in fp32 or bf16.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.layers import repeat_kv
from .flash_attention import _KERNEL_DTYPES

BWD_HEAD_DIMS = (128,)

LAUNCHES: Dict[str, int] = {"flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


Grads3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def flash_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    lse_u: torch.Tensor,
    g_out: torch.Tensor,
    g_lse: Optional[torch.Tensor],
    g_lse_u: Optional[torch.Tensor],
    causal: bool = True,
    scale: Optional[float] = None,
    need_unmasked: bool = True,
) -> Grads3:
    """The plain PyTorch version of both kernels: the contract of the JAX
    package's ``_diff_bwd_jnp``.  Materialises the ``[B,H,T,S]`` fp32 score
    tensor.  ``g_lse_u`` is ignored without ``need_unmasked`` (the forward's
    lse_u is then a copy of lse)."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    groups = H // Hkv
    sc = scale if scale is not None else 1.0 / (D**0.5)
    qf = q.float()
    kf = repeat_kv(k, groups).float()
    vf = repeat_kv(v, groups).float()
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * sc  # [B,H,T,S]
    allowed = torch.ones(B, 1, 1, S, dtype=torch.bool, device=q.device)
    if key_mask is not None:
        allowed = (key_mask != 0)[:, None, None, :]
    if causal:
        allowed = allowed & torch.ones(T, S, dtype=torch.bool, device=q.device).tril()[None, None]
    p = torch.where(allowed, torch.exp(s - lse.transpose(1, 2)[..., None]), 0.0)
    g_out_f = g_out.float()
    dv_rep = torch.einsum("bhts,bthd->bshd", p, g_out_f)
    dp = torch.einsum("bthd,bshd->bhts", g_out_f, vf)
    delta = (g_out_f * out.float()).sum(-1)  # [B,T,H]
    ds = p * (dp - delta.transpose(1, 2)[..., None])
    if g_lse is not None:
        ds = ds + g_lse.float().transpose(1, 2)[..., None] * p
    if need_unmasked and g_lse_u is not None:
        p_u = torch.exp(s - lse_u.transpose(1, 2)[..., None])
        ds = ds + g_lse_u.float().transpose(1, 2)[..., None] * p_u
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * sc
    dk_rep = torch.einsum("bhts,bthd->bshd", ds, qf) * sc
    dk = dk_rep.reshape(B, S, Hkv, groups, D).sum(3)
    dv = dv_rep.reshape(B, S, Hkv, groups, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")


def _launch_backward(
    q, k, v, key_mask, out, lse, lse_u, g_out, g_lse, g_lse_u, causal, scale, need_unmasked,
    kernels=KERNELS,
) -> Grads3:
    """Check the inputs, launch ``kernels`` (both by default) on the current
    stream and count them; the outputs of a kernel not launched are None."""
    from . import _build

    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    tensors = [k, v, out, g_out, lse, lse_u] + [x for x in (key_mask, g_lse, g_lse_u) if x is not None]
    if any(x.device != dev for x in tensors):
        raise ValueError("flash_bwd: all inputs must be on one device")
    if not (q.dtype == k.dtype == v.dtype == g_out.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"flash_bwd: q/k/v/g_out must share one dtype of {list(_KERNEL_DTYPES)}, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}/{g_out.dtype}"
        )
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_bwd: head dim {D} not in {BWD_HEAD_DIMS}")
    if (k.shape != (B, S, Hkv, D) or v.shape != k.shape or H % Hkv
            or out.shape != q.shape or g_out.shape != q.shape
            or lse.shape != (B, T, H) or lse_u.shape != (B, T, H)):
        raise ValueError(f"flash_bwd: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} lse {tuple(lse.shape)}")
    if T == 0 or S == 0 or B == 0:
        raise ValueError("flash_bwd: empty input")
    if key_mask is None:
        km = torch.ones(B, S, dtype=torch.int32, device=dev)
    else:
        if tuple(key_mask.shape) != (B, S):
            raise ValueError(f"flash_bwd: key_mask shape {tuple(key_mask.shape)} != {(B, S)}")
        km = (key_mask != 0).to(torch.int32).contiguous()
    f32 = torch.float32
    zeros = torch.zeros(B, T, H, dtype=f32, device=dev)
    g_lse = zeros if g_lse is None else g_lse.to(f32).contiguous()
    g_lse_u = zeros if (g_lse_u is None or not need_unmasked) else g_lse_u.to(f32).contiguous()
    q, k, v, g_out = q.contiguous(), k.contiguous(), v.contiguous(), g_out.contiguous()
    lse, lse_u = lse.to(f32).contiguous(), lse_u.to(f32).contiguous()
    delta = (g_out.float() * out.float()).sum(-1).contiguous()  # [B,T,H]
    sc = scale if scale is not None else 1.0 / (D**0.5)
    dq = torch.empty_like(q) if "flash_bwd_dq" in kernels else None
    dk = torch.empty_like(k) if "flash_bwd_dkv" in kernels else None
    dv = torch.empty_like(v) if "flash_bwd_dkv" in kernels else None
    lib = _build.load_library()
    inputs = (q, k, v, g_out, km, lse, lse_u, delta, g_lse, g_lse_u)
    ptrs = [x.data_ptr() for x in inputs]
    shape = (B, T, S, H, Hkv, D, _KERNEL_DTYPES[q.dtype], float(sc), int(causal),
             int(need_unmasked))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, outs in (("flash_bwd_dq", (dq,)), ("flash_bwd_dkv", (dk, dv))):
            if name not in kernels:
                continue
            err = getattr(lib, f"mimic_{name}")(
                *ptrs, *(o.data_ptr() for o in outs), *shape, stream
            )
            if err != 0:
                msg = lib.mimic_cuda_error_string(err).decode()
                raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
            LAUNCHES[name] += 1
    return dq, dk, dv


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    lse_u: torch.Tensor,
    g_out: torch.Tensor,
    g_lse: Optional[torch.Tensor],
    g_lse_u: Optional[torch.Tensor],
    causal: bool = True,
    scale: Optional[float] = None,
    need_unmasked: bool = True,
) -> Grads3:
    """Returns (dq [B,T,H,D], dk [B,S,Hkv,D], dv [B,S,Hkv,D]): the two kernels
    on CUDA, the plain version on the CPU.  There is no size cut-off: every
    CUDA call launches the kernels."""
    args = (q, k, v, key_mask, out, lse, lse_u, g_out, g_lse, g_lse_u, causal, scale,
            need_unmasked)
    if q.device.type == "cuda":
        return _launch_backward(*args)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(*args)
    raise ValueError(f"flash_bwd: no kernel and no plain path for device {q.device}")
