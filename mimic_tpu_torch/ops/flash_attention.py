"""Attention forward emitting softmax log-normalizers: kernels and plain version.

Counterpart of ``mimic_tpu/ops/flash_attention.py``.  The MimIC shift needs
log Z₂ = logsumexp of the attention scores; the kernels carry the running
(max, sum) pair anyway and emit it in two flavours per query row:

- ``lse``: the masked log-normalizer (the softmax denominator);
- ``lse_unmasked``: logsumexp over every key, ignoring causal and padding
  masks (the reference ``do_shift``'s log Z₂).

Layout at the boundary is the JAX package's: q ``[B,T,H,D]``, k
``[B,S,Hkv,D]``, v ``[B,S,Hkv,Dv]`` (GQA by head index; Dv = D but for
latent attention's 192 / 128), key_mask ``[B,S]`` (nonzero = attend, may
hold interior zeros).  Every function returns ``(out [B,T,H,Dv],
lse [B,T,H] fp32, lse_unmasked [B,T,H] fp32)``; the default scale is
1/sqrt(D).

Two hand-written CUDA kernels (``csrc/``, built by ``_build.py``):

- ``flash_fwd`` (replaces Pallas ``_kernel``): online softmax over key tiles;
- ``onepass_fwd`` (replaces Pallas ``_onepass_kernel``): the full-row contract
  (every key tile is looked at).

For bf16 inputs both are one tensor-core kernel (``csrc/attn_mma.cuh``: wgmma
products, TMA-fed K/V ring, one sweep with an online softmax) entered with two
tile-visiting rules; ``attention_tiled_plain`` is its algorithm, tile by tile,
in plain PyTorch for the CPU tests.  fp32 inputs keep scalar fp32 kernels.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version, ``attention_plain``, only for CPU tensors.  ``LAUNCHES`` counts
kernel launches by name; nothing else touches it.  Each bf16 launch at head
width 72 (the vision towers' attention) also counts ``attn_fwd_d72_launches``
in the program's recorder (``utils/tracing.py``).  Gradients go through
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
from ..utils.tracing import count

NEG = -1.0e30

# dispatch thresholds, kept from the JAX package so each shape routes to the
# same contract (re-deciding them from H100 timings is later work)
ONEPASS_MAX_S = 3072
ONEPASS_MAX_S_NONCAUSAL = 8192

# (query / key, value) head widths the CUDA kernels are instantiated for: CLIP
# ViT-L 64, SigLIP 72, CLIP ViT-H 80, the text towers 128, in fp32 and bf16; and
# latent attention's 192 / 128 (Kimi-VL), in bf16 only
KERNEL_HEAD_DIMS = ((64, 64), (72, 72), (80, 80), (128, 128), (192, 128))
BF16_ONLY_HEAD_DIMS = ((192, 128),)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 kernel's tiling by query / key head width: query rows per CTA (one
# warpgroup of TILE_GROUP_ROWS at the CLIP towers' head dims 64 and 80, two
# elsewhere) and keys per tile (the library's mimic_attn_fwd_tiling reports the
# compiled values; tests/test_torch_kernels.py holds the two together on the card)
TILE_BLOCK_M = {64: 64, 72: 128, 80: 64, 128: 128, 192: 128}
TILE_GROUP_ROWS = 64
TILE_BLOCK_N = {64: 64, 72: 64, 80: 64, 128: 128, 192: 128}
# head widths whose kernel ends the sweep at the batch's last attendable key (without
# lse_u, where every row may drop the tiles past it): the CLIP towers' one-warpgroup
# form and the vision towers' D72
TILE_SWEEP_ENDS_AT_LAST_KEY = frozenset({64, 72, 80})
# the program's counter of the vision towers' launches (bf16 at head width 72)
D72_FORM_COUNTER = "attn_fwd_d72_launches"

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453

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


def attention_tiled_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    causal: bool = True,
    scale: Optional[float] = None,
    need_unmasked: bool = True,
    skip_tiles: bool = False,
) -> Out3:
    """The bf16 kernel's algorithm, tile by tile, in plain PyTorch (tests only).

    What ``csrc/attn_mma.cuh`` does, at its granularity: a CTA of
    ``TILE_BLOCK_M[D]`` query rows, warpgroups of ``TILE_GROUP_ROWS`` rows that
    decide together, key tiles of ``TILE_BLOCK_N[D]`` (128 and 64 for other
    head dims); fp32 scores scaled AFTER the product, an online
    softmax in the log2 domain, p rounded to v's dtype for P·V with fp32 row
    sums, ``lse_unmasked`` from the attendable p rescaled plus the masked
    pairs' own exponentials.  The rules it shares with the kernel:

    - a tile wholly masked or wholly above the warpgroup's causal diagonal is
      *dead*: its P·V (and, without ``need_unmasked``, its scores) is dropped
      unless a row of the warpgroup still has no attendable key, where
      p = exp(NEG - NEG) = 1 on masked keys (such a row stays the mean of v
      over every key, as in ``attention_plain``);
    - ``skip_tiles`` (``flash_fwd`` without ``need_unmasked``) ends the sweep
      at the CTA's causal diagonal and passes over dead tiles unseen: a row
      with no attendable key then averages the visited tiles only;
    - at head dims 64, 72 and 80 (``TILE_SWEEP_ENDS_AT_LAST_KEY``) a CTA
      without ``need_unmasked`` ends its sweep at its batch's last attendable
      key when every tile past it would be dropped anyway: under
      ``skip_tiles``, or when each of its rows has an attendable key (the batch
      has one and, causal, its first lies at or before the CTA's first row).
      Those tiles are never loaded.

    ``onepass_fwd`` is ``skip_tiles=False``; ``flash_fwd`` is
    ``skip_tiles=not need_unmasked``.

    All batches and heads move together: a tile's decisions (dead per batch,
    P·V dropped per batch and head) are masks over ``[B, H]`` that pick, per
    warpgroup, between the updated and the kept running state.
    """
    B, T, H, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    sc = scale if scale is not None else 1.0 / (D**0.5)
    c = sc * _LOG2E
    half_neg = 0.5 * NEG
    block_m, group_rows = TILE_BLOCK_M.get(D, 128), TILE_GROUP_ROWS
    block_n = TILE_BLOCK_N.get(D, 64)
    qf = q.float().transpose(1, 2)                          # [B, H, T, D]
    kf = repeat_kv(k, H // Hkv).float().transpose(1, 2)     # [B, H, S, D]
    vf = repeat_kv(v, H // Hkv).float().transpose(1, 2)
    km = torch.ones(B, S, dtype=torch.bool) if key_mask is None else key_mask != 0
    keys = torch.arange(S)
    has_key = km.any(-1)                                                  # [B]
    first_key = torch.where(km, keys, S).amin(-1)
    last_tile = torch.where(km, keys, -1).amax(-1) // block_n             # -1: no key
    out = torch.empty(B, H, T, Dv, dtype=torch.float32)
    lse = torch.empty(B, H, T, dtype=torch.float32)
    lse_u = torch.empty(B, H, T, dtype=torch.float32)
    where = torch.where
    for q0 in range(0, T, block_m):
        ntiles = -(-S // block_n)
        if skip_tiles and causal:
            ntiles = min(ntiles, (q0 + block_m - 1) // block_n + 1)
        # per batch: the sweep ends after the last attendable key's tile
        ends = torch.full((B,), ntiles)
        if D in TILE_SWEEP_ENDS_AT_LAST_KEY and not need_unmasked:
            trims = has_key & (first_key <= q0) if causal else has_key
            trims = trims | skip_tiles
            ends = where(trims, torch.clamp(last_tile + 1, max=ntiles), ends)
        for g0 in range(q0, min(q0 + block_m, T), group_rows):
            rows = torch.arange(g0, min(g0 + group_rows, T))
            R = rows.numel()
            m = torch.full((B, H, R), NEG)
            mu = torch.full((B, H, R), NEG)
            l, lu, o = torch.zeros(B, H, R), torch.zeros(B, H, R), torch.zeros(B, H, R, Dv)
            for k0 in range(0, ntiles * block_n, block_n):
                cols = torch.arange(k0, min(k0 + block_n, S))  # keys >= S never count
                dead = ~km[:, cols].any(-1)[:, None].expand(B, H)            # [B, H]
                if causal and k0 > g0 + group_rows - 1:
                    dead = torch.ones_like(dead)
                # P·V wanted: a live tile, or a row of the warpgroup still without a key
                do_pv = ~dead | ~(m > half_neg).all(-1)
                skip = dead if skip_tiles else torch.zeros_like(dead)
                skip = skip | (k0 // block_n >= ends)[:, None]  # past the batch's sweep
                upd_pv = (~skip & do_pv)[..., None]                          # [B, H, 1]
                upd_lu = (~skip & need_unmasked)[..., None]  # (under upd_pv)
                x = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * c  # log2 domain
                mu_new = torch.maximum(mu, x.amax(-1))
                # only lse_u wants this tile
                lu_only = lu * torch.exp2(mu - mu_new) + torch.exp2(x - mu_new[..., None]).sum(-1)
                att = km[:, cols][:, None, None, :].expand(B, 1, R, -1)
                if causal:
                    att = att & (cols[None, :] <= rows[:, None])
                xm = where(att, x, NEG)
                m_new = torch.maximum(m, xm.amax(-1))
                p = torch.exp2(xm - m_new[..., None])  # masked: 0, or 1
                alpha = torch.exp2(m - m_new)
                l_new = l * alpha + p.sum(-1)
                lu_pv, mu_pv = lu, mu
                if need_unmasked:
                    own = where(att, 0.0, torch.exp2(x - mu_new[..., None])).sum(-1)
                    shared = where(att, p, 0.0).sum(-1) * torch.exp2(m_new - mu_new)
                    lu_pv, mu_pv = lu * torch.exp2(mu - mu_new) + shared + own, mu_new
                o_new = o * alpha[..., None] + p.to(v.dtype).float() @ vf[:, :, cols]
                lu = where(upd_pv, lu_pv, where(upd_lu, lu_only, lu))
                mu = where(upd_pv, mu_pv, where(upd_lu, mu_new, mu))
                l = where(upd_pv, l_new, l)
                m = where(upd_pv, m_new, m)
                o = where(upd_pv[..., None], o_new, o)
            l_safe = l.clamp_min(1e-30)
            out[:, :, rows] = o / l_safe[..., None]
            row_lse = where(m > half_neg, (m + torch.log2(l_safe)) * _LN2, torch.full_like(m, NEG))
            lse[:, :, rows] = row_lse
            lse_u[:, :, rows] = ((mu + torch.log2(lu.clamp_min(1e-30))) * _LN2
                                 if need_unmasked else row_lse)
    return (out.transpose(1, 2).contiguous().to(q.dtype), lse.transpose(1, 2).contiguous(),
            lse_u.transpose(1, 2).contiguous())


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
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    if k.device != dev or v.device != dev or (key_mask is not None and key_mask.device != dev):
        raise ValueError(f"{name}: q, k, v and key_mask must be on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"{name}: q/k/v must share one dtype of {list(_KERNEL_DTYPES)}, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if (D, Dv) not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head widths (q/k, v) {(D, Dv)} not in {KERNEL_HEAD_DIMS}")
    if (D, Dv) in BF16_ONLY_HEAD_DIMS and q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: head widths {(D, Dv)} take bf16 only, got {q.dtype}")
    if k.shape != (B, S, Hkv, D) or v.shape != (B, S, Hkv, Dv) or H % Hkv:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if T == 0 or S == 0 or B == 0:
        raise ValueError(f"{name}: empty input")
    if key_mask is None:
        km = torch.ones(B, S, dtype=torch.int32, device=dev)
    else:
        if tuple(key_mask.shape) != (B, S):
            raise ValueError(f"{name}: key_mask shape {tuple(key_mask.shape)} != {(B, S)}")
        km = (key_mask != 0).to(torch.int32).contiguous()
    # contiguous and 16-byte aligned: the bf16 kernel reads through TMA descriptors
    q, k, v = (x.contiguous() if x.data_ptr() % 16 == 0 else x.contiguous().clone()
               for x in (q, k, v))
    sc = scale if scale is not None else 1.0 / (D**0.5)
    if not sc > 0:  # the kernels order scores before scaling them
        raise ValueError(f"{name}: scale must be positive, got {sc}")
    out = q.new_empty(B, T, H, Dv)
    lse = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    lse_u = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = getattr(lib, f"mimic_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(),
            out.data_ptr(), lse.data_ptr(), lse_u.data_ptr(),
            B, T, S, H, Hkv, D, Dv, _KERNEL_DTYPES[q.dtype], float(sc),
            int(causal), int(need_unmasked), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.mimic_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
    if q.dtype == torch.bfloat16 and (D, Dv) == (72, 72):
        count(D72_FORM_COUNTER)
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
