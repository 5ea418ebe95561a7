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

For bf16 inputs both run on the tensor cores (``csrc/attn_bwd_mma.cuh``):
p and ds rounded to bf16 before the second products, as the JAX kernels do,
and ``flash_bwd_dkv``'s (GQA head, query tile) items split over a
thread-block cluster of ``dkv_split`` CTAs whose fp32 sums are added in rank
order.  ``flash_attention_backward_tiled_plain`` is that algorithm, tile by
tile, in plain PyTorch for the CPU tests.  fp32 inputs keep scalar kernels.

Δ is a plain reduction outside them, as in the JAX package.
``flash_attention_backward`` launches both for CUDA tensors (or raises) and
takes the plain version, ``flash_attention_backward_plain``, only for CPU
tensors.  ``LAUNCHES`` counts kernel launches by name; nothing else touches
it.  The kernels take the text towers' heads, the only ones that train:
128 / 128 in fp32 or bf16, and latent attention's 192-wide q / k with 128-wide
v in bf16 (``dq`` and ``dk`` at 192, ``dv`` at 128).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.layers import repeat_kv
from .flash_attention import _KERNEL_DTYPES, _LOG2E, BF16_ONLY_HEAD_DIMS

# (query / key, value) head widths of the kernels; the second in bf16 only
BWD_HEAD_DIMS = ((128, 128), (192, 128))

# the bf16 kernels' tiling: query rows per dq CTA and keys per dq tile; keys per
# dkv CTA and query rows per dkv tile; the largest dkv cluster (the library's
# mimic_flash_bwd_tiling reports the compiled values; tests/test_torch_kernels.py
# holds the two together on the card)
TILE_DQ_ROWS = 64
TILE_DQ_KEYS = 64
TILE_DKV_KEYS = 64
TILE_DKV_ROWS = 32
MAX_SPLIT = 8

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
    delta: Optional[torch.Tensor] = None,
) -> Grads3:
    """The plain PyTorch version of both kernels: the contract of the JAX
    package's ``_diff_bwd_jnp``.  Materialises the ``[B,H,T,S]`` fp32 score
    tensor.  ``g_lse_u`` is ignored without ``need_unmasked`` (the forward's
    lse_u is then a copy of lse).  ``delta`` [B,T,H] fp32: Δ when the caller
    has it (the ring computes it once per query chunk), else Σ g_out ∘ out."""
    B, T, H, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
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
    if delta is None:
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
    dv = dv_rep.reshape(B, S, Hkv, groups, Dv).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dkv_split(B: int, T: int, S: int, H: int, Hkv: int, sms: int) -> int:
    """The bf16 ``flash_bwd_dkv``'s cluster split: the smallest power of two up
    to ``MAX_SPLIT`` that gives each of the ``sms`` SMs a CTA, never more ranks
    than a key tile has (GQA head, query tile) items.  On 132 SMs: the shift
    pass (B2 T=S=256, 32/8 heads) 4, B1 T=S=2048 1."""
    tiles = -(-S // TILE_DKV_KEYS) * Hkv * B
    items = (H // Hkv) * -(-T // TILE_DKV_ROWS)
    split = 1
    while split < MAX_SPLIT and tiles * split < sms and 2 * split <= items:
        split *= 2
    return split


VISIT_KEYS = ("dq_tiles", "dkv_items")


def flash_attention_backward_tiled_plain(
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
    round_operands: Optional[bool] = None,
    split: int = 1,
    visits: Optional[Dict[str, int]] = None,
) -> Grads3:
    """The bf16 kernels' algorithm, tile by tile, in plain PyTorch (tests only).

    What ``csrc/attn_bwd_mma.cuh`` computes, at its granularity:

    - dq: CTAs of ``TILE_DQ_ROWS`` query rows walk key tiles of
      ``TILE_DQ_KEYS``; dkv: CTAs of ``TILE_DKV_KEYS`` keys walk their
      (GQA head, query tile of ``TILE_DKV_ROWS``) items, split over ``split``
      cluster ranks in contiguous ranges; each rank's fp32 sums are added in
      rank order;
    - scores in fp32, the scale folded into the exponent (p = 2^(s c − lse
      log₂e), c = scale log₂e); with ``round_operands`` (default: bf16
      inputs) p and ds are rounded to bf16 before the second products; dq
      and dk are multiplied by the scale once, at the end;
    - the visiting rules: with ``need_unmasked`` every tile; without it dq
      ends at the CTA's causal diagonal and passes over key tiles with no
      attendable key, and dkv passes over items wholly above the diagonal
      and over CTAs with no attendable key.  A visited tile runs all of its
      products.

    ``visits`` (a dict), when given, receives the CTA tiles (dq) and items
    (dkv) visited, over all batches and heads.  A tile passed over adds
    exactly zero, so the visiting rules change no value.
    """
    B, T, H, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    sc = scale if scale is not None else 1.0 / (D**0.5)
    c = sc * _LOG2E
    rnd = q.dtype == torch.bfloat16 if round_operands is None else round_operands
    operand = (lambda x: x.to(torch.bfloat16).float()) if rnd else (lambda x: x)  # noqa: E731
    counts = visits if visits is not None else {}
    for key in VISIT_KEYS:
        counts.setdefault(key, 0)
    qf = q.float().transpose(1, 2)          # [B, H, T, D]
    gf = g_out.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)          # [B, Hkv, S, D]
    vf = v.float().transpose(1, 2)
    km = torch.ones(B, S, dtype=torch.bool) if key_mask is None else (key_mask != 0).cpu()
    tr = lambda x: x.float().transpose(1, 2)  # noqa: E731  [B, T, H] -> [B, H, T]
    zeros = torch.zeros(B, H, T)
    delta = tr((g_out.float() * out.float()).sum(-1))
    lse2, lseu2 = tr(lse) * _LOG2E, tr(lse_u) * _LOG2E
    crow = (zeros if g_lse is None else tr(g_lse)) - delta
    gu = zeros if (g_lse_u is None or not need_unmasked) else tr(g_lse_u)

    def tile_ds(x, dp, att, lse2_, lseu2_, crow_, gu_):
        """p and ds of a tile from the scaled scores x (log2 domain) and dp;
        every (row, key) of the tile lies inside T and S."""
        p = torch.where(att, torch.exp2(x - lse2_), 0.0)
        ds = p * (dp + crow_)
        if need_unmasked:
            ds = ds + gu_ * torch.exp2(x - lseu2_)
        return p, ds

    # ---- dq ----
    kr, vr = repeat_kv(k, G).float().transpose(1, 2), repeat_kv(v, G).float().transpose(1, 2)
    dq = torch.empty(B, H, T, D)
    for q0 in range(0, T, TILE_DQ_ROWS):
        rows = torch.arange(q0, min(q0 + TILE_DQ_ROWS, T))
        ntiles = -(-S // TILE_DQ_KEYS)
        if causal and not need_unmasked:
            ntiles = min(ntiles, (q0 + TILE_DQ_ROWS - 1) // TILE_DQ_KEYS + 1)
        acc = torch.zeros(B, H, rows.numel(), D)
        for k0 in range(0, ntiles * TILE_DQ_KEYS, TILE_DQ_KEYS):
            cols = torch.arange(k0, min(k0 + TILE_DQ_KEYS, S))
            # the CTAs that visit the tile (one passed over has no attendable key)
            counts["dq_tiles"] += H * int((km[:, cols].any(-1) | need_unmasked).sum())
            att = km[:, cols][:, None, None, :]
            if causal:
                att = att & (cols[None, :] <= rows[:, None])
            x = (qf[:, :, rows] @ kr[:, :, cols].transpose(-1, -2)) * c
            dp = gf[:, :, rows] @ vr[:, :, cols].transpose(-1, -2)
            sel = lambda t: t[:, :, rows, None]  # noqa: E731
            _, ds = tile_ds(x, dp, att, sel(lse2), sel(lseu2), sel(crow), sel(gu))
            acc = acc + operand(ds) @ kr[:, :, cols]
        dq[:, :, rows] = acc * sc

    # ---- dk, dv: items (GQA head g, query tile) of a key tile, split over ranks ----
    nqt = -(-T // TILE_DKV_ROWS)
    n_items = G * nqt
    by_group = lambda t: t.reshape(B, Hkv, G, *t.shape[2:])  # noqa: E731  [B,H,..] -> [B,Hkv,G,..]
    qg, gg = by_group(qf), by_group(gf)
    lse2g, lseu2g, crowg, gug = (by_group(t) for t in (lse2, lseu2, crow, gu))
    dk = torch.empty(B, Hkv, S, D)
    dv = torch.empty(B, Hkv, S, Dv)
    for k0 in range(0, S, TILE_DKV_KEYS):
        cols = torch.arange(k0, min(k0 + TILE_DKV_KEYS, S))
        cta_any = km[:, cols].any(-1)               # [B]
        total_k = total_v = None
        for rank in range(split):
            part_k = torch.zeros(B, Hkv, cols.numel(), D)
            part_v = torch.zeros(B, Hkv, cols.numel(), Dv)
            for i in range(rank * n_items // split, (rank + 1) * n_items // split):
                g, q0 = i // nqt, (i % nqt) * TILE_DKV_ROWS
                above = causal and k0 > q0 + TILE_DKV_ROWS - 1
                # [B]: the CTA visits the item
                visited = torch.ones_like(cta_any) if need_unmasked else cta_any & (not above)
                if not bool(visited.any()):
                    continue
                counts["dkv_items"] += Hkv * int(visited.sum())
                rows = torch.arange(q0, min(q0 + TILE_DKV_ROWS, T))
                att = km[:, cols][:, None, :, None]
                if causal:
                    att = att & (cols[:, None] <= rows[None, :])
                q_i, g_i = qg[:, :, g, rows], gg[:, :, g, rows]          # [B, Hkv, R, D]
                xT = (kf[:, :, cols] @ q_i.transpose(-1, -2)) * c          # [B, Hkv, C, R]
                dpT = vf[:, :, cols] @ g_i.transpose(-1, -2)
                sel = lambda t: t[:, :, g, None, rows]  # noqa: E731  [B, Hkv, 1, R]
                pT, dsT = tile_ds(xT, dpT, att, sel(lse2g), sel(lseu2g), sel(crowg), sel(gug))
                part_k = part_k + operand(dsT) @ q_i
                part_v = part_v + operand(pT) @ g_i
            total_k = part_k if total_k is None else total_k + part_k
            total_v = part_v if total_v is None else total_v + part_v
        dk[:, :, cols] = total_k * sc
        dv[:, :, cols] = total_v
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")


def _launch_backward(
    q, k, v, key_mask, out, lse, lse_u, g_out, g_lse, g_lse_u, causal, scale, need_unmasked,
    kernels=KERNELS, split=None, delta=None,
) -> Grads3:
    """Check the inputs, launch ``kernels`` (both by default) on the current
    stream and count them; the outputs of a kernel not launched are None.
    ``split``: the bf16 dkv kernel's cluster split (default ``dkv_split``);
    ``delta``: a precomputed Δ [B,T,H] (default Σ g_out ∘ out)."""
    from . import _build

    B, T, H, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    tensors = [k, v, out, g_out, lse, lse_u] + [x for x in (key_mask, g_lse, g_lse_u) if x is not None]
    if any(x.device != dev for x in tensors):
        raise ValueError("flash_bwd: all inputs must be on one device")
    if not (q.dtype == k.dtype == v.dtype == g_out.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"flash_bwd: q/k/v/g_out must share one dtype of {list(_KERNEL_DTYPES)}, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}/{g_out.dtype}"
        )
    if (D, Dv) not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_bwd: head widths (q/k, v) {(D, Dv)} not in {BWD_HEAD_DIMS}")
    if (D, Dv) in BF16_ONLY_HEAD_DIMS and q.dtype != torch.bfloat16:
        raise TypeError(f"flash_bwd: head widths {(D, Dv)} take bf16 only, got {q.dtype}")
    if (k.shape != (B, S, Hkv, D) or v.shape != (B, S, Hkv, Dv) or H % Hkv
            or out.shape != (B, T, H, Dv) or g_out.shape != out.shape
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
    # contiguous and 16-byte aligned: the bf16 kernels load rows by 16-byte cp.async
    q, k, v, g_out = (x.contiguous() if x.data_ptr() % 16 == 0 else x.contiguous().clone()
                      for x in (q, k, v, g_out))
    lse, lse_u = lse.to(f32).contiguous(), lse_u.to(f32).contiguous()
    if delta is None:
        delta = (g_out.float() * out.float()).sum(-1)  # [B,T,H]
    elif delta.shape != (B, T, H) or delta.device != dev:
        raise ValueError(f"flash_bwd: delta shape {tuple(delta.shape)} != {(B, T, H)}")
    delta = delta.to(f32).contiguous()
    sc = scale if scale is not None else 1.0 / (D**0.5)
    dq = torch.empty_like(q) if "flash_bwd_dq" in kernels else None
    dk = torch.empty_like(k) if "flash_bwd_dkv" in kernels else None
    dv = torch.empty_like(v) if "flash_bwd_dkv" in kernels else None
    lib = _build.load_library()
    inputs = (q, k, v, g_out, km, lse, lse_u, delta, g_lse, g_lse_u)
    ptrs = [x.data_ptr() for x in inputs]
    shape = (B, T, S, H, Hkv, D, Dv, _KERNEL_DTYPES[q.dtype], float(sc), int(causal),
             int(need_unmasked))
    if split is None:
        from .quant import _sm_count

        split = dkv_split(B, T, S, H, Hkv, _sm_count(dev.index)) if q.dtype == torch.bfloat16 else 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, outs, extra in (("flash_bwd_dq", (dq,), ()),
                                  ("flash_bwd_dkv", (dk, dv), (split,))):
            if name not in kernels:
                continue
            err = getattr(lib, f"mimic_{name}")(
                *ptrs, *(o.data_ptr() for o in outs), *shape, *extra, stream
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
    delta: Optional[torch.Tensor] = None,
) -> Grads3:
    """Returns (dq [B,T,H,D], dk [B,S,Hkv,D], dv [B,S,Hkv,Dv]): the two kernels
    on CUDA, the plain version on the CPU.  There is no size cut-off: every
    CUDA call launches the kernels.  ``delta``: a precomputed Δ = Σ g_out ∘
    out [B,T,H] fp32 (``out`` then only sets the shape)."""
    args = (q, k, v, key_mask, out, lse, lse_u, g_out, g_lse, g_lse_u, causal, scale,
            need_unmasked)
    if q.device.type == "cuda":
        return _launch_backward(*args, delta=delta)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(*args, delta=delta)
    raise ValueError(f"flash_bwd: no kernel and no plain path for device {q.device}")
