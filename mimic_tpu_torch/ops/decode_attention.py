"""Int8 prompt-KV attention for beam-search decode steps.

Counterpart of ``mimic_tpu/ops/decode_attention.py``.  The beam-shared prompt
region of the KV cache is stored int8 with one symmetric scale per (layer,
batch row, kv head, position): ``{"q8": int8 [L,B0,Hkv,Sp,D], "scale": fp32
[L,B0,Hkv,Sp]}``.  The scales fold into the scores (k) and into the
probabilities (v), so no dequantized copy exists anywhere:

    score[m, s] = (q · log2 e) · k8[s] · kscale[s]         (log2 domain)
    out[m, d]   = Σ_s (p[m, s] · vscale[s]) · v8[s, d]

``prompt_attention_int8`` returns the *unnormalised partial* softmax state of
the prompt region, ``(o [B,Hkv,G,1,D], m [B,Hkv,G,1] (natural log), l
[B,Hkv,G,1])``, all fp32, for a logsumexp merge with the generated and current
parts (``models/layers.py::cached_attention``).  The beams fold into the
query-group axis: the prompt KV is read once per batch row.

One hand-written CUDA kernel, ``prompt_attn_int8`` (``csrc/prompt_attn_int8.cu``,
replaces Pallas ``_kernel``), launched for CUDA tensors (or raising); the plain
version, ``prompt_attention_int8_plain``, serves CPU tensors only.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .quant import _KERNEL_DTYPES, INV_127, _raise_on_error

NEG = -1.0e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# the kernel's key chunk and its limits on the folded query rows and head dim
KEY_BLOCK = 128
MAX_ROWS = 32
HEAD_DIM = 128

LAUNCHES: Dict[str, int] = {"prompt_attn_int8": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def is_quantized_kv(x: Any) -> bool:
    return isinstance(x, dict) and "q8" in x


def prompt_kv_len(pk: Any) -> int:
    """Prompt-region length of a prompt cache leaf: axis -3 of a tensor
    ([L,B0,Sp,Hkv,D] or [B0,Sp,Hkv,D]), axis 3 of a quantized ``q8``."""
    if is_quantized_kv(pk):
        return pk["q8"].shape[3]
    return pk.shape[-3]


def _quantize_layer(xl: torch.Tensor):
    """[B0,Sp,Hkv,D] → (int8 [B0,Hkv,Sp,D], fp32 [B0,Hkv,Sp]), bit-identical to
    the JAX transform (fp32 constant 1/127, round half to even)."""
    xf = xl.transpose(1, 2).float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q8 = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q8, scale[..., 0]


def quantize_prompt_kv(
    prompt_k: torch.Tensor, prompt_v: torch.Tensor, padded_len: int = 0
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """[L,B0,Sp,Hkv,D] → ``{"q8": int8 [L,B0,Hkv,Sq,D], "scale": f32
    [L,B0,Hkv,Sq]}`` each, one layer at a time (the fp32 working set is one
    layer).  ``padded_len`` (Sq ≥ Sp) appends zero positions: the bytes JAX
    gives for a zero-padded prompt (q8 0, scale 1) without making the copy."""
    def one(x):
        L, B0, Sp, Hkv, D = x.shape
        Sq = max(padded_len, Sp)
        q8 = torch.zeros(L, B0, Hkv, Sq, D, dtype=torch.int8, device=x.device)
        scale = torch.ones(L, B0, Hkv, Sq, dtype=torch.float32, device=x.device)
        for l in range(L):
            q8[l, :, :, :Sp], scale[l, :, :, :Sp] = _quantize_layer(x[l])
        return {"q8": q8, "scale": scale}

    return one(prompt_k), one(prompt_v)


def _fold(qg: torch.Tensor, B0: int) -> torch.Tensor:
    """[B,1,Hkv,G,D] → [B0,Hkv,Kb·G,D] (beams into the group axis)."""
    B, _, Hkv, G, D = qg.shape
    Kb = B // B0
    return qg.reshape(B0, Kb, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(B0, Hkv, Kb * G, D)


def _unfold(x: torch.Tensor, B: int, G: int) -> torch.Tensor:
    """[B0,Hkv,Kb·G,...] → [B,Hkv,G,1,...]."""
    B0, Hkv = x.shape[:2]
    Kb = B // B0
    x = x.reshape((B0, Hkv, Kb, G) + x.shape[3:]).movedim(2, 1)
    x = x.reshape((B, Hkv, G) + x.shape[4:])
    return x.unsqueeze(3)


def prompt_attention_int8_plain(qf, k8, ks, v8, vs, prompt_mask):
    """Plain version of the kernel on one layer, folded layout: qf [B0,Hkv,M,D]
    (activation dtype, prescaled by 1/√D), k8/v8 [B0,Hkv,Sp,D] int8, ks/vs
    [B0,Hkv,Sp] fp32, prompt_mask [B0,Sp].  Returns (o [B0,Hkv,M,D],
    m [B0,Hkv,M] natural log, l [B0,Hkv,M]), fp32.

    As the kernel: q is multiplied by log2 e and rounded back to its dtype,
    masked scores sit at NEG, and p·vscale is rounded to q's dtype before
    the PV product.  The whole row is one block here.
    """
    q = (qf.float() * LOG2E).to(qf.dtype).float()
    s = torch.einsum("bhmd,bhsd->bhms", q, k8.float()) * ks.float()[:, :, None, :]
    s = torch.where((prompt_mask != 0)[:, None, None, :], s, NEG)
    m = s.amax(dim=-1)
    p = torch.exp2(s - m[..., None])
    l = p.sum(dim=-1)
    pv = (p * vs.float()[:, :, None, :]).to(qf.dtype).float()
    o = torch.einsum("bhms,bhsd->bhmd", pv, v8.float())
    return o, m * LN2, l


def _launch(qf, k8, ks, v8, vs, mask):
    from . import _build

    name = "prompt_attn_int8"
    B0, Hkv, M, D = qf.shape
    Sp = k8.shape[2]
    if qf.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: q must be one of {list(_KERNEL_DTYPES)}, got {qf.dtype}")
    if D != HEAD_DIM or M > MAX_ROWS or Sp % KEY_BLOCK or Sp == 0:
        raise ValueError(f"{name}: needs head dim {HEAD_DIM}, at most {MAX_ROWS} folded query "
                         f"rows and a prompt length that is a non-zero multiple of {KEY_BLOCK} "
                         f"(D {D}, rows {M}, Sp {Sp})")
    for t in (qf, k8, ks, v8, vs, mask):
        if t.device != qf.device:
            raise ValueError(f"{name}: all inputs must be on {qf.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if (k8.dtype, v8.dtype, ks.dtype, vs.dtype, mask.dtype) != (
            torch.int8, torch.int8, torch.float32, torch.float32, torch.int32):
        raise TypeError(f"{name}: needs int8 k/v, fp32 scales and an int32 mask")
    if (k8.shape != (B0, Hkv, Sp, D) or v8.shape != k8.shape or ks.shape != (B0, Hkv, Sp)
            or vs.shape != ks.shape or mask.shape != (B0, Sp)):
        raise ValueError(f"{name}: bad shapes q {tuple(qf.shape)} k {tuple(k8.shape)} "
                         f"scale {tuple(ks.shape)} mask {tuple(mask.shape)}")
    lib = _build.load_library()
    nsplit = Sp // KEY_BLOCK
    dev = qf.device
    work = torch.empty(nsplit * B0 * Hkv * M * (D + 2), dtype=torch.float32, device=dev)
    o = torch.empty(B0, Hkv, M, D, dtype=torch.float32, device=dev)
    m = torch.empty(B0, Hkv, M, dtype=torch.float32, device=dev)
    l = torch.empty(B0, Hkv, M, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.mimic_prompt_attn_int8(
            qf.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
            mask.data_ptr(), work.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            B0, Hkv, M, Sp, _KERNEL_DTYPES[qf.dtype], torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(lib, err, name)
    LAUNCHES[name] += 1
    return o, m, l


def prompt_attention_int8(
    qg: torch.Tensor,            # [B, 1, Hkv, G, D], prescaled by 1/√D, activation dtype
    pk: Dict[str, Any],          # quantized prompt keys with a "layer" index
    pv: Dict[str, Any],          # quantized prompt values
    prompt_mask: torch.Tensor,   # [B0, Sp] (nonzero = attend)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial softmax state ``(o, m, l)`` of the int8 prompt region (see the
    module docstring); the kernel on CUDA, the plain version on the CPU."""
    B, T, Hkv, G, D = qg.shape
    if T != 1:
        raise ValueError("int8 prompt attention is a single-token decode path")
    layer = int(pk["layer"])
    B0 = pk["q8"].shape[1]
    qf = _fold(qg, B0).contiguous()
    k8, ks = pk["q8"][layer], pk["scale"][layer]
    v8, vs = pv["q8"][layer], pv["scale"][layer]
    if qg.device.type == "cuda":
        mask = (prompt_mask != 0).to(torch.int32).contiguous()
        o, m, l = _launch(qf, k8, ks, v8, vs, mask)
    elif qg.device.type == "cpu":
        o, m, l = prompt_attention_int8_plain(qf, k8, ks, v8, vs, prompt_mask)
    else:
        raise ValueError(f"prompt_attn_int8: no kernel and no plain path for device {qg.device}")
    return _unfold(o, B, G), _unfold(m, B, G), _unfold(l, B, G)
