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
version, ``prompt_attention_int8_plain``, serves CPU tensors only.  bf16 takes
the tensor-core form: one launch per call, the key axis split over the CTAs of
a thread-block cluster (``prompt_split``), the partials merged in rank order;
``prompt_attention_int8_tiled_plain`` follows its split, chunk order and
merges step by step.  fp32 takes the scalar chunk kernel and its merge.
"""

from __future__ import annotations

import functools
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
# the bf16 kernel: warps per CTA (each owns KEY_BLOCK / PROMPT_WARPS keys of every
# chunk) and the CTAs one (batch row, kv head) may be split over (a portable cluster)
PROMPT_WARPS = 8
PROMPT_SPLITS = tuple(range(1, 9))
# up to this many folded rows (one m16 tile) a warp takes two chunks' keys per
# softmax step; above it, one
PAIR_MAX_ROWS = 16


def prompt_steps(c0: int, c1: int, M: int):
    """The chunk groups a warp of the bf16 kernel walks in order over its rank's
    chunks [c0, c1): pairs (a lone last chunk for an odd count) at M <= 16,
    single chunks above."""
    nb = 2 if M <= PAIR_MAX_ROWS else 1
    return [tuple(range(c, min(c + nb, c1))) for c in range(c0, c1, nb)]

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


def prompt_split(B0: int, Hkv: int, Sp: int, clusters) -> int:
    """CTAs per (batch row, kv head) of the bf16 kernel: among the splits of
    ``PROMPT_SPLITS`` that give every CTA at least one 128-key chunk and keep
    the call's B0 · Hkv clusters resident at once (one wave; ``clusters(s)``:
    how many clusters of s CTAs the card holds at once), the one that leaves
    the fewest chunks to a CTA, the smallest such on a tie (less to merge).  A
    cluster's CTAs must share a GPC, so an H100 (one CTA per SM) holds 15
    clusters of 8 or of 7 but 17 of 6: call B's 16 (batch row, kv head) take 6,
    call A's 32 take 2 (PERF.md §6)."""
    n = Sp // KEY_BLOCK
    best, most = 1, n
    for s in PROMPT_SPLITS:
        if s <= n and B0 * Hkv <= clusters(s) and -(-n // s) < most:
            best, most = s, -(-n // s)
    return best


@functools.lru_cache(maxsize=None)
def _clusters(index: int, split: int, M: int) -> int:
    from . import _build

    with torch.cuda.device(index):
        return _build.load_library().mimic_prompt_attn_max_clusters(split, M)


def _merge(parts):
    """Merge partial (o, m, l) states in list order, log2 domain: the running max
    over all parts first, then each part rescaled and added in order."""
    mt = parts[0][1]
    for _, m, _ in parts[1:]:
        mt = torch.maximum(mt, m)
    o = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for op, m, lp in parts:
        f = torch.exp2(m - mt)
        o = o + op * f[..., None]
        l = l + lp * f
    return o, mt, l


def prompt_attention_int8_tiled_plain(qf, k8, ks, v8, vs, prompt_mask, split: int):
    """The bf16 kernel's algorithm step by step, in PyTorch (same arguments and
    outputs as ``prompt_attention_int8_plain``).  Rank r of ``split`` takes
    chunks [r n / split, (r + 1) n / split) of the n = Sp / 128; warp w of a rank
    takes keys 16 w .. 16 w + 15 of each of its chunks, in chunk order and in
    the groups of ``prompt_steps``, with an online softmax over each group's
    keys at once (running max, rescaled sum and o; p · vscale rounded to q's
    dtype against the running max); the warps' partials merge in warp order,
    the ranks' in rank order."""
    B0, Hkv, M, D = qf.shape
    Sp = k8.shape[2]
    n = Sp // KEY_BLOCK
    q = (qf.float() * LOG2E).to(qf.dtype).float()
    s_all = torch.einsum("bhmd,bhsd->bhms", q, k8.float()) * ks.float()[:, :, None, :]
    s_all = torch.where((prompt_mask != 0)[:, None, None, :], s_all, NEG)
    keys = KEY_BLOCK // PROMPT_WARPS
    # [.., chunk, warp, key of the warp's slice]
    s_all = s_all.reshape(B0, Hkv, M, n, PROMPT_WARPS, keys)
    vs_all = vs.float().reshape(B0, Hkv, n, PROMPT_WARPS, keys)
    v_all = v8.float().reshape(B0, Hkv, n, PROMPT_WARPS, keys, D)
    ranks = []
    for r in range(split):
        c0, c1 = r * n // split, (r + 1) * n // split
        warps = []
        for w in range(PROMPT_WARPS):
            m = torch.full((B0, Hkv, M), float("-inf"))
            l = torch.zeros(B0, Hkv, M)
            o = torch.zeros(B0, Hkv, M, D)
            for group in prompt_steps(c0, c1, M):
                g = slice(group[0], group[-1] + 1)
                s = s_all[:, :, :, g, w].reshape(B0, Hkv, M, -1)
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                pv = (p * vs_all[:, :, g, w].reshape(B0, Hkv, 1, -1)).to(qf.dtype).float()
                o = o * alpha[..., None] + torch.einsum(
                    "bhms,bhsd->bhmd", pv, v_all[:, :, g, w].reshape(B0, Hkv, -1, D))
                m = m_new
            warps.append((o, m, l))
        ranks.append(_merge(warps))
    o, m, l = _merge(ranks)
    return o, m * LN2, l


def _launch(qf, k8, ks, v8, vs, mask, split=None):
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
    dev = qf.device
    if qf.dtype == torch.bfloat16:
        # the tensor-core kernel: no workspace, the key axis split over a cluster
        if split is None:
            split = prompt_split(B0, Hkv, Sp, lambda s: _clusters(dev.index, s, M))
        if split not in PROMPT_SPLITS or split > Sp // KEY_BLOCK:
            raise ValueError(f"{name}: split {split} not in {PROMPT_SPLITS} or above "
                             f"{Sp // KEY_BLOCK} chunks")
        work = None
    else:
        # the scalar chunk kernel writes one partial per 128-key chunk, then merges
        split = 1
        work = torch.empty(Sp // KEY_BLOCK * B0 * Hkv * M * (D + 2), dtype=torch.float32, device=dev)
    o = torch.empty(B0, Hkv, M, D, dtype=torch.float32, device=dev)
    m = torch.empty(B0, Hkv, M, dtype=torch.float32, device=dev)
    l = torch.empty(B0, Hkv, M, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.mimic_prompt_attn_int8(
            qf.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
            mask.data_ptr(), None if work is None else work.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), B0, Hkv, M, Sp, _KERNEL_DTYPES[qf.dtype], split,
            torch.cuda.current_stream(dev).cuda_stream,
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
