"""Int8 quantization: the transform, the matmul kernels and ``qdot``.

Counterpart of ``mimic_tpu/ops/quant.py``.  A quantized
weight is a dict handle ``{"q8": int8 [..., K', N'], "scale": f32 [..., N]}``:
per-output-channel symmetric scales, ``q8`` zero-padded on N (and on K with
``pad_k``) to a multiple of 128, ``scale`` keeping the original N.  A
zero-size int8 ``a8`` entry marks a handle for W8A8 dispatch.  Inside the
decoder's layer loop a stacked handle also carries ``"layer": l`` and the
kernels read ``W[l]`` straight out of the ``[L, K, N]`` stack (a pointer
offset), so no per-layer copy is made.

Three hand-written CUDA kernels (``csrc/``, built by ``_build.py``):

- ``int8_matmul`` (``csrc/int8_matmul.cu``, replaces Pallas ``_kernel`` and
  ``_kernel_stacked``): ``(x @ W8) · scale`` with the int8 weights converted
  in registers and fp32 accumulation; bf16 rows on the tensor cores with the
  split-K sum inside a thread-block cluster (``csrc/int8_mma.cuh``, split
  chosen by ``mma_plan``), fp32 rows on the scalar kernel with a
  deterministic second pass;
- ``fused_mlp_int8`` (``csrc/fused_mlp_int8.cu``, replaces Pallas
  ``_mlp_kernel``): a layer's whole SwiGLU MLP at decode M, the ``[M, 2F]``
  intermediate never in device memory (bf16: two tensor-core products that
  pass the rounded ``silu(g)·u`` ``[M, F]`` between them);
- ``w8a8_matmul`` (``csrc/w8a8_matmul.cu``, replaces Pallas ``_w8a8_kernel``
  and ``_w8a8_kernel_stacked``): per-row int8 activations (``quantize_rows``)
  times int8 weights on the integer tensor cores (``wgmma`` s8 fed by TMA),
  an exact int32 sum and the two-scale epilogue ``(acc · s_x[m]) · s_w[n]``;
  ``qdot`` sends an ``a8`` handle there at prefill M (>= 256) on CUDA.

One more kernel feeds it: ``quantize_rows`` (``csrc/quantize_rows.cu``), the
per-row activation quantization in one pass, the port's form of the fused XLA
pass that ``mimic_tpu/ops/quant.py::quantize_rows`` is under ``jit``.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain PyTorch version only for CPU tensors; ``LAUNCHES`` counts the matmul
kernels' launches by name and ``ROW_LAUNCHES`` the row quantization's, and
nothing else touches them.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]

# weight names quantized inside the decoder layer stack (all [L, K, N] stacked)
DECODER_MATMUL_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)

# Where XLA compiles ``amax / 127.0`` (inside ``lax.map``: the JAX transform of
# stacked weights and of the prompt KV) it becomes a multiplication by the fp32
# constant 1/127, which gives another scale than a true division in some
# columns; a 2-D weight is quantized op by op in JAX, a true division.  The
# port does the same in each case, so the bytes match.
INV_127 = float(np.float32(1.0 / 127.0))

# qdot's int8_matmul takes fewer rows than this; from here on a dequantized
# torch.matmul is faster (JAX: M < 256, a TPU cut-off).  The tensor-core kernel
# reads the weights once per 16 rows, so its time grows with M; on an H100 at
# the q/k/v shape it beats dequantize + bf16 torch.matmul up to M 384 (0.197
# against 0.242 ms) and loses at 512 (0.259 against 0.245 ms; PERF.md §6)
KERNEL_MAX_M = 480
# prefill-sized M of a W8A8 (``a8``) handle takes w8a8_matmul (JAX: M >= 256)
W8A8_MIN_M = 256
# the fused MLP's gate on M (the JAX package's M < 256)
MLP_MAX_M = 256
# the fused MLP kernel works on F-blocks of this many columns
MLP_BLOCK_F = 64

# the tensor-core products of bf16 rows (csrc/int8_mma.cuh): weight columns per
# CTA, weight rows per staged tile, activation rows per CTA, and the K splits a
# cluster of CTAs can sum (a portable cluster holds at most 8)
MMA_BLOCK_N = 128
MMA_BLOCK_K = 64
MMA_ROWS = 16
MMA_SPLITS = (1, 2, 4, 8)
# the fewest weight tiles a CTA is given when K is split (see mma_plan)
MMA_MIN_TILES = 16

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"int8_matmul": 0, "fused_mlp_int8": 0, "w8a8_matmul": 0}
ROW_LAUNCHES: Dict[str, int] = {"quantize_rows": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROW_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# quantization transform
# ---------------------------------------------------------------------------


def _quantize_columns(w2: torch.Tensor, stacked: bool):
    """[K, N] float → (int8 [K, N], fp32 [N]), bit-identical to the JAX
    transform (``stacked``: a layer of a stacked weight, see ``INV_127``).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    wf = w2.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiplication by its reciprocal, which is the stacked case's rounding
    div = amax * INV_127 if stacked else amax / torch.full_like(amax, 127.0)
    scale = torch.where(amax > 0, div, torch.ones_like(amax))
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale[0]


def _quantize_parts(parts, act_quant: bool = False, pad_k: bool = False) -> Params:
    """Quantize the concatenation along N of ``parts`` (each ``[..., K, Ni]``)
    without making it: layer by layer and part by part into preallocated
    outputs.  Scales are per output column, so this gives the bytes of
    quantizing the concatenated stack."""
    lead, K = parts[0].shape[:-2], parts[0].shape[-2]
    dev = parts[0].device
    N = sum(p.shape[-1] for p in parts)
    Kp = _round_up(K, 128) if pad_k else K
    q8 = torch.zeros(*lead, Kp, _round_up(N, 128), dtype=torch.int8, device=dev)
    scale = torch.empty(*lead, N, dtype=torch.float32, device=dev)
    flat_q, flat_s = q8.reshape(-1, Kp, q8.shape[-1]), scale.reshape(-1, N)
    flat_parts = [p.reshape(-1, K, p.shape[-1]) for p in parts]
    for i in range(flat_q.shape[0]):
        off = 0
        for p in flat_parts:
            n = p.shape[-1]
            q, s = _quantize_columns(p[i], stacked=len(lead) > 0)
            flat_q[i, :K, off:off + n] = q
            flat_s[i, off:off + n] = s
            off += n
    out = {"q8": q8, "scale": scale}
    if act_quant:
        out["a8"] = torch.zeros(0, dtype=torch.int8, device=dev)
    return out


def quantize_weight(w: torch.Tensor, act_quant: bool = False, pad_k: bool = False) -> Params:
    """[..., K, N] float → {"q8": int8 [..., K', N'], "scale": f32 [..., N]}
    (see the module docstring); stacked weights quantize one layer at a time,
    so the fp32 working set is one layer."""
    return _quantize_parts([w], act_quant=act_quant, pad_k=pad_k)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q8" in w


def _lm_and_decoder(params: Params):
    lm = dict(params["lm"]) if "lm" in params else dict(params)
    return lm, dict(lm["decoder"])


def _with_lm(params: Params, lm: Params) -> Params:
    if "lm" in params:
        out = dict(params)
        out["lm"] = lm
        return out
    return lm


def mark_act_quant(params: Params) -> Params:
    """Add the ``a8`` marker to the quantized handles of ``lm.decoder.layers``
    (re-tagging only: the weight bytes are shared, not copied)."""
    lm, dec = _lm_and_decoder(params)
    a8 = lambda v: torch.zeros(0, dtype=torch.int8, device=v["q8"].device)
    dec["layers"] = {
        k: dict(v, a8=a8(v)) if is_quantized(v) else v for k, v in dec["layers"].items()
    }
    lm["decoder"] = dec
    return _with_lm(params, lm)


def concat_quantized(parts) -> Params:
    """Fuse already-quantized weights along N; only for parts without lane
    padding (every N a multiple of 128)."""
    for p in parts:
        if p["q8"].shape[-1] != p["scale"].shape[-1]:
            raise ValueError(
                "concat_quantized needs unpadded parts (N a 128-multiple); "
                f"got stored N {p['q8'].shape[-1]} vs scale N {p['scale'].shape[-1]}"
            )
    out = {
        "q8": torch.cat([p["q8"] for p in parts], dim=-1),
        "scale": torch.cat([p["scale"] for p in parts], dim=-1),
    }
    if all("a8" in p for p in parts):
        out["a8"] = torch.zeros(0, dtype=torch.int8, device=out["q8"].device)
    return out


def quantize_lm_params(params: Params, fuse: bool = True, act_quant: bool = False) -> Params:
    """Quantize the text tower's decode matmuls of an LVLM / LM tree.

    The decoder layer projections (``fuse=True``: q/k/v into ``qkv_proj``,
    gate/up into ``gateup_proj``), any ``cross`` layers (unfused) and an
    untied lm head.  ``act_quant`` marks the self-attention layer stacks for
    W8A8.  Everything else (vision tower, connector, embeddings, norms) is
    shared with the input tree, not copied; the input is not mutated.
    """
    lm, dec = _lm_and_decoder(params)
    for group in ("layers", "cross"):
        if group not in dec:
            continue
        g = dict(dec[group])
        aq = act_quant and group == "layers"
        if fuse and group == "layers":
            if "q_proj" in g and not is_quantized(g["q_proj"]):
                g["qkv_proj"] = _quantize_parts(
                    [g.pop("q_proj"), g.pop("k_proj"), g.pop("v_proj")], act_quant=aq)
            if "gate_proj" in g and not is_quantized(g["gate_proj"]):
                g["gateup_proj"] = _quantize_parts(
                    [g.pop("gate_proj"), g.pop("up_proj")], act_quant=aq)
        for name in DECODER_MATMUL_KEYS:
            if name in g and not is_quantized(g[name]):
                g[name] = quantize_weight(g[name], act_quant=aq)
        dec[group] = g
    lm["decoder"] = dec
    if "lm_head" in lm and not is_quantized(lm["lm_head"]):
        lm["lm_head"] = quantize_weight(lm["lm_head"])
    return _with_lm(params, lm)


def dequantize(w: Params) -> torch.Tensor:
    """fp32 ``q8[..., :, :N] · scale`` of a handle (its ``layer`` if it has one)."""
    wq, scale = w["q8"], w["scale"]
    if w.get("layer") is not None:
        wq, scale = wq[w["layer"]], scale[w["layer"]]
    return wq[..., : scale.shape[-1]].float() * scale.float()[..., None, :]


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------


def int8_matmul_plain(x, wq, scale, out_dtype=None) -> torch.Tensor:
    """``(x @ wq) · scale`` in fp32 (int8 and bf16 values are exact in fp32)."""
    out_dtype = out_dtype or x.dtype
    return ((x.float() @ wq.float()) * scale.float()).to(out_dtype)


@functools.lru_cache(maxsize=4096)
def mma_plan(M: int, K: int, tiles: int, sms: int) -> int:
    """The K split of a tensor-core product: ``tiles`` column tiles, each cut
    into ``ksplit`` ranges of whole ``MMA_BLOCK_K``-row tiles, one CTA per
    range and 16-row block of M.  The smallest split of ``MMA_SPLITS`` that
    gives the SMs 1.6 CTAs each (two fit on one: more warps to hide the
    conversion's latency) while every CTA keeps ``MMA_MIN_TILES`` weight tiles
    (below that the fixed work per CTA, pipeline fill and the cluster's sum,
    dominates); failing that the largest split that keeps them.  At
    idefics2-8b's decode shapes on 132 SMs: q/k/v 4, o 4, lm head 1, gate/up
    1, down 8, each within 5 % of the best split in a sweep of all four
    (PERF.md §6)."""
    ktiles = -(-K // MMA_BLOCK_K)
    blocks = tiles * -(-M // MMA_ROWS)
    splits = [ks for ks in MMA_SPLITS if -(-ktiles // ks) >= MMA_MIN_TILES] or [1]
    return next((ks for ks in splits if 5 * blocks * ks >= 8 * sms), splits[-1])


def int8_matmul_tiled_plain(x, wq, scale, ksplit: int, out_dtype=None) -> torch.Tensor:
    """The tensor-core kernel's sum, split by split (tests): fp32 partial sums
    over each rank's K range of whole ``MMA_BLOCK_K``-row tiles, added in rank
    order, then the scale.  (Inside a range the tensor cores' order is their
    own; every product and partial sum is exact or an fp32 rounding, as here.)"""
    out_dtype = out_dtype or x.dtype
    ktiles = -(-wq.shape[0] // MMA_BLOCK_K)
    chunk = -(-ktiles // ksplit) * MMA_BLOCK_K
    acc = torch.zeros(x.shape[0], wq.shape[1], dtype=torch.float32, device=x.device)
    for k0 in range(0, ksplit * chunk, chunk):
        acc = acc + x[:, k0:k0 + chunk].float() @ wq[k0:k0 + chunk].float()
    return (acc * scale.float()).to(out_dtype)


def fused_mlp_tiled_plain(xn, gu_q8, gu_scale, down_q8, down_scale, ks_gu: int, ks_down: int,
                          out_dtype=None) -> torch.Tensor:
    """The bf16 path's two products (tests): gate|up split by ``ks_gu`` with
    the scales, ``silu(g)·u`` rounded to the activation dtype (the ``h`` that
    passes between the two launches), then the down product split by
    ``ks_down``."""
    out_dtype = out_dtype or xn.dtype
    Fh = gu_q8.shape[-1] // 2
    gu = int8_matmul_tiled_plain(xn, gu_q8, gu_scale, ks_gu, torch.float32)
    h = (F.silu(gu[:, :Fh]) * gu[:, Fh:]).to(xn.dtype)
    return int8_matmul_tiled_plain(h, down_q8, down_scale, ks_down, out_dtype)


def fused_mlp_plain(xn, gu_q8, gu_scale, down_q8, down_scale, out_dtype=None) -> torch.Tensor:
    """One layer's SwiGLU MLP as the kernel computes it: gate/up scales before
    silu, ``silu(g)·u`` rounded to the activation dtype, then the down product
    in fp32 and its scale."""
    out_dtype = out_dtype or xn.dtype
    Fh = gu_q8.shape[-1] // 2
    gu = (xn.float() @ gu_q8.float()) * gu_scale.float()
    a = (F.silu(gu[:, :Fh]) * gu[:, Fh:]).to(xn.dtype)
    return ((a.float() @ down_q8.float()) * down_scale.float()).to(out_dtype)


def quantize_rows_plain(x: torch.Tensor):
    """Plain version of ``quantize_rows``: [..., K] float → (int8 [..., K], f32
    [...] scales).

    ``s = max(amax, 1e-8) / 127`` and ``x8 = clip(round(x / s), ±127)``, half
    to even, bit-identical to JAX's ``quantize_rows`` under ``jit`` (how the
    TPU forward always runs it): there XLA turns ``/ 127.0`` into a
    multiplication by the fp32 constant 1/127 (``INV_127``), which moves the
    scale by one ulp in about 5 % of rows against the op-by-op division.  The
    second division is a true one (a tensor divisor, on the card too)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = amax.clamp_min(1e-8) * INV_127
    x8 = torch.round(xf / s).clamp_(-127, 127).to(torch.int8)
    return x8, s[..., 0]


def w8a8_matmul_plain(x8, xs, wq, scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``(float(x8 @ wq) · xs[m]) · scale[n]`` with the integer sum taken in
    float64, where it is exact (|sum| ≤ 127·127·K < 2⁵³; a float32 product is
    exact only below 2²⁴ and an int8 ``torch.matmul`` wraps around).  The sum
    rounds to fp32 once, as an int32 does, and the scales multiply it in the
    kernel's order, so kernel and plain version agree bit for bit."""
    acc = (x8.double() @ wq.double()).float()
    return ((acc * xs.float()[:, None]) * scale.float()[None, :]).to(out_dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _raise_on_error(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.mimic_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _check_cuda(name: str, x: torch.Tensor, *tensors: torch.Tensor) -> None:
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: activations must be one of {list(_KERNEL_DTYPES)}, got {x.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _launch_int8_matmul(x, wq, scale, layer, out_dtype) -> torch.Tensor:
    from . import _build

    name = "int8_matmul"
    M, K = x.shape
    stacked = wq.dim() == 3
    N = wq.shape[-1]
    x = x.contiguous()
    _check_cuda(name, x, wq, scale)
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: weights must be int8 and scales fp32, got {wq.dtype}/{scale.dtype}")
    if wq.shape[-2] != K or scale.shape[-1] != N or (stacked and scale.shape[0] != wq.shape[0]):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} w {tuple(wq.shape)} "
                         f"scale {tuple(scale.shape)}")
    if N % 16 or M == 0 or K == 0:
        raise ValueError(f"{name}: N must be a non-zero multiple of 16 and M, K non-zero "
                         f"(M {M}, K {K}, N {N})")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: out_dtype must be one of {list(_KERNEL_DTYPES)}")
    w_ptr, s_ptr = wq.data_ptr(), scale.data_ptr()
    if stacked:
        if not 0 <= layer < wq.shape[0]:
            raise ValueError(f"{name}: layer {layer} outside [0, {wq.shape[0]})")
        w_ptr += layer * K * N          # int8: one byte per element
        s_ptr += layer * N * 4          # fp32
    lib = _build.load_library()
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        x = _mma_rows(x)
        ksplit = mma_plan(M, K, -(-N // MMA_BLOCK_N), _sm_count(x.device.index))
        with torch.cuda.device(x.device):
            err = lib.mimic_int8_matmul_mma(x.data_ptr(), x.shape[1], w_ptr, s_ptr, out.data_ptr(),
                                            M, K, N, ksplit, _KERNEL_DTYPES[out_dtype], stream)
    else:
        ksplit = lib.mimic_int8_matmul_ksplit(M, K, N)
        work = torch.empty(ksplit * M * N, dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            err = lib.mimic_int8_matmul(
                x.data_ptr(), w_ptr, s_ptr, work.data_ptr(), out.data_ptr(), M, K, N, ksplit,
                _KERNEL_DTYPES[out_dtype], stream,
            )
    _raise_on_error(lib, err, name)
    LAUNCHES[name] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _mma_rows(x: torch.Tensor) -> torch.Tensor:
    """bf16 rows as the tensor-core kernels read them: 16-byte chunks, so a row
    length that is a multiple of 8 (zero columns appended, which add nothing)
    and a 16-byte aligned start."""
    if x.shape[1] % 8:
        x = F.pad(x, (0, 8 - x.shape[1] % 8))
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _no_device(name: str, x: torch.Tensor):
    return ValueError(f"{name}: no kernel and no plain path for device {x.device}")


def int8_matmul(x, wq, scale, out_dtype=None) -> torch.Tensor:
    """``(x [M,K] @ wq [K,N] int8) · scale [N]`` → [M, N] (kernel on CUDA)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cuda":
        return _launch_int8_matmul(x, wq, scale, None, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, scale, out_dtype)
    raise _no_device("int8_matmul", x)


def int8_matmul_stacked(x, wq, scale, layer: int, out_dtype=None) -> torch.Tensor:
    """``int8_matmul`` on layer ``layer`` of a stacked ``[L,K,N]`` weight and
    ``[L,N]`` scale, read in place (kernel on CUDA)."""
    out_dtype = out_dtype or x.dtype
    layer = int(layer)
    if x.device.type == "cuda":
        return _launch_int8_matmul(x, wq, scale, layer, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq[layer], scale[layer], out_dtype)
    raise _no_device("int8_matmul_stacked", x)


def _launch_w8a8_matmul(x8, xs, wq, scale, layer, out_dtype) -> torch.Tensor:
    from . import _build

    name = "w8a8_matmul"
    M, K = x8.shape
    stacked = wq.dim() == 3
    N = wq.shape[-1]
    for t in (x8, xs, wq, scale):
        if t.device != x8.device:
            raise ValueError(f"{name}: all inputs must be on {x8.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if x8.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"{name}: activations and weights must be int8, got {x8.dtype}/{wq.dtype}")
    if xs.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be fp32, got {xs.dtype}/{scale.dtype}")
    if (wq.shape[-2] != K or xs.shape != (M,) or scale.shape[-1] != N
            or scale.dim() != wq.dim() - 1 or (stacked and scale.shape[0] != wq.shape[0])):
        raise ValueError(f"{name}: bad shapes x8 {tuple(x8.shape)} xs {tuple(xs.shape)} "
                         f"w {tuple(wq.shape)} scale {tuple(scale.shape)}")
    if K % 16 or N % 16 or M == 0 or K == 0 or N == 0:
        raise ValueError(f"{name}: K and N must be non-zero multiples of 16 and M non-zero "
                         f"(M {M}, K {K}, N {N})")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: out_dtype must be one of {list(_KERNEL_DTYPES)}")
    w_ptr, s_ptr = wq.data_ptr(), scale.data_ptr()
    if stacked:
        if not 0 <= layer < wq.shape[0]:
            raise ValueError(f"{name}: layer {layer} outside [0, {wq.shape[0]})")
        w_ptr += layer * K * N          # int8: one byte per element
        s_ptr += layer * N * 4          # fp32
    if x8.data_ptr() % 16 or w_ptr % 16:
        raise ValueError(f"{name}: x8 and the weights must start 16-byte aligned (TMA)")
    lib = _build.load_library()
    out = torch.empty(M, N, dtype=out_dtype, device=x8.device)
    with torch.cuda.device(x8.device):
        err = lib.mimic_w8a8_matmul(
            x8.data_ptr(), xs.data_ptr(), w_ptr, s_ptr, out.data_ptr(), M, K, N,
            _KERNEL_DTYPES[out_dtype], torch.cuda.current_stream(x8.device).cuda_stream,
        )
    _raise_on_error(lib, err, name)
    LAUNCHES[name] += 1
    return out


def _launch_quantize_rows(x: torch.Tensor):
    from . import _build

    name = "quantize_rows"
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: rows must be one of {list(_KERNEL_DTYPES)}, got {x.dtype}")
    lead, K = x.shape[:-1], x.shape[-1]
    xm = x.reshape(-1, K).contiguous()
    M = xm.shape[0]
    if K == 0:
        raise ValueError(f"{name}: rows of length 0 have no scale")
    x8 = torch.empty(M, K, dtype=torch.int8, device=x.device)
    s = torch.empty(M, dtype=torch.float32, device=x.device)
    if M == 0:
        return x8.reshape(*lead, K), s.reshape(lead)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.mimic_quantize_rows(xm.data_ptr(), x8.data_ptr(), s.data_ptr(), M, K,
                                      _KERNEL_DTYPES[x.dtype],
                                      torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(lib, err, name)
    ROW_LAUNCHES[name] += 1
    return x8.reshape(*lead, K), s.reshape(lead)


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8: [..., K] float → (int8 [..., K], f32 [...]
    scales), bit-identical to JAX's jitted ``quantize_rows`` (see
    ``quantize_rows_plain``): the one-pass kernel on CUDA, the plain version on
    the CPU."""
    if x.device.type == "cuda":
        return _launch_quantize_rows(x)
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    raise _no_device("quantize_rows", x)


def w8a8_matmul(x8, xs, wq, scale, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``(x8 [M,K] int8 @ wq [K,N] int8) · xs [M] · scale [N]`` → [M, N], the
    sum exact in int32 (kernel on CUDA)."""
    if x8.device.type == "cuda":
        return _launch_w8a8_matmul(x8, xs, wq, scale, None, out_dtype)
    if x8.device.type == "cpu":
        return w8a8_matmul_plain(x8, xs, wq, scale, out_dtype)
    raise _no_device("w8a8_matmul", x8)


def w8a8_matmul_stacked(x8, xs, wq, scale, layer: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``w8a8_matmul`` on layer ``layer`` of a stacked ``[L,K,N]`` weight and
    ``[L,N]`` scale, read in place (kernel on CUDA)."""
    layer = int(layer)
    if x8.device.type == "cuda":
        return _launch_w8a8_matmul(x8, xs, wq, scale, layer, out_dtype)
    if x8.device.type == "cpu":
        return w8a8_matmul_plain(x8, xs, wq[layer], scale[layer], out_dtype)
    raise _no_device("w8a8_matmul_stacked", x8)


def _launch_fused_mlp(xn, gu_q8, gu_scale, down_q8, down_scale, layer, out_dtype):
    from . import _build

    name = "fused_mlp_int8"
    M, D = xn.shape
    L, _, F2 = gu_q8.shape
    Fh = F2 // 2
    xn = xn.contiguous()
    _check_cuda(name, xn, gu_q8, gu_scale, down_q8, down_scale)
    if gu_q8.dtype != torch.int8 or down_q8.dtype != torch.int8:
        raise TypeError(f"{name}: weights must be int8")
    if gu_scale.dtype != torch.float32 or down_scale.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be fp32")
    if (gu_q8.shape != (L, D, F2) or gu_scale.shape != (L, F2) or down_q8.shape != (L, Fh, D)
            or down_scale.shape != (L, D)):
        raise ValueError(f"{name}: bad shapes xn {tuple(xn.shape)} gu {tuple(gu_q8.shape)} "
                         f"down {tuple(down_q8.shape)}")
    if Fh % MLP_BLOCK_F or D % 16 or M == 0:
        raise ValueError(f"{name}: needs F % {MLP_BLOCK_F} == 0, D % 16 == 0, M > 0 "
                         f"(F {Fh}, D {D}, M {M})")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: out_dtype must be one of {list(_KERNEL_DTYPES)}")
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    lib = _build.load_library()
    out = torch.empty(M, D, dtype=out_dtype, device=xn.device)
    weights = (gu_q8.data_ptr() + layer * D * F2, gu_scale.data_ptr() + layer * F2 * 4,
               down_q8.data_ptr() + layer * Fh * D, down_scale.data_ptr() + layer * D * 4)
    stream = torch.cuda.current_stream(xn.device).cuda_stream
    if xn.dtype == torch.bfloat16:
        xn = _mma_rows(xn)
        sms = _sm_count(xn.device.index)
        ks_gu = mma_plan(M, D, Fh // MLP_BLOCK_F, sms)
        ks_down = mma_plan(M, Fh, -(-D // MMA_BLOCK_N), sms)
        h = torch.empty(M, Fh, dtype=torch.bfloat16, device=xn.device)
        with torch.cuda.device(xn.device):
            err = lib.mimic_fused_mlp_int8_mma(
                xn.data_ptr(), *weights, h.data_ptr(), out.data_ptr(), M, D, Fh, ks_gu, ks_down,
                _KERNEL_DTYPES[out_dtype], stream)
    else:
        work = torch.empty(Fh // MLP_BLOCK_F * M * D, dtype=torch.float32, device=xn.device)
        with torch.cuda.device(xn.device):
            err = lib.mimic_fused_mlp_int8(
                xn.data_ptr(), *weights, work.data_ptr(), out.data_ptr(), M, D, Fh,
                _KERNEL_DTYPES[out_dtype], stream)
    _raise_on_error(lib, err, name)
    LAUNCHES[name] += 1
    return out


def fused_mlp_stacked(xn, gu_q8, gu_scale, down_q8, down_scale, layer: int, out_dtype=None):
    """Layer ``layer``'s SwiGLU MLP ``silu(xn@Wg)·(xn@Wu) @ Wd`` from the fused
    gate|up stack ``[L,D,2F]`` and the down stack ``[L,F,D]`` (kernel on CUDA)."""
    out_dtype = out_dtype or xn.dtype
    layer = int(layer)
    if xn.device.type == "cuda":
        return _launch_fused_mlp(xn, gu_q8, gu_scale, down_q8, down_scale, layer, out_dtype)
    if xn.device.type == "cpu":
        return fused_mlp_plain(xn, gu_q8[layer], gu_scale[layer], down_q8[layer],
                               down_scale[layer], out_dtype)
    raise _no_device("fused_mlp_stacked", xn)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def fused_mlp(xn: torch.Tensor, gateup: Any, down: Any) -> Optional[torch.Tensor]:
    """The SwiGLU MLP through the fused kernel when eligible, else ``None``.

    Kept from the JAX gate: both weights are stacked handles (they carry a
    ``layer``), no lane padding in storage, decode-sized M (< 256) and a
    CUDA tensor in place of the TPU backend.  Re-decided for this kernel: M
    needs no padding to 16 and may span several 16-row blocks (each re-reads
    the weights, as the TPU's single-M-block rule warned; decode M is 6-12),
    and F must divide into the kernel's 64-column blocks (not 256).  A
    recorded gradient also declines: the fused kernel has no backward, the
    two-``qdot`` path does.
    """
    if not (is_quantized(gateup) and is_quantized(down)):
        return None
    if gateup.get("layer") is None or down.get("layer") is None:
        return None
    D = xn.shape[-1]
    xm = xn.reshape(-1, D)
    M = xm.shape[0]
    if xn.device.type != "cuda" or M >= MLP_MAX_M:
        return None
    if torch.is_grad_enabled() and xn.requires_grad:
        return None
    gu_q8, gu_scale = gateup["q8"], gateup["scale"]
    d_q8, d_scale = down["q8"], down["scale"]
    if gu_q8.shape[-1] != gu_scale.shape[-1] or d_q8.shape[-1] != d_scale.shape[-1]:
        return None  # lane-padded storage: interior pad columns break the split
    Fh = gu_q8.shape[-1] // 2
    if d_q8.shape[-2] != Fh or Fh % MLP_BLOCK_F or D % 16:
        return None
    out = fused_mlp_stacked(xm, gu_q8, gu_scale, d_q8, d_scale, gateup["layer"],
                            out_dtype=xn.dtype)
    return out.reshape(xn.shape)


class Int8MatmulDiff(torch.autograd.Function):
    """The int8 matmul differentiable in its activations (JAX ``_input_vjp``).

    Forward: ``int8_matmul`` / ``int8_matmul_stacked`` (kernel on CUDA, the
    plain version on the CPU).  Backward: ``dY @ deq(W)ᵀ`` in fp32, rounded
    to dY's dtype, as in JAX.  The weights are frozen and get no gradient;
    without this Function a kernel output written through a raw pointer
    would carry no ``grad_fn`` and cut every gradient through a frozen int8
    tower.
    """

    @staticmethod
    def forward(ctx, xm, wq, scale, layer, out_dtype):
        ctx.save_for_backward(wq, scale)
        ctx.layer = layer
        if layer is None:
            return int8_matmul(xm, wq, scale, out_dtype=out_dtype)
        return int8_matmul_stacked(xm, wq, scale, layer, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        wq, scale = ctx.saved_tensors
        deq = dequantize({"q8": wq, "scale": scale, "layer": ctx.layer})
        return (dy.float() @ deq.t()).to(dy.dtype), None, None, None, None


class W8A8MatmulDiff(Int8MatmulDiff):
    """The W8A8 matmul differentiable in its activations.

    Forward: ``quantize_rows`` then ``w8a8_matmul`` / ``w8a8_matmul_stacked``.
    Backward: ``Int8MatmulDiff``'s ``dY @ deq(W)ᵀ``, a straight-through
    estimate that treats the per-row activation rounding as the identity (JAX
    ``_input_vjp`` around ``run_w8a8``).
    """

    @staticmethod
    def forward(ctx, xm, wq, scale, layer, out_dtype):
        ctx.save_for_backward(wq, scale)
        ctx.layer = layer
        x8, xs = quantize_rows(xm)
        if layer is None:
            return w8a8_matmul(x8, xs, wq, scale, out_dtype=out_dtype)
        return w8a8_matmul_stacked(x8, xs, wq, scale, layer, out_dtype=out_dtype)


def int8_matmul_diff(xm, wq, scale, layer=None, out_dtype=None) -> torch.Tensor:
    """``Int8MatmulDiff``: the int8 matmul with a gradient for ``xm``."""
    return Int8MatmulDiff.apply(xm, wq, scale, layer, out_dtype or xm.dtype)


def w8a8_matmul_diff(xm, wq, scale, layer=None, out_dtype=None) -> torch.Tensor:
    """``W8A8MatmulDiff``: row-quantize ``xm`` and multiply int8 × int8, with
    a straight-through gradient for ``xm``."""
    return W8A8MatmulDiff.apply(xm, wq, scale, layer, out_dtype or xm.dtype)


def qdot(x: torch.Tensor, w: Any, preferred_element_type=None) -> torch.Tensor:
    """``x @ w`` that also takes a quantized handle (JAX ``qdot``).

    Plain tensors: ``x @ w`` (cast to ``preferred_element_type`` if given).
    Quantized, on the CPU: the dequantized fp32 product, as JAX off the TPU.
    The ``a8`` marker is inert there, again as in JAX.
    On CUDA: an ``a8`` handle at M >= ``W8A8_MIN_M`` (256, as in JAX) takes
    ``w8a8_matmul`` through ``W8A8MatmulDiff`` (rows quantized per token, not
    bit-parity with the weight-only product); otherwise M < ``KERNEL_MAX_M``
    launches ``int8_matmul`` through ``Int8MatmulDiff`` (differentiable in
    ``x``; the marker is inert there) and larger M a dequantized
    ``torch.matmul``.  The cut-off is re-decided for the H100 (see
    ``KERNEL_MAX_M``: the kernel wins up to M 384, the dequantized product from
    512).  The kernel masks a ragged last row tile itself, so the TPU path's
    padding of M to 128 is not carried over.
    """
    if not is_quantized(w):
        out = x @ w
        return out if preferred_element_type is None else out.to(preferred_element_type)

    wq, scale, layer = w["q8"], w["scale"], w.get("layer")
    n, n_stored = scale.shape[-1], wq.shape[-1]
    lead, K = x.shape[:-1], x.shape[-1]
    out_dtype = preferred_element_type or x.dtype
    xm = x.reshape(-1, K)
    if wq.shape[-2] != K:
        # pad_k storage: zero activation columns contribute nothing (exact)
        xm = F.pad(xm, (0, wq.shape[-2] - K))
    if x.device.type == "cpu":
        out = (xm.float() @ dequantize(w)).to(out_dtype)
    elif x.device.type != "cuda":
        raise _no_device("qdot", x)
    else:
        w8a8 = xm.shape[0] >= W8A8_MIN_M and "a8" in w
        if not w8a8 and xm.shape[0] >= KERNEL_MAX_M:
            out = (xm @ dequantize(w).to(x.dtype)).to(out_dtype)
        else:
            if n != n_stored:
                scale = F.pad(scale, (0, n_stored - n))
            diff = w8a8_matmul_diff if w8a8 else int8_matmul_diff
            out = diff(xm, wq, scale, layer, out_dtype)[:, :n]
    return out.reshape(*lead, n)
