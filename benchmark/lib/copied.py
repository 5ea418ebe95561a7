"""Frozen copies of the measurement pieces of ``chip_smoke.py``.

The program may change in later PRs; the yardstick may not.  So the pieces
of the smoke script that the benchmark reads are copied here once, as they
were, each with one line naming its source.  Later edits to ``chip_smoke.py``
do not reach the benchmark.
"""

from __future__ import annotations

import numpy as np
import torch

# copied from chip_smoke.py (PEAK_BYTES, PEAK_OPS)
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): device
# memory bytes/s and tensor-core operations/s by input type.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}


# copied from chip_smoke.py::nbytes
def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# copied from chip_smoke.py::kv_nbytes
def kv_nbytes(k, v, allowed, need_unmasked: bool, mean_of_v: bool) -> int:
    """The bytes of an attention's k and v [B, S, Hkv, D] that its function needs,
    each read once: every key for lse_u; else a batch's keys that some row may
    attend to (``allowed`` [B, T, S]), and all of its v where a row attends to
    none and ``mean_of_v`` (onepass_fwd: that row is the mean of v over every key)."""
    if need_unmasked:
        return nbytes(k, v)
    S = k.shape[1]
    keys = allowed.any(1).sum(-1)
    v_keys = torch.where(~allowed.any(-1).all(-1), S, keys) if mean_of_v else keys
    per_key = k[0, 0].numel() * k.element_size()
    return int((keys + v_keys).sum().item()) * per_key


# copied from chip_smoke.py::bound
def bound(n_bytes: int, n_ops: int, op_type: str) -> dict:
    """The least time the card could take: every input byte read once and every
    output byte written once at the memory peak, or the operations at the
    tensor cores' peak for their type, whichever is larger."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_OPS[op_type] * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops
            else "operations", "bytes": n_bytes, "operations": n_ops}


# copied from chip_smoke.py::synthetic_image
def synthetic_image(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(980, 980, 3), dtype=np.uint8)


# copied from chip_smoke.py (WORDS)
WORDS = ("red blue green small large dog cat bus tree sky table person two three "
         "standing sitting water street kitchen field plate window").split()


# copied from chip_smoke.py::synthetic_text
def synthetic_text(seed: int, n_chars: int) -> str:
    rng = np.random.default_rng(seed)
    parts, size = [], 0
    while size < n_chars:
        w = " ".join(rng.choice(WORDS, size=6))
        line = f"Question: what is {w}? Answer: {rng.choice(WORDS)}\n"
        parts.append(line)
        size += len(line)
    return "".join(parts)[:n_chars]


# copied from chip_smoke.py::kernel_group
def kernel_group(key: str) -> str:
    k = key.lower()
    # int8_matmul_kernel / int8_matmul_mma_kernel; fused_mlp_kernel and the
    # bf16 path's fused_mlp_gateup_kernel / fused_mlp_down_kernel
    return ("attention backward kernels" if "flash_bwd" in key or "bwd::" in key
            else "attention forward kernels" if "mimic::" in key
            else "int8_matmul" if "int8_matmul" in key
            else "w8a8_matmul" if "w8a8" in key
            else "quantize_rows" if "quantize_rows" in key
            else "fused_mlp" if "fused_mlp" in key
            else "prompt_attn" if "prompt_attn" in key
            else "int8 split-K reduce" if "splitk_reduce" in key
            else "matmuls" if any(w in k for w in ("gemm", "nvjet", "xmma", "cutlass"))
            else "other")


# copied from chip_smoke.py::covered_us
def covered_us(spans) -> float:
    """Length of the union of (start, end) spans: device time during which at
    least one of the kernels ran.  A sum of kernel durations counts twice what
    overlaps (a programmatic dependent launch starts before its predecessor
    ends)."""
    total, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return total + (0.0 if cur is None else cur[1] - cur[0])


# copied from chip_smoke.py::make_train_batch (the synthetic shape of the smoke
# script's train phase; the cells feed the collator's batches instead)
def make_train_batch(cfg, B=2, T_rec=2048, T_shift=256, n_demo_img=8, M=64):
    """The dual-pass batch of scripts/bench_8b_train.py, as device tensors:
    random token ids with 64 image tokens per image (8 demo images + the query
    image in the record pass, the query image in the shift pass), random 980 px
    pixels with full patch masks, and M gathered query tokens per row (the
    last M of each pass)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    size, S = cfg.vision.image_size, cfg.image_seq_len
    ng = size // cfg.vision.patch_size
    hi = min(32000, cfg.text.vocab_size)
    lo = min(300, hi // 2)
    full_ids = torch.randint(lo, hi, (B, T_rec), generator=gen, device=dev)
    # 128 text tokens after each image where they fit (idefics2's 64-token images)
    gap = min(128, (T_rec - 4 - M - (n_demo_img + 1) * S) // (n_demo_img + 1))
    for i in range(n_demo_img + 1):
        pos = 4 + i * (S + gap)
        full_ids[:, pos:pos + S] = cfg.image_token_id
    query_ids = torch.randint(lo, hi, (B, T_shift), generator=gen, device=dev)
    query_ids[:, 4:4 + S] = cfg.image_token_id

    def pixels(n):
        px = torch.randn(B, n, size, size, 3, generator=gen, device=dev).to(torch.bfloat16)
        return px, torch.ones(B, n, ng, ng, dtype=torch.int32, device=dev)

    full_px, full_patch = pixels(n_demo_img + 1)
    query_px, query_patch = pixels(1)
    idx = torch.arange(M, device=dev)[None].expand(B, M)
    return {
        "full_ids": full_ids, "full_mask": torch.ones(B, T_rec, dtype=torch.int32, device=dev),
        "full_pixels": full_px, "full_patch_mask": full_patch,
        "query_ids": query_ids, "query_mask": torch.ones(B, T_shift, dtype=torch.int32, device=dev),
        "query_pixels": query_px, "query_patch_mask": query_patch,
        "prefix_q_idx": idx + (T_rec - M), "shift_q_idx": idx + (T_shift - M),
        "q_valid": torch.ones(B, M, dtype=torch.bool, device=dev),
    }
