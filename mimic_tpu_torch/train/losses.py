"""Training losses for the dual-pass objective.

Counterpart of ``mimic_tpu/train/losses.py`` (same formulas, same reductions):

- layer-wise MSE / cosine between shift-pass and record-pass hidden states at
  the query tokens, mean over (layers × selected tokens × dims) per sample,
  then over the batch;
- LM cross-entropy over next tokens whose shifted attention mask is 1;
- logits KL (``kl_div(log_softmax(shift), softmax(prefix), "batchmean")``)
  over the answer+EOS tokens.

Selected-token sets arrive as fixed-width ``(indices, valid)`` pairs built on
the host (``mimic_tpu/train/masking.py``).  Rows are selected by indexing; the
JAX package's one-hot matmul exists for the TPU and gives the same values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gather_tokens(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """x [..., B, T, D], indices [B, M] → [..., B, M, D] (an optional leading L axis)."""
    idx = indices.long()
    if x.ndim == 4:  # [L,B,T,D]
        return x[:, torch.arange(idx.shape[0], device=x.device)[:, None], idx]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def layer_wise_mse(
    shift_hidden: torch.Tensor,   # [L,B,T2,D]
    prefix_hidden: torch.Tensor,  # [L,B,T1,D]
    shift_idx: torch.Tensor,      # [B,M]
    prefix_idx: torch.Tensor,     # [B,M]
    valid: torch.Tensor,          # [B,M]
) -> torch.Tensor:
    s = gather_tokens(shift_hidden, shift_idx).float()
    p = gather_tokens(prefix_hidden, prefix_idx).float()
    sq = (s - p).square().sum(-1)                                   # [L,B,M]
    sq = torch.where(valid.bool()[None], sq, 0.0)
    per_sample = sq.sum(dim=(0, 2))                                 # [B]
    L, _, _, D = s.shape
    counts = valid.bool().sum(1).clamp_min(1)                       # [B]
    per_sample = per_sample / (L * counts * D)
    return per_sample.mean()


def layer_wise_cos(
    shift_hidden: torch.Tensor,
    prefix_hidden: torch.Tensor,
    shift_idx: torch.Tensor,
    prefix_idx: torch.Tensor,
    valid: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    s = gather_tokens(shift_hidden, shift_idx).float()
    p = gather_tokens(prefix_hidden, prefix_idx).float()
    dot = (s * p).sum(-1)
    ns = torch.linalg.vector_norm(s, dim=-1)
    np_ = torch.linalg.vector_norm(p, dim=-1)
    # torch.cosine_similarity clamps each norm at eps
    cos = dot / (ns.clamp_min(eps) * np_.clamp_min(eps))          # [L,B,M]
    cos = torch.where(valid.bool()[None], cos, 0.0)
    counts = valid.bool().sum(1).clamp_min(1)                       # [B]
    mean_t = cos.sum(2) / counts[None]                              # [L,B]
    return (1.0 - mean_t).mean()


def lm_cross_entropy(
    logits: torch.Tensor,          # [B,T,V]
    labels: torch.Tensor,          # [B,T]
    attention_mask: torch.Tensor,  # [B,T] (pad-excluding, HF semantics)
) -> torch.Tensor:
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    mask = attention_mask[:, 1:].float()
    logprobs = F.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logprobs, -1, shift_labels[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def logits_kl(
    shift_logits: torch.Tensor,   # [B,T2,V]
    prefix_logits: torch.Tensor,  # [B,T1,V]
    shift_idx: torch.Tensor,      # [B,M] answer+EOS positions in the shift pass
    prefix_idx: torch.Tensor,     # [B,M] answer+EOS positions in the record pass
    valid: torch.Tensor,          # [B,M]
) -> torch.Tensor:
    log_q = F.log_softmax(gather_tokens(shift_logits, shift_idx).float(), dim=-1)
    log_p = F.log_softmax(gather_tokens(prefix_logits, prefix_idx).float(), dim=-1)
    kl = (log_p.exp() * (log_p - log_q)).sum(-1)                   # [B,M]
    kl = torch.where(valid.bool(), kl, 0.0)
    # batchmean over the gathered rows (the reference flattens the selected
    # tokens into the batch dimension before kl_div)
    return kl.sum() / valid.bool().sum().clamp_min(1)
