"""The routed-expert MLP of DeepSeek-V3-style towers (Kimi-VL): a sigmoid
router with a score-correction bias (``noaux_tc``, one group), the top-k
experts of each row as SwiGLU MLPs, and shared experts on every row.

It replaces no kernel of the JAX package, which has no expert layer.  What
bounds it on the card: each projection is one grouped product over every
expert (``torch._grouped_mm``), so a call reads each expert's weights once; at
the record pass's ~10k rows that is compute (each expert sees ~900 rows), at
the shift pass's 1.5k rows the weights' bytes.  The design keeps the host out
of the block: the router, the sort of the (row, expert) assignments and the
groups' offsets stay on the device, every assignment goes to its expert with
no capacity limit and no row dropped, and the combine is a gather back to
row order and a weighted sum, in a fixed order.  The weights are frozen: the
backward of a grouped product is the same product of the output's gradient
against the transposed weights, and no weight gradient is made.

On the CPU the grouped product is a plain loop over the experts (its
reference, as the attention kernels have theirs).  Spans: ``moe.block``
around the whole block, ``moe.route`` (router, top-k, weights, sort and
offsets) and ``moe.experts`` (permute, grouped products, combine, shared
experts); counters ``moe_assignments`` (rows × k) and
``moe_grouped_launches`` (three a block, from shapes).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..utils.tracing import count, span
from .config import TextConfig
from .layers import swiglu_mlp

Params = Dict[str, Any]


def _grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """rows [offs[e-1], offs[e]) of ``x`` times ``w[e]``, expert by expert."""
    out = x.new_empty(x.shape[0], w.shape[-1])
    start = 0
    for e, end in enumerate(offs.tolist()):
        out[start:end] = x[start:end] @ w[e]
        start = end
    return out


class _GroupedMM(torch.autograd.Function):
    """``torch._grouped_mm`` with the gradient of its rows: the same grouped
    product of the output's gradient against the transposed weights (the
    weights are frozen and get none)."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(w, offs)
        return torch._grouped_mm(x, w, offs=offs)

    @staticmethod
    def backward(ctx, g):
        w, offs = ctx.saved_tensors
        return torch._grouped_mm(g.contiguous(), w.transpose(-2, -1), offs=offs), None, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """x [M, K] (rows sorted by expert), w [E, K, N], offs [E] int32 (each
    group's end) → [M, N]: one grouped product on a card, the plain loop on
    the CPU."""
    if w.requires_grad:
        raise ValueError("grouped_mm: the expert weights are frozen (no weight gradient)")
    count("moe_grouped_launches")
    if x.device.type == "cuda":
        return _GroupedMM.apply(x, w, offs)
    return _grouped_mm_plain(x, w, offs)


class _Permute(torch.autograd.Function):
    """x[index] whose gradient is g[inverse] (a gather, not a scatter-add):
    ``index`` is a permutation and ``inverse`` its inverse."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.save_for_backward(index, inverse)
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        index, inverse = ctx.saved_tensors
        return _Permute.apply(g, inverse, index), None, None


class _Gather(torch.autograd.Function):
    """h[order // k]: each assignment's row, in expert order.  The gradient
    is each row's k assignments summed, g[inverse] viewed [N, k, D], in a
    fixed order (no scatter-add)."""

    @staticmethod
    def forward(ctx, h, order, inverse, k):
        ctx.save_for_backward(inverse)
        ctx.k = k
        return h.index_select(0, torch.div(order, k, rounding_mode="floor"))

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        D = g.shape[-1]
        return g.index_select(0, inverse).view(-1, ctx.k, D).sum(1), None, None, None


def route(x: torch.Tensor, mp: Params, cfg: TextConfig):
    """x [N, D] → (expert ids [N, k], weights [N, k] fp32): the sigmoid scores
    of an fp32 router, the top k of score + correction bias, their scores
    divided by their sum and times the scaling factor."""
    scores = torch.sigmoid(x.float() @ mp["router"].float())
    choice = scores + mp["router_bias"].float()
    idx = torch.topk(choice, cfg.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    return idx, w


def moe_block(x: torch.Tensor, mp: Params, cfg: TextConfig) -> torch.Tensor:
    """The expert MLP of one layer over x [B, T, D]; ``mp`` that layer's
    ``router`` [D, E], ``router_bias`` [E], experts ``gate`` / ``up``
    [E, D, Fe] and ``down`` [E, Fe, D], and ``shared_gate`` / ``shared_up`` /
    ``shared_down``."""
    B, T, D = x.shape
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    h = x.reshape(B * T, D)
    n = h.shape[0] * k
    count("moe_assignments", n)
    with span("moe.block"):
        with span("moe.route"):
            idx, w = route(h, mp, cfg)
            flat = idx.reshape(-1)
            order = torch.argsort(flat, stable=True)       # assignments by expert
            inverse = torch.empty_like(order)
            inverse[order] = torch.arange(n, device=x.device)
            experts = torch.arange(E, device=x.device, dtype=flat.dtype)
            offs = torch.searchsorted(flat[order], experts, right=True).to(torch.int32)
        with span("moe.experts"):
            rows = _Gather.apply(h, order, inverse, k)
            a = F.silu(grouped_mm(rows, mp["gate"], offs)) * grouped_mm(rows, mp["up"], offs)
            y = _Permute.apply(grouped_mm(a, mp["down"], offs), inverse, order)
            out = (y.reshape(-1, k, D).float() * w[..., None]).sum(1)
            shared = swiglu_mlp(h, mp["shared_gate"], mp["shared_up"], mp["shared_down"])
            return (out + shared.float()).to(x.dtype).reshape(B, T, D)
