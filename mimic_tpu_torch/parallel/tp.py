"""Tensor-parallel collectives over the current mesh's ``model`` axis.

Megatron's pair of conjugate regions, as ``torch.autograd.Function``s:

- ``copy_to_region``: identity forward, ``all_reduce`` backward.  Every
  replicated tensor that enters a head- or column-sharded region goes through
  it (the layer input, a shift leaf sliced to this rank's heads, LoRA's B, the
  μ-gate of the flat shift), so its gradient is summed over ``model``: each
  rank saw only its own heads' share.
- ``reduce_from_region``: ``all_reduce`` forward (a row-parallel product's
  partial sums), identity backward.
- ``gather_from_region``: the vocab ``all_gather`` of column-parallel logits;
  backward keeps this rank's columns.

With no current mesh, or a ``model`` axis of one rank, each is the identity
and ``split_width`` the full width: the one-process path runs unchanged.

Which dimension of a weight is split follows the rules of ``mesh.py``: a
dimension the rules split over ``model`` is split when it divides, so
``split_width(full)`` is what ``shard_params`` left of it.  A module under a
``model`` axis expects ``shard_params``' tree and says so when it gets another.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import axis_group, axis_rank, axis_size, current_mesh


def model_size() -> int:
    return axis_size(current_mesh(), "model")


def model_rank() -> int:
    return axis_rank(current_mesh(), "model")


def model_group():
    return axis_group(current_mesh(), "model")


def split_width(full: int) -> int:
    """The width this rank holds of a dimension of size ``full`` that the rules
    split over ``model``: ``full / n`` where n divides it, else all of it."""
    n = model_size()
    return full // n if n > 1 and full % n == 0 else full


def local_heads(heads: int, head_dim: int, what: str) -> int:
    """The heads this rank holds of a projection of ``heads * head_dim`` columns
    split over ``model``.  The rules split columns, not heads: a split inside a
    head (``heads`` not divisible by the axis while the columns are) is not
    ported and raises."""
    width = split_width(heads * head_dim)
    if width % head_dim:
        raise NotImplementedError(
            f"{what}: {heads} heads over a model axis of {model_size()} split inside a "
            "head; tensor parallelism needs the heads to divide the axis"
        )
    return width // head_dim


def local_block(x: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    """This rank's contiguous ``width`` of ``x`` along ``dim`` (``x`` itself when
    ``width`` is all of it)."""
    if x.shape[dim] == width:
        return x
    return x.narrow(dim, model_rank() * width, width)


def check_width(t: torch.Tensor, dim: int, width: int, what: str) -> None:
    """Raise unless ``t``'s ``dim`` holds the ``width`` this rank should hold."""
    if t.shape[dim] != width:
        raise ValueError(
            f"{what}: dimension {dim} holds {t.shape[dim]}, this rank's share of the "
            f"model axis is {width}; under a model axis the tree must be shard_params'"
        )


def is_split(w: torch.Tensor, dim: int, full: int, what: str) -> bool:
    """Whether ``w``'s ``dim`` (of size ``full`` unsplit) is split over the model
    axis; under one raises when the tree is not what ``shard_params`` gives."""
    if model_size() == 1:
        return False
    width = split_width(full)
    check_width(w, dim, width, what)
    return width != full


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        parts = [torch.empty_like(x.contiguous()) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_group_rank(ctx.group, dist.get_rank())
        return g[..., r * ctx.width:(r + 1) * ctx.width], None


def copy_to_region(x: torch.Tensor, split: bool = True) -> torch.Tensor:
    """``x`` entering a region sharded over ``model`` (identity where ``split``
    is false: the region is replicated, each rank's gradient already whole)."""
    group = model_group() if split else None
    return x if group is None else _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, split: bool = True) -> torch.Tensor:
    """The partial sums of a row-parallel product, summed over ``model``
    (identity where ``split`` is false)."""
    group = model_group() if split else None
    return x if group is None else _ReduceFromRegion.apply(x, group)


def gather_from_region(x: torch.Tensor) -> torch.Tensor:
    group = model_group()
    return x if group is None else _GatherFromRegion.apply(x, group)


def shared_heads(x: Optional[torch.Tensor], dim: int, width: int) -> Optional[torch.Tensor]:
    """A replicated tensor used on this rank's heads or columns only (a shift
    leaf, LoRA's B, a prefix): its block along ``dim``, through
    ``copy_to_region`` so its gradient is summed over ``model``."""
    if x is None or x.shape[dim] == width:
        return x
    return local_block(copy_to_region(x), dim, width)
