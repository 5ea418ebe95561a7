"""Tensor-parallel collectives over the current mesh's ``model`` axis.

Megatron's conjugate regions, as ``torch.autograd.Function``s:

- ``copy_to_region``: identity forward, ``all_reduce`` backward.  Every
  replicated tensor that enters a head- or column-sharded region goes through
  it (the layer input, a shift leaf sliced to this rank's heads, LoRA's B, the
  μ-gate of the flat shift), so its gradient is summed over ``model``: each
  rank saw only its own heads' share.
- ``reduce_from_region``: ``all_reduce`` forward (a row-parallel product's
  partial sums), identity backward.
- ``gather_from_region``: ``all_gather`` of this rank's columns (the vocab of
  column-parallel logits, a head-split projection's q/k/v); backward keeps
  this rank's columns.
- ``scatter_to_region``: this rank's columns of a replicated tensor (a
  gathered attention's output, cut to this rank's rows of ``o_proj``);
  backward ``all_gather``s the columns' gradients, so that what reaches the
  gathered attention is whole on every rank.

With no current mesh, or a ``model`` axis of one rank, each is the identity
and ``split_width`` the full width: the one-process path runs unchanged.

Which dimension of a weight is split follows the rules of ``mesh.py``: a
dimension the rules split over ``model`` is split when it divides, so
``split_width(full)`` is what ``shard_params`` left of it.  The rules split
columns, not heads, so an attention runs in one of two head regions
(``whole_heads``): where every rank's block holds whole heads, aligned with
the KV heads its query heads read, each rank attends over its own heads; where
a block cuts inside a head (or holds query heads whose KV heads lie on another
rank), q/k/v are gathered to every head, every rank attends over all of them
and the output is scattered back to this rank's rows of ``o_proj``: the
result GSPMD gives for an attention it cannot partition.  ``head_region``
decides it, from the facts its callers pass: besides the shapes, whether the
layer's projections are int8 handles (whole on every rank: every head, no
collective), whether a ring runs over ``model`` itself (gathered), and how
many KV heads the call's cache holds.  A module under a ``model`` axis
expects ``shard_params``' tree and says so when it gets another;
``gather_split`` makes a split weight whole again (what int8 quantization
reads).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def whole_heads(heads: int, kv_heads: int, head_dim: int, n: int) -> bool:
    """Whether a ``model`` axis of ``n`` ranks leaves each rank whole heads of an
    attention of ``heads`` query heads on ``kv_heads`` KV heads of ``head_dim``,
    each rank's query heads aligned with the KV heads they read.

    The rules cut q's ``heads * head_dim`` columns (and k/v's, and ``o_proj``'s
    rows) into ``n`` contiguous blocks where ``n`` divides them.  True where
    nothing is cut (``n`` 1, or ``n`` does not divide q's columns, and so not
    k/v's either) or where ``n`` divides the KV heads (and so the query heads,
    rank r's query heads reading exactly its own KV heads).  False otherwise:
    a block cuts inside a head, or holds whole query heads whose KV heads lie
    on another rank; the attention then runs gathered (``head_region``)."""
    if n == 1 or (heads * head_dim) % n:
        return True
    return kv_heads % n == 0


def head_region(
    heads: int, kv_heads: int, head_dim: int, *, handles: bool = False,
    ring_axis: Optional[str] = None, cache_heads: Optional[int] = None,
) -> Tuple[int, int]:
    """(query heads, KV heads) of the attention this rank runs under the current
    mesh: its own blocks where they hold whole heads (``whole_heads``), else
    every head.  Every head, too, where

    - ``handles``: the layer's projections are int8 handles, which the rules
      never split (JAX replicates them): q/k/v come out whole on every rank;
    - ``ring_axis`` is ``"model"``: the ring runs over the model axis itself,
      and a rank's own heads cannot travel a ring whose peers hold others, so
      q/k/v are gathered to every head first (what GSPMD gives);
    - ``cache_heads``, the KV heads of the call's cache, is ``kv_heads``: the
      cache holds every KV head (a prefill whose decode steps read handles),
      and one call keeps one cache region.  A cache of any other count than
      the region's raises.

    Without those facts the KV heads, which size a KV cache or a prefix's
    slots, depend on ``kv_heads`` alone: ``kv_heads / n`` where the axis
    divides them, else all of them."""
    own = (whole_heads(heads, kv_heads, head_dim, model_size()) and not handles
           and ring_axis != "model")
    region = ((split_width(heads * head_dim) // head_dim,
               split_width(kv_heads * head_dim) // head_dim) if own else (heads, kv_heads))
    if cache_heads is None or cache_heads == region[1]:
        return region
    if cache_heads == kv_heads:
        return heads, kv_heads
    raise ValueError(
        f"head_region: the cache holds {cache_heads} KV heads, this rank's region "
        f"{region[1]} of {kv_heads}; size it with init_kv_cache(handles=...) as the call runs")


def gather_split(w: torch.Tensor, dim: int, full: int, what: str) -> torch.Tensor:
    """The whole of a weight whose ``dim`` (``full`` unsplit) the rules split
    over ``model``: the ranks' blocks gathered along ``dim`` (no gradient; the
    bits of the weight before ``shard_params``).  ``w`` itself where it is whole."""
    if not is_split(w, dim, full, what):
        return w
    w = w.contiguous()
    parts = [torch.empty_like(w) for _ in range(model_size())]
    dist.all_gather(parts, w, group=model_group())
    return torch.cat(parts, dim=dim)


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


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, width):
        ctx.group = group
        r = dist.get_group_rank(group, dist.get_rank())
        return x[..., r * width:(r + 1) * width].contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(dist.get_world_size(ctx.group))]
        dist.all_gather(parts, g, group=ctx.group)
        return torch.cat(parts, dim=-1), None, None


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


def _not_region(x: torch.Tensor, width: int, what: str) -> ValueError:
    return ValueError(
        f"{what}: {x.shape[-1]} columns, neither the region's {width} nor this rank's share "
        f"of them under a model axis of {model_size()}")


def gather_from_region(x: torch.Tensor, width: Optional[int] = None) -> torch.Tensor:
    """This rank's columns of ``x`` gathered over ``model`` to ``width`` (any
    width when None).  Where ``x`` already holds all ``width`` (a whole-heads
    region, or a projection the rules left whole) it is returned as it is;
    any width but ``width`` and ``width / n`` raises."""
    group = model_group()
    if group is None or x.shape[-1] == width:
        return x
    if width is not None and x.shape[-1] * model_size() != width:
        raise _not_region(x, width, "gather_from_region")
    return _GatherFromRegion.apply(x, group)


def scatter_to_region(x: torch.Tensor, width: int) -> torch.Tensor:
    """This rank's block of ``width`` columns of a replicated ``x``, its
    gradient gathered over ``model``.  Where ``x`` holds ``width`` columns (a
    whole-heads region, or rows the rules left whole) it is returned as it
    is; any width but ``width`` and ``n * width`` raises."""
    group = model_group()
    if group is None or x.shape[-1] == width:
        return x
    if x.shape[-1] != width * model_size():
        raise _not_region(x, width, "scatter_to_region")
    return _ScatterToRegion.apply(x, group, width)


def shared_heads(x: Optional[torch.Tensor], dim: int, width: int) -> Optional[torch.Tensor]:
    """A replicated tensor used on this rank's heads or columns only (a shift
    leaf, LoRA's B, a prefix): its block along ``dim``, through
    ``copy_to_region`` so its gradient is summed over ``model``."""
    if x is None or x.shape[dim] == width:
        return x
    return local_block(copy_to_region(x), dim, width)
