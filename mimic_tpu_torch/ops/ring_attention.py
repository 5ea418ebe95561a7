"""Ring attention: sequence-parallel exact attention over a mesh axis.

Counterpart of ``mimic_tpu/ops/ring_attention.py``.  Each rank of the ring
axis owns a contiguous query chunk ``[rank·C, (rank+1)·C)`` and keeps it; the
K/V/mask blocks travel the ring with ``dist.batch_isend_irecv`` (JAX's
``ppermute`` ``i → i+1``), so at ring step ``t`` a rank holds the block of
rank ``(rank − t) mod n``.  Causal masking works on global positions.

Each block's partial attention is one call of the port's attention forward
(``ops/flash_attention.py::_dispatch``): ``flash_fwd`` / ``onepass_fwd`` on the
card, their plain version on the CPU.  The block kinds:

- kv-rank < rank: the whole block is in the past, non-causal over its key mask;
- kv-rank == rank: the diagonal block, causal;
- kv-rank > rank: every key is in the causal future.  It runs with no
  attendable key, so its ``(out, lse)`` weigh nothing beside an attended block
  and only its unmasked log-normalizer counts (MimIC's log Z₂ sees every key).

The blocks are merged in fp32 by logsumexp (as the decoder's prefix merge):
``m = max lse_i``, ``w_i = exp(lse_i − m)``, ``out = Σ w_i·out_i / Σ w_i``,
``lse = m + log Σ w_i``; the same for ``lse_u``.  A row with no attendable
key anywhere has ``lse_i = NEG`` in every block, so every ``w_i`` is 1 and it
is the mean of v over all T keys, as JAX's ring gives it (with
``need_unmasked``, where every kernel visits every key tile): never ``-inf``,
never NaN.

Forward only: with gradients recorded a ring call raises.  In the MimIC step
the ring carries the record pass, which runs without gradients.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import axis_group, axis_rank, axis_size
from .flash_attention import _dispatch

Out3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def ring_block(
    q: torch.Tensor,
    k_blk: torch.Tensor,
    v_blk: torch.Tensor,
    mask_blk: torch.Tensor,
    rank: int,
    kv_rank: int,
    causal: bool,
    scale: Optional[float],
    need_unmasked: bool,
) -> Out3:
    """The partial attention of query chunk ``rank`` over the K/V block of
    ``kv_rank``: one launch of the attention forward."""
    if causal and kv_rank > rank:
        # every key in the causal future: none attendable, lse_u over all of them
        mask_blk = torch.zeros_like(mask_blk)
    return _dispatch(q, k_blk, v_blk, mask_blk, causal and kv_rank == rank, scale, need_unmasked)


class RingMerge:
    """The logsumexp merge of block results, one block at a time, in fp32."""

    def __init__(self) -> None:
        self.m = self.s = self.o = self.mu = self.su = None

    def add(self, out: torch.Tensor, lse: torch.Tensor, lse_u: torch.Tensor) -> None:
        if self.m is None:
            self.m, self.s, self.o = lse, torch.ones_like(lse), out.float()
            self.mu, self.su = lse_u, torch.ones_like(lse_u)
            return
        m = torch.maximum(self.m, lse)
        a, b = torch.exp(self.m - m), torch.exp(lse - m)
        self.s = self.s * a + b
        self.o = self.o * a[..., None] + out.float() * b[..., None]
        self.m = m
        mu = torch.maximum(self.mu, lse_u)
        self.su = self.su * torch.exp(self.mu - mu) + torch.exp(lse_u - mu)
        self.mu = mu

    def result(self, dtype: torch.dtype) -> Out3:
        return ((self.o / self.s[..., None]).to(dtype), self.m + torch.log(self.s),
                self.mu + torch.log(self.su))


def _check_no_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("ring attention's backward is not ported yet")


def ring_attention(
    q: torch.Tensor,         # [B, C, H, D] local query chunk
    k: torch.Tensor,         # [B, C, Hkv, D] local key chunk
    v: torch.Tensor,         # [B, C, Hkv, D]
    key_mask: torch.Tensor,  # [B, C] local slot validity
    group,
    causal: bool = True,
    scale: Optional[float] = None,
    need_unmasked: bool = True,
) -> Out3:
    """Per-shard body: this rank's ``(out, lse, lse_unmasked)`` for its query
    chunk over the ring of ``group`` (every rank of the group calls it).
    Semantics match ``flash_attention`` on the gathered sequence."""
    _check_no_grad(q, k, v)
    ranks = dist.get_process_group_ranks(group) if group is not None else [0]
    n = len(ranks)
    rank = ranks.index(dist.get_rank()) if group is not None else 0
    nxt, prv = ranks[(rank + 1) % n], ranks[(rank - 1) % n]
    blk = [k.contiguous(), v.contiguous(), key_mask.contiguous()]
    merge = RingMerge()
    for t in range(n):
        reqs: List = []
        if t < n - 1:
            # pass this block on while it is used
            recv = [torch.empty_like(x) for x in blk]
            ops = [dist.P2POp(dist.isend, x, nxt, group) for x in blk]
            ops += [dist.P2POp(dist.irecv, x, prv, group) for x in recv]
            reqs = dist.batch_isend_irecv(ops)
        merge.add(*ring_block(q, blk[0], blk[1], blk[2], rank, (rank - t) % n, causal, scale,
                              need_unmasked))
        for req in reqs:
            req.wait()
        if reqs:
            blk = recv
    return merge.result(q.dtype)


def ring_attention_sharded(
    mesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    axis_name: str = "sp",
    causal: bool = True,
    need_unmasked: bool = True,
    batch_axis: Optional[str] = None,
) -> Out3:
    """Full-length q/k/v/key_mask → full-length ``(out, lse, lse_u)``: this
    rank's chunk along T on ``axis_name`` runs the ring, and the chunks are
    gathered back along T over that axis.  ``batch_axis`` names the mesh's
    data axis, whose rows ``shard_batch`` already gave this rank (the batch
    here is this rank's rows)."""
    names = mesh.mesh_dim_names or ()
    for axis in (axis_name, batch_axis):
        if axis is not None and axis not in names:
            raise ValueError(f"ring attention: the mesh has no axis {axis!r} ({names})")
    _check_no_grad(q, k, v)
    n, r = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    T = q.shape[1]
    if T % n:
        raise ValueError(f"ring attention: T={T} does not split over {n} ranks of {axis_name!r}")
    C = T // n
    chunk = lambda x: x[:, r * C:(r + 1) * C]  # noqa: E731
    group = axis_group(mesh, axis_name)
    outs = ring_attention(chunk(q), chunk(k), chunk(v), chunk(key_mask), group, causal=causal,
                          need_unmasked=need_unmasked)
    if group is None:
        return outs

    def gather(x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    return tuple(gather(x) for x in outs)
