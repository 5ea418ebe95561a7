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

The backward (``RingAttentionDiff``) runs the same ring again.  Each block's
gradient is one call of the attention backward
(``ops/flash_backward.py::flash_attention_backward``: ``flash_bwd_dq`` and
``flash_bwd_dkv`` on the card, their plain version on the CPU), given the
chunk's *merged* ``out``, ``lse`` and ``lse_u``.  With them the block's
p = exp(s − lse) and p_u = exp(s − lse_u) are the global ones, so the
kernels' ds = p∘(dO·vᵀ − Δ) + g_lse∘p + g_lse_u∘p_u is exact per block, and
Δ = Σ g_out∘out is computed once per chunk.  q, g_out and the saved forward
stay on their rank; K, V, the key mask and fp32 accumulators of dk / dv
travel the ring, each rank adding its block's partial, and one more hop
brings each block's dk / dv home; dq sums locally in fp32.
``ring_attention_backward_chunks`` runs the same schedule in one process,
indexing the n chunks instead.  A future block carries only g_lse_u∘p_u: it
runs whenever ``need_unmasked`` (n² launches of each kernel per call) and is
skipped without it, where it adds exactly zero (n(n+1)/2).

A row with no attendable key gets p = 0 in the backward (the kernels' and
the JAX package's flash VJP's convention), so such a row gives v no
gradient; JAX's ring differentiated by autodiff gives dv its g_out / T.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import axis_group, axis_rank, axis_size
from .flash_attention import _dispatch
from .flash_backward import flash_attention_backward

Out3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _future(rank: int, kv_rank: int, causal: bool) -> bool:
    """Every key of the block lies in the causal future of the chunk."""
    return causal and kv_rank > rank


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
    if _future(rank, kv_rank, causal):
        # every key in the causal future: none attendable, lse_u over all of them
        mask_blk = torch.zeros_like(mask_blk)
    return _dispatch(q, k_blk, v_blk, mask_blk, causal and kv_rank == rank, scale, need_unmasked)


def ring_block_backward(
    q: torch.Tensor,
    k_blk: torch.Tensor,
    v_blk: torch.Tensor,
    mask_blk: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    lse_u: torch.Tensor,
    g_out: torch.Tensor,
    g_lse: Optional[torch.Tensor],
    g_lse_u: Optional[torch.Tensor],
    rank: int,
    kv_rank: int,
    causal: bool,
    scale: Optional[float],
    need_unmasked: bool,
    delta: Optional[torch.Tensor] = None,
) -> Optional[Out3]:
    """The counterpart of ``ring_block``: query chunk ``rank``'s share of
    ``(dq, dk, dv)`` through the K/V block of ``kv_rank``, one launch of each
    backward kernel.  ``out``, ``lse`` and ``lse_u`` are the chunk's merged
    forward (over every block), ``delta`` its Δ.  None for a future block
    without ``need_unmasked``, which adds exactly zero."""
    if _future(rank, kv_rank, causal):
        if not need_unmasked:
            return None
        mask_blk = torch.zeros_like(mask_blk)
    return flash_attention_backward(
        q, k_blk, v_blk, mask_blk, out, lse, lse_u, g_out, g_lse, g_lse_u,
        causal=causal and kv_rank == rank, scale=scale, need_unmasked=need_unmasked, delta=delta,
    )


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


def _ring_peers(group) -> Tuple[int, int, int, int]:
    """(n, this rank's index on the ring, the next rank, the previous rank)."""
    ranks = dist.get_process_group_ranks(group) if group is not None else [0]
    n = len(ranks)
    rank = ranks.index(dist.get_rank()) if group is not None else 0
    return n, rank, ranks[(rank + 1) % n], ranks[(rank - 1) % n]


def _exchange(tensors: List[torch.Tensor], nxt: int, prv: int, group):
    """Start passing ``tensors`` to the next rank and receiving their
    counterparts from the previous one: (receive buffers, requests)."""
    recv = [torch.empty_like(x) for x in tensors]
    ops = [dist.P2POp(dist.isend, x, nxt, group) for x in tensors]
    ops += [dist.P2POp(dist.irecv, x, prv, group) for x in recv]
    return recv, dist.batch_isend_irecv(ops)


def _wait(reqs) -> None:
    for req in reqs:
        req.wait()


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
    n, rank, nxt, prv = _ring_peers(group)
    blk = [k.contiguous(), v.contiguous(), key_mask.contiguous()]
    merge = RingMerge()
    for t in range(n):
        if t < n - 1:
            # pass this block on while it is used
            recv, reqs = _exchange(blk, nxt, prv, group)
        merge.add(*ring_block(q, blk[0], blk[1], blk[2], rank, (rank - t) % n, causal, scale,
                              need_unmasked))
        if t < n - 1:
            _wait(reqs)
            blk = recv
    return merge.result(q.dtype)


class _RingExchange:
    """One rank's K/V blocks on the ring and the fp32 dk / dv accumulators of
    the block it holds, both passed ``i → i+1``.  At step t the rank holds
    block ``(rank − t) mod n``; the next block's exchange starts before the
    block's kernels, and the accumulators' hop overlaps the next block's.
    K/V/mask move n − 1 times, the accumulators n times (the last hop brings
    them home).  Each exchange has its own buffers."""

    def __init__(self, k, v, key_mask, group) -> None:
        self.n, self.rank, self.nxt, self.prv = _ring_peers(group)
        self.group = group
        self.blk = [k.contiguous(), v.contiguous(), key_mask.contiguous()]
        f32 = dict(dtype=torch.float32, device=k.device)
        self.acc = [torch.zeros(k.shape, **f32), torch.zeros(v.shape, **f32)]
        self.reqs = self.acc_reqs = None

    def block(self, t: int) -> List[torch.Tensor]:
        if t < self.n - 1:  # pass this block on while it is used
            self.recv, self.reqs = _exchange(self.blk, self.nxt, self.prv, self.group)
        return self.blk

    def add(self, t: int, dk: Optional[torch.Tensor], dv: Optional[torch.Tensor]) -> None:
        if self.acc_reqs is not None:
            _wait(self.acc_reqs)  # this block's dk / dv from the ranks before
        if dk is not None:
            self.acc = [self.acc[0] + dk.float(), self.acc[1] + dv.float()]
        if self.n > 1:
            self.acc, self.acc_reqs = _exchange(self.acc, self.nxt, self.prv, self.group)
        if t < self.n - 1:
            _wait(self.reqs)
            self.blk = self.recv

    def result(self) -> List[torch.Tensor]:
        """This rank's own block's dk / dv, summed over every rank's queries."""
        if self.acc_reqs is not None:
            _wait(self.acc_reqs)
        return self.acc


class _IndexedChunks:
    """The ring in one process: rank ``rank``'s block at step t is chunk
    ``(rank − t) mod n`` of ``chunks``, and its dk / dv partial goes straight
    into that chunk's fp32 sums, which every rank's schedule shares."""

    def __init__(self, chunks, sums, rank: int) -> None:
        self.chunks, self.sums, self.rank = chunks, sums, rank

    def block(self, t: int) -> List[torch.Tensor]:
        return self.chunks[(self.rank - t) % len(self.chunks)]

    def add(self, t: int, dk: Optional[torch.Tensor], dv: Optional[torch.Tensor]) -> None:
        if dk is not None:
            sums = self.sums[(self.rank - t) % len(self.chunks)]
            sums[0] += dk.float()
            sums[1] += dv.float()


def _backward_schedule(q, out, lse, lse_u, g_out, g_lse, g_lse_u, rank, n, blocks, causal, scale,
                       need_unmasked) -> torch.Tensor:
    """Rank ``rank``'s backward over the ring: at step t its query chunk meets
    ``blocks.block(t)``, the block of rank ``(rank − t) mod n``, through
    ``ring_block_backward`` and hands the block's dk / dv partial to
    ``blocks.add`` (None where a future block is skipped).  Δ once per chunk;
    returns dq summed in fp32."""
    delta = (g_out.float() * out.float()).sum(-1)  # [B, C, H]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for t in range(n):
        k_blk, v_blk, m_blk = blocks.block(t)
        part = ring_block_backward(q, k_blk, v_blk, m_blk, out, lse, lse_u, g_out, g_lse, g_lse_u,
                                   rank, (rank - t) % n, causal, scale, need_unmasked, delta=delta)
        if part is not None:
            dq += part[0].float()
        blocks.add(t, *(part[1:] if part is not None else (None, None)))
    return dq


def ring_attention_backward(
    q: torch.Tensor,         # [B, C, H, D] local query chunk
    k: torch.Tensor,         # [B, C, Hkv, D] local key chunk
    v: torch.Tensor,
    key_mask: torch.Tensor,  # [B, C]
    out: torch.Tensor,       # [B, C, H, D] the chunk's merged forward
    lse: torch.Tensor,       # [B, C, H]
    lse_u: torch.Tensor,
    g_out: torch.Tensor,     # [B, C, H, D] cotangents of the chunk's rows
    g_lse: Optional[torch.Tensor],
    g_lse_u: Optional[torch.Tensor],
    group,
    causal: bool = True,
    scale: Optional[float] = None,
    need_unmasked: bool = True,
) -> Out3:
    """Per-shard body of the backward: this rank's ``(dq, dk, dv)`` for its
    query chunk and its K/V chunk (every rank of the group calls it): the
    schedule over the P2P ring of ``_RingExchange``."""
    ring = _RingExchange(k, v, key_mask, group)
    dq = _backward_schedule(q, out, lse, lse_u, g_out, g_lse, g_lse_u, ring.rank, ring.n, ring,
                            causal, scale, need_unmasked)
    dk, dv = ring.result()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ring_attention_backward_chunks(
    q: torch.Tensor,         # [B, T, H, D] the whole sequence
    k: torch.Tensor,         # [B, T, Hkv, D]
    v: torch.Tensor,
    key_mask: torch.Tensor,  # [B, T]
    out: torch.Tensor,       # [B, T, H, D] the ring's merged forward
    lse: torch.Tensor,       # [B, T, H]
    lse_u: torch.Tensor,
    g_out: torch.Tensor,
    g_lse: Optional[torch.Tensor],
    g_lse_u: Optional[torch.Tensor],
    n: int,
    causal: bool = True,
    scale: Optional[float] = None,
    need_unmasked: bool = True,
) -> Out3:
    """The ring's backward of n ranks in one process: each rank's chunk
    through the schedule ``ring_attention_backward`` runs, the exchange
    replaced by indexing the n chunks (``_IndexedChunks``).  Full-length
    ``(dq, dk, dv)``, each rounded once from its fp32 sum."""
    C = q.shape[1] // n
    chunk = lambda x, r: None if x is None else x[:, r * C:(r + 1) * C]  # noqa: E731
    chunks = [[chunk(x, j) for x in (k, v, key_mask)] for j in range(n)]
    f32 = dict(dtype=torch.float32, device=q.device)
    sums = [[torch.zeros(chunk(k, j).shape, **f32), torch.zeros(chunk(v, j).shape, **f32)]
            for j in range(n)]
    dq = [_backward_schedule(*(chunk(x, r) for x in (q, out, lse, lse_u, g_out, g_lse, g_lse_u)),
                             r, n, _IndexedChunks(chunks, sums, r), causal, scale, need_unmasked)
          for r in range(n)]
    return (torch.cat(dq, dim=1).to(q.dtype), torch.cat([s[0] for s in sums], dim=1).to(k.dtype),
            torch.cat([s[1] for s in sums], dim=1).to(v.dtype))


class RingAttentionDiff(torch.autograd.Function):
    """``ring_attention`` over this rank's chunk of full-length q/k/v, its
    ``(out, lse, lse_u)`` gathered back along T, with gradients.

    Forward: the ring, then an all-gather of the three outputs; this rank's
    inputs and merged outputs are saved.  Backward: this rank's chunk of the
    full cotangents through ``ring_attention_backward``, then an all-gather
    of dq, dk and dv.  Downstream of the gather every rank of the group
    holds the same tensors, so every rank ends with the same full gradients:
    nothing is summed over the group.  ``key_mask`` gets no gradient.
    """

    @staticmethod
    def forward(ctx, q, k, v, key_mask, group, n, r, causal, need_unmasked):
        C = q.shape[1] // n
        chunks = [x[:, r * C:(r + 1) * C].contiguous() for x in (q, k, v, key_mask)]
        outs = ring_attention(*chunks, group, causal=causal, need_unmasked=need_unmasked)
        ctx.save_for_backward(*chunks, *outs)
        ctx.group, ctx.n, ctx.r = group, n, r
        ctx.causal, ctx.need_unmasked = causal, need_unmasked
        ctx.set_materialize_grads(False)
        return tuple(_gather(x, group, n) for x in outs)

    @staticmethod
    def backward(ctx, g_out, g_lse, g_lse_u):
        q, k, v, km, out, lse, lse_u = ctx.saved_tensors
        C, r = q.shape[1], ctx.r
        chunk = lambda g: None if g is None else g[:, r * C:(r + 1) * C]  # noqa: E731
        g_out = torch.zeros_like(out) if g_out is None else chunk(g_out).contiguous()
        grads = ring_attention_backward(q, k, v, km, out, lse, lse_u, g_out, chunk(g_lse),
                                        chunk(g_lse_u), ctx.group, causal=ctx.causal,
                                        need_unmasked=ctx.need_unmasked)
        return (*(_gather(g, ctx.group, ctx.n) for g in grads),) + (None,) * 6


def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The group's chunks of ``x`` concatenated along T (dim 1), in rank order."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


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
    gathered back along T over that axis (``RingAttentionDiff``, so the call
    records gradients for q, k and v).  ``batch_axis`` names the mesh's data
    axis, whose rows ``shard_batch`` already gave this rank (the batch here
    is this rank's rows)."""
    names = mesh.mesh_dim_names or ()
    for axis in (axis_name, batch_axis):
        if axis is not None and axis not in names:
            raise ValueError(f"ring attention: the mesh has no axis {axis!r} ({names})")
    n, r = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    T = q.shape[1]
    if T % n:
        raise ValueError(f"ring attention: T={T} does not split over {n} ranks of {axis_name!r}")
    return RingAttentionDiff.apply(q, k, v, key_mask, axis_group(mesh, axis_name), n, r, causal,
                                   need_unmasked)
