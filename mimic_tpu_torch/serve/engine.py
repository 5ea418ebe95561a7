"""Continuous-batching serving engine: fixed decode slots + bucketed prefill.

Counterpart of ``mimic_tpu/serve/engine.py``, with the same semantics:

- **S decode slots** share one single-token decode step.  Every slot sits at
  its own sequence length: the decoder writes new KV at per-slot columns
  (``cache_write_pos``) and attends under per-slot key masks, so a new request
  joins mid-flight without waiting for the batch to drain.
- **Bucketed prefill admission**: prompts are left-padded to the smallest
  fitting length bucket, prefilled one wave per bucket, and each row's KV
  block is spliced into a free slot.  Admission is bucket-major (the deepest
  bucket queue first), arrival order kept within a bucket.
- **Deterministic slot lifetimes**: a request holds its slot for
  ``ceil((max_new_tokens - 1) / decode_block)`` decode blocks, so the host
  issues every admission and decode block without reading the device.  EOS is
  handled on the device (a per-slot ``fin`` flag pads later tokens, as
  ``greedy_generate`` does) and the tokens are assembled at the end of
  ``run()``.
- **Early-EOS slot reclamation** (``reclaim=True``): the host reads each
  issued block's tokens one block behind the device and frees slots whose
  request already emitted EOS, instead of letting them run their remaining
  scheduled blocks.

Greedy decode; the MimIC shift stays active when ``shift`` is set, with
``logz2="masked"`` (empty slot columns are not pad tokens).  IDEFICS-1 is not
supported (its cross-attention needs the image states at every step).

What the JAX engine does for XLA or the TPU, re-decided here:

- XLA compiles one program per (bucket, wave rows), so JAX pads a wave's rows
  to a power of two and sends the pad rows to a scratch slot ``S``.  Eager
  PyTorch compiles nothing, so a wave prefills exactly its admitted rows, and
  there is no scratch slot: the cache and the per-slot state hold S rows.
- The decode block is a Python loop of ``decode_block`` steps (JAX: one
  ``lax.scan``) with every per-slot tensor on the device and no read of the
  device inside.
- A wave's prompt ids, slots, pad and real-token counts still cross to the
  device as one packed array: one host-to-device copy per wave.
- The reader: right after each wave's first tokens and each decode block are
  issued, a non-blocking copy into pinned host memory starts and a CUDA event
  is recorded behind it.  Reading a record waits on its event alone, so the
  block issued after it keeps running (a ``.cpu()`` would wait for
  everything enqueued, the newest block included).  On the CPU the tokens are
  already on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..bridge import tree_map
from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.decoder import holds_handles, init_kv_cache
from ..models.generate import _param_dtype, _prefill
from ..models.lvlm import LVLMBatch, lvlm_forward


@dataclass
class ServeRequest:
    uid: int
    input_ids: np.ndarray               # [T] prompt token ids (unpadded)
    pixel_values: Optional[np.ndarray] = None  # [N,H,W,C]
    patch_mask: Optional[np.ndarray] = None
    max_new_tokens: int = 10
    # precomputed encoded image features (``encode_images`` output for this
    # request's images, e.g. from ``models/feature_cache.py``), as either
    #   - a tensor [N*S, D], or
    #   - ``(base, row)``: row ``row`` of a shared batched tensor [R, N*S, D];
    #     requests sharing one base admit with one ``index_select`` per wave.
    # Encode ahead of submission, batched and cached: waves are small, and
    # a vision tower run inside a wave runs at its batch size.
    image_feats: Optional[Any] = None


@dataclass
class ServeResult:
    uid: int
    tokens: List[int] = field(default_factory=list)


class _HostRecord:
    """A device tensor's copy on the host, readable once ``wait`` returns."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class ServeEngine:
    """One-card continuous-batching server over a fixed slot pool.

    ``device`` (default: the card, raising without one) holds the cache, the
    per-slot state and the parameters (moved there if they lie elsewhere).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        *,
        num_slots: int = 16,
        max_len: int = 1024,
        prefill_buckets: Sequence[int] = (128, 256, 512),
        decode_block: int = 4,
        shift: Optional[Dict[str, torch.Tensor]] = None,
        eos_token_id: Optional[int] = None,
        decode_params: Optional[Dict[str, Any]] = None,
        reclaim: bool = True,
        device: Optional[DeviceLike] = None,
    ):
        if cfg.family == "idefics1":
            raise ValueError("serve engine does not support cross-attention families")
        self.device = resolve_device(device)
        to_dev = lambda tree: None if tree is None else tree_map(
            lambda t: t.to(self.device), tree)
        self.cfg = cfg
        self.params = to_dev(params)
        self.decode_params = to_dev(decode_params) if decode_params is not None else self.params
        self.shift = to_dev(shift)
        self.S = num_slots
        self.T = max_len
        self.buckets = tuple(sorted(prefill_buckets))
        self.decode_block = decode_block
        self.eos = eos_token_id if eos_token_id is not None else cfg.eos_token_id
        self.attn_impl = "flash" if self.device.type == "cuda" else "xla"
        self.dtype = _param_dtype(self.params)

        dev = self.device
        # this rank's KV heads under a model axis (every one beside int8 handles)
        self._handles = holds_handles(self.decode_params["lm"]["decoder"])
        self._cache = dict(init_kv_cache(cfg.text, self.S, self.T, dev, self.dtype,
                                         handles=self._handles), length=self.T)
        # per-slot host state (deterministic schedule: never read from the device)
        self._alive = np.zeros(self.S, bool)
        self._blocks_left = np.zeros(self.S, np.int64)
        # per-slot device state
        self._rows = torch.arange(self.S, device=dev)
        self._valid = torch.zeros(self.S, self.T + 1, dtype=torch.int32, device=dev)
        self._tok = torch.zeros(self.S, dtype=torch.int64, device=dev)
        self._pos = torch.zeros(self.S, dtype=torch.int64, device=dev)   # cache write column
        self._rpos = torch.zeros(self.S, dtype=torch.int64, device=dev)  # RoPE position (real tokens)
        self._fin = torch.zeros(self.S, dtype=torch.bool, device=dev)    # EOS flag
        self._pending: List[ServeRequest] = []
        # claims: (uid, first_ref=(wave_idx, row), start_chunk, budget, slot)
        self._claims: List[tuple] = []
        self._firsts: List[_HostRecord] = []  # per-wave first tokens [A]
        self._chunks: List[_HostRecord] = []  # per-block tokens [decode_block, S]
        self._last: Optional[_HostRecord] = None  # the record issued last
        # ``_tenant[slot]`` is the claim index occupying the slot: a chunk row is
        # attributed to the tenant that owned the slot for those steps, so a
        # reused slot's old tokens never free the new tenant
        self.reclaim = reclaim
        self._tenant: Dict[int, int] = {}
        self.reclaimed_blocks = 0  # scheduled blocks saved
        self.blocks_run = 0        # decode blocks issued
        self.host_syncs = 0        # waits of the host for the device

    # -- device work ---------------------------------------------------------

    def _decode_block(self) -> torch.Tensor:
        """Advance every slot ``decode_block`` tokens; returns [decode_block, S].

        ``pos`` is the cache write column (prompt bucket + generated count),
        ``rpos`` the RoPE position (the count of real tokens: left padding
        does not advance it).  ``fin`` carries EOS: once a slot emits EOS,
        every later token is pad.  Retired and freed slots keep stepping with
        ``pos`` clamped at ``max_len``: column ``max_len`` is the always
        attendable current-token column, and the decoder drops their k/v
        write; a prefill resets the whole row before the slot is reused.
        """
        toks = []
        for _ in range(self.decode_block):
            out = lvlm_forward(
                self.decode_params, self.cfg,
                LVLMBatch(input_ids=self._tok[:, None], attention_mask=self._valid),
                position_ids=self._rpos[:, None],
                kv_cache=self._cache,
                kv_total_len=self.T + 1,
                shift=self.shift,
                logz2="masked",
                cache_write_pos=self._pos,
            )
            self._cache = out.decoder.kv_cache
            self._fin = self._fin | (self._tok == self.eos)
            nxt = torch.where(self._fin, self.cfg.pad_token_id, out.logits[:, -1].argmax(-1))
            # the just-processed token is now in the cache: open its mask column
            self._valid[self._rows, self._pos] = 1
            self._pos = (self._pos + 1).clamp_max(self.T)
            self._rpos = self._rpos + 1
            self._tok = nxt
            toks.append(nxt)
        return torch.stack(toks)

    def _prefill_wave(self, bucket: int, packed: np.ndarray, pixels, pixel_mask, patch_mask,
                      feats) -> torch.Tensor:
        """Prefill one admission wave (A rows, one bucket) and splice every row
        into its slot; returns the first tokens [A].

        ``packed`` [A, bucket + 3]: the left-padded prompt ids, then each
        row's slot, left-pad count and real-token count; the attention mask
        is derived from the pad count on the device.
        """
        packed = torch.from_numpy(packed).to(self.device)
        ids, slots = packed[:, :bucket], packed[:, bucket]
        n_pads, n_reals = packed[:, bucket + 1], packed[:, bucket + 2]
        col = torch.arange(self.T + 1, device=self.device)
        mask = (col[None, :bucket] >= n_pads[:, None]).to(torch.int32)
        to_dev = lambda x: None if x is None else torch.from_numpy(x).to(self.device)
        batch = LVLMBatch(
            input_ids=ids, attention_mask=mask, pixel_values=to_dev(pixels),
            pixel_mask=to_dev(pixel_mask), patch_mask=to_dev(patch_mask),
        )
        last_logits, pcache, _ = _prefill(
            self.params, self.cfg, batch, bucket, self.shift, "masked", self.dtype,
            self.attn_impl, image_feats=feats, handles=self._handles,
        )
        first = last_logits.argmax(-1)
        self._cache["k"][:, slots, :bucket] = pcache["k"]
        self._cache["v"][:, slots, :bucket] = pcache["v"]
        row = (col[None] >= n_pads[:, None]) & (col[None] < bucket)
        row[:, self.T] = True  # the current-token column is always attendable
        self._valid[slots] = row.to(torch.int32)
        self._tok[slots] = first
        self._pos[slots] = bucket
        self._rpos[slots] = n_reals
        self._fin[slots] = first == self.eos
        return first

    # -- host API ------------------------------------------------------------

    def submit(self, req: ServeRequest) -> int:
        bucket = self._bucket_for(len(req.input_ids))
        if bucket + req.max_new_tokens > self.T:
            raise ValueError(
                f"bucket {bucket} + max_new_tokens {req.max_new_tokens} "
                f"exceeds slot capacity {self.T}"
            )
        self._pending.append(req)
        return req.uid

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket {self.buckets[-1]}")

    def _wave_feats(self, reqs: List[ServeRequest]) -> Optional[torch.Tensor]:
        """The wave's precomputed image features [A, N*S, D], or None."""
        if not any(r.image_feats is not None for r in reqs):
            return None
        # vision-decoupled admission: the features were encoded ahead of submission
        if any(r.pixel_values is not None and r.image_feats is None for r in reqs):
            raise ValueError(
                "one admission wave mixes precomputed image_feats with "
                "raw pixel_values — encode all or none ahead of submit"
            )
        shared = [r.image_feats for r in reqs if isinstance(r.image_feats, tuple)]
        if len(shared) == sum(r.image_feats is not None for r in reqs) and (
            shared and all(f[0] is shared[0][0] for f in shared)
        ):
            # one shared base: a single gather builds the wave.  Rows without
            # images point at row 0: their prompts carry no image tokens
            base = shared[0][0]
            idx = [int(r.image_feats[1]) if r.image_feats is not None else 0 for r in reqs]
            return torch.index_select(base, 0, torch.tensor(idx, device=base.device)).to(
                self.device)

        def one(f):
            return torch.as_tensor(f[0][f[1]] if isinstance(f, tuple) else f, device=self.device)

        f0 = one(next(r.image_feats for r in reqs if r.image_feats is not None))
        return torch.stack([
            torch.zeros_like(f0) if r.image_feats is None else one(r.image_feats) for r in reqs
        ])

    def _admit(self) -> List[tuple]:
        """Admit pending requests into free slots; returns the new waves'
        unread-first records (for the reclamation reader)."""
        new_items: List[tuple] = []
        free = [s for s in range(self.S) if not self._alive[s]]
        if not free or not self._pending:
            return new_items
        # bucket-major admission: fill the wave from the deepest bucket queues
        # first, so a wave needs as few prefills as possible.  Within a bucket,
        # arrival order is kept; every pending request is admitted within
        # #buckets waves.
        queues: Dict[int, List[int]] = {}  # bucket -> pending-list indices
        for i, req in enumerate(self._pending):
            queues.setdefault(self._bucket_for(len(req.input_ids)), []).append(i)
        by_bucket: Dict[int, List[ServeRequest]] = {}
        room = len(free)
        taken: set = set()
        for bucket in sorted(queues, key=lambda b: -len(queues[b])):
            if room <= 0:
                break
            take = queues[bucket][:room]
            by_bucket[bucket] = [self._pending[i] for i in take]
            taken.update(take)
            room -= len(take)
        # remove admitted entries by POSITION: the same ServeRequest object
        # submitted twice is two queue entries, and only the admitted copy
        # leaves the queue
        self._pending = [r for i, r in enumerate(self._pending) if i not in taken]

        for bucket, reqs in by_bucket.items():
            A = len(reqs)
            packed = np.zeros((A, bucket + 3), np.int64)
            pixels = pixel_mask = patch_mask = None
            feats = self._wave_feats(reqs)
            if feats is None and any(r.pixel_values is not None for r in reqs):
                shape = next(r.pixel_values.shape for r in reqs if r.pixel_values is not None)
                pixels = np.zeros((A,) + shape, np.float32)
                pixel_mask = np.zeros((A, shape[0]), np.int32)
                if any(r.patch_mask is not None for r in reqs):
                    pshape = next(r.patch_mask.shape for r in reqs if r.patch_mask is not None)
                    patch_mask = np.zeros((A,) + pshape, np.int32)
            slots = [free.pop(0) for _ in reqs]
            for a, r in enumerate(reqs):
                n = len(r.input_ids)
                packed[a, bucket - n : bucket] = r.input_ids  # left padding
                packed[a, bucket:] = (slots[a], bucket - n, n)
                if pixels is not None and r.pixel_values is not None:
                    pixels[a] = r.pixel_values
                    pixel_mask[a] = 1
                    if patch_mask is not None and r.patch_mask is not None:
                        patch_mask[a] = r.patch_mask
            first = self._prefill_wave(bucket, packed, pixels, pixel_mask, patch_mask, feats)
            wave = len(self._firsts)
            self._firsts.append(self._issue(first))
            entries = []
            for a, (r, slot) in enumerate(zip(reqs, slots)):
                budget = r.max_new_tokens - 1  # the first token came from the prefill
                blocks = -(-budget // self.decode_block) if budget > 0 else 0
                self._alive[slot] = blocks > 0
                self._blocks_left[slot] = blocks
                seq = len(self._claims)
                self._claims.append((r.uid, (wave, a), len(self._chunks), budget, slot))
                self._tenant[slot] = seq
                entries.append((a, slot, seq))
            new_items.append(("first", self._firsts[wave], entries))
        return new_items

    @torch.no_grad()
    def run(self) -> List[ServeResult]:
        """Process all submitted requests to completion; returns results
        ordered by uid.

        The loop issues work first (admissions and decode blocks), then, with
        ``reclaim=True``, reads the tokens of everything issued except the
        newest block, one block behind the device.  A slot whose tenant's
        tokens hold EOS is freed at once: its remaining scheduled blocks are
        never issued, and the slot re-admits a pending request a block later.
        With ``reclaim=False`` the only wait for the device is ``_collect``'s.
        """
        unread: List[tuple] = []
        while self._pending or self._alive.any():
            unread.extend(self._admit())
            if self._alive.any():
                self._chunks.append(self._issue(self._decode_block()))
                unread.append(("chunk", len(self._chunks) - 1))
                self.blocks_run += 1
                live = self._alive.nonzero()[0]
                self._blocks_left[live] -= 1
                self._alive[live] = self._blocks_left[live] > 0
            if self.reclaim and len(unread) > 1:
                self._wait(self._record(unread[-2]))
                for item in unread[:-1]:
                    self._reclaim_item(item)
                del unread[:-1]
        return self._collect()

    def _issue(self, t: torch.Tensor) -> _HostRecord:
        self._last = _HostRecord(t)
        return self._last

    def _record(self, item: tuple) -> _HostRecord:
        return item[1] if item[0] == "first" else self._chunks[item[1]]

    def _wait(self, record: _HostRecord) -> None:
        """Wait until ``record`` (and everything issued before it) is on the host."""
        record.wait()
        self.host_syncs += 1

    def _reclaim_item(self, item: tuple) -> None:
        """Scan one read-back record (a wave's first tokens or a decode block)
        for EOS and free the emitting slots early."""
        if item[0] == "first":
            _, record, entries = item
            first = record.host.numpy()
            for a, slot, seq in entries:
                if (
                    self._alive[slot]
                    and self._tenant.get(slot) == seq
                    and int(first[a]) == self.eos
                ):
                    self.reclaimed_blocks += int(self._blocks_left[slot])
                    self._alive[slot] = False
                    self._blocks_left[slot] = 0
        else:
            _, ci = item
            chunk = self._chunks[ci].host.numpy()  # [decode_block, S]
            lo = ci * self.decode_block
            for slot in range(self.S):
                if not self._alive[slot]:
                    continue
                seq = self._tenant.get(slot)
                if seq is None:
                    continue
                _, _, c0, budget, _ = self._claims[seq]
                if ci < c0:
                    continue  # the chunk predates this tenant (the slot was reused)
                start = max(lo, c0 * self.decode_block)
                stop = min(lo + self.decode_block, c0 * self.decode_block + budget)
                if stop <= start:
                    continue
                if (chunk[start - lo : stop - lo, slot] == self.eos).any():
                    self.reclaimed_blocks += int(self._blocks_left[slot])
                    self._alive[slot] = False
                    self._blocks_left[slot] = 0

    def _collect(self) -> List[ServeResult]:
        """One wait for the device, then per-request sequences assembled on
        the host (truncated at EOS)."""
        if self._last is not None:
            self._wait(self._last)  # everything issued before it is done too
        chunks = (
            np.concatenate([c.host.numpy() for c in self._chunks], axis=0)
            if self._chunks else np.zeros((0, self.S), np.int64)
        )  # [total_steps, S]
        firsts = [f.host.numpy() for f in self._firsts]
        done = []
        for uid, (wave, a), c0, budget, slot in self._claims:
            toks = [int(firsts[wave][a])]
            if budget > 0:
                start = c0 * self.decode_block
                toks += [int(t) for t in chunks[start : start + budget, slot]]
            if self.eos in toks:
                toks = toks[: toks.index(self.eos)]
            done.append(ServeResult(uid=uid, tokens=toks))
        self._claims, self._firsts, self._chunks, self._last = [], [], [], None
        # stale tenant entries would index into the cleared claims list
        self._tenant.clear()
        return sorted(done, key=lambda r: r.uid)
