"""Dataset adapter base — parity with ``src/dataset_utils/interface.py``.

An adapter owns a support set and a query set (plain item lists), applies the
reference's seeded shuffle/selection invariants, and builds train/validation
context dataloaders.  Concrete adapters add instruction text, answer extraction,
and the metric-specific eval loop.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...config import DataConfig
from ..core import ContextDataLoader, prepare_dataloader, prepare_input
from ..samplers import (
    BatchSampler,
    DistributedSampler,
    ListSampler,
    RandomSampler,
    SequentialSampler,
)


def seeded_shuffle(items: Sequence, seed: int) -> List:
    """HF ``datasets.Dataset.shuffle(seed)`` permutation semantics
    (numpy default_rng permutation)."""
    perm = np.random.default_rng(seed).permutation(len(items))
    return [items[i] for i in perm]


class DatasetAdapter(ABC):
    """Mirrors ``DatasetBase`` + ``PostInitMeta`` invariants
    (``src/dataset_utils/interface.py:33-150``)."""

    support_datasets: List[str] = []

    _num_skip_oom: int = 0
    _eval_shard: Tuple[int, int] = (0, 1)  # (rank, num_replicas)

    def __init__(self, data_cfg: DataConfig, support_set: Sequence, query_set: Sequence):
        self.cfg = data_cfg
        if self.name not in self.support_datasets:
            raise ValueError(
                f"Dataset {self.name} is not supported by {type(self).__name__}"
            )
        # post-init invariants (interface.py:36-62): shuffle support; shuffle+select
        # query down to num_query_samples
        self._support_set = seeded_shuffle(support_set, data_cfg.seed)
        query = list(query_set)
        n = data_cfg.num_query_samples
        if n:
            if n > len(query):
                n = len(query)
                self.cfg.num_query_samples = n
            self._query_set = seeded_shuffle(query, data_cfg.seed)[:n]
        else:
            self._query_set = query
            self.cfg.num_query_samples = len(query)

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def support_set(self) -> List:
        return self._support_set

    @property
    def query_set(self) -> List:
        return self._query_set

    # -- abstract surface ----------------------------------------------------

    @staticmethod
    @abstractmethod
    def metric_key() -> str: ...

    @property
    @abstractmethod
    def instruction(self) -> Optional[str]: ...

    @property
    @abstractmethod
    def num_role_in_round(self) -> int: ...

    @abstractmethod
    def extract_answer(self, item: Dict) -> str: ...

    @abstractmethod
    def eval(self, eval_cfg, runner) -> Tuple[List[Dict], Dict]: ...

    # -- host-sharded evaluation ---------------------------------------------

    def set_eval_shard(self, rank: int, num_replicas: int) -> None:
        """Restrict this adapter's validation set to query stride ``rank::R``.

        Within one (dataset, shot, epoch) task, each host evaluates an
        interleaved slice of the query set (the eval analog of the reference's
        manual train DistributedSampler, ``src/train.py:104``; the reference
        eval phase has no such sharding and leaves extra GPUs idle).  When
        sharded, ``eval()`` returns the un-computed ``Metric`` (rows intact)
        so ``pipeline.evaluate.run_eval`` can merge rows across hosts before
        computing the final score.
        """
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self._eval_shard = (rank, num_replicas)

    def _finish(self, records: List[Dict], metric) -> Tuple[List[Dict], Any]:
        rank, num_replicas = self._eval_shard
        if num_replicas == 1:
            return records, metric.compute()
        return records, metric  # caller merges rows across hosts, then computes

    # -- prediction ----------------------------------------------------------

    def get_prediction(
        self, runner, batch, max_skip_oom: int = 0, **generation_args
    ) -> Optional[List[str]]:
        """Context batch → generated strings (interface.py:152-190).

        ``max_skip_oom``: on a device OOM ("RESOURCE_EXHAUSTED" — XLA's analog
        of torch's "out of memory"), skip the batch (return None) up to this
        many times, then re-raise — same budget semantics as the reference.
        Rare on TPU (XLA preallocates), but a too-long prompt bucket can still
        exhaust HBM at compile/run time."""
        ret = prepare_input(self.name, batch, instruction=self.instruction)
        if isinstance(ret, tuple):
            context, images = ret
            args = (images, context)
        else:
            args = (None, ret)
        try:
            return runner.generate(*args, **generation_args)
        except Exception as e:
            msg = str(e)
            if "RESOURCE_EXHAUSTED" not in msg and "out of memory" not in msg:
                raise
            if self._num_skip_oom >= max_skip_oom:
                raise
            self._num_skip_oom += 1
        return None

    # -- dataloaders ---------------------------------------------------------

    def train_dataloader(
        self,
        apply_template: Callable,
        batch_size: int,
        distributed: bool = False,
        num_replicas: int = 1,
        rank: int = 0,
    ) -> ContextDataLoader:
        """(num_shot demos + 1 query) contexts → {prefix_texts, query_texts,
        answers, images} string batches (interface.py:192-289)."""

        def collate_fn(batch_contexts):
            results: Dict[str, Any] = {}
            ret = prepare_input(self.name, batch_contexts, instruction=self.instruction)
            if isinstance(ret, tuple):
                batch_context, batch_images = ret
                results["images"] = batch_images
            else:
                batch_context = ret
            n_role = self.num_role_in_round
            results["prefix_texts"] = (
                [apply_template(ctx[:-n_role]) for ctx in batch_context]
                if self.cfg.num_shot > 0
                else None
            )
            results["query_texts"] = [
                apply_template(ctx[-n_role:]) for ctx in batch_context
            ]
            results["answers"] = [self.extract_answer(ctx[-1]) for ctx in batch_contexts]
            return results

        n = min(self.cfg.num_query_samples, len(self.support_set))
        train_set = self.support_set[:n]
        example_sampler = RandomSampler(
            len(train_set),
            replacement=True,
            num_samples=self.cfg.num_shot * n,
            seed=self.cfg.seed,
        )
        if distributed:
            query_sampler = DistributedSampler(len(train_set), num_replicas, rank)
        else:
            query_sampler = SequentialSampler(len(train_set))

        if self.cfg.num_shot > 0:
            return prepare_dataloader(
                [train_set, train_set],
                batch_size=batch_size,
                num_per_dataset=[self.cfg.num_shot, 1],
                samplers=[
                    BatchSampler(example_sampler, self.cfg.num_shot, drop_last=True),
                    query_sampler,
                ],
                collate_fn=collate_fn,
                drop_last=True,
            )
        return prepare_dataloader(
            [train_set],
            batch_size=batch_size,
            num_shots=0,
            samplers=[query_sampler],
            collate_fn=collate_fn,
        )

    def validation_dataloader(self, batch_size: int) -> ContextDataLoader:
        """Support-sampled demos + sequential queries (interface.py:291-327).

        Under ``set_eval_shard(rank, R)`` each host takes queries
        ``rank, rank+R, rank+2R, …`` with exactly the demo blocks a
        single-host run would have paired with those queries (the full demo
        stream is materialized once and sliced block-wise), so sharded and
        unsharded evals see identical (demos, query) contexts.
        """
        rank, num_replicas = self._eval_shard
        nq = len(self.query_set)
        if self.cfg.num_shot > 0:
            total_required = self.cfg.num_shot * self.cfg.num_query_samples
            support_sampler = RandomSampler(
                len(self.support_set),
                replacement=total_required > len(self.support_set),
                num_samples=total_required,
                seed=self.cfg.seed,
            )
            if num_replicas > 1:
                stream = list(iter(support_sampler))
                ns = self.cfg.num_shot
                demo_idx = [
                    i
                    for q in range(rank, nq, num_replicas)
                    for i in stream[q * ns : (q + 1) * ns]
                ]
                support_sampler = ListSampler(demo_idx)
                query_sampler = ListSampler(range(rank, nq, num_replicas))
            else:
                query_sampler = SequentialSampler(nq)
            return prepare_dataloader(
                [self.support_set, self.query_set],
                batch_size=batch_size,
                num_per_dataset=[self.cfg.num_shot, 1],
                samplers=[
                    BatchSampler(support_sampler, self.cfg.num_shot, drop_last=True),
                    query_sampler,
                ],
                drop_last=True,
            )
        if num_replicas > 1:
            return prepare_dataloader(
                [self.query_set],
                batch_size=batch_size,
                num_shots=0,
                samplers=[ListSampler(range(rank, nq, num_replicas))],
            )
        return prepare_dataloader(
            [self.query_set], batch_size=batch_size, num_shots=0
        )
