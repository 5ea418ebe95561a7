"""Deterministic, torch-free samplers for in-context-learning context assembly.

Reproduces the semantics of the reference's sampler stack
(``testbed/data/sampler/__init__.py`` + torch samplers used at
``src/dataset_utils/interface.py:243-267``): a demonstrations sampler and a query
sampler are zipped into contexts of ``num_shot + 1`` indices, then ``batch_size``
contexts are merged into one flat index batch.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.n))

    def __len__(self) -> int:
        return self.n


class ListSampler:
    """Yields a fixed, explicit index sequence (host-sharded eval uses this to
    replay exactly the demo/query stream a single-host run would assign)."""

    def __init__(self, indices: Sequence[int]):
        self.indices = list(indices)

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

    def __len__(self) -> int:
        return len(self.indices)


class RandomSampler:
    """Uniform sampling; with replacement draws ``num_samples`` indices, without
    replacement yields one shuffled epoch (fresh draw each ``__iter__``)."""

    def __init__(
        self,
        n: int,
        replacement: bool = False,
        num_samples: Optional[int] = None,
        seed: int = 0,
    ):
        self.n = n
        self.replacement = replacement
        self.num_samples = num_samples if num_samples is not None else n
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        if self.replacement:
            yield from self._rng.integers(0, self.n, size=self.num_samples).tolist()
        else:
            yield from self._rng.permutation(self.n)[: self.num_samples].tolist()

    def __len__(self) -> int:
        return self.num_samples


class DistributedSampler:
    """Round-robin partition of a sequential index range across hosts
    (reference uses torch DistributedSampler(shuffle=False), interface.py:252)."""

    def __init__(self, n: int, num_replicas: int = 1, rank: int = 0, drop_last: bool = False):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank
        if drop_last:
            self.num_samples = n // num_replicas
        else:
            self.num_samples = -(-n // num_replicas)
        self.total = self.num_samples * num_replicas

    def __iter__(self) -> Iterator[int]:
        indices = list(range(self.n))
        # pad to make evenly divisible (same as torch non-drop_last behavior)
        if len(indices) < self.total:
            indices += indices[: self.total - len(indices)]
        yield from indices[self.rank : self.total : self.num_replicas]

    def __len__(self) -> int:
        return self.num_samples


class BatchSampler:
    def __init__(self, sampler, batch_size: int, drop_last: bool = True):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.sampler) // self.batch_size
        return -(-len(self.sampler) // self.batch_size)


class ConcatSampler:
    """Zip N index samplers (each yielding an int or a list of ints) into one list per
    step, offsetting each sampler's indices by its dataset's cumulative size
    (reference testbed/data/sampler/__init__.py:5-65)."""

    def __init__(self, samplers: Sequence, cumulative_sizes: Optional[List[int]] = None):
        self.samplers = list(samplers)
        if cumulative_sizes is not None:
            self.offsets = [0] + list(cumulative_sizes[:-1])
        else:
            self.offsets = [0] * len(self.samplers)

    def __iter__(self) -> Iterator[List[int]]:
        iters = [iter(s) for s in self.samplers]
        while True:
            try:
                step = [next(it) for it in iters]
            except StopIteration:
                return
            batch: List[int] = []
            for offset, mini in zip(self.offsets, step):
                if isinstance(mini, list):
                    batch.extend(i + offset for i in mini)
                else:
                    batch.append(mini + offset)
            yield batch

    def __len__(self) -> int:
        return min(len(s) for s in self.samplers)


class MultiBatchSampler:
    """Merge ``merge_size`` context-index lists into one flat batch
    (reference testbed/data/sampler/__init__.py:68-146)."""

    def __init__(self, sampler, merge_size: int, drop_last: bool = False):
        if not isinstance(merge_size, int) or isinstance(merge_size, bool) or merge_size <= 0:
            raise ValueError(f"merge_size must be a positive int, got {merge_size!r}")
        self.sampler = sampler
        self.merge_size = merge_size

        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        buffer: List[int] = []
        count = 0
        for indices in self.sampler:
            buffer.extend(indices)
            count += 1
            if count == self.merge_size:
                yield buffer
                buffer, count = [], 0
        if buffer and not self.drop_last:
            yield buffer

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.sampler) // self.merge_size
        return -(-len(self.sampler) // self.merge_size)
