"""Context preparation and generation postprocessing.

Behavioral parity with ``testbed/data/__init__.py``:

- ``prepare_input``: a batch of contexts (each a list of raw dataset items) becomes a
  batch of chat-message lists via the per-dataset retriever, with an optional
  instruction message prepended; retrievers that also return images yield a parallel
  batch of image lists.
- ``postprocess_generation``: truncate at the first stop word, strip, then apply the
  per-dataset normalizer.
- ``prepare_dataloader``: assemble (num_shot demos + 1 query) contexts from one or
  more datasets via ``ConcatSampler``/``MultiBatchSampler`` and yield batches of
  ``batch_size`` contexts.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

from .registry import DATASET_RETRIEVERS, POSTPROCESSORS
from .samplers import BatchSampler, ConcatSampler, MultiBatchSampler, RandomSampler, SequentialSampler

Context = List[Dict[str, Any]]


def prepare_input(
    dataset_name: str,
    batch: List[Context],
    instruction: Optional[str] = None,
):
    """Convert raw item contexts into chat-message contexts (+ images if multimodal).

    Returns ``batch_messages`` or ``(batch_messages, batch_images)`` when the
    retriever yields images (one flat image list per context, in message order).
    """
    retriever = DATASET_RETRIEVERS.get(dataset_name)
    batch_messages: List[List[Dict[str, Any]]] = []
    batch_images: List[List[Any]] = []
    has_images = False
    for context in batch:
        messages: List[Dict[str, Any]] = []
        images: List[Any] = []
        if instruction is not None:
            messages.append({"role": "instruction", "content": instruction})
        for i, item in enumerate(context):
            is_last = i == len(context) - 1
            prepared = retriever(item, is_last)
            if isinstance(prepared, tuple):
                msg, *rest = prepared
                messages.extend(msg)
                has_images = True
                for extra in rest:
                    if isinstance(extra, list):
                        images.extend(extra)
                    else:
                        images.append(extra)
            else:
                messages.extend(prepared)
        batch_messages.append(messages)
        batch_images.append(images)
    if has_images:
        return batch_messages, batch_images
    return batch_messages


def postprocess_generation(
    dataset_name: str,
    predictions: Union[str, List[str]],
    stop_words: Optional[List[str]] = None,
):
    """Stop-word truncation + per-dataset normalization (testbed/data/__init__.py:126-176)."""
    is_batched = not isinstance(predictions, str)
    preds = list(predictions) if is_batched else [predictions]
    postprocess = POSTPROCESSORS.get(dataset_name)

    def truncate(pred: str) -> str:
        if stop_words:
            pred = re.split("|".join(re.escape(w) for w in stop_words), pred, maxsplit=1)[0]
        return pred.strip()

    result = [postprocess(truncate(p)) for p in preds]
    return result if is_batched else result[0]


class ContextDataLoader:
    """Yields batches of contexts: ``List[List[item]]`` of shape [batch, num_shot+1].

    With a ``collate_fn``, yields ``collate_fn(batch_contexts)`` instead.
    """

    def __init__(
        self,
        datasets: Sequence,
        batch_sampler,
        collate_fn: Optional[Callable] = None,
        context_size: int = 1,
    ):
        self.datasets = datasets
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.context_size = context_size
        self._cumulative = []
        total = 0
        for ds in datasets:
            total += len(ds)
            self._cumulative.append(total)

    def _fetch(self, idx: int):
        prev = 0
        for ds, cum in zip(self.datasets, self._cumulative):
            if idx < cum:
                return ds[idx - prev]
            prev = cum
        raise IndexError(idx)

    def __iter__(self) -> Iterator:
        for flat in self.batch_sampler:
            contexts = [
                [self._fetch(i) for i in flat[k : k + self.context_size]]
                for k in range(0, len(flat), self.context_size)
            ]
            yield self.collate_fn(contexts) if self.collate_fn else contexts

    def __len__(self) -> int:
        return len(self.batch_sampler)


def prepare_dataloader(
    datasets,
    batch_size: int,
    num_shots: Optional[int] = None,
    num_per_dataset: Optional[Union[int, List[int]]] = None,
    collate_fn: Optional[Callable] = None,
    samplers=None,
    drop_last: bool = False,
    shuffle: bool = False,
    seed: int = 0,
) -> ContextDataLoader:
    """Build a context dataloader (parity with testbed/data/__init__.py:179-316)."""
    if not isinstance(datasets, list):
        datasets = [datasets]
    if num_shots is None:
        if num_per_dataset is None:
            raise ValueError("num_shots and num_per_dataset can't both be None")
        num_shots = (
            num_per_dataset - 1
            if isinstance(num_per_dataset, int)
            else sum(num_per_dataset) - 1
        )
    if num_per_dataset is None:
        num_per_dataset = [num_shots + 1]
    elif isinstance(num_per_dataset, int):
        num_per_dataset = [num_per_dataset]
    if len(num_per_dataset) != len(datasets):
        raise ValueError("num_per_dataset must have one entry per dataset")
    if sum(num_per_dataset) != num_shots + 1:
        raise ValueError("The sum of num_per_dataset should equal num_shots + 1.")

    if samplers is None:
        samplers = [None] * len(datasets)
    elif not isinstance(samplers, list):
        samplers = [samplers]
    if len(samplers) != len(datasets):
        raise ValueError("samplers must have one entry per dataset")

    def batchilize(ds, sampler, mini):
        if sampler is None:
            sampler = (
                RandomSampler(len(ds), seed=seed) if shuffle else SequentialSampler(len(ds))
            )
        if isinstance(sampler, BatchSampler):
            if sampler.batch_size != mini:
                raise ValueError(
                    f"Sampler yields lists of {sampler.batch_size}, expected {mini}"
                )
            return sampler
        return BatchSampler(sampler, mini, drop_last=True)

    batched = [
        batchilize(ds, s, m) for ds, s, m in zip(datasets, samplers, num_per_dataset)
    ]
    cumulative = []
    total = 0
    for ds in datasets:
        total += len(ds)
        cumulative.append(total)
    concat = ConcatSampler(batched, cumulative)
    multi = MultiBatchSampler(concat, batch_size, drop_last)
    return ContextDataLoader(
        datasets, multi, collate_fn=collate_fn, context_size=num_shots + 1
    )
