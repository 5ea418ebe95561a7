"""Dataset retriever / postprocess registries.

Same roles as the reference's decorator registries (``testbed/data/common.py:11-82``):
a *retriever* converts one raw dataset item into chat messages (+ images); a
*postprocess* normalizes one generated string for metric computation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from ..utils.registry import Registry

# retriever(item, is_last) -> (messages, images)
RetrieverFn = Callable[[Dict[str, Any], bool], Tuple[List[Dict[str, Any]], Any]]
# postprocess(text) -> normalized prediction
PostprocessFn = Callable[[str], Any]

DATASET_RETRIEVERS: Registry[RetrieverFn] = Registry("dataset retriever", expected_params=2)
POSTPROCESSORS: Registry[PostprocessFn] = Registry("postprocess", expected_params=1)


def register_dataset_retriever(name: str, **kwargs):
    return DATASET_RETRIEVERS.register(name, **kwargs)


def register_postprocess(name: str, **kwargs):
    return POSTPROCESSORS.register(name, **kwargs)
