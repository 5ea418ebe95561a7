from .core import ContextDataLoader, postprocess_generation, prepare_dataloader, prepare_input
from .registry import (
    DATASET_RETRIEVERS,
    POSTPROCESSORS,
    register_dataset_retriever,
    register_postprocess,
)
from .samplers import (
    BatchSampler,
    ConcatSampler,
    DistributedSampler,
    MultiBatchSampler,
    RandomSampler,
    SequentialSampler,
)
from .templates import apply_prompt_template, TEMPLATE_RENDERERS
from .prefetch import PrefetchIterator, prefetch

# importing registers all built-in dataset retrievers/postprocessors
from . import retrievers  # noqa: F401

__all__ = [
    "BatchSampler",
    "ConcatSampler",
    "ContextDataLoader",
    "DATASET_RETRIEVERS",
    "DistributedSampler",
    "MultiBatchSampler",
    "POSTPROCESSORS",
    "RandomSampler",
    "SequentialSampler",
    "TEMPLATE_RENDERERS",
    "PrefetchIterator",
    "apply_prompt_template",
    "prefetch",
    "postprocess_generation",
    "prepare_dataloader",
    "prepare_input",
    "register_dataset_retriever",
    "register_postprocess",
]
