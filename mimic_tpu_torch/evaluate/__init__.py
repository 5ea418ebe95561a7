from .base import Metric
from .cider import CIDEr, CiderScorer
from .okvqa_stem import OKVQAStemmer, okvqa_postprocess, singularize
from .ptb_tokenizer import ptb_tokenize, tokenize_for_caption_metrics
from .simple import Accuracy, ExactMatch
from .vqa_accuracy import VQAAccuracy, normalize_answer, vqa_sample_accuracy

_METRICS = {
    "vqa_accuracy": VQAAccuracy,
    "cider": CIDEr,
    "exact_match": ExactMatch,
    "accuracy": Accuracy,
}


def load_metric(name: str, **kwargs) -> Metric:
    """Factory mirroring ``evaluate.load`` for the metrics the harness uses."""
    try:
        return _METRICS[name](**kwargs)
    except KeyError:
        raise ValueError(f"Unknown metric {name!r}; valid: {', '.join(_METRICS)}") from None


__all__ = [
    "Accuracy",
    "CIDEr",
    "CiderScorer",
    "ExactMatch",
    "Metric",
    "OKVQAStemmer",
    "VQAAccuracy",
    "load_metric",
    "normalize_answer",
    "okvqa_postprocess",
    "ptb_tokenize",
    "singularize",
    "tokenize_for_caption_metrics",
    "vqa_sample_accuracy",
]
