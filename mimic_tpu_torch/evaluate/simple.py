"""Exact-match and accuracy metrics (replacing HF ``evaluate.load("exact_match")`` /
``evaluate.load("accuracy")`` used by the reference at ``src/dataset_utils/vqa.py:112``,
``seed_bench.py:65`` and ``mme.py:94``)."""

from __future__ import annotations

from typing import Any, Dict, List

from .base import Metric


class ExactMatch(Metric):
    """Fraction of predictions equal to their reference string (0..1)."""

    def _compute(self, rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        matches = sum(1.0 for r in rows if str(r["prediction"]) == str(r["reference"]))
        return {"exact_match": matches / len(rows)}


class Accuracy(Metric):
    """Fraction of predictions equal to their (possibly non-string) reference (0..1)."""

    def _compute(self, rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        matches = sum(1.0 for r in rows if r["prediction"] == r["reference"])
        return {"accuracy": matches / len(rows)}
